"""Continuous-batching LLM engine: one per serve replica.

Copy of ``ray_tpu/serve/llm/engine.py`` over the port's adapters, with
its trace spans (``_private/tracing``).

Reference analogue: vLLM's LLMEngine/Scheduler. The serve data plane's
adaptive micro-batching flushes a *window* of requests into one call —
right for stateless fns, wrong for autoregressive decode, where a batch admitted
together must otherwise run until its LONGEST member finishes while
finished slots sit idle. This engine schedules at token granularity:

* every engine step runs ONE batched decode over all RUNNING
  sequences; a sequence that finishes frees its KV pages and its batch
  slot **that step**, and a WAITING sequence takes the slot on the
  next step — no flush windows, no drain-the-batch stalls;
* admission is **prefill/decode cost-aware**: per step at most
  ``max_prefill_tokens`` of prompt work is attached to the decode
  batch (one over-budget prompt is admitted alone), so a long prefill
  can never starve the in-flight decode batch, and a sequence is only
  admitted when the paged KV cache can hold its prompt PLUS its full
  generation budget (no mid-decode OOM, ``kv_cache.py``);
* ``policy="static"`` keeps the same code path but only admits when
  the running set is empty — the flush-by-window baseline the
  ``_BENCH_LLM`` gate compares against.

Two fleet-efficiency features compose as engine flags
(docs/LLM_SERVING.md):

* ``enable_prefix_cache`` — admission looks the prompt up in a radix
  tree over KV pages (``prefix_cache.py``); cached prefix tokens are
  mapped read-only into the block table and skipped at prefill, with
  copy-on-extend when the suffix starts mid-page.  Cache-hit tokens
  flow into the ledger, metrics, and the autoscaler signal.
* ``spec_k`` — speculative decoding (``spec_decode.py``): a draft
  proposes up to k greedy tokens, the target verifies them in ONE
  batched ``decode_window`` step, greedy accept/reject keeps the
  output token-identical to sequential greedy decode.

Prefill/decode disaggregation (``disagg.py``): a *prefill* replica runs
a prompt and exactly one token (``prefill_export``) and snapshots the
prompt's KV pages as the sequence retires (``take_export``); a *decode*
replica rebinds them into its own pages and enters the decode batch
mid-flight (``adopt_request``), so a long prompt never stalls its
in-flight decode streams.

Tracing: each sequence carries the trace ctx of its ``__llm_open__``
call; on finish the engine records ``llm.queue`` / ``llm.kv_alloc`` /
``llm.prefix_lookup`` / ``llm.prefill`` / ``llm.decode`` /
``llm.kv_ship`` / ``llm.draft`` / ``llm.verify`` phase spans, so a
trace's critical path attributes time-to-first-token vs inter-token
latency per request.

Tokens stream out through per-sequence cursors (``poll``), which the
replica exposes as ``__llm_next__`` and the router/proxy turn into
handle iterators and SSE (docs/LLM_SERVING.md).

Drain (``prepare_drain``): stop admitting NEW sequences — shed them
retriably so the router places them on a serving replica — but finish
every in-flight decode; the replica reports running+waiting sequences
in its load so the controller's drain poll waits for zero before the
kill (KV-aware graceful drain).
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.exceptions import ReplicaOverloadedError
from ray_tpu_torch.serve.llm.kv_cache import OutOfKVBlocksError, PagedKVCache

# sequence states
WAITING, RUNNING, FINISHED, FAILED = ("waiting", "running", "finished",
                                      "failed")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls (greedy by default — deterministic,
    the property the continuous-vs-static equivalence gate relies on).
    ``seed`` keys a per-request RNG so temperature sampling replays."""
    max_new_tokens: int = 32
    temperature: float = 0.0
    seed: int = 0
    stop_token: Optional[int] = None

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "SamplingParams":
        return cls(
            max_new_tokens=max(1, int(payload.get("max_new_tokens", 32))),
            temperature=max(0.0, float(payload.get("temperature", 0.0))),
            seed=int(payload.get("seed", 0)),
            stop_token=payload.get("stop_token"))

    def to_payload(self) -> Dict[str, Any]:
        return {"max_new_tokens": self.max_new_tokens,
                "temperature": self.temperature,
                "seed": self.seed,
                "stop_token": self.stop_token}


@dataclass
class EngineConfig:
    max_running: int = 16          # decode batch slots
    max_waiting: int = 64          # admission queue bound (shed past it)
    max_prefill_tokens: int = 512  # prompt tokens attachable per step
    max_seq_len: int = 2048        # prompt + generation hard cap
    num_blocks: int = 512          # KV pool pages (+1 reserved null)
    block_size: int = 16           # tokens per page
    policy: str = "continuous"     # continuous | static
    enable_prefix_cache: bool = False   # radix prefix KV sharing
    spec_k: int = 0                # speculative draft tokens per step
    draft_model: Optional[str] = None        # toy | gpt2 | llama
    draft_model_config: Optional[Dict[str, Any]] = None


@dataclass
class Sequence:
    seq_id: str
    request_id: Optional[str]
    prompt: List[int]
    sampling: SamplingParams
    trace_ctx: Optional[Dict[str, str]] = None
    status: str = WAITING
    tokens: List[int] = field(default_factory=list)   # generated
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    # fleet features
    cached_tokens: int = 0          # prompt tokens skipped at prefill
    export_kv: bool = False         # prefill-role: snapshot KV on finish
    adopted: bool = False           # decode-role: arrived via handoff
    import_lane: Optional[str] = None
    draft_proposed: int = 0
    draft_accepted: int = 0
    draft_s: float = 0.0
    verify_s: float = 0.0
    # phase timestamps for spans + TTFT/ITL telemetry
    t_arrival: float = field(default_factory=time.time)
    t_alloc: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_prefill_end: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    t_import_start: Optional[float] = None
    t_import_end: Optional[float] = None
    rng: Optional[random.Random] = None

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.tokens)

    def budget_tokens(self) -> int:
        return len(self.prompt) + self.sampling.max_new_tokens


class LLMEngine:
    """Continuous-batching scheduler + paged KV cache + streaming
    cursors around one model adapter (``model_runner.py``)."""

    def __init__(self, adapter, config: Optional[EngineConfig] = None):
        self.adapter = adapter
        self.config = config or EngineConfig()
        self.cache = PagedKVCache(self.config.num_blocks,
                                  self.config.block_size)
        adapter.bind_cache(self.cache)
        self.prefix_cache = None
        if self.config.enable_prefix_cache:
            from ray_tpu_torch.serve.llm.prefix_cache import RadixPrefixCache
            self.prefix_cache = RadixPrefixCache(self.cache)
        self._draft = None
        if self.config.spec_k > 0:
            from ray_tpu_torch.serve.llm.spec_decode import make_draft
            self._draft = make_draft(
                self.config.draft_model or "toy",
                self.config.draft_model_config)
        self._seqs: Dict[str, Sequence] = {}
        self._waiting: deque = deque()          # seq ids, FIFO
        self._running: List[str] = []           # decode batch membership
        self._draining = False
        self._stopped = False
        self._seq_counter = 0
        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)   # engine wakeup
        self._out_cv = threading.Condition(self._lock)    # pollers wakeup
        # telemetry: bounded reservoirs + a (ts, n) token-rate window
        self._ttft = deque(maxlen=512)
        self._itl = deque(maxlen=2048)
        self._rate_win: deque = deque()          # (ts, tokens committed)
        self._hit_win: deque = deque()           # (ts, cache-hit tokens)
        self._total_generated = 0
        self._total_prompt = 0
        self._total_requests = 0
        self._total_finished = 0
        self._total_shed = 0
        self._total_failed = 0
        self._total_cache_hit = 0       # finalized (ledger-consistent)
        self._total_draft = 0
        self._total_accepted = 0
        # prefill-role KV snapshots awaiting pickup (__llm_prefill__)
        self._exports: Dict[str, Dict[str, Any]] = {}
        # per-request token ledger:
        # (rid, n_tokens, finish_reason, n_prompt, n_cached) — the
        # server half of the game-day per-token reconciliation
        self._token_ledger = deque(maxlen=65536)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-llm-engine")
        self._thread.start()

    # ------------------------------------------------------------ intake

    def add_request(self, prompt_tokens: List[int],
                    sampling: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    trace_ctx: Optional[Dict[str, str]] = None,
                    _export_kv: bool = False) -> str:
        """Enqueue a sequence; returns its stream id. Sheds retriably
        (``ReplicaOverloadedError``) when draining, when the waiting
        queue is full, or when the request can never fit the pool —
        the router re-places shed sequences on another replica."""
        sampling = sampling or SamplingParams()
        n_prompt = len(prompt_tokens)
        if n_prompt == 0:
            raise ValueError("empty prompt")
        if n_prompt + sampling.max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({n_prompt}) + max_new_tokens "
                f"({sampling.max_new_tokens}) exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        total = n_prompt + sampling.max_new_tokens
        if self.cache.blocks_for(total) > self.cache.num_blocks - 1:
            raise ValueError(
                f"request needs {self.cache.blocks_for(total)} KV blocks"
                f" but the pool only has {self.cache.num_blocks - 1}")
        with self._lock:
            if self._draining or self._stopped:
                self._total_shed += 1
                raise ReplicaOverloadedError(
                    "llm-engine(draining)", len(self._waiting),
                    self.config.max_waiting)
            if len(self._waiting) >= self.config.max_waiting:
                self._total_shed += 1
                raise ReplicaOverloadedError(
                    "llm-engine", len(self._waiting),
                    self.config.max_waiting)
            self._seq_counter += 1
            seq_id = f"seq-{self._seq_counter}"
            seq = Sequence(seq_id, request_id, list(prompt_tokens),
                           sampling, trace_ctx=trace_ctx)
            seq.export_kv = _export_kv
            if sampling.temperature > 0:
                seq.rng = random.Random(
                    (hash(request_id or seq_id) & 0xFFFFFFFF)
                    ^ sampling.seed)
            self._seqs[seq_id] = seq
            self._waiting.append(seq_id)
            self._total_requests += 1
            self._total_prompt += n_prompt
            self._work_cv.notify_all()
            return seq_id

    # ---- prefill/decode disaggregation (disagg.py) --

    def prefill_export(self, prompt_tokens: List[int],
                       sampling: Optional[SamplingParams] = None,
                       request_id: Optional[str] = None,
                       trace_ctx: Optional[Dict[str, str]] = None) -> str:
        """Prefill-role entry: run the prompt and exactly ONE decode
        step, snapshotting the prompt's KV pages on finish for
        shipment to a decode replica (``take_export``)."""
        sampling = sampling or SamplingParams()
        one = dataclasses.replace(sampling, max_new_tokens=1)
        return self.add_request(prompt_tokens, one, request_id,
                                trace_ctx, _export_kv=True)

    def take_export(self, seq_id: str,
                    max_wait_s: float = 5.0) -> Optional[Dict[str, Any]]:
        """The snapshot of a finished ``prefill_export`` sequence
        (``{"prompt", "first_token", "kv", "finish_reason",
        "cached_tokens"}``), or None after ``max_wait_s``."""
        # the poller can observe ``done`` a beat before _retire stages
        # the snapshot — wait it out (bounded)
        deadline = time.time() + max(0.0, max_wait_s)
        with self._lock:
            while seq_id not in self._exports:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._out_cv.wait(timeout=min(remaining, 0.25))
            return self._exports.pop(seq_id, None)

    def adopt_request(self, prompt_tokens: List[int], first_token: int,
                      kv_blob: Optional[Dict[str, Any]],
                      sampling: Optional[SamplingParams] = None,
                      request_id: Optional[str] = None,
                      trace_ctx: Optional[Dict[str, str]] = None,
                      lane: str = "inline",
                      t_ship_start: Optional[float] = None) -> str:
        """Decode-role entry: rebind a shipped prompt KV snapshot into
        freshly allocated pages and enter the decode batch mid-flight —
        the first token is pollable immediately (disagg's TTFT win).

        Raises ``ReplicaOverloadedError`` (retriable) when the pool or
        batch is full, and whatever ``import_kv`` raises on a blob
        mismatch — the deployment falls back to plain ``add_request``
        (re-prefill) in both cases."""
        sampling = sampling or SamplingParams()
        n_prompt = len(prompt_tokens)
        if n_prompt == 0:
            raise ValueError("empty prompt")
        stop = sampling.stop_token
        terminal = None
        if stop is not None and int(first_token) == stop:
            terminal = "stop"
        elif sampling.max_new_tokens <= 1:
            terminal = "length"
        with self._lock:
            if self._draining or self._stopped:
                self._total_shed += 1
                raise ReplicaOverloadedError(
                    "llm-engine(draining)", len(self._waiting),
                    self.config.max_waiting)
            self._seq_counter += 1
            seq_id = f"seq-{self._seq_counter}"
            seq = Sequence(seq_id, request_id, list(prompt_tokens),
                           sampling, trace_ctx=trace_ctx)
            seq.adopted = True
            seq.cached_tokens = n_prompt    # zero prefill work here
            seq.import_lane = lane
            if sampling.temperature > 0:
                seq.rng = random.Random(
                    (hash(request_id or seq_id) & 0xFFFFFFFF)
                    ^ sampling.seed)
            self._seqs[seq_id] = seq
            self._total_requests += 1
            self._total_prompt += n_prompt
        if terminal is not None:
            # the prefill replica's single token already ended the
            # stream — no pages, no import, just a finished cursor
            with self._lock:
                now = time.time()
                seq.tokens = [int(first_token)]
                seq.t_first_token = now
                seq.t_finish = now
                seq.status = FINISHED
                seq.finish_reason = terminal
                self._total_generated += 1
                self._out_cv.notify_all()
            self._finalize(seq)
            return seq_id
        if kv_blob is None:
            raise ValueError("adopt_request needs a KV blob")
        budget = seq.budget_tokens()
        if n_prompt + sampling.max_new_tokens > self.config.max_seq_len:
            with self._lock:
                self._seqs.pop(seq_id, None)
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        try:
            try:
                self.cache.allocate(seq_id, budget)
            except OutOfKVBlocksError:
                if self.prefix_cache is None:
                    raise
                self.prefix_cache.evict(self.cache.blocks_for(budget))
                self.cache.allocate(seq_id, budget)
        except OutOfKVBlocksError as e:
            with self._lock:
                self._seqs.pop(seq_id, None)
                self._total_shed += 1
            raise ReplicaOverloadedError(
                "llm-engine(kv)", len(self._running),
                self.config.max_running) from e
        t_imp0 = time.time()
        try:
            self.adapter.import_kv(seq_id, n_prompt, kv_blob)
        except Exception:
            self.cache.free(seq_id)
            with self._lock:
                self._seqs.pop(seq_id, None)
            raise
        with self._lock:
            now = time.time()
            seq.t_alloc = t_imp0
            seq.t_import_start = t_ship_start or t_imp0
            seq.t_import_end = now
            seq.tokens = [int(first_token)]
            seq.t_first_token = now
            self._ttft.append(now - seq.t_arrival)
            self._total_generated += 1
            self._rate_win.append((now, 1))
            self._hit_win.append((now, n_prompt))
            seq.status = RUNNING
            self._running.append(seq_id)
            self._work_cv.notify_all()
            self._out_cv.notify_all()
        return seq_id

    def poll(self, seq_id: str, cursor: int = 0,
             max_wait_s: float = 10.0) -> Dict[str, Any]:
        """Streaming cursor read: block (bounded) until tokens past
        ``cursor`` exist or the sequence finished; returns the delta."""
        deadline = time.time() + max(0.0, max_wait_s)
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                raise KeyError(f"unknown stream {seq_id!r}")
            while (len(seq.tokens) <= cursor
                   and seq.status not in (FINISHED, FAILED)):
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._out_cv.wait(timeout=min(remaining, 1.0))
            done = seq.status in (FINISHED, FAILED)
            out = {
                "tokens": list(seq.tokens[cursor:]),
                "cursor": len(seq.tokens),
                "done": done,
                "n_tokens": len(seq.tokens),
            }
            if done:
                out["finish_reason"] = seq.finish_reason
                if seq.error:
                    out["error"] = seq.error
                if seq.t_first_token is not None:
                    out["ttft_s"] = round(
                        seq.t_first_token - seq.t_arrival, 6)
                # a finished, fully-read stream is garbage-collectable
                if cursor + len(out["tokens"]) >= len(seq.tokens):
                    self._seqs.pop(seq_id, None)
            return out

    def cancel(self, seq_id: str) -> bool:
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                return False
            if seq.status in (FINISHED, FAILED):
                self._seqs.pop(seq_id, None)
                return True
            if seq.status == WAITING:
                try:
                    self._waiting.remove(seq_id)
                except ValueError:
                    pass
            else:
                try:
                    self._running.remove(seq_id)
                except ValueError:
                    pass
                self.adapter.release(seq_id)
                self.cache.free(seq_id)
            seq.status = FAILED
            seq.finish_reason = "cancelled"
            seq.t_finish = time.time()
            self._seqs.pop(seq_id, None)
            self._out_cv.notify_all()
            return True

    # ------------------------------------------------------------ control

    def prepare_drain(self):
        """KV-aware drain step: no new sequences, in-flight ones run
        to completion (the controller kills the replica only once the
        reported queue — which includes these — hits zero)."""
        with self._lock:
            self._draining = True
            self._work_cv.notify_all()

    def stop(self):
        with self._lock:
            self._stopped = True
            self._work_cv.notify_all()
            self._out_cv.notify_all()
        self._thread.join(timeout=5.0)

    def in_flight(self) -> int:
        with self._lock:
            return len(self._running) + len(self._waiting)

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            now = time.time()
            while self._rate_win and now - self._rate_win[0][0] > 5.0:
                self._rate_win.popleft()
            while self._hit_win and now - self._hit_win[0][0] > 5.0:
                self._hit_win.popleft()
            window_tokens = sum(n for _, n in self._rate_win)
            window_s = (now - self._rate_win[0][0]
                        if len(self._rate_win) > 1 else 0.0)
            hit_tokens = sum(n for _, n in self._hit_win)
            ttft = sorted(self._ttft)
            itl = sorted(self._itl)

            def q(vals, frac):
                if not vals:
                    return 0.0
                return vals[min(len(vals) - 1, int(frac * len(vals)))]

            out = {
                "running": len(self._running),
                "waiting": len(self._waiting),
                "draining": self._draining,
                "tokens_per_s": round(
                    window_tokens / window_s, 3) if window_s > 0 else 0.0,
                "generated_tokens_total": self._total_generated,
                "prompt_tokens_total": self._total_prompt,
                "requests_total": self._total_requests,
                "finished_total": self._total_finished,
                "shed_total": self._total_shed,
                "failed_total": self._total_failed,
                "cache_hit_tokens_total": self._total_cache_hit,
                "cache_hit_tokens_per_s": round(
                    hit_tokens / window_s, 3) if window_s > 0 else 0.0,
                "spec_draft_tokens_total": self._total_draft,
                "spec_accepted_tokens_total": self._total_accepted,
                "ttft_p50_s": round(q(ttft, 0.50), 6),
                "ttft_p99_s": round(q(ttft, 0.99), 6),
                "itl_p50_s": round(q(itl, 0.50), 6),
                "itl_p99_s": round(q(itl, 0.99), 6),
            }
        out.update(self.cache.stats())
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        return out

    def token_ledger(self) -> List[Any]:
        """(request_id, n_tokens, finish_reason, n_prompt, n_cached)
        per finished sequence — joined against client-side token
        counts and prompt lengths by the game-day reconciler."""
        with self._lock:
            return [list(r) for r in self._token_ledger]

    # ------------------------------------------------------------ engine

    def _loop(self):
        while True:
            with self._lock:
                if self._stopped:
                    return
                if not self._running and not self._waiting:
                    self._work_cv.wait(timeout=0.5)
                    continue
            try:
                self._step()
            except Exception as e:  # noqa: BLE001 — fail sequences, not
                self._fail_all(e)   # the engine thread

    def _admit_locked(self) -> List[Sequence]:
        """Cost-aware admission (caller holds the lock): fill free
        batch slots from the FIFO while this step's prefill budget and
        the KV pool allow.  With the prefix cache on, the prompt is
        first matched against the radix tree: matched pages map in
        read-only (refcounted) and their tokens don't count against
        the prefill budget.  Static policy only admits into an empty
        batch (the flush-by-window baseline)."""
        if self.config.policy == "static" and self._running:
            return []
        admitted: List[Sequence] = []
        budget = self.config.max_prefill_tokens
        bs = self.cache.block_size
        while (self._waiting
               and len(self._running) + len(admitted)
               < self.config.max_running):
            seq = self._seqs[self._waiting[0]]
            n_prompt = len(seq.prompt)
            t0 = time.time()
            shared_pages: List[int] = []
            cached = 0
            if self.prefix_cache is not None:
                m, pages = self.prefix_cache.lookup(seq.prompt)
                # always recompute >= 1 prompt token so prefill has
                # logits to sample the first generated token from
                m = min(m, n_prompt - 1)
                if m > 0:
                    shared_pages = pages[:-(-m // bs)]
                    cached = m
            cost = n_prompt - cached
            if admitted and cost > budget:
                break  # next step; an over-budget prompt goes alone
            need_total = self.cache.blocks_for(seq.budget_tokens())
            try:
                try:
                    if shared_pages:
                        self.cache.allocate_with_prefix(
                            seq.seq_id, seq.budget_tokens(), shared_pages)
                    else:
                        self.cache.allocate(seq.seq_id,
                                            seq.budget_tokens())
                except OutOfKVBlocksError:
                    if self.prefix_cache is None:
                        raise
                    # recycle cold cached branches before giving up —
                    # never the prefix we just matched
                    freed = self.prefix_cache.evict(
                        need_total - len(shared_pages),
                        pinned=set(shared_pages))
                    if not freed:
                        raise
                    if shared_pages:
                        self.cache.allocate_with_prefix(
                            seq.seq_id, seq.budget_tokens(), shared_pages)
                    else:
                        self.cache.allocate(seq.seq_id,
                                            seq.budget_tokens())
                seq.t_alloc = time.time()
                seq._t_alloc_start = t0  # type: ignore[attr-defined]
            except OutOfKVBlocksError:
                break  # pages free up as running sequences finish
            seq.cached_tokens = cached
            if cached:
                self._hit_win.append((seq.t_alloc, cached))
            self._waiting.popleft()
            admitted.append(seq)
            budget -= cost
            if cost >= self.config.max_prefill_tokens:
                break  # the lone long prefill consumed the step
        return admitted

    def _step(self):
        """One engine step: decode every RUNNING sequence, then prefill
        this step's admissions (decode first — admission cost must
        never delay in-flight tokens)."""
        with self._lock:
            decode_seqs = [self._seqs[sid] for sid in self._running
                           if sid in self._seqs]
        if decode_seqs:
            if self._draft is not None:
                self._decode_spec(decode_seqs)
            else:
                self._decode(decode_seqs)
        with self._lock:
            admitted = self._admit_locked()
        if admitted:
            self._prefill(admitted)

    def _decode(self, seqs: List[Sequence]):
        t0 = time.time()
        logits = self.adapter.decode(seqs)      # [B, V] np.ndarray
        self._commit(seqs, logits, step_t0=t0)

    def _decode_spec(self, seqs: List[Sequence]):
        """Speculative step: draft proposes per greedy sequence, the
        target verifies every window in ONE batched decode_window
        call, accepted tokens commit together.  Non-greedy sequences
        ride the same step with single-token windows — composable with
        everything else."""
        t0 = time.time()
        k = self.config.spec_k
        vocab = getattr(self.adapter, "vocab_size", None)
        windows: List[List[int]] = []
        for s in seqs:
            remaining = s.sampling.max_new_tokens - len(s.tokens)
            if (s.sampling.temperature > 0 or remaining <= 1 or k <= 0):
                windows.append([int(s.tokens[-1])])
                continue
            w = min(k + 1, remaining + 1)
            td = time.time()
            props = self._draft.propose(s.prompt + s.tokens, w - 1)
            s.draft_s += time.time() - td
            win = [int(s.tokens[-1])]
            for p in props:
                p = int(p)
                if vocab is not None and not (0 <= p < vocab):
                    break   # draft vocab overhangs the target's
                win.append(p)
            s.draft_proposed += len(win) - 1
            self._total_draft += len(win) - 1
            windows.append(win)
        tv = time.time()
        rows = self.adapter.decode_window(seqs, windows)
        verify_dt = time.time() - tv
        self._commit_window(seqs, windows, rows, step_t0=t0,
                            verify_dt=verify_dt)

    def _prefill(self, seqs: List[Sequence]):
        t0 = time.time()
        for s in seqs:
            s.t_prefill_start = t0
        logits = self.adapter.prefill(seqs)     # [B, V]
        t1 = time.time()
        if self.prefix_cache is not None:
            # publish the finished prompts' full pages to the radix
            # tree (before _commit can free a finished seq's pages)
            for s in seqs:
                table = self.cache.block_table(s.seq_id)
                if table:
                    self.prefix_cache.insert(s.prompt, table)
        with self._lock:
            for s in seqs:
                s.t_prefill_end = t1
                s.status = RUNNING
                self._running.append(s.seq_id)
        self._commit(seqs, logits, step_t0=t0)

    def _sample(self, seq: Sequence, row) -> int:
        if seq.sampling.temperature <= 0 or seq.rng is None:
            return int(row.argmax())
        x = [v / seq.sampling.temperature for v in row.tolist()]
        m = max(x)
        exps = [math.exp(v - m) for v in x]
        total = sum(exps)
        r = seq.rng.random() * total
        acc = 0.0
        for i, e in enumerate(exps):
            acc += e
            if acc >= r:
                return i
        return len(exps) - 1

    def _finish_checks_locked(self, seq: Sequence, tok: int) -> bool:
        stop = seq.sampling.stop_token
        if stop is not None and tok == stop:
            seq.finish_reason = "stop"
        elif len(seq.tokens) >= seq.sampling.max_new_tokens:
            seq.finish_reason = "length"
        return seq.finish_reason is not None

    def _commit(self, seqs: List[Sequence], logits, *, step_t0: float):
        """Sample one token per sequence and publish: streaming
        cursors advance, finished sequences free their pages and their
        batch slot immediately (the admission the NEXT step sees)."""
        now = time.time()
        finished: List[Sequence] = []
        with self._lock:
            for i, seq in enumerate(seqs):
                sid = seq.seq_id
                if sid not in self._seqs or seq.status not in (RUNNING,
                                                               WAITING):
                    continue
                tok = self._sample(seq, logits[i])
                if seq.t_first_token is None:
                    seq.t_first_token = now
                    self._ttft.append(now - seq.t_arrival)
                else:
                    self._itl.append(now - step_t0)
                seq.tokens.append(tok)
                self._total_generated += 1
                if self._finish_checks_locked(seq, tok):
                    seq.status = FINISHED
                    seq.t_finish = now
                    try:
                        self._running.remove(sid)
                    except ValueError:
                        pass
                    finished.append(seq)
            self._rate_win.append((now, len(seqs)))
            self._out_cv.notify_all()
        self._retire(finished)

    def _commit_window(self, seqs: List[Sequence],
                       windows: List[List[int]], rows,
                       *, step_t0: float, verify_dt: float):
        """Speculative publish: per sequence, accept the drafted
        prefix the target agrees with (greedy_verify), commit the
        correction/bonus, and roll the KV cache back over rejected
        window positions."""
        from ray_tpu_torch.serve.llm.spec_decode import greedy_verify
        now = time.time()
        finished: List[Sequence] = []
        rollbacks: List[tuple] = []
        total_committed = 0
        with self._lock:
            for seq, win, row in zip(seqs, windows, rows):
                sid = seq.seq_id
                if sid not in self._seqs or seq.status != RUNNING:
                    # cancelled mid-step: its state is already released
                    continue
                if len(win) == 1:
                    committed = [self._sample(seq, row[0])]
                else:
                    seq.verify_s += verify_dt / max(1, len(seqs))
                    argmaxes = [int(r.argmax()) for r in row]
                    committed = greedy_verify(win, argmaxes)
                    acc = max(0, len(committed) - 1)
                    seq.draft_accepted += acc
                    self._total_accepted += acc
                applied = 0
                dt_tok = (now - step_t0) / max(1, len(committed))
                for tok in committed:
                    if seq.t_first_token is None:
                        seq.t_first_token = now
                        self._ttft.append(now - seq.t_arrival)
                    else:
                        self._itl.append(dt_tok)
                    seq.tokens.append(int(tok))
                    applied += 1
                    self._total_generated += 1
                    if self._finish_checks_locked(seq, int(tok)):
                        break
                total_committed += applied
                # cache holds len(win) new positions; keep exactly the
                # ones a sequential decode would have written
                if applied < len(win):
                    rollbacks.append((sid, len(win) - applied))
                if seq.finish_reason:
                    seq.status = FINISHED
                    seq.t_finish = now
                    try:
                        self._running.remove(sid)
                    except ValueError:
                        pass
                    finished.append(seq)
            self._rate_win.append((now, total_committed))
            self._out_cv.notify_all()
        for sid, n in rollbacks:
            self.adapter.rollback(sid, n)
        self._retire(finished)

    def _retire(self, finished: List[Sequence]):
        for seq in finished:
            if seq.export_kv:
                self._maybe_export(seq)
            self.adapter.release(seq.seq_id)
            self.cache.free(seq.seq_id)
            self._finalize(seq)

    def _maybe_export(self, seq: Sequence):
        """Prefill-role finish: snapshot the prompt's KV pages BEFORE
        release/free recycles them; ``__llm_prefill__`` picks the
        snapshot up via ``take_export``."""
        try:
            blob = self.adapter.export_kv(seq.seq_id, len(seq.prompt))
        except Exception:
            blob = None
        with self._lock:
            self._exports[seq.seq_id] = {
                "prompt": list(seq.prompt),
                "first_token": seq.tokens[0] if seq.tokens else None,
                "kv": blob,
                "finish_reason": seq.finish_reason,
                "cached_tokens": seq.cached_tokens,
            }
            while len(self._exports) > 128:
                self._exports.pop(next(iter(self._exports)))
            self._out_cv.notify_all()

    def _finalize(self, seq: Sequence):
        with self._lock:
            self._total_finished += 1
            self._total_cache_hit += seq.cached_tokens
            reason = seq.finish_reason
            if seq.export_kv and reason == "length":
                reason = "handoff"   # generation continues elsewhere
            self._token_ledger.append(
                (seq.request_id, len(seq.tokens), reason,
                 len(seq.prompt), seq.cached_tokens))
        self._record_spans(seq)

    def _fail_all(self, err: Exception):
        """A model-step failure fails the sequences it was computing —
        pollers see an explicit error, never a silent truncation."""
        with self._lock:
            ids = list(self._running) + list(self._waiting)
            self._running.clear()
            self._waiting.clear()
            for sid in ids:
                seq = self._seqs.get(sid)
                if seq is None:
                    continue
                seq.status = FAILED
                seq.error = f"{type(err).__name__}: {err}"
                seq.finish_reason = "error"
                seq.t_finish = time.time()
                self._total_failed += 1
                self.adapter.release(sid)
                self.cache.free(sid)
            self._out_cv.notify_all()

    # ------------------------------------------------------------ tracing

    def _record_spans(self, seq: Sequence):
        """Phase spans for the PR 9 trace plane: queue / kv-alloc /
        prefix-lookup / prefill / decode (+ kv_ship for adopted
        sequences, draft/verify aggregates for speculative ones),
        parented under the ``__llm_open__`` call's replica execute
        span — TTFT = queue + kv_alloc + prefill, inter-token latency
        = decode / n_tokens."""
        ctx = seq.trace_ctx
        if not ctx or not ctx.get("trace_id"):
            return
        from ray_tpu_torch._private import tracing
        tid, parent = ctx["trace_id"], ctx.get("span_id")

        def span(name, phase, t0, t1, attrs=None, min_width=None):
            if t0 is None or t1 is None:
                return
            if min_width is not None:
                t1 = max(t1, t0 + min_width)
            elif t1 - t0 <= 1e-5:
                return
            tracing.record_span(
                tid, tracing.new_span_id(), name,
                parent_span_id=parent, kind="serve.llm", phase=phase,
                start_ts=t0, end_ts=t1, attrs=attrs)

        alloc_start = getattr(seq, "_t_alloc_start", None)
        span("llm.queue", "queue", seq.t_arrival,
             alloc_start or seq.t_prefill_start)
        span("llm.kv_alloc", "schedule", alloc_start, seq.t_alloc)
        if seq.cached_tokens and not seq.adopted:
            # sub-µs radix walk: clamp so the span survives recording
            span("llm.prefix_lookup", "schedule", alloc_start,
                 seq.t_alloc, attrs={"cached_tokens": seq.cached_tokens},
                 min_width=2e-5)
        span("llm.prefill", "execute", seq.t_prefill_start,
             seq.t_prefill_end,
             attrs={"prompt_tokens": len(seq.prompt),
                    "cached_tokens": seq.cached_tokens})
        if seq.adopted:
            span("llm.kv_ship", "transfer", seq.t_import_start,
                 seq.t_import_end,
                 attrs={"prompt_tokens": len(seq.prompt),
                        "lane": seq.import_lane or "inline"},
                 min_width=2e-5)
        span("llm.decode", "execute", seq.t_first_token, seq.t_finish,
             attrs={"tokens": len(seq.tokens),
                    "finish_reason": seq.finish_reason})
        if seq.draft_proposed and seq.t_first_token is not None:
            span("llm.draft", "execute", seq.t_first_token,
                 seq.t_first_token + seq.draft_s,
                 attrs={"proposed": seq.draft_proposed,
                        "accepted": seq.draft_accepted},
                 min_width=2e-5)
            span("llm.verify", "execute", seq.t_first_token,
                 seq.t_first_token + seq.verify_s,
                 attrs={"proposed": seq.draft_proposed,
                        "accepted": seq.draft_accepted},
                 min_width=2e-5)
