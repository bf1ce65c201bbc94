"""LLMServer — the serve deployment callable hosting one engine.

Copy of ``ray_tpu/serve/llm/deployment.py`` over the port's adapters.
A replica holds an ``LLMEngine`` (continuous batching + paged KV cache)
and exposes it through the standard replica request path
(``serve/_private/replica.py``), so routing, backpressure, shedding,
ledgers, tracing, HA and drain all apply unchanged:

  ``__call__(payload)``            unary generate (proxy POST without
                                   ``stream``, ``handle.remote``)
  ``__llm_open__(payload)``        start a stream -> {"stream_id"}
  ``__llm_next__(sid, cursor, w)`` cursor poll -> token delta
  ``__llm_cancel__(sid)``          abandon a stream
  ``__llm_metrics__()``            engine metrics + token ledger
  ``__llm_prefill__(payload)``     disagg hop 1: prompt + first token,
                                   returns a KV handoff descriptor
  ``__llm_adopt__(handoff)``       disagg hop 2: rebind the shipped KV
                                   (or re-prefill on a torn frame) ->
                                   {"stream_id", "adopted"}

Serve integration hooks (consumed by ``serve/_private/replica.py``):

  ``__serve_load__``         merged into ``get_load`` — in-flight
                             sequences count as queue depth (the
                             controller's drain poll waits for them:
                             KV-aware graceful drain) and the ``llm``
                             metrics ride the controller's telemetry
                             into the autoscaler
  ``__serve_prepare_drain__`` engine stops admitting, finishes decodes
  ``__serve_drain_exempt__``  stream polls stay answerable while
                             draining
  ``__serve_prepare_shutdown__`` flush the per-request token ledger to
                             the GCS KV (``gameday/store.py``) so a
                             replica retired by a rolling update keeps
                             its half of the per-token reconciliation

A replica takes a role by the hop it is sent: the controller assigns
roles over a deployment's replicas (``llm_roles``), and the router's
``open_stream`` sends ``__llm_prefill__`` to a prefill replica and
``__llm_adopt__`` with the descriptor it returned to a decode replica.
Outside the runtime a caller drives both hops::

    handoff = prefill_server.__llm_prefill__({"tokens": p,
                                              "max_new_tokens": 64})
    sid = decode_server.__llm_adopt__(handoff)["stream_id"]

On ``cuda`` (the default device of ``gpt2`` and ``llama``) a replica
needs its GPU by grant: ``ray_actor_options={"num_gpus": 1}``. A
replica the runtime granted no GPU sees ``CUDA_VISIBLE_DEVICES=""``,
and the server raises at construction, naming the grant.

Payload schema (dict): ``prompt`` (str, byte-tokenized) or ``tokens``
(list[int]); optional ``max_new_tokens``, ``temperature``, ``seed``,
``stop_token``, ``stream`` (proxy SSE opt-in).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch.serve.llm.disagg import KVShipError, KVShipper
from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                            SamplingParams)
from ray_tpu_torch.serve.llm.model_runner import make_adapter


logger = logging.getLogger(__name__)


class ByteTokenizer:
    """Dependency-free fallback: UTF-8 bytes, mod vocab. Real models
    bring their own tokenizer; the toy/test path just needs a stable
    string <-> tokens round trip."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b % self.vocab_size for b in text.encode("utf-8")]

    def decode(self, tokens: List[int]) -> str:
        return bytes(t % 256 for t in tokens).decode("utf-8", "replace")


class LLMServer:
    """Deployment callable: one engine per replica. ``model`` is
    ``toy``, ``gpt2`` or ``llama``; ``model_config`` goes to the adapter
    (for ``gpt2`` and ``llama``: ``config``, ``params``, ``seed``,
    ``device``, which defaults to ``cuda``). ``max_seq_len`` is capped
    at the model's position count (Llama-2's 2048)."""

    # replica keeps answering these while draining — in-flight streams
    # must drain their remaining tokens before the controller's kill
    __serve_drain_exempt__ = ("__llm_next__", "__llm_cancel__",
                              "__llm_metrics__")
    # the replica normally strips the reserved request-id kwarg; the
    # engine needs it for the per-request token ledger + trace spans
    __serve_wants_request_id__ = True

    def __init__(self, model: str = "toy",
                 model_config: Optional[Dict[str, Any]] = None,
                 engine_config: Optional[Dict[str, Any]] = None):
        _require_gpu_grant(model, model_config)
        self.adapter = make_adapter(model, model_config)
        cfg = EngineConfig(**(engine_config or {}))
        limit = getattr(self.adapter, "max_seq_len", None)
        if limit is not None and cfg.max_seq_len > limit:
            cfg = dataclasses.replace(cfg, max_seq_len=limit)
        self.engine = LLMEngine(self.adapter, cfg)
        self.tokenizer = ByteTokenizer(self.adapter.vocab_size)
        self.model = model
        self._shipper: Optional[KVShipper] = None

    def _get_shipper(self) -> KVShipper:
        if self._shipper is None:
            self._shipper = KVShipper(f"{os.getpid()}-{id(self)}")
        return self._shipper

    @staticmethod
    def _trace_ctx() -> Optional[Dict[str, str]]:
        # parent the engine's phase spans under THIS request's replica
        # execute span (installed by replica._execute for sampled
        # requests) so TTFT decomposes on the trace waterfall
        try:
            from ray_tpu_torch._private import worker as worker_mod
            w = worker_mod._global_worker
            if w is not None:
                ctx = getattr(w.task_context, "trace", None)
                return dict(ctx) if ctx else None
        except Exception:
            pass
        return None

    # ------------------------------------------------------------ intake

    def _tokens_of(self, payload: Union[Dict[str, Any], str, list]
                   ) -> List[int]:
        if isinstance(payload, str):
            return self.tokenizer.encode(payload)
        raw = None
        if isinstance(payload, list):
            raw = payload
        elif isinstance(payload, dict):
            if payload.get("tokens") is not None:
                raw = payload["tokens"]
            elif payload.get("prompt") is not None:
                return self.tokenizer.encode(str(payload["prompt"]))
        if raw is None:
            raise ValueError(
                "LLM payload needs 'prompt' (str) or 'tokens' (list[int])")
        tokens = [int(t) for t in raw]
        vocab = self.adapter.vocab_size
        # an id past the embedding table would be a device-side fault
        if any(not 0 <= t < vocab for t in tokens):
            raise ValueError(f"token ids must lie in [0, {vocab})")
        return tokens

    def _open(self, payload, request_id: Optional[str]) -> str:
        sampling = (SamplingParams.from_payload(payload)
                    if isinstance(payload, dict) else SamplingParams())
        return self.engine.add_request(
            self._tokens_of(payload), sampling, request_id=request_id,
            trace_ctx=self._trace_ctx())

    # --------------------------------------------------------- serve API

    def __call__(self, payload=None, __rtpu_request_id__=None):
        """Unary generation (proxy POST without ``stream``, plain
        ``handle.remote``)."""
        sid = self._open(payload or {}, __rtpu_request_id__)
        cursor = 0
        tokens: List[int] = []
        ttft = None
        while True:
            chunk = self.engine.poll(sid, cursor, max_wait_s=30.0)
            tokens.extend(chunk["tokens"])
            cursor = chunk["cursor"]
            if chunk.get("ttft_s") is not None:
                ttft = chunk["ttft_s"]
            if chunk["done"]:
                if chunk.get("error"):
                    raise RuntimeError(
                        f"generation failed: {chunk['error']}")
                out = {"tokens": tokens, "n_tokens": len(tokens),
                       "finish_reason": chunk.get("finish_reason"),
                       "text": self.tokenizer.decode(tokens)}
                if ttft is not None:
                    out["ttft_s"] = ttft
                return out

    def __llm_open__(self, payload=None, __rtpu_request_id__=None):
        return {"stream_id": self._open(payload or {}, __rtpu_request_id__)}

    def __llm_next__(self, stream_id: str, cursor: int = 0,
                     max_wait_s: float = 10.0):
        chunk = self.engine.poll(stream_id, int(cursor),
                                 max_wait_s=float(max_wait_s))
        if chunk["tokens"]:
            chunk["text"] = self.tokenizer.decode(chunk["tokens"])
        return chunk

    def __llm_cancel__(self, stream_id: str):
        return {"cancelled": self.engine.cancel(stream_id)}

    # -------------------------------------- disaggregation (disagg.py)

    def __llm_prefill__(self, payload=None, __rtpu_request_id__=None):
        """Disagg hop 1 (prefill replica): run prompt + ONE token,
        snapshot the prompt's KV pages, and return a handoff
        descriptor the router carries to a decode replica. The
        descriptor always includes the prompt + sampling so the decode
        side can re-prefill if the KV frame is lost."""
        payload = payload or {}
        sampling = (SamplingParams.from_payload(payload)
                    if isinstance(payload, dict) else SamplingParams())
        tokens = self._tokens_of(payload)
        sid = self.engine.prefill_export(
            tokens, sampling, request_id=__rtpu_request_id__,
            trace_ctx=self._trace_ctx())
        cursor = 0
        while True:
            chunk = self.engine.poll(sid, cursor, max_wait_s=30.0)
            cursor = chunk["cursor"]
            if chunk["done"]:
                break
        if chunk.get("error"):
            raise RuntimeError(f"prefill failed: {chunk['error']}")
        export = self.engine.take_export(sid) or {}
        first = export.get("first_token")
        if first is None:
            raise RuntimeError("prefill produced no first token")
        handoff: Dict[str, Any] = {
            "prompt": tokens,
            "first_token": int(first),
            "n_prompt": len(tokens),
            "sampling": sampling.to_payload(),
            "t_ship_start": time.time(),
        }
        terminal = (sampling.max_new_tokens <= 1
                    or (sampling.stop_token is not None
                        and int(first) == sampling.stop_token))
        if not terminal and export.get("kv") is not None:
            handoff["kv"] = self._get_shipper().ship({"kv": export["kv"]})
        return handoff

    def __llm_adopt__(self, handoff=None, __rtpu_request_id__=None):
        """Disagg hop 2 (decode replica): fetch the KV frame, rebind
        its pages into this replica's pool, and continue decoding from
        the prefill replica's first token. Any fault — chaos drop or
        reset, a CRC or length mismatch, a vanished ring slot, a blob
        that does not fit the adapter — falls back to a local re-prefill:
        greedy decode is deterministic, so the stream gives the tokens
        the handoff would have given in the same batch (bf16 rounding
        differs between batchings, and may swap near-tied tokens);
        ``adopted: False`` says which path ran."""
        handoff = handoff or {}
        rid = __rtpu_request_id__
        trace_ctx = self._trace_ctx()
        prompt = [int(t) for t in handoff.get("prompt") or []]
        sampling = SamplingParams.from_payload(
            dict(handoff.get("sampling") or {}))
        first = handoff.get("first_token")
        terminal = (sampling.max_new_tokens <= 1
                    or (sampling.stop_token is not None and first is not None
                        and int(first) == sampling.stop_token))
        if terminal and first is not None:
            sid = self.engine.adopt_request(
                prompt, int(first), None, sampling, request_id=rid,
                trace_ctx=trace_ctx)
            return {"stream_id": sid, "adopted": True}
        blob = None
        desc = handoff.get("kv")
        if desc is not None and first is not None:
            try:
                frame = self._get_shipper().receive(
                    desc, method="__llm_adopt__")
            except KVShipError:
                frame = None
            blob = (frame or {}).get("kv")
        if blob is not None:
            try:
                sid = self.engine.adopt_request(
                    prompt, int(first), blob, sampling, request_id=rid,
                    trace_ctx=trace_ctx,
                    lane=desc.get("lane", "inline"),
                    t_ship_start=handoff.get("t_ship_start"))
                return {"stream_id": sid, "adopted": True}
            except Exception:
                logger.warning(
                    "llm.kv_ship: adoption failed, re-prefilling",
                    exc_info=True)
        # fallback: deterministic re-prefill on this (decode) replica;
        # sheds retriably if this replica is saturated
        sid = self.engine.add_request(prompt, sampling, request_id=rid,
                                      trace_ctx=trace_ctx)
        return {"stream_id": sid, "adopted": False}

    def __llm_metrics__(self):
        m = self.engine.metrics()
        m["token_ledger"] = self.engine.token_ledger()
        return m

    # ------------------------------------------------- serve integration

    def __serve_load__(self) -> Dict[str, Any]:
        m = self.engine.metrics()
        return {
            # in-flight sequences ARE queue depth: the router's p2c
            # scoring sees decode load, the autoscaler sees pressure,
            # and the controller's drain poll waits for zero
            "queue_len_extra": m["running"] + m["waiting"],
            "llm": m,
        }

    def __serve_prepare_drain__(self):
        self.engine.prepare_drain()

    def __serve_prepare_shutdown__(self, replica_name: str = ""):
        """Best-effort token-ledger flush (rolling update / downscale):
        reconciliation joins client token counts against it even after
        this replica is gone."""
        try:
            from ray_tpu_torch.gameday import store
            ledger = self.engine.token_ledger()
            if ledger:
                store.flush_llm_ledger(replica_name, ledger)
        except Exception:
            pass
        try:
            if self._shipper is not None:
                self._shipper.free()
        except Exception:
            pass
        try:
            self.engine.stop()
        except Exception:
            pass

    def check_health(self):
        if not self.engine._thread.is_alive():
            raise RuntimeError("LLM engine thread died")
        return "ok"


def _require_gpu_grant(model: str, model_config: Optional[Dict[str, Any]]):
    """Raise when a server on ``cuda`` runs in a process the runtime
    granted no GPU (``CUDA_VISIBLE_DEVICES`` set to ``""``): it must
    never carry on on the CPU."""
    if model == "toy":
        return
    device = str((model_config or {}).get("device", "cuda"))
    if not device.startswith("cuda"):
        return
    if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
        raise RuntimeError(
            f"LLMServer(model={model!r}) runs on {device!r}, but this "
            "process holds no GPU grant (CUDA_VISIBLE_DEVICES is empty): "
            "deploy it with ray_actor_options={'num_gpus': 1}, or pass "
            "model_config={'device': 'cpu'}")
