"""Model adapters: the engine's prefill/decode contract.

Counterpart of ``ray_tpu/serve/llm/model_runner.py``. An adapter owns
the *storage* of the paged KV pool (the engine's ``PagedKVCache`` owns
only the allocator) and exposes the compute entry points:

    prefill(seqs) -> logits [B, V]   write the prompts' KV into their
                                     pages (skipping any cached-prefix
                                     tokens), return last-token logits
    decode(seqs)  -> logits [B, V]   append each sequence's newest
                                     sampled token, attend against the
                                     cached prefix, return next logits
    decode_window(seqs, windows)     speculative decode: append a
                                     window of tokens per sequence in
                                     ONE batched step and return the
                                     logits after every position
    rollback(seq_id, n)              retract the last n cached tokens
    copy_page(src, dst)              duplicate page contents (copy-on-
                                     write of a shared prefix page)
    export_kv / import_kv            serialize / rebind a prompt's KV
                                     pages

Two implementations:

* ``ToyAdapter`` — a dependency-free numpy language model whose next
  token is a deterministic function of the cached prefix READ BACK
  THROUGH THE BLOCK TABLES (a paging bug corrupts its output).

* ``TorchModelAdapter`` — GPT-2 (``models/gpt2.py``) or Llama
  (``models/llama.py``) over a paged pool of torch tensors on the
  adapter's device. Every single-token decode step runs attention in the
  hand-written paged-decode kernel (through
  ``ops.attention.cached_attention``); prefill and speculative windows
  pad their length to a power of two >= 8 and take the gather +
  ``decode_attention`` path, with padding tokens parked on the null
  page.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device


def _pad_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _cached_tokens(seq) -> int:
    return int(getattr(seq, "cached_tokens", 0) or 0)


class ToyAdapter:
    """Deterministic numpy LM over the paged pool (tests, game day,
    bench). Each token's "KV" is its embedding; the next-token logits
    are ``mean(cached embeddings) @ E^T`` — prefix-dependent, exactly
    reproducible, and read through the block tables so paging bugs are
    visible as wrong tokens, not just wrong latency."""

    def __init__(self, vocab_size: int = 256, dim: int = 32,
                 seed: int = 0, step_delay_s: float = 0.0,
                 per_seq_delay_s: float = 0.0,
                 per_prefill_token_delay_s: float = 0.0):
        rng = np.random.RandomState(seed)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.embed = rng.randn(self.vocab_size, self.dim).astype(
            np.float32)
        self.step_delay_s = float(step_delay_s)
        self.per_seq_delay_s = float(per_seq_delay_s)
        self.per_prefill_token_delay_s = float(per_prefill_token_delay_s)
        self._lock = threading.Lock()

    def bind_cache(self, cache):
        self.cache = cache
        self.pages = np.zeros(
            (cache.num_blocks, cache.block_size, self.dim), np.float32)
        # seq id -> {"table": np.ndarray pages, "len": cached tokens}
        self._state: Dict[str, Dict[str, Any]] = {}

    def copy_page(self, src: int, dst: int):
        self.pages[dst] = self.pages[src]

    def _write(self, st, tokens: List[int]):
        bs = self.cache.block_size
        table = st["table"]
        for i, tok in enumerate(tokens):
            pos = st["len"] + i
            self.pages[table[pos // bs], pos % bs] = self.embed[tok]
        st["len"] += len(tokens)

    def _logits(self, st) -> np.ndarray:
        bs = self.cache.block_size
        table = st["table"]
        n = st["len"]
        nb = -(-n // bs)
        flat = self.pages[table[:nb]].reshape(nb * bs, self.dim)[:n]
        h = flat.mean(axis=0)
        return (h @ self.embed.T).astype(np.float32)

    def _cow_partial_page(self, seq_id: str, st, cached: int):
        """A cached prefix ending mid-page means our first write lands
        in a shared page: take a private copy first (copy-on-extend)."""
        bs = self.cache.block_size
        if cached % bs == 0:
            return
        old, new = self.cache.copy_on_write(seq_id, cached // bs)
        if new != old:
            self.copy_page(old, new)
            st["table"] = np.asarray(
                self.cache.block_table(seq_id), np.int64)

    def prefill(self, seqs) -> np.ndarray:
        n_tok = sum(len(s.prompt) - _cached_tokens(s) for s in seqs)
        if self.step_delay_s or self.per_prefill_token_delay_s:
            time.sleep(self.step_delay_s
                       + self.per_prefill_token_delay_s * n_tok)
        out = np.zeros((len(seqs), self.vocab_size), np.float32)
        with self._lock:
            for i, s in enumerate(seqs):
                cached = _cached_tokens(s)
                st = {"table": np.asarray(
                    self.cache.block_table(s.seq_id), np.int64),
                    "len": cached}
                self._state[s.seq_id] = st
                self._cow_partial_page(s.seq_id, st, cached)
                self._write(st, s.prompt[cached:])
                out[i] = self._logits(st)
        return out

    def decode(self, seqs) -> np.ndarray:
        if self.step_delay_s or self.per_seq_delay_s:
            time.sleep(self.step_delay_s
                       + self.per_seq_delay_s * len(seqs))
        out = np.zeros((len(seqs), self.vocab_size), np.float32)
        with self._lock:
            for i, s in enumerate(seqs):
                st = self._state[s.seq_id]
                self._write(st, [s.tokens[-1]])
                out[i] = self._logits(st)
        return out

    def decode_window(self, seqs, windows) -> List[np.ndarray]:
        """Append each sequence's token window, returning logits after
        EVERY window position ([w_i, V] per sequence). The toy model is
        sequential anyway; the contract (and the flax implementation)
        is one batched step."""
        if self.step_delay_s or self.per_seq_delay_s:
            time.sleep(self.step_delay_s
                       + self.per_seq_delay_s * len(seqs))
        out = []
        with self._lock:
            for s, win in zip(seqs, windows):
                st = self._state[s.seq_id]
                rows = np.zeros((len(win), self.vocab_size), np.float32)
                for j, tok in enumerate(win):
                    self._write(st, [int(tok)])
                    rows[j] = self._logits(st)
                out.append(rows)
        return out

    def rollback(self, seq_id: str, n: int):
        with self._lock:
            st = self._state.get(seq_id)
            if st is not None and n > 0:
                st["len"] = max(0, st["len"] - int(n))

    def export_kv(self, seq_id: str, n_prompt: int) -> Dict[str, Any]:
        """Snapshot the prompt's KV pages for prefill→decode handoff."""
        bs = self.cache.block_size
        nb = -(-int(n_prompt) // bs)
        with self._lock:
            st = self._state[seq_id]
            table = np.asarray(st["table"][:nb], np.int64)
            return {"kind": "toy", "n": int(n_prompt),
                    "pages": self.pages[table].copy()}

    def import_kv(self, seq_id: str, n_prompt: int,
                  blob: Dict[str, Any]):
        """Rebind shipped prompt KV into this replica's (freshly
        allocated, private) pages."""
        if blob.get("kind") != "toy":
            raise ValueError("KV blob is not from a toy adapter")
        bs = self.cache.block_size
        nb = -(-int(n_prompt) // bs)
        with self._lock:
            table = np.asarray(
                self.cache.block_table(seq_id), np.int64)
            self.pages[table[:nb]] = blob["pages"]
            self._state[seq_id] = {"table": table, "len": int(n_prompt)}

    def release(self, seq_id: str):
        with self._lock:
            self._state.pop(seq_id, None)


def build_model(kind: str, config=None, params=None, seed: int = 0,
                device="cuda"):
    """(config, model) for serving: ``kind`` ``gpt2`` or ``llama`` (the
    tiny test config unless ``config`` is given), weights from flax
    ``params`` or else seeded as the model's family does (GPT-2 on the
    host, then moved; Llama built and seeded on ``device``: a 7B init on
    the host takes minutes and 27 GB of host memory), stored in the
    dtypes they compute in, in eval mode on ``device``."""
    device = resolve_device(device)
    if kind == "gpt2":
        from ray_tpu_torch.models import gpt2
        cfg = config or gpt2.GPT2Config.tiny()
        model = gpt2.GPT2(cfg)
        if params is None:
            model.init_weights(torch.Generator().manual_seed(seed))
        else:
            gpt2.params_from_flax(params, model)
    elif kind == "llama":
        from ray_tpu_torch.models import llama
        cfg = config or llama.LlamaConfig.tiny()
        if params is None:
            model = llama.make_llama(cfg, seed, device=device)
        else:
            model = llama.LlamaModel(cfg)
            llama.params_from_flax(params, model)
    else:
        raise ValueError(f"unknown model kind {kind!r} (gpt2 | llama)")
    # serving stores the weights in the dtype each computes in (flax
    # casts its f32 params at every call: the same values)
    return cfg, model.to_compute_dtype().to(device).eval()


def model_positions(cfg) -> int:
    """The model's position count: GPT-2's n_positions, Llama's
    max_seq_len (the rows of its RoPE table)."""
    return cfg.n_positions if hasattr(cfg, "n_positions") else cfg.max_seq_len


class TorchModelAdapter:
    """GPT-2 or Llama incremental decode over the paged pool, in PyTorch.

    The pool is two ``[L, P, bs, Hkv, D]`` tensors in ``cfg.dtype`` on
    ``device`` (Llama's Hkv: its kv heads, not replicated over the query
    groups), updated IN PLACE through per-layer views (``index_put_``);
    the JAX adapter donates its pools to the same end. Decode steps run
    one token per row with no padding, so every layer's attention goes
    through the paged-decode kernel. Prefill and speculative windows
    pad their length to a power of two >= 8; padding tokens write to
    the null page and attend to nothing. Only each row's last real
    token goes through the LM head. ``max_seq_len`` is the model's
    position count: rows that would pass it, or that name a token or
    page out of range, are refused on the host before any device call.
    """

    def __init__(self, kind: str = "gpt2", config=None, params=None,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.kind = kind
        self.cfg, self.model = build_model(kind, config, params, seed,
                                           self.device)
        cfg = self.cfg
        if kind == "gpt2":
            self.n_layers, self.n_kv_heads = cfg.n_layer, cfg.n_head
            self.head_dim = cfg.n_embd // cfg.n_head
        else:
            self.n_layers, self.n_kv_heads = cfg.n_layers, cfg.n_kv_heads
            self.head_dim = cfg.head_dim
        self.vocab_size = cfg.vocab_size
        self.max_seq_len = model_positions(cfg)
        self.decode_steps = 0       # batched single-token steps run
        self._lock = threading.Lock()

    def bind_cache(self, cache):
        self.cache = cache
        shape = (self.n_layers, cache.num_blocks, cache.block_size,
                 self.n_kv_heads, self.head_dim)
        self.k_pages = torch.zeros(shape, dtype=self.cfg.dtype,
                                   device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        # every block table is padded to the worst case per sequence
        self.nb_max = cache.blocks_for(self.max_seq_len)
        self._state: Dict[str, Dict[str, Any]] = {}

    def copy_page(self, src: int, dst: int):
        with self._lock:
            self.k_pages[:, dst] = self.k_pages[:, src]
            self.v_pages[:, dst] = self.v_pages[:, src]

    def _run(self, rows: List[Dict[str, Any]],
             full: bool = False) -> np.ndarray:
        """rows: [{tokens: [ints], len: cache length, table: [pages]}]
        -> last-token logits [B, V] (or full [B, S, V] when ``full``)
        as f32 numpy."""
        B = len(rows)
        n = np.asarray([len(r["tokens"]) for r in rows])
        single = not full and int(n.max()) == 1
        S = 1 if single else _pad_pow2(int(n.max()), 8)
        tokens = np.zeros((B, S), np.int64)
        lengths = np.zeros((B,), np.int32)
        valid = np.zeros((B, S), bool)
        tables = np.zeros((B, self.nb_max), np.int32)
        for i, r in enumerate(rows):
            tokens[i, :n[i]] = r["tokens"]
            lengths[i] = r["len"]
            valid[i, :n[i]] = True
            t = r["table"][:self.nb_max]
            tables[i, :len(t)] = t
        if int((lengths + n).max()) > self.max_seq_len:
            raise ValueError(f"a sequence would pass the model's "
                             f"{self.max_seq_len} positions")
        if tokens.min() < 0 or tokens.max() >= self.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self.vocab_size})")
        if tables.min() < 0 or tables.max() >= self.cache.num_blocks:
            raise ValueError("block table names a page outside the pool")
        dev = self.device
        with self._lock, torch.no_grad():
            tab = torch.from_numpy(tables).to(dev)
            caches = [{"k_pages": self.k_pages[l], "v_pages": self.v_pages[l],
                       "block_tables": tab} for l in range(self.n_layers)]
            h = self.model.trunk(
                torch.from_numpy(tokens).to(dev), kv_cache=caches,
                seq_lengths=torch.from_numpy(lengths).to(dev),
                valid=None if single else torch.from_numpy(valid).to(dev))
            if not full:
                # last REAL token's hidden state per row
                h = h[torch.arange(B, device=dev),
                      torch.from_numpy(n - 1).to(dev)]
            return self.model.head(h).float().cpu().numpy()

    def prefill(self, seqs) -> np.ndarray:
        rows = []
        for s in seqs:
            cached = _cached_tokens(s)
            if cached % self.cache.block_size:
                # copy-on-extend: the suffix write lands in the last
                # shared prefix page — privatize it first
                old, new = self.cache.copy_on_write(
                    s.seq_id, cached // self.cache.block_size)
                if new != old:
                    self.copy_page(old, new)
            table = self.cache.block_table(s.seq_id)
            self._state[s.seq_id] = {"table": table, "len": len(s.prompt)}
            rows.append({"tokens": s.prompt[cached:], "len": cached,
                         "table": table})
        return self._run(rows)

    def decode(self, seqs) -> np.ndarray:
        rows = []
        for s in seqs:
            st = self._state[s.seq_id]
            rows.append({"tokens": [s.tokens[-1]], "len": st["len"],
                         "table": st["table"]})
            st["len"] += 1
        self.decode_steps += 1
        return self._run(rows)

    def decode_window(self, seqs, windows) -> List[np.ndarray]:
        """One batched multi-token incremental step; position j's
        logits condition on exactly window[:j+1] (``cached_attention``
        is causal at the offset) — the speculative verify contract."""
        rows = []
        for s, win in zip(seqs, windows):
            st = self._state[s.seq_id]
            rows.append({"tokens": list(win), "len": st["len"],
                         "table": st["table"]})
            st["len"] += len(win)
        full = self._run(rows, full=True)      # [B, S, V]
        return [full[i, :len(win)] for i, win in enumerate(windows)]

    def rollback(self, seq_id: str, n: int):
        st = self._state.get(seq_id)
        if st is not None and n > 0:
            st["len"] = max(0, st["len"] - int(n))

    def _page_index(self, table, n_prompt: int) -> torch.Tensor:
        nb = -(-int(n_prompt) // self.cache.block_size)
        return torch.as_tensor(np.asarray(table[:nb], np.int64),
                               device=self.device)

    def export_kv(self, seq_id: str, n_prompt: int) -> Dict[str, Any]:
        idx = self._page_index(self._state[seq_id]["table"], n_prompt)
        with self._lock:
            k = self.k_pages[:, idx].cpu()
            v = self.v_pages[:, idx].cpu()
        return {"kind": f"torch:{self.kind}", "n": int(n_prompt),
                "k": k, "v": v}

    def import_kv(self, seq_id: str, n_prompt: int, blob: Dict[str, Any]):
        if blob.get("kind") != f"torch:{self.kind}":
            raise ValueError(
                f"KV blob kind {blob.get('kind')!r} does not match "
                f"adapter torch:{self.kind}")
        table = self.cache.block_table(seq_id)
        idx = self._page_index(table, n_prompt)
        with self._lock:
            self.k_pages[:, idx] = blob["k"].to(self.device,
                                                self.k_pages.dtype)
            self.v_pages[:, idx] = blob["v"].to(self.device,
                                                self.v_pages.dtype)
        self._state[seq_id] = {"table": table, "len": int(n_prompt)}

    def release(self, seq_id: str):
        self._state.pop(seq_id, None)


def make_adapter(model: str = "toy",
                 model_config: Optional[Dict[str, Any]] = None):
    """Deployment-facing factory: ``model`` is ``toy`` | ``gpt2`` |
    ``llama`` (tiny test configs unless ``model_config`` overrides; its
    ``device`` defaults to ``cuda``)."""
    model_config = dict(model_config or {})
    if model == "toy":
        return ToyAdapter(**model_config)
    if model in ("gpt2", "llama"):
        return TorchModelAdapter(kind=model, **model_config)
    raise ValueError(f"unknown model {model!r} (toy | gpt2 | llama)")
