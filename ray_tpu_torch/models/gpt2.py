"""GPT-2 family as ``nn.Module``s: the serving and training slices' model.

Counterpart of ``ray_tpu/models/gpt2.py`` with the same numerics:

  - module paths are flax's (``h_{i}.attn.c_attn`` ...), so weights
    carry across with ``params_from_flax``; a flax Dense kernel is
    [in, out] and lands transposed in ``nn.Linear.weight`` [out, in];
  - params are kept in f32 and Dense and Embed cast input, weight and
    bias to ``cfg.dtype`` at every call, as flax does, so an optimizer
    updates f32 weights (``to_compute_dtype`` stores them in
    ``cfg.dtype`` instead, for serving: the casts are then no-ops and
    give the same values);
  - LayerNorm is flax's: eps 1e-6, computed and returned in f32;
  - GELU is the tanh approximation;
  - the LM head is tied to ``wte`` and, like flax's ``Embed.attend``,
    multiplies in ``cfg.dtype``, so bf16 models give bf16 logits;
  - dropout draws from an explicit ``torch.Generator`` and runs only
    when one is passed (flax's ``deterministic=False`` with a dropout
    rng).

``attention_backend="flash"`` runs ``ops.attention.flash_attention``
(the whole-kv CUDA kernels at GPT-2's shapes), ``"reference"`` the
plain attention. With ``kv_cache`` the forward is one incremental step
over a contiguous cache (``init_kv_cache``) or one layer of a paged
pool (the serve engine).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.attention import (TRAINING_KERNELS, TrainingAttention,
                                         attention_reference,
                                         cached_attention, flash_attention,
                                         paged_attention_decode)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    attention_backend: str = "flash"  # flash | reference

    @classmethod
    def small(cls):  # gpt2 124M
        return cls()

    @classmethod
    def medium(cls):
        return cls(n_embd=1024, n_layer=24, n_head=16)

    @classmethod
    def large(cls):
        return cls(n_embd=1280, n_layer=36, n_head=20)

    @classmethod
    def tiny(cls, vocab_size: int = 512):  # tests
        return cls(vocab_size=vocab_size, n_positions=256, n_embd=128,
                   n_layer=2, n_head=4, dtype=torch.float32,
                   attention_backend="reference")


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=..., use_bias=...)``: f32 params; input,
    kernel and bias cast to ``dtype`` at every call."""

    def __init__(self, n_in: int, n_out: int, dtype, bias: bool = True):
        super().__init__(n_in, n_out, bias=bias, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=...)``: an f32 table cast to ``dtype`` at
    every call; ``attend`` is the tied LM head."""

    def __init__(self, num: int, features: int, dtype):
        super().__init__(num, features, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.compute_dtype))

    def attend(self, x):
        dt = self.compute_dtype
        return x.to(dt) @ self.weight.to(dt).T


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, f32 in and out."""

    def __init__(self, n: int):
        super().__init__(n, eps=1e-6, dtype=torch.float32)

    def forward(self, x):
        return super().forward(x.float())


def dropout(x, p: float, generator: Optional[torch.Generator]):
    """flax ``nn.Dropout``: identity without a generator (deterministic);
    otherwise keep each element with probability 1 - p, scaled by
    1 / (1 - p), from ``generator``'s stream."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, impl: TrainingAttention):
        super().__init__()
        self.cfg = cfg
        self.impl = impl
        self.c_attn = Dense(cfg.n_embd, 3 * cfg.n_embd, cfg.dtype)
        self.c_proj = Dense(cfg.n_embd, cfg.n_embd, cfg.dtype)

    def forward(self, x, kv_cache=None, seq_lengths=None, valid=None,
                paged_decode=paged_attention_decode, generator=None):
        cfg = self.cfg
        B, S, E = x.shape
        H = cfg.n_head
        q, k, v = self.c_attn(x).split(E, dim=-1)
        if kv_cache is not None:
            def tok(t):  # [B,S,E] -> [B,S,H,D]
                return t.reshape(B, S, H, E // H)
            y, kv_cache = cached_attention(
                tok(q), tok(k), tok(v), kv_cache, seq_lengths, valid=valid,
                paged_decode=paged_decode)
            y = self.c_proj(y.reshape(B, S, E))
            return dropout(y, cfg.dropout, generator), kv_cache

        def heads(t):  # [B,S,E] -> [B,H,S,D]
            return t.reshape(B, S, H, E // H).transpose(1, 2)
        if cfg.attention_backend == "flash":
            y = flash_attention(heads(q), heads(k), heads(v), causal=True,
                                impl=self.impl)
        elif cfg.attention_backend == "reference":
            y = attention_reference(heads(q), heads(k), heads(v),
                                    causal=True)
        else:
            raise NotImplementedError(
                f"attention_backend={cfg.attention_backend!r} is not ported "
                "(ring attention: ROADMAP.md Queue A item 8)")
        y = y.transpose(1, 2).reshape(B, S, E)
        return dropout(self.c_proj(y), cfg.dropout, generator)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.c_fc = Dense(cfg.n_embd, 4 * cfg.n_embd, cfg.dtype)
        self.c_proj = Dense(4 * cfg.n_embd, cfg.n_embd, cfg.dtype)

    def forward(self, x, generator=None):
        h = F.gelu(self.c_fc(x), approximate="tanh")
        return dropout(self.c_proj(h), self.cfg.dropout, generator)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, impl: TrainingAttention):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd)
        self.attn = CausalSelfAttention(cfg, impl)
        self.ln_2 = LayerNorm(cfg.n_embd)
        self.mlp = MLP(cfg)

    def forward(self, x, kv_cache=None, seq_lengths=None, valid=None,
                paged_decode=paged_attention_decode, generator=None):
        if kv_cache is not None:
            y, kv_cache = self.attn(self.ln_1(x), kv_cache, seq_lengths,
                                    valid, paged_decode, generator)
            x = x + y
            return x + self.mlp(self.ln_2(x), generator), kv_cache
        x = x + self.attn(self.ln_1(x), generator=generator)
        return x + self.mlp(self.ln_2(x), generator)


class GPT2(nn.Module):
    """``impl`` picks what the flash backend runs: the attention kernels
    (default) or their plain versions (``ops.attention.TRAINING_PLAIN``),
    to compare one with the other."""

    def __init__(self, cfg: GPT2Config,
                 impl: TrainingAttention = TRAINING_KERNELS):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.n_embd, cfg.dtype)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, cfg.dtype)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, impl))
        self.ln_f = LayerNorm(cfg.n_embd)

    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.cfg.n_layer)]

    def trunk(self, input_ids, positions=None, kv_cache=None,
              seq_lengths=None, valid=None,
              paged_decode=paged_attention_decode, dropout_generator=None):
        """Everything before the LM head: ``ln_f`` output, f32 [B,S,E].
        With ``kv_cache`` (a list of per-layer caches, updated in place)
        the S tokens are one incremental step after ``seq_lengths``
        cached tokens; ``valid`` marks real tokens when S is padded."""
        B, S = input_ids.shape
        dev = input_ids.device
        gen = dropout_generator
        if positions is None:
            ar = torch.arange(S, device=dev)[None, :]
            if kv_cache is not None:
                positions = seq_lengths[:, None].long() + ar
                if valid is not None:
                    positions = torch.where(valid, positions, 0)
            else:
                positions = ar
        x = dropout(self.wte(input_ids) + self.wpe(positions),
                    self.cfg.dropout, gen)
        for i, block in enumerate(self.blocks()):
            if kv_cache is not None:
                x, _ = block(x, kv_cache[i], seq_lengths, valid,
                             paged_decode, gen)
            else:
                x = block(x, generator=gen)
        return self.ln_f(x)

    def head(self, h):
        """Weight-tied LM head in ``cfg.dtype`` (flax ``Embed.attend``)."""
        return self.wte.attend(h)

    def forward(self, input_ids, positions=None, kv_cache=None,
                seq_lengths=None, valid=None,
                paged_decode=paged_attention_decode, dropout_generator=None):
        """Full forward (logits) or, with ``kv_cache``, one incremental
        step returning ``(logits, kv_cache)``; the caches are updated in
        place. Prefill is the ``seq_lengths == 0`` case. Dropout runs
        only with a ``dropout_generator``."""
        logits = self.head(self.trunk(input_ids, positions, kv_cache,
                                      seq_lengths, valid, paged_decode,
                                      dropout_generator))
        return (logits, kv_cache) if kv_cache is not None else logits

    @torch.no_grad()
    def to_compute_dtype(self):
        """Store the Dense and Embed weights in ``cfg.dtype`` (serving:
        half the memory, no per-call casts, the same values). LayerNorm
        stays f32. Not for training: optimizer updates need f32."""
        for mod in self.modules():
            if isinstance(mod, (Dense, Embed)):
                mod.to(self.cfg.dtype)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``: lecun-normal
        Dense kernels (normal truncated at 2 sigma), zero biases,
        LayerNorm ones and zeros, Embed's normal(1 / sqrt(features))."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                std = math.sqrt(1.0 / mod.in_features) / .87962566103423978
                mod.weight.copy_(_truncated_normal(mod.weight.shape,
                                                   generator) * std)
                mod.bias.zero_()
            elif isinstance(mod, Embed):
                w = torch.empty(mod.weight.shape)
                nn.init.normal_(w, std=mod.embedding_dim ** -0.5,
                                generator=generator)
                mod.weight.copy_(w)
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self


def _truncated_normal(shape, generator: torch.Generator):
    """Standard normal truncated to [-2, 2], by redrawing the samples
    outside it (the same law as inverse-CDF sampling, and much faster on
    a CPU for GPT-2's 85M Dense weights), on the generator's device."""
    dev = generator.device
    w = torch.randn(shape, generator=generator, device=dev)
    bad = w.abs() > 2
    while bool(bad.any()):
        w[bad] = torch.randn(int(bad.sum()), generator=generator, device=dev)
        bad = w.abs() > 2
    return w


def causal_lm_loss(logits, labels, ignore_index: int = -100):
    """Next-token cross entropy, the JAX package's rounding: the max has
    no gradient; ``logits - max`` is taken in the logits' dtype, then
    exp and the sum run in f32; the gathered logit is cast to f32; the
    mean runs over labels != ``ignore_index``."""
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:].long()
    mask = shift_labels != ignore_index
    safe = torch.where(mask, shift_labels, 0)
    m = shift_logits.detach().amax(dim=-1)
    sumexp = torch.exp((shift_logits - m[..., None]).float()).sum(dim=-1)
    lse = m.float() + torch.log(sumexp)
    ll = torch.gather(shift_logits, -1, safe[..., None])[..., 0].float()
    total = ((lse - ll) * mask).sum()
    return total / mask.sum().clamp(min=1)


def init_kv_cache(cfg: GPT2Config, batch_size: int, max_len: int,
                  device="cuda"):
    """Per-layer contiguous KV caches for incremental decode ([B, S_max,
    H, D] token-major, the layout the paged pool shares), on ``cuda``
    unless the caller asks for ``cpu``."""
    device = resolve_device(device)
    hd = cfg.n_embd // cfg.n_head
    shape = (batch_size, max_len, cfg.n_head, hd)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layer)]


def params_from_flax(tree: Dict[str, Any],
                     model: Optional[GPT2] = None) -> Dict[str, torch.Tensor]:
    """flax GPT-2 params (``{"params": {...}}``, arrays or anything
    ``np.asarray`` takes) -> this module's ``state_dict`` in f32. With
    ``model`` the weights are also loaded into it (cast to its dtypes)."""
    p = tree["params"]

    def t(x, transpose=False):
        a = torch.from_numpy(np.array(np.asarray(x), np.float32))
        return a.T.contiguous() if transpose else a

    sd: Dict[str, torch.Tensor] = {
        "wte.weight": t(p["wte"]["embedding"]),
        "wpe.weight": t(p["wpe"]["embedding"]),
        "ln_f.weight": t(p["ln_f"]["scale"]),
        "ln_f.bias": t(p["ln_f"]["bias"]),
    }
    layers = sorted(k for k in p if k.startswith("h_"))
    for name in layers:
        blk = p[name]
        for ln in ("ln_1", "ln_2"):
            sd[f"{name}.{ln}.weight"] = t(blk[ln]["scale"])
            sd[f"{name}.{ln}.bias"] = t(blk[ln]["bias"])
        for path in ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj"):
            sub, dense = path.split(".")
            sd[f"{name}.{path}.weight"] = t(blk[sub][dense]["kernel"], True)
            sd[f"{name}.{path}.bias"] = t(blk[sub][dense]["bias"])
    if model is not None:
        model.load_state_dict(sd)
    return sd
