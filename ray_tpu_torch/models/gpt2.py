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
    rng); on a mesh a ``MeshDropout`` over that generator gives each
    rank its rows of the one-device mask.

``attention_backend="flash"`` runs ``ops.attention.flash_attention``
(the whole-kv CUDA kernels at GPT-2's shapes; the streaming ones with
``exact=True``), ``"reference"`` the plain attention, ``"ring"``
``ops.ring_attention`` over the mesh's sp axis (one causal block of the
streaming kernels without a mesh). With ``kv_cache``
the forward is one incremental step over a contiguous cache
(``init_kv_cache``) or one layer of a paged pool (the serve engine).

On a mesh with tp > 1 (``GPT2.set_mesh``) each tp rank computes its
own heads of the attention, its own columns of the MLP and a partial
sum of the tied head over its share of ``n_embd``; the embeddings and
the LayerNorms run whole on every rank. Every param is used whole (the
trainer gathers it), and each slice one rank works on passes through
``collectives.psum_backward``, so that after the backward every rank
holds the whole gradient of every param for its batch rows.

On a mesh with sp > 1 each rank holds its slice of the sequence:
positions (``wpe``'s rows) start at its sp index times its length, and
the attention of every backend goes through the ring (the blocks'
plain versions for ``"reference"``, the streaming kernels otherwise):
the same exact attention over the whole sequence.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.attention import (TRAINING_KERNELS, TRAINING_PLAIN,
                                         TrainingAttention,
                                         attention_reference,
                                         cached_attention, flash_attention,
                                         paged_attention_decode)
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import BATCH_AXES


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    attention_backend: str = "flash"  # flash | ring | reference

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
        return dense(x, self.weight, self.bias, self.compute_dtype)


def dense(x, weight, bias, dtype):
    """``Dense.forward`` on given params (a tp rank's slices of them):
    x, weight and bias cast to ``dtype``; ``bias`` may be None."""
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


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


class MeshDropout:
    """The one-device dropout stream on one rank of a mesh. Each draw is
    the mask of the whole global [B, S, ...] (B split over the batch's
    (dp, fsdp) ranks, S over sp; tp ranks hold the same rows), drawn from
    ``generator`` in the one-device order, of which the rank keeps its
    rows and positions. So a mesh step drops the units that the same
    step on one device drops."""

    def __init__(self, generator: torch.Generator, mesh):
        self.generator = generator
        self.mesh = mesh

    def keep(self, shape, p: float, device) -> torch.Tensor:
        mesh = self.mesh
        B, S = shape[0], shape[1]
        nb, ib = mesh.size(BATCH_AXES), mesh.index(BATCH_AXES)
        ns, isp = mesh.size("sp"), mesh.index("sp")
        u = torch.rand((B * nb, S * ns, *shape[2:]),
                       generator=self.generator, device=device)
        return u[ib * B:(ib + 1) * B, isp * S:(isp + 1) * S] >= p


def dropout(x, p: float,
            generator: Union[torch.Generator, MeshDropout, None]):
    """flax ``nn.Dropout``: identity without a generator (deterministic);
    otherwise keep each element with probability 1 - p, scaled by
    1 / (1 - p), from ``generator``'s stream (a ``MeshDropout``: this
    rank's part of the global mask)."""
    if generator is None or p == 0.0:
        return x
    if isinstance(generator, MeshDropout):
        keep = generator.keep(x.shape, p, x.device)
    else:
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, impl: TrainingAttention):
        super().__init__()
        self.cfg = cfg
        self.impl = impl
        self.exact = False
        self.tp_mesh = None
        self.sp_mesh = None
        self.c_attn = Dense(cfg.n_embd, 3 * cfg.n_embd, cfg.dtype)
        self.c_proj = Dense(cfg.n_embd, cfg.n_embd, cfg.dtype)

    def forward(self, x, kv_cache=None, seq_lengths=None, valid=None,
                paged_decode=paged_attention_decode, generator=None):
        cfg = self.cfg
        B, S, E = x.shape
        H = cfg.n_head
        if kv_cache is not None:
            q, k, v = self.c_attn(x).split(E, dim=-1)

            def tok(t):  # [B,S,E] -> [B,S,H,D]
                return t.reshape(B, S, H, E // H)
            y, kv_cache = cached_attention(
                tok(q), tok(k), tok(v), kv_cache, seq_lengths, valid=valid,
                paged_decode=paged_decode)
            y = self.c_proj(y.reshape(B, S, E))
            return dropout(y, cfg.dropout, generator), kv_cache
        if self.tp_mesh is not None:
            return dropout(self._forward_tp(x), cfg.dropout, generator)
        q, k, v = self.c_attn(x).split(E, dim=-1)
        y = self._attend(q, k, v, H)
        return dropout(self.c_proj(y), cfg.dropout, generator)

    def _attend(self, q, k, v, H):
        """[B,S,H*D] q, k, v of ``H`` heads -> [B,S,H*D]."""
        B, S, HD = q.shape

        def heads(t):  # [B,S,H*D] -> [B,H,S,D]
            return t.reshape(B, S, H, HD // H).transpose(1, 2)
        backend = self.cfg.attention_backend
        if backend not in ("flash", "ring", "reference"):
            raise ValueError(f"attention_backend={backend!r}: flash, ring "
                             "or reference")
        if backend == "ring" or self.sp_mesh is not None:
            y = ring_attention(
                heads(q), heads(k), heads(v), mesh=self.sp_mesh,
                causal=True,
                impl=TRAINING_PLAIN if backend == "reference" else self.impl)
        elif backend == "flash":
            y = flash_attention(heads(q), heads(k), heads(v), causal=True,
                                exact=self.exact, impl=self.impl)
        else:
            y = attention_reference(heads(q), heads(k), heads(v),
                                    causal=True)
        return y.transpose(1, 2).reshape(B, S, HD)

    def _forward_tp(self, x):
        """Tensor-parallel attention: this tp rank's n_head / tp heads.
        ``c_attn``'s output is [q | k | v], each E wide and head-major,
        so the rank's rows are the same head block of each of the three
        (not a contiguous third of 3E, which would mix q with k); its
        part of ``c_proj`` is the matching block of input columns, and
        the partial outputs are summed over tp."""
        mesh, dt = self.tp_mesh, self.cfg.dtype
        E = x.shape[-1]
        H = self.cfg.n_head
        n, r = mesh.size("tp"), mesh.index("tp")
        Hl = H // n
        w = C.psum_backward(self.c_attn.weight, "tp", mesh)
        b = C.psum_backward(self.c_attn.bias, "tp", mesh)
        block = slice(r * Hl, (r + 1) * Hl)
        w = w.view(3, H, E // H, E)[:, block].reshape(3 * E // n, E)
        b = b.view(3, H, E // H)[:, block].reshape(3 * E // n)
        q, k, v = dense(C.psum_backward(x, "tp", mesh), w, b, dt).split(
            E // n, dim=-1)
        y = self._attend(q, k, v, Hl)
        wp = C.psum_backward(self.c_proj.weight, "tp", mesh)
        part = dense(y, wp[:, r * E // n:(r + 1) * E // n], None, dt)
        return C.psum_forward(part, "tp", mesh) + self.c_proj.bias.to(dt)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.tp_mesh = None
        self.c_fc = Dense(cfg.n_embd, 4 * cfg.n_embd, cfg.dtype)
        self.c_proj = Dense(4 * cfg.n_embd, cfg.n_embd, cfg.dtype)

    def forward(self, x, generator=None):
        if self.tp_mesh is not None:
            return dropout(self._forward_tp(x), self.cfg.dropout, generator)
        h = F.gelu(self.c_fc(x), approximate="tanh")
        return dropout(self.c_proj(h), self.cfg.dropout, generator)

    def _forward_tp(self, x):
        """Tensor-parallel MLP: this tp rank's block of the 4E hidden
        units, the partial outputs summed over tp."""
        mesh, dt = self.tp_mesh, self.cfg.dtype
        n, r = mesh.size("tp"), mesh.index("tp")
        F4 = self.c_fc.out_features
        cols = slice(r * F4 // n, (r + 1) * F4 // n)
        w = C.psum_backward(self.c_fc.weight, "tp", mesh)[cols]
        b = C.psum_backward(self.c_fc.bias, "tp", mesh)[cols]
        h = F.gelu(dense(C.psum_backward(x, "tp", mesh), w, b, dt),
                   approximate="tanh")
        wp = C.psum_backward(self.c_proj.weight, "tp", mesh)[:, cols]
        return (C.psum_forward(dense(h, wp, None, dt), "tp", mesh)
                + self.c_proj.bias.to(dt))


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
        self.tp_mesh = None
        self.sp_mesh = None
        self.wte = Embed(cfg.vocab_size, cfg.n_embd, cfg.dtype)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, cfg.dtype)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, impl))
        self.ln_f = LayerNorm(cfg.n_embd)

    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.cfg.n_layer)]

    def set_exact(self, exact: bool):
        """``exact=True`` sends the flash backend's training attention
        down the streaming path (the exact running-max softmax) whatever
        the shape."""
        for blk in self.blocks():
            blk.attn.exact = exact
        return self

    def set_mesh(self, mesh):
        """Split the attention heads, the MLP's hidden units and the tied
        head's contraction over ``mesh``'s tp axis, and the sequence
        over its sp axis (``set_blocks_mesh``)."""
        self.tp_mesh, self.sp_mesh = set_blocks_mesh(self.blocks(), self.cfg,
                                                     mesh)
        return self

    def position_offset(self, seq_len: int) -> int:
        """The global position of this rank's first token: its sp index
        times ``seq_len`` (0 without sp)."""
        mesh = self.sp_mesh
        return 0 if mesh is None else mesh.index("sp") * seq_len

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
                positions = ar + self.position_offset(S)
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
        """Weight-tied LM head in ``cfg.dtype`` (flax ``Embed.attend``).
        Under tp each rank multiplies its block of n_embd and the partial
        logits are summed over tp."""
        mesh = self.tp_mesh
        if mesh is None:
            return self.wte.attend(h)
        n, r = mesh.size("tp"), mesh.index("tp")
        E, dt = self.cfg.n_embd, self.cfg.dtype
        cols = slice(r * E // n, (r + 1) * E // n)
        w = C.psum_backward(self.wte.weight, "tp", mesh)[:, cols]
        part = C.psum_backward(h, "tp", mesh)[..., cols].to(dt) @ w.to(dt).T
        return C.psum_forward(part, "tp", mesh)

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

    def init_weights(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``
        (``init_flax_weights``)."""
        return init_flax_weights(self, generator)


def set_blocks_mesh(blocks, cfg: GPT2Config, mesh):
    """Set ``mesh`` on GPT-2 ``Block``s: under tp > 1 each tp rank
    computes its heads of the attention and its columns of the MLP
    (n_head and n_embd must divide by tp); under sp > 1 the rank's
    tokens are its slice of the sequence and attention runs through
    the ring. Returns (tp mesh, sp mesh), None where the axis has size
    1."""
    tp = mesh.size("tp")
    if tp > 1 and (cfg.n_head % tp or cfg.n_embd % tp):
        raise ValueError(f"tp={tp} must divide n_head={cfg.n_head} and "
                         f"n_embd={cfg.n_embd}")
    tp_mesh = mesh if tp > 1 else None
    sp_mesh = mesh if mesh.size("sp") > 1 else None
    for blk in blocks:
        blk.attn.tp_mesh = blk.mlp.tp_mesh = tp_mesh
        blk.attn.sp_mesh = sp_mesh
    return tp_mesh, sp_mesh


@torch.no_grad()
def init_flax_weights(module: nn.Module, generator: torch.Generator):
    """flax's initialisers on every Dense, Embed and LayerNorm of
    ``module`` in module order, drawn from ``generator``: lecun-normal
    Dense kernels (normal truncated at 2 sigma), zero biases, LayerNorm
    ones and zeros, Embed's normal(1 / sqrt(features))."""
    for mod in module.modules():
        if isinstance(mod, Dense):
            std = math.sqrt(1.0 / mod.in_features) / .87962566103423978
            mod.weight.copy_(_truncated_normal(mod.weight.shape,
                                               generator) * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Embed):
            w = torch.empty(mod.weight.shape)
            nn.init.normal_(w, std=mod.embedding_dim ** -0.5,
                            generator=generator)
            mod.weight.copy_(w)
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return module


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
    total, count = causal_lm_loss_terms(logits, labels, ignore_index)
    return total / count.clamp(min=1)


def causal_lm_loss_terms(logits, labels, ignore_index: int = -100,
                         next_labels=None):
    """``causal_lm_loss``'s sum over the counted tokens and their count
    (f32): on a mesh each batch shard gives its two, and the loss is
    the sum of the sums over the sum of the counts. ``next_labels``
    ([B, 1], for a slice of the sequence): the label of the position
    after the slice's last, so that its last logit is counted too
    (``ignore_index`` where the sequence ends)."""
    if next_labels is None:
        shift_logits = logits[:, :-1]
        shift_labels = labels[:, 1:].long()
    else:
        shift_logits = logits
        shift_labels = torch.cat([labels[:, 1:], next_labels], 1).long()
    mask = shift_labels != ignore_index
    safe = torch.where(mask, shift_labels, 0)
    m = shift_logits.detach().amax(dim=-1)
    sumexp = torch.exp((shift_logits - m[..., None]).float()).sum(dim=-1)
    lse = m.float() + torch.log(sumexp)
    ll = torch.gather(shift_logits, -1, safe[..., None])[..., 0].float()
    return ((lse - ll) * mask).sum(), mask.sum().float()


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


StateDict = Union[Mapping[str, torch.Tensor], str, "os.PathLike[str]"]


def read_state_dict(state_dict: StateDict) -> Mapping[str, torch.Tensor]:
    """A mapping as given, or the local file at a path, read onto the
    CPU by ``torch.load(weights_only=True)`` (an HF ``pytorch_model.bin``).
    Nothing is downloaded."""
    if isinstance(state_dict, (str, os.PathLike)):
        return torch.load(state_dict, map_location="cpu", weights_only=True)
    return state_dict


def load_hf_gpt2_params(state_dict: StateDict,
                        config: Optional[GPT2Config] = None,
                        model: Optional[GPT2] = None
                        ) -> Dict[str, torch.Tensor]:
    """An HF ``GPT2LMHeadModel`` state_dict (a mapping, or the path of a
    local file that ``torch.load`` reads) -> this module's
    ``state_dict`` in f32, for ``config.n_layer`` layers
    (``GPT2Config()`` by default). HF's Conv1D weights are [in, out], a
    flax kernel's layout, so each lands transposed in ``nn.Linear``; the
    head is tied to ``wte`` on both sides. With ``model`` the weights are
    also loaded into it. The counterpart of the JAX package's
    ``load_hf_gpt2_params``, which takes a model name and loads it with
    ``transformers``; this one reads local weights only."""
    sd = read_state_dict(state_dict)
    cfg = config or GPT2Config()

    def t(key, transpose=False):
        if key not in sd:
            raise KeyError(f"load_hf_gpt2_params: the state_dict has no "
                           f"{key!r} (n_layer={cfg.n_layer})")
        a = sd[key].detach().to("cpu", torch.float32)
        return (a.T if transpose else a).contiguous()

    out = {"wte.weight": t("transformer.wte.weight"),
           "wpe.weight": t("transformer.wpe.weight"),
           "ln_f.weight": t("transformer.ln_f.weight"),
           "ln_f.bias": t("transformer.ln_f.bias")}
    for i in range(cfg.n_layer):
        hf = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            out[f"h_{i}.{ln}.weight"] = t(hf + ln + ".weight")
            out[f"h_{i}.{ln}.bias"] = t(hf + ln + ".bias")
        for path in ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj"):
            out[f"h_{i}.{path}.weight"] = t(hf + path + ".weight", True)
            out[f"h_{i}.{path}.bias"] = t(hf + path + ".bias")
    if model is not None:
        model.load_state_dict(out)
    return out
