"""Llama-family decoder as ``nn.Module``s: the long-context training slice's model.

Counterpart of ``ray_tpu/models/llama.py`` (full forward) with the same
numerics:

  - module paths are flax's (``tok_embeddings``, ``layers_{i}.attention.wq``,
    ``layers_{i}.feed_forward.w1``, ``attention_norm``, ``ffn_norm``,
    ``norm``, ``output``), so weights carry across with
    ``params_from_flax``; no biases;
  - params are kept in f32 and every Dense and the embedding cast input
    and weight to ``cfg.dtype`` at every call, as flax does;
  - RMSNorm accumulates in f32 and returns the input's dtype, so the
    residual stream stays in ``cfg.dtype`` (bf16 in training);
  - rotary embeddings rotate halves (first half, second half) by angles
    made in f64 with numpy and stored as f32, as the JAX package does;
  - grouped-query attention repeats each kv head over its query group
    (``repeat_interleave``); SwiGLU MLP;
  - the LM head is an f32 Dense, not tied to the embedding.

``attention_backend="flash"`` runs ``ops.attention.flash_attention``:
the whole-kv kernels where ``_use_whole_kv`` holds (s <= 2048), the
streaming kernels otherwise (Llama-2's 4096 tokens); ``"reference"``
the plain attention; ``"ring"`` ``ops.ring_attention`` over the mesh's
sp axis (``set_mesh``; one causal block of the streaming kernels
without a mesh), the kv heads repeated over their query groups first,
as in the JAX package. With sp > 1 each rank holds its slice of the
sequence, rotated by its global positions, and every backend goes
through the ring (plain blocks for ``"reference"``).

With ``kv_cache`` the forward is one incremental step (the serving
slice): the new tokens are rotated by their absolute positions, the
un-replicated kv heads are written to a contiguous cache
(``init_kv_cache``) or one layer of the serve engine's paged pool, and
attention runs in ``ops.attention.cached_attention`` (single-token
paged steps in the paged-decode kernel). ``import_hf_llama`` maps a
local HF ``LlamaForCausalLM`` state_dict onto the modules.

The training step is the JAX package's example loop
(``examples/06_llama_finetune.py``): forward, ``causal_lm_loss``,
backward, ``optax.adamw(3e-4)`` -- here ``train_step`` with ``adamw``,
on a model from ``make_llama`` (on ``cuda`` unless ``device="cpu"``):

    model = make_llama(cfg, seed=0)
    opt = adamw(model.parameters())
    loss = train_step(model, opt, input_ids)     # ids on the model's device
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
from ray_tpu_torch.models.gpt2 import (Dense, Embed, StateDict,
                                       _truncated_normal, read_state_dict)
from ray_tpu_torch.ops.attention import (TRAINING_KERNELS, TRAINING_PLAIN,
                                         TrainingAttention, _repeat_kv,
                                         attention_reference,
                                         cached_attention, flash_attention,
                                         paged_attention_decode)
from ray_tpu_torch.ops.ring_attention import ring_attention

_BACKENDS = ("flash", "ring", "reference")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32          # < n_heads => grouped-query attention
    ffn_hidden: Optional[int] = None  # default: SwiGLU 8/3 * dim rounded
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attention_backend: str = "flash"  # flash | ring | reference

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.ffn_hidden is not None:
            return self.ffn_hidden
        # llama-2 sizing: 2/3 * 4d, rounded up to a multiple of 256
        h = int(2 * (4 * self.dim) / 3)
        return (h + 255) // 256 * 256

    @classmethod
    def llama2_7b(cls):
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 512):  # tests: GQA exercised
        return cls(vocab_size=vocab_size, max_seq_len=256, dim=128,
                   n_layers=2, n_heads=8, n_kv_heads=2,
                   dtype=torch.float32, attention_backend="reference")


class RMSNorm(nn.Module):
    """f32 accumulation whatever the input's dtype; returns that dtype."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                  + self.eps)
        return (normed * self.weight).to(x.dtype)


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float) -> torch.Tensor:
    """[S, D/2, 2] (cos, sin) of the rotation angles. The angles are made
    in f64 (an f32 product t * inv is ~2e-4 rad off at t = 4095) and the
    cos and sin stored as f32."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_seq_len), inv)
    return torch.from_numpy(
        np.stack([np.cos(freqs), np.sin(freqs)], -1).astype(np.float32))


def apply_rope(x, freqs, positions=None):
    """x [B, H, S, D]: rotate the (first half, second half) feature pairs
    by each position's angle, in f32, back to x's dtype. ``positions``
    ([B, S], optional) gives each token its absolute position."""
    S, D = x.shape[2], x.shape[3]
    if positions is None:
        cos, sin = freqs[:S, :, 0], freqs[:S, :, 1]       # [S, D/2]
    else:
        per = freqs[positions.long()]                    # [B, S, D/2, 2]
        cos, sin = per[..., 0][:, None], per[..., 1][:, None]
    x1, x2 = x[..., :D // 2].float(), x[..., D // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, impl: TrainingAttention):
        super().__init__()
        self.cfg = cfg
        self.impl = impl
        self.sp_mesh = None
        hd, dt = cfg.head_dim, cfg.dtype
        self.wq = Dense(cfg.dim, cfg.n_heads * hd, dt, bias=False)
        self.wk = Dense(cfg.dim, cfg.n_kv_heads * hd, dt, bias=False)
        self.wv = Dense(cfg.dim, cfg.n_kv_heads * hd, dt, bias=False)
        self.wo = Dense(cfg.n_heads * hd, cfg.dim, dt, bias=False)

    def forward(self, x, freqs, kv_cache=None, seq_lengths=None, valid=None,
                positions=None, paged_decode=paged_attention_decode):
        """Full attention, or with ``kv_cache`` one incremental step:
        returns (out, kv_cache), the cache updated in place."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def heads(t, n):  # [B,S,n*hd] -> [B,n,S,hd]
            return t.reshape(B, S, n, hd).transpose(1, 2)
        q = apply_rope(heads(self.wq(x), H), freqs, positions)
        k = apply_rope(heads(self.wk(x), Hkv), freqs, positions)
        v = heads(self.wv(x), Hkv)
        if kv_cache is not None:
            # the cache holds the Hkv heads; cached_attention broadcasts
            # them over each query group
            y, kv_cache = cached_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                kv_cache, seq_lengths, valid=valid, paged_decode=paged_decode)
            return self.wo(y.reshape(B, S, H * hd)), kv_cache
        k, v = _repeat_kv(k, H // Hkv), _repeat_kv(v, H // Hkv)
        backend = cfg.attention_backend
        if backend == "ring" or self.sp_mesh is not None:
            y = ring_attention(
                q, k, v, mesh=self.sp_mesh, causal=True,
                impl=TRAINING_PLAIN if backend == "reference" else self.impl)
        elif backend == "flash":
            y = flash_attention(q, k, v, causal=True, impl=self.impl)
        else:
            y = attention_reference(q, k, v, causal=True)
        return self.wo(y.transpose(1, 2).reshape(B, S, H * hd))


class LlamaMLP(nn.Module):
    """SwiGLU: w2(silu(w1 x) * w3 x)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        dt = cfg.dtype
        self.w1 = Dense(cfg.dim, cfg.ffn_dim, dt, bias=False)
        self.w3 = Dense(cfg.dim, cfg.ffn_dim, dt, bias=False)
        self.w2 = Dense(cfg.ffn_dim, cfg.dim, dt, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, impl: TrainingAttention):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.attention = LlamaAttention(cfg, impl)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.feed_forward = LlamaMLP(cfg)

    def forward(self, x, freqs, kv_cache=None, seq_lengths=None, valid=None,
                positions=None, paged_decode=paged_attention_decode):
        if kv_cache is not None:
            y, kv_cache = self.attention(
                self.attention_norm(x), freqs, kv_cache, seq_lengths, valid,
                positions, paged_decode)
            x = x + y
            return x + self.feed_forward(self.ffn_norm(x)), kv_cache
        x = x + self.attention(self.attention_norm(x), freqs)
        return x + self.feed_forward(self.ffn_norm(x))


class LlamaModel(nn.Module):
    """Decoder LM: tokens [B, S] -> f32 logits [B, S, vocab].

    ``impl`` picks what the flash backend runs: the attention kernels
    (default) or, to compare one with the other, their plain versions
    (``ops.attention.TRAINING_PLAIN``)."""

    def __init__(self, cfg: LlamaConfig,
                 impl: TrainingAttention = TRAINING_KERNELS):
        super().__init__()
        if cfg.attention_backend not in _BACKENDS:
            raise ValueError(f"attention_backend={cfg.attention_backend!r}: "
                             f"one of {_BACKENDS}")
        self.cfg = cfg
        self.sp_mesh = None
        self.tok_embeddings = Embed(cfg.vocab_size, cfg.dim, cfg.dtype)
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}",
                            LlamaBlock(cfg, impl))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.output = Dense(cfg.dim, cfg.vocab_size, torch.float32,
                            bias=False)
        self.register_buffer("freqs", rope_frequencies(
            cfg.head_dim, cfg.max_seq_len, cfg.rope_theta), persistent=False)

    def blocks(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.n_layers)]

    def set_mesh(self, mesh):
        """Split the sequence over ``mesh``'s sp axis: each rank's tokens
        are its slice, rotated by their global positions, and attention
        runs through the ring. Nothing else is split: tp must be 1."""
        if mesh.size("tp") > 1:
            raise ValueError("LlamaModel splits only the sequence over a "
                             f"mesh; tp={mesh.size('tp')}")
        self.sp_mesh = mesh if mesh.size("sp") > 1 else None
        for blk in self.blocks():
            blk.attention.sp_mesh = self.sp_mesh
        return self

    def trunk(self, input_ids, kv_cache=None, seq_lengths=None, valid=None,
              paged_decode=paged_attention_decode):
        """Everything before ``head``: the last block's output, [B, S,
        dim] in ``cfg.dtype``. With ``kv_cache`` (a list of per-layer
        caches, updated in place) the S tokens are one incremental step
        after ``seq_lengths`` cached tokens, each rotated by its absolute
        position; ``valid`` marks real tokens when S is padded (padding
        takes position 0, as in the JAX package)."""
        x = self.tok_embeddings(input_ids)
        if kv_cache is None:
            # under sp the rank's tokens start at its slice's position
            freqs = self.freqs
            if self.sp_mesh is not None:
                S = input_ids.shape[1]
                freqs = freqs[self.sp_mesh.index("sp") * S:]
            for block in self.blocks():
                x = block(x, freqs)
            return x
        S = input_ids.shape[1]
        positions = seq_lengths[:, None].long() + torch.arange(
            S, device=input_ids.device)[None, :]
        if valid is not None:
            positions = torch.where(valid, positions, 0)
        for i, block in enumerate(self.blocks()):
            x, _ = block(x, self.freqs, kv_cache[i], seq_lengths, valid,
                         positions, paged_decode)
        return x

    def head(self, h):
        """The final RMSNorm and the f32 ``output`` Dense: f32 logits."""
        return self.output(self.norm(h))

    def forward(self, input_ids, kv_cache=None, seq_lengths=None, valid=None,
                paged_decode=paged_attention_decode):
        """Full forward (f32 logits [B, S, vocab]) or, with ``kv_cache``,
        one incremental step returning ``(logits, kv_cache)``; prefill is
        the ``seq_lengths == 0`` case."""
        logits = self.head(self.trunk(input_ids, kv_cache, seq_lengths, valid,
                                      paged_decode))
        return (logits, kv_cache) if kv_cache is not None else logits

    @torch.no_grad()
    def to_compute_dtype(self):
        """Store each Dense and the embedding in the dtype it computes
        in (serving: half the memory at bf16, no per-call casts, the same
        values): the blocks' Dense kernels and the embedding in
        ``cfg.dtype``; the ``output`` head stays f32, as do the RMSNorm
        weights. Not for training: optimizer updates need f32."""
        for mod in self.modules():
            if isinstance(mod, (Dense, Embed)):
                mod.to(mod.compute_dtype)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator`` on its device (a
        CUDA generator draws the 7B-wide weights on the card): lecun-normal
        Dense kernels (normal truncated at 2 sigma), Embed's
        normal(1 / sqrt(features)), RMSNorm ones."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                std = math.sqrt(1.0 / mod.in_features) / .87962566103423978
                mod.weight.copy_(_truncated_normal(mod.weight.shape,
                                                   generator) * std)
            elif isinstance(mod, Embed):
                mod.weight.copy_(torch.randn(
                    mod.weight.shape, generator=generator,
                    device=generator.device) * mod.embedding_dim ** -0.5)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        return self


def make_llama(cfg: LlamaConfig, seed: int = 0, *,
               impl: TrainingAttention = TRAINING_KERNELS,
               device="cuda") -> LlamaModel:
    """The Llama slice's entry point: a ``LlamaModel`` built on
    ``device`` (``cuda`` unless the caller asks for ``cpu``) and
    initialised with flax's laws from a generator on that device seeded
    with ``seed``. Built in place, not moved: a 7B-wide init on the host
    takes longer than the training steps that follow it."""
    dev = resolve_device(device)
    with dev:
        model = LlamaModel(cfg, impl=impl)
    model.to(dev)                   # the rope table is made on the host
    return model.init_weights(torch.Generator(dev).manual_seed(seed))


def init_kv_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
                  device="cuda"):
    """Per-layer contiguous KV caches for incremental decode ([B, S_max,
    Hkv, D] token-major: the un-replicated kv heads), in ``cfg.dtype`` on
    ``cuda`` unless the caller asks for ``cpu``."""
    device = resolve_device(device)
    shape = (batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def causal_lm_loss(logits, input_ids):
    """Next-token cross-entropy in f32, mean over B * (S - 1): no labels
    argument and no ignore index, as in the JAX package."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, input_ids[:, 1:, None].long())[..., 0]
    return nll.mean()


def adamw(params, learning_rate: float = 3e-4):
    """``optax.adamw(learning_rate)`` with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, weight_decay 1e-4), decaying every leaf as optax
    does. Not the GPT-2 trainer's (b2 0.95, weight_decay 0.1)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def train_step(model: LlamaModel, opt: torch.optim.Optimizer, input_ids):
    """One step of the example loop: forward, ``causal_lm_loss``,
    backward, the optimizer's update (in place). Returns the loss, a 0-d
    tensor on the model's device (not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = causal_lm_loss(model(input_ids), input_ids)
    loss.backward()
    opt.step()
    return loss.detach()


def params_from_flax(tree: Dict[str, Any],
                     model: Optional[LlamaModel] = None
                     ) -> Dict[str, torch.Tensor]:
    """flax Llama params (``{"params": {...}}``, arrays or anything
    ``np.asarray`` takes) -> this module's ``state_dict`` in f32 (a flax
    Dense kernel [in, out] lands transposed). With ``model`` the weights
    are also loaded into it."""
    p = tree["params"]

    def t(x, transpose=False):
        a = torch.from_numpy(np.array(np.asarray(x), np.float32))
        return a.T.contiguous() if transpose else a

    sd: Dict[str, torch.Tensor] = {
        "tok_embeddings.weight": t(p["tok_embeddings"]["embedding"]),
        "norm.weight": t(p["norm"]["weight"]),
        "output.weight": t(p["output"]["kernel"], True),
    }
    for name in sorted(k for k in p if k.startswith("layers_")):
        blk = p[name]
        for norm in ("attention_norm", "ffn_norm"):
            sd[f"{name}.{norm}.weight"] = t(blk[norm]["weight"])
        for sub, denses in (("attention", ("wq", "wk", "wv", "wo")),
                            ("feed_forward", ("w1", "w2", "w3"))):
            for d in denses:
                sd[f"{name}.{sub}.{d}.weight"] = t(blk[sub][d]["kernel"],
                                                   True)
    if model is not None:
        model.load_state_dict(sd)
    return sd


def import_hf_llama(state_dict: StateDict, cfg: LlamaConfig,
                    model: Optional[LlamaModel] = None
                    ) -> Dict[str, torch.Tensor]:
    """An HF ``LlamaForCausalLM`` state_dict (a mapping, or the path of a
    local file that ``torch.load`` reads) -> this module's
    ``state_dict`` in f32, for ``cfg.n_layers`` layers. HF's Linear
    weights are [out, in] like ``nn.Linear``'s and its rotary layout is
    this module's rotate-half, so nothing is transposed or permuted.
    With ``model`` the weights are also loaded into it. The counterpart
    of the JAX package's ``import_hf_llama``, without ``transformers``."""
    sd = read_state_dict(state_dict)

    def t(key):
        if key not in sd:
            raise KeyError(f"import_hf_llama: the state_dict has no {key!r} "
                           f"(cfg.n_layers={cfg.n_layers})")
        return sd[key].detach().to("cpu", torch.float32).contiguous()

    out = {"tok_embeddings.weight": t("model.embed_tokens.weight"),
           "norm.weight": t("model.norm.weight"),
           "output.weight": t("lm_head.weight")}
    hf = {"attention_norm": "input_layernorm",
          "ffn_norm": "post_attention_layernorm",
          "attention.wq": "self_attn.q_proj", "attention.wk": "self_attn.k_proj",
          "attention.wv": "self_attn.v_proj", "attention.wo": "self_attn.o_proj",
          "feed_forward.w1": "mlp.gate_proj", "feed_forward.w3": "mlp.up_proj",
          "feed_forward.w2": "mlp.down_proj"}
    for i in range(cfg.n_layers):
        for ours, theirs in hf.items():
            out[f"layers_{i}.{ours}.weight"] = t(
                f"model.layers.{i}.{theirs}.weight")
    if model is not None:
        model.load_state_dict(out)
    return out
