"""Attention: reference, training (flash), cached and paged decode.

Counterpart of ``ray_tpu/ops/attention.py`` (the parts the serving and
training slices run). Layouts are the JAX package's, so the two can be
compared input for input:

  q                 [B, H, D] (decode) or [B, H, S, D]
  k/v pages         [P, bs, Hkv, D]; page 0 is the null page
  block tables      [B, NB] int32 (physical page per logical block)
  lengths           [B] int32

Paths:
  attention_reference         full attention (causal, segment ids)
  flash_attention             training attention with its own backward:
                              the whole-kv kernels
                              (kernels/csrc/whole_attention.cu) where
                              ``_use_whole_kv`` holds, the streaming
                              flash-v2 kernels
                              (kernels/csrc/flash_attention.cu: exact
                              running-max softmax, top-left causal)
                              otherwise
  decode_attention            new-token queries against a contiguous,
                              padded cache (prefill and multi-token
                              steps; plain tensor code)
  paged_attention_reference   gather the pages, then decode_attention:
                              the plain version of the kernel
  paged_attention_decode      single-token decode in the hand-written
                              CUDA kernel (kernels/csrc/paged_decode.cu)
                              for CUDA tensors; the plain version for
                              CPU tensors
  cached_attention            one incremental step for the models:
                              append, then the kernel when S == 1, else
                              gather + decode_attention

Masked logits are -1e30, never -inf: a page (or kv tile) wholly past a
sequence's length or the causal diagonal then adds exactly 0, which
lets a kernel stop early and still compute the same function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ray_tpu_torch import kernels

_NEG_INF = -1e30
_KERNEL_THREADS = 128      # kThreads in paged_decode.cu
_KERNEL_MAX_ACC = 8        # kMaxAcc in paged_decode.cu
_KERNEL_SMEM_MAX = 48 * 1024
_KERNEL_TILE_TOKENS = 64   # tokens per tile the kernel aims for


def attention_reference(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        segment_ids=None):
    """q, k, v [B, H, S, D] -> [B, H, Sq, D]; f32 logits and softmax,
    probabilities cast to v's dtype before the product with v.
    ``segment_ids`` = (q_seg [B, Sq], k_seg [B, Sk]): a query attends
    only to keys of its own segment (packed sequences)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    seq_q, seq_k = q.shape[2], k.shape[2]
    if causal:
        qi = torch.arange(seq_q, device=q.device)[:, None] + (seq_k - seq_q)
        ki = torch.arange(seq_k, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, _NEG_INF)
    if segment_ids is not None:
        q_seg, k_seg = segment_ids
        same = q_seg[:, None, :, None] == k_seg[:, None, None, :]
        logits = logits.masked_fill(~same, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Training attention: whole-kv kernels and flash_attention
#
# For self-attention at s <= _WHOLE_KV_MAX_S the JAX package runs the
# whole-kv kernels: no running max, a static shift with an overflow cap
# (exp(min(s, _CAP_HI) - _CAP_SHIFT)), exact while pre-scaled logits
# stay under _CAP_HI. The predicate that picks them is reproduced
# exactly, because it chooses the numerics. ``exact=None`` means False:
# the JAX package's RTPU_ATTN_EXACT / RTPU_ATTN_DEBUG env fallbacks are
# not carried over (pass ``exact=`` / ``debug=``).

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
_WHOLE_KV_MAX_S = 2048
_CAP_HI = 50.0             # logit cap: exp(50-25)=7e10 << f32 max
_CAP_SHIFT = 25.0
_WHOLE_TILE = 64                        # kTile in whole_attention.cu
_HEAD_DIMS = (16, 32, 64, 128)          # head dims the attention kernels take


def _whole_block_q(s: int) -> int:
    bq = max(128, min(s, (4 << 20) // (4 * s) // 128 * 128))
    while s % bq:
        bq //= 2
    return max(bq, 128)


def _use_whole_kv(sq: int, sk: int, d: int,
                  exact: Optional[bool] = None) -> bool:
    if exact:
        return False
    return (sq == sk and sk <= _WHOLE_KV_MAX_S and d <= 128
            and sk % 128 == 0 and sq % _whole_block_q(sq) == 0)


def _debug_check_logits(q_scaled, k):
    """Debug-mode range check for the whole-kv path: the static-shift
    softmax is exact only while every pre-softmax logit stays under
    ``_CAP_HI``; beyond it the clamp flattens the distribution. Builds
    the full score matrix and syncs: debugging only."""
    s_max = float(torch.einsum("bhqd,bhkd->bhqk", q_scaled.float(),
                               k.float()).max())
    if s_max > _CAP_HI:
        raise FloatingPointError(
            f"flash_attention whole-kv fast path: max scaled logit "
            f"{s_max:.3f} exceeds the static softmax cap "
            f"_CAP_HI={_CAP_HI}: the clamp would silently distort the "
            f"distribution. Pass exact=True to use the exact streaming "
            f"path, or rescale the logits.")


def _causal_keep(s: int, device):
    """[s, s] bool, True where key <= query."""
    i = torch.arange(s, device=device)
    return i[None, :] <= i[:, None]


def whole_attention_forward_reference(q, k, v, *, causal: bool):
    """Plain version of the whole-kv forward kernel, same rounding
    points. q (pre-scaled), k, v [B, H, S, D] -> (o [B, H, S, D] in
    q's dtype, lse [B, H, S] f32)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    e = torch.exp(torch.clamp(s, max=_CAP_HI) - _CAP_SHIFT)
    if causal:
        e = e.masked_fill(~_causal_keep(q.shape[2], q.device), 0.0)
    l = torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), torch.log(l[..., 0]) + _CAP_SHIFT


def _delta(o, do):
    """rowsum(o * do) in f32: computed outside the backward kernel, as
    ``_whole_backward`` does in XLA."""
    return (o.float() * do.float()).sum(-1)


def whole_attention_backward_reference(q, k, v, o, lse, do, *,
                                       causal: bool):
    """Plain version of the whole-kv backward kernel, same rounding
    points (ds and p rounded to the input dtype before their products;
    dk and dv summed over all q rows in f32 and rounded once).
    Returns (dq, dk, dv) in the inputs' dtype."""
    delta = _delta(o, do)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.exp(torch.clamp(s, max=_CAP_HI) - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[2], q.device), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def whole_attention_forward_f64(q, k, v, *, causal: bool):
    """The whole-kv forward's function in f64 with no rounding point (e
    is not rounded before e.v, o is not rounded): the yardstick that a
    bf16 kernel and its plain version are both measured against, since
    both round. Returns (o, lse) in f64."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double())
    e = torch.exp(torch.clamp(s, max=_CAP_HI) - _CAP_SHIFT)
    if causal:
        e = e.masked_fill(~_causal_keep(q.shape[2], q.device), 0.0)
    l = torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", e, v.double()) / l
    return o, torch.log(l[..., 0]) + _CAP_SHIFT


def whole_attention_backward_f64(q, k, v, o, lse, do, *, causal: bool):
    """The whole-kv backward's function in f64 with no rounding point,
    from the same o and lse: the backward's yardstick. Returns (dq, dk,
    dv) in f64."""
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    delta = (o * do).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    p = torch.exp(torch.clamp(s, max=_CAP_HI) - lse.double()[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[2], q.device), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, v) - delta)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q),
            torch.einsum("bhqk,bhqd->bhkd", p, do))


def error_ratios(out, plain, ref):
    """(max, rms) of |out - ref| over the same of |plain - ref|: how far
    a kernel's output strays from a yardstick, in units of its plain
    version's own distance from it. Near 1 when the two make errors of
    one kind (the same rounding points); a skipped tile or a wrong mask
    adds an error of its own and drives the ratios up."""
    ref = ref.double()
    e_out = (out.double() - ref).abs()
    e_plain = (plain.double() - ref).abs()
    tiny = torch.finfo(torch.float64).tiny
    return (float(e_out.max() / e_plain.max().clamp(min=tiny)),
            float(e_out.square().mean().sqrt()
                  / e_plain.square().mean().sqrt().clamp(min=tiny)))


def _check_attention_args(name, q, k, v, like_q=(), rows=(),
                          seq_multiple=16):
    """What the attention kernels take: q (and ``like_q``: o, do) [B, H,
    Sq, D], k, v [B, H, Sk, D], ``rows`` (lse, delta) [B, H, Sq] f32;
    bf16 or f32; D in _HEAD_DIMS; Sq, Sk positive multiples of
    ``seq_multiple``; contiguous, 16-byte aligned, on one device."""
    tensors = [q, k, v, *like_q]
    every = tensors + list(rows)
    if any(t.device != q.device for t in every):
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{[str(t.device) for t in every]}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {q.dtype} is not supported "
                        "(bfloat16, float32)")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v (and o, do) must share one dtype")
    if any(t.dtype != torch.float32 for t in rows):
        raise TypeError(f"{name}: lse and delta must be float32")
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or any(t.shape != q.shape for t in like_q)
            or any(t.shape != q.shape[:3] for t in rows)):
        raise ValueError(
            f"{name}: want q (o, do) [B, H, Sq, D], k, v [B, H, Sk, D], "
            f"lse/delta [B, H, Sq]; got {[tuple(t.shape) for t in every]}")
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} is not one the kernel "
                         f"takes {_HEAD_DIMS}")
    if Sq % seq_multiple or Sk % seq_multiple or not Sq * Sk:
        raise ValueError(f"{name}: sequence lengths {Sq}, {Sk} must be "
                         f"positive multiples of {seq_multiple}")
    if not all(t.is_contiguous() for t in every):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in every):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _check_whole_args(name, q, k, v, like_q=(), rows=()):
    """The whole-kv kernels take self-attention only, in 64-row tiles."""
    if k.shape != q.shape:
        raise ValueError(f"{name}: want q, k, v of one shape [B, H, S, D] "
                         f"(self-attention), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    _check_attention_args(name, q, k, v, like_q, rows, _WHOLE_TILE)


def _attention_lib(name, n_ints, n_pointers):
    """Kernel library ``name`` with its C signatures set: for each
    function in ``n_pointers``, that many pointers, ``n_ints`` ints (the
    dtype flag, dims, causal) and the stream; each returns an int."""
    lib = kernels.load(name)
    for fn, n_ptr in n_pointers.items():
        f = getattr(lib, fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_ints
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return lib


@functools.cache
def _whole_lib():
    return _attention_lib("whole_attention", 5, {
        "rtt_whole_attention_fwd": 5, "rtt_whole_attention_bwd": 9})


def _no_kernel(name, device):
    raise ValueError(f"{name}: no kernel for device {device}")


def _launch(lib, fn, name, ptrs, dims, causal):
    """Launch one attention kernel (C function ``fn`` of ``lib``) on the
    current stream of ptrs[0]'s device: pointers, the dtype flag,
    ``dims``, causal, the stream. Checks the launch and counts it."""
    q = ptrs[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn)(*(t.data_ptr() for t in ptrs),
                               1 if q.dtype == torch.bfloat16 else 0, *dims,
                               int(causal), stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)


def whole_attention_forward(q, k, v, *, causal: bool):
    """Whole-kv attention forward: q (pre-scaled), k, v [B, H, S, D] ->
    (o, lse f32 [B, H, S]).

    CUDA tensors go to the hand-written sm_90a kernel (counted as
    ``whole_attention_forward``); CPU tensors to the plain version,
    ``whole_attention_forward_reference``. Anything the kernel does not
    take raises; nothing falls back."""
    if q.device.type == "cpu":
        return whole_attention_forward_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        _no_kernel("whole_attention_forward", q.device)
    _check_whole_args("whole_attention_forward", q, k, v)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    _launch(_whole_lib(), "rtt_whole_attention_fwd", "whole_attention_forward",
            (q, k, v, out, lse), (B * H, S, D), causal)
    return out, lse


def whole_attention_backward(q, k, v, o, lse, do, *, causal: bool):
    """Whole-kv attention backward -> (dq, dk, dv) for q pre-scaled.

    ``delta = rowsum(o * do)`` is one PyTorch op here; CUDA tensors then
    go to the hand-written sm_90a kernel (one launch that computes dq,
    dk and dv; counted as ``whole_attention_backward``), CPU tensors to
    ``whole_attention_backward_reference``. Nothing falls back."""
    if q.device.type == "cpu":
        return whole_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal=causal)
    if q.device.type != "cuda":
        _no_kernel("whole_attention_backward", q.device)
    _check_whole_args("whole_attention_backward", q, k, v, (o, do), (lse,))
    B, H, S, D = q.shape
    delta = _delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch(_whole_lib(), "rtt_whole_attention_bwd", "whole_attention_backward",
            (q, k, v, do, lse, delta, dq, dk, dv), (B * H, S, D), causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Streaming attention (flash-v2): the exact running-max softmax the JAX
# package runs where ``_use_whole_kv`` does not hold (exact=True,
# sq != sk, s > 2048). No logit cap. The causal mask is aligned
# top-left, as in the Pallas kernels: query row r sees keys 0..r,
# whatever sk - sq is (``attention_reference`` aligns bottom-right; the
# two agree where sq == sk, as for every in-repo caller).

def _fit_block(block: int, s: int) -> int:
    """The JAX auto mode's block for a sequence of ``s``: ``block``
    halved until it divides ``s`` (under 16 means the shape cannot be
    tiled)."""
    b = min(block, s)
    while b >= 16 and s % b:
        b //= 2
    return b


def _masked(s, rows, keys, causal: bool):
    """Scores with -1e30 where a key lies right of its row (causal,
    top-left); ``rows`` and ``keys`` are the absolute positions."""
    if not causal:
        return s
    return s.masked_fill(keys[None, :] > rows[:, None], _NEG_INF)


def _n_kv_blocks(sq: int, sk: int, block_k: int, causal: bool) -> int:
    """kv blocks some row reaches; causal blocks past the last row's
    diagonal add exactly 0 (p = exp(-1e30 - m) = 0), so they are skipped."""
    n = -(-sk // block_k)
    return min(n, -(-sq // block_k)) if causal else n


def flash_attention_forward_reference(q, k, v, *, causal: bool,
                                      block_k: Optional[int] = None):
    """Plain version of the streaming forward kernel (``_fwd_kernel``),
    with its rounding points: kv blocks of ``block_k`` (default: the
    block ``flash_attention`` fits to Sk by default) walked with a
    running max m and sum l in f32; p = exp(s - m_new) rounded to v's
    dtype before p.v, l from the unrounded p; o = acc / max(l, 1e-30)
    rounded to q's dtype, lse = m + log max(l, 1e-30). Masked logits
    are -1e30 (top-left causal). q (pre-scaled) [B, H, Sq, D], k, v
    [B, H, Sk, D] -> (o, lse f32 [B, H, Sq])."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_k = block_k or _fit_block(DEFAULT_BLOCK_K, Sk)
    dev = q.device
    qf = q.float()
    rows = torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq, 1), _NEG_INF, device=dev)
    l = torch.zeros(B, H, Sq, 1, device=dev)
    acc = torch.zeros(B, H, Sq, D, device=dev)
    for j in range(_n_kv_blocks(Sq, Sk, block_k, causal)):
        cols = slice(j * block_k, (j + 1) * block_k)
        kj, vj = k[:, :, cols].float(), v[:, :, cols]
        keys = torch.arange(j * block_k, j * block_k + kj.shape[2],
                            device=dev)
        s = _masked(torch.einsum("bhqd,bhkd->bhqk", qf, kj), rows, keys,
                    causal)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vj.float())
        m = m_new
    l = l.clamp(min=1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_backward_dkv_reference(q, k, v, do, lse, delta, *,
                                           causal: bool,
                                           block_q: Optional[int] = None):
    """Plain version of the dkv kernel (``_bwd_dkv_kernel``): over q
    blocks of ``block_q`` (default: fitted to Sq, as in the forward),
    p = exp(s - lse) (0 where masked),
    dv += (p rounded to do's dtype)^T . do, ds = p (dp - delta) rounded
    to q's dtype, dk += ds^T . q; dk, dv summed in f32 and rounded
    once. Returns (dk, dv)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_q = block_q or _fit_block(DEFAULT_BLOCK_Q, Sq)
    dev = q.device
    kf, vf = k.float(), v.float()
    keys = torch.arange(Sk, device=dev)
    dk = torch.zeros(B, H, Sk, D, device=dev)
    dv = torch.zeros(B, H, Sk, D, device=dev)
    for i in range(-(-Sq // block_q)):
        rs = slice(i * block_q, (i + 1) * block_q)
        qi, doi = q[:, :, rs].float(), do[:, :, rs].float()
        rows = torch.arange(i * block_q, i * block_q + qi.shape[2],
                            device=dev)
        s = _masked(torch.einsum("bhqd,bhkd->bhqk", qi, kf), rows, keys,
                    causal)
        p = torch.exp(s - lse[:, :, rs, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), doi)
        dp = torch.einsum("bhqd,bhkd->bhqk", doi, vf)
        ds = (p * (dp - delta[:, :, rs, None])).to(q.dtype).float()
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qi)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_dq_reference(q, k, v, do, lse, delta, *,
                                          causal: bool,
                                          block_k: Optional[int] = None):
    """Plain version of the dq kernel (``_bwd_dq_kernel``): over kv
    blocks of ``block_k`` (default: fitted to Sk), ds = p (dp - delta) rounded to k's dtype,
    dq += ds . k, summed in f32 and rounded once. Returns dq."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_k = block_k or _fit_block(DEFAULT_BLOCK_K, Sk)
    dev = q.device
    qf, dof = q.float(), do.float()
    rows = torch.arange(Sq, device=dev)
    dq = torch.zeros(B, H, Sq, D, device=dev)
    for j in range(_n_kv_blocks(Sq, Sk, block_k, causal)):
        cols = slice(j * block_k, (j + 1) * block_k)
        kj, vj = k[:, :, cols].float(), v[:, :, cols].float()
        keys = torch.arange(j * block_k, j * block_k + kj.shape[2],
                            device=dev)
        s = _masked(torch.einsum("bhqd,bhkd->bhqk", qf, kj), rows, keys,
                    causal)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vj)
        ds = (p * (dp - delta[..., None])).to(k.dtype).float()
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kj)
    return dq.to(q.dtype)


def _head_slices(n_heads: int, sq: int, sk: int, budget: int = 1 << 29):
    """Slices of the b*h heads, each small enough that one f64 [n, sq,
    sk] matrix stays under ``budget`` bytes (the f64 yardsticks hold a
    few such at once)."""
    n = max(1, budget // (8 * sq * sk))
    return [slice(i, min(i + n, n_heads)) for i in range(0, n_heads, n)]


def flash_attention_forward_f64(q, k, v, *, causal: bool):
    """The streaming forward's function in f64 with no rounding point:
    the exact softmax, top-left causal. The yardstick that a bf16 kernel
    and its plain version are both measured against; computed a few
    heads at a time. Returns (o, lse) in f64."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dev = q.device
    q3, k3, v3 = (t.reshape(B * H, -1, D) for t in (q, k, v))
    rows, keys = torch.arange(Sq, device=dev), torch.arange(Sk, device=dev)
    o = torch.empty(B * H, Sq, D, dtype=torch.float64, device=dev)
    lse = torch.empty(B * H, Sq, dtype=torch.float64, device=dev)
    for hs in _head_slices(B * H, Sq, Sk):
        s = _masked(torch.einsum("nqd,nkd->nqk", q3[hs].double(),
                                 k3[hs].double()), rows, keys, causal)
        lse[hs] = torch.logsumexp(s, -1)
        o[hs] = torch.einsum("nqk,nkd->nqd", torch.exp(s - lse[hs, :, None]),
                             v3[hs].double())
    return o.reshape(B, H, Sq, D), lse.reshape(B, H, Sq)


def flash_attention_backward_f64(q, k, v, o, lse, do, *, causal: bool):
    """The streaming backward's function in f64 with no rounding point,
    from the same o and lse (delta = rowsum(o * do) in f64): the
    backward's yardstick, a few heads at a time. Returns (dq, dk, dv)
    in f64."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dev = q.device
    q3, o3, do3 = (t.reshape(B * H, Sq, D) for t in (q, o, do))
    k3, v3 = (t.reshape(B * H, Sk, D) for t in (k, v))
    lse3 = lse.reshape(B * H, Sq)
    rows, keys = torch.arange(Sq, device=dev), torch.arange(Sk, device=dev)
    out = [torch.empty(B * H, n, D, dtype=torch.float64, device=dev)
           for n in (Sq, Sk, Sk)]
    for hs in _head_slices(B * H, Sq, Sk):
        qq, kk, vv, oo, dd = (t[hs].double() for t in (q3, k3, v3, o3, do3))
        s = _masked(torch.einsum("nqd,nkd->nqk", qq, kk), rows, keys, causal)
        p = torch.exp(s - lse3[hs].double()[..., None])
        ds = p * (torch.einsum("nqd,nkd->nqk", dd, vv)
                  - (oo * dd).sum(-1, keepdim=True))
        out[0][hs] = torch.einsum("nqk,nkd->nqd", ds, kk)
        out[1][hs] = torch.einsum("nqk,nqd->nkd", ds, qq)
        out[2][hs] = torch.einsum("nqk,nqd->nkd", p, dd)
    return tuple(t.reshape(B, H, -1, D) for t in out)


@functools.cache
def _flash_lib():
    return _attention_lib("flash_attention", 6, {
        "rtt_flash_attention_fwd": 5, "rtt_flash_attention_bwd_dkv": 8,
        "rtt_flash_attention_bwd_dq": 7})


def flash_resource_usage():
    """ptxas's report on each streaming-kernel instance
    (``kernels.resource_usage``) with ``smem_bytes``, the dynamic shared
    memory per CTA that its launch sets. Builds the library: needs
    ``nvcc``."""
    f = _flash_lib().rtt_flash_attention_smem_bytes
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_longlong
    out = kernels.resource_usage("flash_attention")
    for r in out:
        which = ("fwd", "dkv", "dq").index(r["kernel"].split("_")[1])
        r["smem_bytes"] = f(which, 0 if r["kernel"].endswith("_kernel") else 1,
                            r["d"])
    return out


def _flash_dims(q, k):
    B, H, Sq, D = q.shape
    return (B * H, Sq, k.shape[2], D)


def flash_attention_forward(q, k, v, *, causal: bool):
    """Streaming attention forward: q (pre-scaled) [B, H, Sq, D], k, v
    [B, H, Sk, D] -> (o, lse f32 [B, H, Sq]).

    CUDA tensors go to the hand-written sm_90a kernel (64-row tiles;
    counted as ``flash_attention_forward``); CPU tensors to the plain
    version, ``flash_attention_forward_reference`` at its default
    blocks. Anything the kernel does not take raises; nothing falls
    back."""
    name = "flash_attention_forward"
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        _no_kernel(name, q.device)
    _check_attention_args(name, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(_flash_lib(), "rtt_flash_attention_fwd", name, (q, k, v, out, lse),
            _flash_dims(q, k), causal)
    return out, lse


def flash_attention_backward_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """Streaming backward, the dkv pass -> (dk, dv). ``delta`` is
    rowsum(o * do) in f32 (``_delta``). CUDA tensors go to the kernel
    (counted as ``flash_attention_backward_dkv``), CPU tensors to
    ``flash_attention_backward_dkv_reference``. Nothing falls back."""
    name = "flash_attention_backward_dkv"
    if q.device.type == "cpu":
        return flash_attention_backward_dkv_reference(
            q, k, v, do, lse, delta, causal=causal)
    if q.device.type != "cuda":
        _no_kernel(name, q.device)
    _check_attention_args(name, q, k, v, (do,), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_flash_lib(), "rtt_flash_attention_bwd_dkv", name,
            (q, k, v, do, lse, delta, dk, dv), _flash_dims(q, k), causal)
    return dk, dv


def flash_attention_backward_dq(q, k, v, do, lse, delta, *, causal: bool):
    """Streaming backward, the dq pass -> dq. CUDA tensors go to the
    kernel (counted as ``flash_attention_backward_dq``), CPU tensors to
    ``flash_attention_backward_dq_reference``. Nothing falls back."""
    name = "flash_attention_backward_dq"
    if q.device.type == "cpu":
        return flash_attention_backward_dq_reference(
            q, k, v, do, lse, delta, causal=causal)
    if q.device.type != "cuda":
        _no_kernel(name, q.device)
    _check_attention_args(name, q, k, v, (do,), (lse, delta))
    dq = torch.empty_like(q)
    _launch(_flash_lib(), "rtt_flash_attention_bwd_dq", name,
            (q, k, v, do, lse, delta, dq), _flash_dims(q, k), causal)
    return dq


class TrainingAttention(NamedTuple):
    """What ``flash_attention`` runs: the whole-kv pair and the streaming
    triple, as kernels (``TRAINING_KERNELS``) or, to compare one with the
    other, as their plain versions (``TRAINING_PLAIN``)."""
    whole_forward: object
    whole_backward: object
    forward: object
    backward_dkv: object
    backward_dq: object


TRAINING_KERNELS = TrainingAttention(
    whole_attention_forward, whole_attention_backward,
    flash_attention_forward, flash_attention_backward_dkv,
    flash_attention_backward_dq)
TRAINING_PLAIN = TrainingAttention(
    whole_attention_forward_reference, whole_attention_backward_reference,
    flash_attention_forward_reference, flash_attention_backward_dkv_reference,
    flash_attention_backward_dq_reference)


def _streaming(impl: TrainingAttention, q, blocks):
    """The streaming (forward, backward_dkv, backward_dq) that
    ``FlashAttention`` calls. A kernel wrapper runs on CUDA tensors with
    its own 64-row tiles; on CPU tensors it stands for its plain version.
    Plain versions run at the fitted ``blocks`` = (block_q, block_k)."""
    kernel_fns = TRAINING_KERNELS[2:]       # forward, backward_dkv, _dq
    fns = impl[2:]
    if q.device.type == "cpu":
        fns = [plain if f is kernel else f for f, kernel, plain in
               zip(fns, kernel_fns, TRAINING_PLAIN[2:])]
    bq, bk = blocks
    return [f if f in kernel_fns else functools.partial(f, **kw)
            for f, kw in zip(fns, ({"block_k": bk}, {"block_q": bq},
                                   {"block_k": bk}))]


class FlashAttention(torch.autograd.Function):
    """Attention with its own backward (``jax.custom_vjp`` in the JAX
    package) on ``impl``: the whole-kv pair where ``_use_whole_kv``
    holds, the streaming triple otherwise (``_streaming``). q arrives
    pre-scaled (sm_scale 1)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, exact, blocks, impl):
        whole = _use_whole_kv(q.shape[2], k.shape[2], q.shape[3], exact)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if whole:
            out, lse = impl.whole_forward(q, k, v, causal=causal)
        else:
            ctx.streaming = _streaming(impl, q, blocks)
            out, lse = ctx.streaming[0](q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.whole, ctx.impl = causal, whole, impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if ctx.whole:
            grads = ctx.impl.whole_backward(q, k, v, out, lse, do,
                                            causal=ctx.causal)
        else:
            _, backward_dkv, backward_dq = ctx.streaming
            delta = _delta(out, do)
            dk, dv = backward_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
            dq = backward_dq(q, k, v, do, lse, delta, causal=ctx.causal)
            grads = (dq, dk, dv)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    exact: Optional[bool] = None,
                    debug: Optional[bool] = None,
                    impl: TrainingAttention = TRAINING_KERNELS):
    """Fused attention with its own backward. [b, h, s, d] -> [b, h, s, d].

    The JAX package's dispatch, with a kernel wherever the TPU has one:
    shapes its auto mode cannot tile (blocks fitted to the sequence fall
    under 16) go to ``attention_reference``; otherwise sm_scale is
    folded into q here (autograd routes the matching dq scale through
    the multiply) and ``FlashAttention`` runs the whole-kv pair where
    ``_use_whole_kv`` holds, the streaming triple where it does not
    (exact=True, sq != sk, s > 2048, s not a multiple of 128).

    ``exact=True`` forces the streaming path (exact running-max softmax,
    for logits that may pass ``_CAP_HI``); None and False allow the
    whole-kv path. ``debug=True`` raises ``FloatingPointError`` when the
    whole-kv path would clamp a logit. ``impl`` picks the kernels
    (default) or, to compare against them, their plain versions
    (``TRAINING_PLAIN``). ``block_q`` and
    ``block_k`` decide, as in JAX, whether the shape can be tiled; the
    fitted blocks are the plain streaming versions' block sizes. The
    kernels take none: they use their own 64-row tiles.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    sq, sk = q.shape[2], k.shape[2]
    bq, bk = _fit_block(block_q, sq), _fit_block(block_k, sk)
    if bq < 16 or bk < 16 or sq % bq or sk % bk or bq % 16 or bk % 16:
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    q = (q * sm_scale).to(q.dtype)
    if debug and _use_whole_kv(sq, sk, q.shape[3], exact):
        _debug_check_logits(q, k)
    return FlashAttention.apply(q, k, v, causal, exact, (bq, bk), impl)


def _repeat_kv(k, rep: int, dim: int = 1):
    """Broadcast each kv head over its query group (GQA)."""
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=dim)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     sm_scale: Optional[float] = None, q_positions=None):
    """Attention of new-token queries against a (padded) KV cache.

    q: [B, H, S_new, D] -- the S_new newest tokens' queries; the cache
    already holds their keys/values (positions ``lengths - S_new ..
    lengths - 1``). k_cache/v_cache: [B, S_max, Hkv, D]; lengths: [B]
    int32, valid entries INCLUDING the new tokens. Causal within the
    new tokens, full visibility over the prefix, masked past
    ``lengths``. ``q_positions`` ([B, S_new], optional) overrides each
    query row's absolute position (right-padded prefill passes -1 for
    padding rows, whose output is discarded). Returns [B, H, S_new, D].
    """
    B, H, S_new, D = q.shape
    Hkv = k_cache.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    k = _repeat_kv(k_cache.transpose(1, 2), H // Hkv)      # [B,H,S,D]
    v = _repeat_kv(v_cache.transpose(1, 2), H // Hkv)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    S_max = k_cache.shape[1]
    if q_positions is None:
        q_positions = (lengths[:, None] - S_new) + torch.arange(
            S_new, device=q.device)[None, :]
    k_pos = torch.arange(S_max, device=q.device)[None, None, :]
    mask = (k_pos <= q_positions[..., None])[:, None]       # [B,1,S_new,S_max]
    logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def append_kv_pages(k_new, v_new, k_pages, v_pages, block_tables,
                    lengths, valid=None):
    """Scatter new keys/values into their pages, IN PLACE.

    k_new/v_new: [B, S, Hkv, D] written at logical positions ``lengths
    .. lengths + S - 1`` of each sequence; ``valid`` ([B, S] bool,
    optional) routes padding tokens to slot 0 of the null page 0.
    ``k_pages``/``v_pages`` are updated with ``index_put_`` (they may be
    views of one layer of a pool). Distinct sequences own distinct
    pages, so indices collide only in the null page, which is scratch.
    """
    B, S = k_new.shape[:2]
    bs = k_pages.shape[1]
    NB = block_tables.shape[1]
    pos = lengths[:, None].long() + torch.arange(
        S, device=k_new.device)[None, :]
    # padding positions may run past the table; their page is replaced
    # by the null page below, so clamping them changes nothing real
    page = torch.gather(block_tables.long(), 1, (pos // bs).clamp(max=NB - 1))
    slot = pos % bs
    if valid is not None:
        page = torch.where(valid, page, 0)
        slot = torch.where(valid, slot, 0)
    k_pages.index_put_((page, slot), k_new.to(k_pages.dtype))
    v_pages.index_put_((page, slot), v_new.to(v_pages.dtype))


def paged_gather(pages, block_tables):
    """Pages -> per-sequence (padded) contiguous cache:
    [P, bs, Hkv, D] + [B, NB] -> [B, NB*bs, Hkv, D]."""
    B, NB = block_tables.shape
    bs = pages.shape[1]
    out = pages[block_tables.long()]                       # [B,NB,bs,Hkv,D]
    return out.reshape(B, NB * bs, *pages.shape[2:])


def paged_attention_reference(q, k_pages, v_pages, block_tables, lengths,
                              *, sm_scale: Optional[float] = None):
    """Single-token decode against the paged cache via gather: the
    plain version of the kernel. q: [B, H, D]; returns [B, H, D]."""
    out = decode_attention(q[:, :, None, :],
                           paged_gather(k_pages, block_tables),
                           paged_gather(v_pages, block_tables),
                           lengths, sm_scale=sm_scale)
    return out[:, :, 0, :]


def _kernel_smem(tile_pages: int, bs: int, D: int, G: int, elt: int) -> int:
    """Shared-memory bytes of one CTA (layout in paged_decode.cu): K and
    V tiles, f32 q, scores and the per-head m, l, alpha."""
    tile = tile_pages * bs
    return 2 * tile * D * elt + 4 * (G * D + G * tile + 3 * G)


def _kernel_tile_pages(bs: int, D: int, G: int, elt: int) -> int:
    """Pages per shared-memory tile: about _KERNEL_TILE_TOKENS tokens,
    fewer where the tile would pass 48 KB."""
    pages = max(1, _KERNEL_TILE_TOKENS // bs)
    while pages > 1 and _kernel_smem(pages, bs, D, G, elt) > _KERNEL_SMEM_MAX:
        pages //= 2
    if _kernel_smem(pages, bs, D, G, elt) > _KERNEL_SMEM_MAX:
        raise ValueError(f"one page (bs={bs}, D={D}, G={G}) does not fit "
                         f"the kernel's {_KERNEL_SMEM_MAX} bytes of shared "
                         "memory")
    return pages


def _check_kernel_args(q, k_pages, v_pages, block_tables, lengths):
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention_decode: all inputs must be on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_attention_decode: dtype {q.dtype} is not "
                        "supported (bfloat16, float32)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention_decode: q, k_pages and v_pages "
                        "must share one dtype")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention_decode: block_tables and lengths "
                        "must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("paged_attention_decode: want q [B,H,D], pages "
                         "[P,bs,Hkv,D], block_tables [B,NB], lengths [B]")
    B, H, D = q.shape
    P, bs, Hkv, Dk = k_pages.shape
    if (v_pages.shape != k_pages.shape or Dk != D
            or block_tables.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_attention_decode: shapes do not agree: q {tuple(q.shape)}"
            f", pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
            f"tables {tuple(block_tables.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    if H % Hkv:
        raise ValueError(f"paged_attention_decode: H={H} is not a multiple "
                         f"of Hkv={Hkv}")
    elt = q.element_size()
    if (D * elt) % 16 or D * elt > 512:
        raise ValueError(f"paged_attention_decode: a row of D={D} must be "
                         "a multiple of 16 bytes and at most 512 bytes")
    if (H // Hkv) * D > _KERNEL_THREADS * _KERNEL_MAX_ACC:
        raise ValueError("paged_attention_decode: G * D = "
                         f"{(H // Hkv) * D} exceeds "
                         f"{_KERNEL_THREADS * _KERNEL_MAX_ACC}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_decode: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention_decode: q and pages must be "
                         "16-byte aligned")


@functools.cache
def _paged_lib():
    """The paged-decode library, with its C signature set once."""
    lib = kernels.load("paged_decode")
    lib.rtt_paged_decode.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int] * 7 + [ctypes.c_size_t, ctypes.c_void_p])
    lib.rtt_paged_decode.restype = ctypes.c_int
    return lib


def paged_attention_decode(q, k_pages, v_pages, block_tables, lengths, *,
                           sm_scale: Optional[float] = None):
    """Paged-attention decode: q [B, H, D] against block-table-addressed
    pages, without gathering the cache. Returns [B, H, D] in q's dtype.

    CUDA tensors go to the hand-written sm_90a kernel (one CTA per
    sequence and kv head; counted in ``kernels.launch_counts()`` as
    ``paged_attention_decode``). CPU tensors go to the plain version,
    ``paged_attention_reference``. Anything the kernel does not take
    raises; nothing falls back. Rows with ``lengths == 0`` are batch
    padding: the kernel writes zeros there.
    """
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                          lengths, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: no kernel for device "
                         f"{q.device}")
    _check_kernel_args(q, k_pages, v_pages, block_tables, lengths)
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    G = H // Hkv
    elt = q.element_size()
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    if B == 0:
        return out
    tile_pages = _kernel_tile_pages(bs, D, G, elt)
    lib = _paged_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            1 if q.dtype == torch.bfloat16 else 0, float(sm_scale),
            B, Hkv, G, D, bs, NB, tile_pages,
            _kernel_smem(tile_pages, bs, D, G, elt), stream)
    kernels.check(lib, err, "paged_attention_decode")
    kernels.count_launch("paged_attention_decode")
    return out


def cached_attention(q, k_new, v_new, cache, seq_lengths, *,
                     sm_scale: Optional[float] = None, valid=None,
                     paged_decode=paged_attention_decode):
    """One incremental-attention step for the model decode paths.

    q/k_new/v_new: [B, S, H|Hkv, D] projections of the S newest tokens.
    ``cache`` is one layer's cache:

      {"k": [B,S_max,Hkv,D], "v": ...}                    contiguous
      {"k_pages": [P,bs,Hkv,D], "v_pages": ...,
       "block_tables": [B,NB]}                            paged

    Both are updated IN PLACE. ``seq_lengths`` [B] counts valid cache
    entries BEFORE this call; ``valid`` ([B, S] bool, optional) marks
    real tokens when the caller padded S to a bucket. A paged step with
    S == 1 and every token valid goes through ``paged_decode`` (the
    kernel unless a caller passes the plain version); other steps use
    gather + ``decode_attention``. Returns (out [B, S, H, D], cache).
    """
    B, S = q.shape[:2]
    q_positions = None
    if valid is not None:
        new_len = seq_lengths + valid.sum(dim=1, dtype=torch.int32)
        ar = torch.arange(S, device=q.device)[None, :]
        q_positions = torch.where(valid, seq_lengths[:, None] + ar, -1)
    else:
        new_len = seq_lengths + S
    new_len = new_len.to(torch.int32)
    if "k_pages" in cache:
        k_pages, v_pages = cache["k_pages"], cache["v_pages"]
        tables = cache["block_tables"]
        append_kv_pages(k_new, v_new, k_pages, v_pages, tables,
                        seq_lengths, valid=valid)
        if S == 1 and (valid is None or bool(valid.all())):
            out = paged_decode(q[:, 0].contiguous(), k_pages, v_pages,
                               tables, new_len, sm_scale=sm_scale)
            return out[:, None], cache
        out = decode_attention(q.transpose(1, 2),
                               paged_gather(k_pages, tables),
                               paged_gather(v_pages, tables),
                               new_len, sm_scale=sm_scale,
                               q_positions=q_positions)
        return out.transpose(1, 2), cache
    pos = seq_lengths[:, None].long() + torch.arange(
        S, device=q.device)[None, :]
    bidx = torch.arange(B, device=q.device)[:, None].expand(B, S)
    if valid is not None:
        # padded tokens must not clobber cache slots a later real token
        # will own: write only the real ones
        bidx, pos = bidx[valid], pos[valid]
        k_new, v_new = k_new[valid], v_new[valid]
    cache["k"].index_put_((bidx, pos), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((bidx, pos), v_new.to(cache["v"].dtype))
    out = decode_attention(q.transpose(1, 2), cache["k"], cache["v"],
                           new_len, sm_scale=sm_scale,
                           q_positions=q_positions)
    return out.transpose(1, 2), cache
