"""Attention for the serving path: reference, cached and paged decode.

Counterpart of ``ray_tpu/ops/attention.py`` (the parts the serving
slice runs). Layouts are the JAX package's, so the two can be compared
input for input:

  q                 [B, H, D] (decode) or [B, H, S, D]
  k/v pages         [P, bs, Hkv, D]; page 0 is the null page
  block tables      [B, NB] int32 (physical page per logical block)
  lengths           [B] int32

Paths:
  attention_reference         full causal attention (full forward)
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

Masked logits are -1e30, never -inf: a page wholly past a sequence's
length then adds exactly 0, which lets the kernel stop at
``ceil(len / bs)`` pages and still compute the same function.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch import kernels

_NEG_INF = -1e30
_KERNEL_THREADS = 128      # kThreads in paged_decode.cu
_KERNEL_MAX_ACC = 8        # kMaxAcc in paged_decode.cu
_KERNEL_SMEM_MAX = 48 * 1024
_KERNEL_TILE_TOKENS = 64   # tokens per tile the kernel aims for


def attention_reference(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """q, k, v [B, H, S, D] -> [B, H, Sq, D]; f32 logits and softmax,
    probabilities cast to v's dtype before the product with v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    seq_q, seq_k = q.shape[2], k.shape[2]
    if causal:
        qi = torch.arange(seq_q, device=q.device)[:, None] + (seq_k - seq_q)
        ki = torch.arange(seq_k, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


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
    lib = kernels.load("paged_decode")
    fn = lib.rtt_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 7 + [ctypes.c_size_t, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
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
