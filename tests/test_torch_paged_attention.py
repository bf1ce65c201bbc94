"""The port's paged-attention ops against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``ray_tpu.ops.attention`` (including its Pallas paged-decode kernel in
interpret mode) and ``ray_tpu_torch.ops.attention``. Tolerance 1e-5 in
f32: the two sum in different orders. On the CPU the port's kernel
wrapper takes the plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import attention as JA
from ray_tpu_torch import kernels
from ray_tpu_torch.ops import attention as TA

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, H, Hkv, D, bs, NB, lengths): test_llm_serving.py's shape, and a
# ragged GQA shape with a partial last page and a one-token sequence
SHAPES = [
    (3, 8, 2, 16, 8, 4, [5, 17, 30]),
    (4, 8, 2, 32, 4, 6, [1, 9, 24, 13]),
]


def _inputs(B, H, Hkv, D, bs, NB, lengths, seed=0):
    rng = np.random.RandomState(seed)
    P = 1 + B * NB
    return dict(
        q=rng.randn(B, H, D).astype(np.float32),
        k_pages=rng.randn(P, bs, Hkv, D).astype(np.float32),
        v_pages=rng.randn(P, bs, Hkv, D).astype(np.float32),
        # pages handed out in a shuffled order, as an allocator would
        block_tables=(1 + rng.permutation(B * NB)).reshape(B, NB).astype(
            np.int32),
        lengths=np.asarray(lengths, np.int32))


def _jax(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


@pytest.mark.parametrize("shape", SHAPES)
def test_paged_ops_match_jax(shape):
    a = _inputs(*shape)
    j, t = _jax(a), _torch(a)
    args = ("q", "k_pages", "v_pages", "block_tables", "lengths")
    ref_j = JA.paged_attention_reference(*(j[k] for k in args))
    pallas = JA.paged_attention_decode(*(j[k] for k in args),
                                       interpret=True)
    ref_t = TA.paged_attention_reference(*(t[k] for k in args))
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), **TOL)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(pallas), **TOL)

    np.testing.assert_allclose(
        TA.paged_gather(t["k_pages"], t["block_tables"]).numpy(),
        np.asarray(JA.paged_gather(j["k_pages"], j["block_tables"])))

    # decode_attention over the gathered cache, several new tokens each
    S_new = 3
    rng = np.random.RandomState(1)
    q4 = rng.randn(shape[0], shape[1], S_new, shape[3]).astype(np.float32)
    kc = np.array(JA.paged_gather(j["k_pages"], j["block_tables"]))
    vc = np.array(JA.paged_gather(j["v_pages"], j["block_tables"]))
    lens = np.maximum(a["lengths"], S_new)
    out_j = JA.decode_attention(jnp.asarray(q4), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(lens))
    out_t = TA.decode_attention(torch.from_numpy(q4), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(lens))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("with_valid", [False, True])
def test_append_kv_pages_matches_jax(with_valid):
    B, H, Hkv, D, bs, NB, _ = SHAPES[1]
    S = 5   # every new position stays inside its table (NB * bs = 24)
    a = _inputs(B, H, Hkv, D, bs, NB, [1, 9, 19, 0])
    rng = np.random.RandomState(2)
    k_new = rng.randn(B, S, Hkv, D).astype(np.float32)
    v_new = rng.randn(B, S, Hkv, D).astype(np.float32)
    valid = None
    if with_valid:
        valid = np.arange(S)[None, :] < np.asarray([5, 1, 3, 0])[:, None]
    kj, vj = JA.append_kv_pages(
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(a["k_pages"]),
        jnp.asarray(a["v_pages"]), jnp.asarray(a["block_tables"]),
        jnp.asarray(a["lengths"]),
        valid=None if valid is None else jnp.asarray(valid))
    kt = torch.from_numpy(a["k_pages"].copy())
    vt = torch.from_numpy(a["v_pages"].copy())
    TA.append_kv_pages(
        torch.from_numpy(k_new), torch.from_numpy(v_new), kt, vt,
        torch.from_numpy(a["block_tables"]), torch.from_numpy(a["lengths"]),
        valid=None if valid is None else torch.from_numpy(valid))
    # the null page is scratch: colliding padding writes may land in
    # any order there
    np.testing.assert_array_equal(kt.numpy()[1:], np.asarray(kj)[1:])
    np.testing.assert_array_equal(vt.numpy()[1:], np.asarray(vj)[1:])


def test_wrapper_on_cpu_takes_plain_version_and_launches_nothing():
    a = _torch(_inputs(*SHAPES[0]))
    args = ("q", "k_pages", "v_pages", "block_tables", "lengths")
    kernels.reset_launch_counts()
    out = TA.paged_attention_decode(*(a[k] for k in args))
    ref = TA.paged_attention_reference(*(a[k] for k in args))
    assert torch.equal(out, ref)
    assert kernels.launch_counts().get("paged_attention_decode", 0) == 0


@pytest.mark.parametrize("case", ["q_dtype", "gqa", "table_dtype",
                                  "shape"])
def test_kernel_argument_checks(case):
    """What the CUDA kernel does not take is refused before launch."""
    a = _torch(_inputs(*SHAPES[0]))
    if case == "q_dtype":
        a["q"] = a["q"].half()
    elif case == "gqa":
        a["q"] = a["q"][:, :7].contiguous()
    elif case == "table_dtype":
        a["block_tables"] = a["block_tables"].long()
    else:
        a["lengths"] = a["lengths"][:2]
    with pytest.raises((TypeError, ValueError)):
        TA._check_kernel_args(a["q"], a["k_pages"], a["v_pages"],
                              a["block_tables"], a["lengths"])


def test_split_plan_at_llama_serve_shape():
    """Llama-2-7B serving (B 16, H = Hkv = 32, D 128, bs 16, NB 128,
    bf16): tiles of 32 tokens in boxes of a page, splits of 8 pages, 16
    splits covering the table; G = 1 passes the kernel's checks."""
    plan = TA.paged_split_plan(16, 32, 128, 16, 128, 2)
    assert plan == (32, 8, 16, 16, (16, 32, 16, 130), 32 * 1024 + 16 + 4 * 8)
    a = _torch(_inputs(16, 32, 32, 128, 16, 128, [1] * 15 + [2048]))
    TA._check_kernel_args(a["q"].bfloat16(), a["k_pages"].bfloat16(),
                          a["v_pages"].bfloat16(), a["block_tables"],
                          a["lengths"])


def test_kernel_tile_fits_shared_memory():
    """The split plan at the serving shape (B 16, H 12, D 64, bs 16,
    NB 64, bf16): tiles of 64 tokens (8 KB of K) loaded a page (16
    rows) per TMA box, splits of 16 pages, 4 splits; the ring of two K
    and V tiles and the split's page numbers stay within 48 KB at every
    head dim; a box is cut to a divisor of both the page and the tile;
    G past the kernel's limit and pages the boxes cannot take are
    refused."""
    plan = TA.paged_split_plan(16, 12, 64, 16, 64, 2)
    assert plan == (64, 16, 4, 16, (16, 12, 4, 66), 32 * 1024 + 16 + 4 * 16)
    for D, elt in ((16, 4), (64, 4), (128, 2), (128, 4), (256, 2)):
        p = TA.paged_split_plan(2, 8, D, 16, 256, elt)
        assert p.tile_tokens * D * elt == 8192
        assert p.smem_bytes <= 48 * 1024
        assert p.n_splits * p.split_pages >= 256
        assert (p.n_splits - 1) * p.split_pages < 256
    # a page larger than a split: one page per split, boxes of a tile
    assert TA.paged_split_plan(1, 1, 128, 256, 3, 4)[1:4] == (1, 3, 16)
    assert TA.paged_split_plan(1, 1, 64, 24, 8, 2).box_rows == 8
    a = _torch(_inputs(2, 18, 2, 16, 8, 4, [5, 17]))
    with pytest.raises(ValueError, match="G=9"):
        TA._check_kernel_args(a["q"], a["k_pages"], a["v_pages"],
                              a["block_tables"], a["lengths"])
    a = _torch(_inputs(2, 2, 2, 16, 3, 4, [5, 7]))   # boxes of 48 bytes
    with pytest.raises(ValueError, match="128-byte"):
        TA._check_kernel_args(a["q"], a["k_pages"], a["v_pages"],
                              a["block_tables"], a["lengths"])


_NEG = torch.tensor(-1e30)


def _split_then_combine(q, k_pages, v_pages, block_tables, lengths,
                        plan, sm_scale=None):
    """A plain model of the kernel's split-KV decode on ``plan``: each
    split's partial (m, l, acc) over its pages (empty past the length:
    m = -1e30, l = 0, acc = 0; p rounded to the input dtype for acc, l
    from the unrounded p), then the merge in split order. q [B, H, D]
    -> [B, H, D]."""
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    G = H // Hkv
    scale = D ** -0.5 if sm_scale is None else sm_scale
    qs = (q.float() * scale).to(q.dtype).float()
    out = torch.zeros(B, H, D, dtype=q.dtype)
    span = plan.split_pages * bs
    for b in range(B):
        n = int(lengths[b])
        k = TA.paged_gather(k_pages, block_tables[b:b + 1])[0].float()
        v = TA.paged_gather(v_pages, block_tables[b:b + 1])[0].float()
        for h in range(H):
            parts = []
            for i in range(plan.n_splits):
                lo, hi = i * span, min((i + 1) * span, n)
                if lo >= hi:
                    parts.append((_NEG, torch.tensor(0.0), torch.zeros(D)))
                    continue
                s = k[lo:hi, h // G] @ qs[b, h]
                m = s.max()
                p = torch.exp(s - m)
                acc = p.to(q.dtype).float() @ v[lo:hi, h // G]
                parts.append((m, p.sum(), acc))
            M = max(float(m) for m, _, _ in parts)
            l = sum(lp * torch.exp(torch.as_tensor(m) - M)
                    for m, lp, _ in parts)
            acc = sum(a * torch.exp(torch.as_tensor(m) - M)
                      for m, _, a in parts)
            out[b, h] = (acc / torch.clamp(torch.as_tensor(l), min=1e-30)
                         ).to(q.dtype)
    return out


# (B, H, Hkv, D, bs, NB, lengths) at f32, D 64: tiles of 32 tokens,
# splits of 16 pages of 8 tokens (128 tokens). Lengths 0 and 1, on a
# split boundary (128) and one past it, a full table (NB * bs), and
# a partial page
SPLIT_SHAPES = [
    (6, 4, 2, 64, 8, 20, [0, 1, 128, 129, 160, 77]),
    (3, 2, 2, 64, 8, 40, [256, 257, 319]),
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_then_combine_matches_jax(shape):
    """The kernel's split plan, modelled in plain torch (split, then
    merge), against the JAX package's Pallas paged-decode kernel in
    interpret mode, in f32 within 1e-5. Length-0 rows are batch
    padding: the split model (and the kernel) gives zeros there, the
    JAX kernel the mean of v over the table (every logit -1e30), so
    they are held apart."""
    B, H, Hkv, D, bs, NB, lengths = shape
    a = _inputs(*shape)
    j, t = _jax(a), _torch(a)
    args = ("q", "k_pages", "v_pages", "block_tables", "lengths")
    plan = TA.paged_split_plan(B, H, D, bs, NB, 4)
    assert plan.split_pages == 16 and plan.n_splits == -(-NB // 16)
    got = _split_then_combine(*(t[k] for k in args), plan)
    want = JA.paged_attention_decode(*(j[k] for k in args), interpret=True)
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)
    assert not got[torch.from_numpy(~live)].any()


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only refusal")
    from ray_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("shape", SPLIT_SHAPES[:1] + SHAPES)
def test_paged_f64_yardstick_matches_jax(shape):
    """``paged_attention_f64``, the function the card checks hold a bf16
    kernel to, against the JAX package's reference in f32 within 1e-5
    on rows of length > 0, and zeros on length-0 rows."""
    a = _inputs(*shape)
    j, t = _jax(a), _torch(a)
    args = ("q", "k_pages", "v_pages", "block_tables", "lengths")
    got = TA.paged_attention_f64(*(t[k] for k in args))
    assert got.dtype == torch.float64
    want = JA.paged_attention_reference(*(j[k] for k in args))
    live = a["lengths"] > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)
    assert not got[torch.from_numpy(~live)].any()
