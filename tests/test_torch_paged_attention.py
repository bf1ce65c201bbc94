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


def test_kernel_tile_fits_shared_memory():
    # the serving shape: 4 pages of 16 tokens per tile
    assert TA._kernel_tile_pages(16, 64, 1, 2) == 4
    # f32 at D=128 halves the tile to stay within 48 KB
    pages = TA._kernel_tile_pages(16, 128, 4, 4)
    assert TA._kernel_smem(pages, 16, 128, 4, 4) <= 48 * 1024
    with pytest.raises(ValueError):
        TA._kernel_tile_pages(256, 128, 4, 4)


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only refusal")
    from ray_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
