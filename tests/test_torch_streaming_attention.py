"""The port's streaming (flash-v2) attention against the JAX package's
Pallas streaming kernels, on the CPU.

The same numpy inputs, made from a seed, go through
``ray_tpu.ops.attention`` (``_flash_forward`` / ``_flash_backward`` and
the public ``flash_attention``, the Pallas kernels in interpret mode)
and ``ray_tpu_torch.ops.attention`` (on CPU tensors the wrappers take
the kernels' plain versions). Tolerances: 1e-5 in f32 (the two sum in
different orders); in bf16 2e-2, since both round p and ds to bf16 from
f32 values that may differ in their last bits (one bf16 step is 2^-8
relative). The causal mask is aligned top-left on both sides.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as JA
from ray_tpu_torch import kernels
from ray_tpu_torch.ops import attention as TA

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(shapes, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _qkvd(sq, sk, d, seed=0, scale=1.0):
    """q (pre-scaled by d^-0.5, as flash_attention hands it over), k, v,
    do as numpy f32, [1, 2, s, d]."""
    q, k, v, do = _inputs([(1, 2, sq, d), (1, 2, sk, d), (1, 2, sk, d),
                           (1, 2, sq, d)], seed, scale)
    return (q * d ** -0.5).astype(np.float32), k, v, do


@functools.partial(jax.jit, static_argnames="causal")
def _pallas(q, k, v, do, causal):
    """_fwd_kernel, then _bwd_dkv_kernel and _bwd_dq_kernel from its o
    and lse, in interpret mode at 64-blocks: (o, lse, (dq, dk, dv)). One
    jit costs less here than the eager interpreter."""
    o, lse = JA._flash_forward(q, k, v, 1.0, causal, 64, 64, interpret=True)
    return o, lse, JA._flash_backward((q, k, v, o, lse), do, sm_scale=1.0,
                                      causal=causal, block_q=64, block_k=64,
                                      interpret=True)


def _both(arrays, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(x, jd) for x in arrays],
            [torch.from_numpy(x).to(td) for x in arrays])


@pytest.mark.parametrize("sq,sk,causal,dtype", [
    (256, 256, True, "float32"), (256, 128, False, "float32"),
    (128, 256, False, "bfloat16")])
def test_plain_versions_match_pallas_kernels(sq, sk, causal, dtype):
    """The three plain versions against _fwd_kernel, _bwd_dkv_kernel and
    _bwd_dq_kernel in interpret mode, at 64-blocks (several blocks, so
    the running max rescales), sq == sk and sq != sk. Both backwards
    start from JAX's o and lse. Causal sq < sk (top-left) in f32 and
    causal bf16 go through the public path below (each Pallas call costs
    ~2 s here); sq > sk causal: next test."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(_qkvd(sq, sk, 32, seed=1),
                                                 dtype)
    tol = F32 if dtype == "float32" else BF16
    o_j, lse_j, g_j = _pallas(jq, jk, jv, jdo, causal)
    o_t, lse_t = TA.flash_attention_forward_reference(tq, tk, tv,
                                                      causal=causal,
                                                      block_k=64)
    assert o_t.dtype == tq.dtype and lse_t.dtype == torch.float32
    np.testing.assert_allclose(_np(o_t), _np(o_j), **tol)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), **F32)

    o, lse = (torch.from_numpy(np.array(_np(o_j))).to(tq.dtype),
              torch.from_numpy(np.array(_np(lse_j))))
    delta = TA.attention_delta_reference(o, tdo)
    dk, dv = TA.flash_attention_backward_dkv_reference(
        tq, tk, tv, tdo, lse, delta, causal=causal, block_q=64)
    dq = TA.flash_attention_backward_dq_reference(
        tq, tk, tv, tdo, lse, delta, causal=causal, block_k=64)
    for a, b in zip((dq, dk, dv), g_j):
        assert a.dtype == tq.dtype
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def test_sq_above_sk_causal_follows_the_mask():
    """sq = 256 > sk = 128, causal: rows past sk see all sk keys once.
    The plain versions equal the f64 function (f32, 1e-5 of each
    output's scale). The Pallas kernels do not: for q blocks past the
    last kv block, _fwd_kernel's and _bwd_dq_kernel's unmasked loop runs
    to (qi * bq) // bk unclamped and reads past k; interpret mode clamps
    the slice, so rows 192.. count kv block 1 twice. Rows below agree."""
    (jq, jk, jv, _), (tq, tk, tv, tdo) = _both(_qkvd(256, 128, 32, seed=1),
                                               "float32")
    o_j, _ = JA._flash_forward(jq, jk, jv, 1.0, True, 64, 64, interpret=True)
    o, lse = TA.flash_attention_forward_reference(tq, tk, tv, causal=True,
                                                  block_k=64)
    delta = TA.attention_delta_reference(o, tdo)
    grads = (TA.flash_attention_backward_dq_reference(
        tq, tk, tv, tdo, lse, delta, causal=True, block_k=64),
        *TA.flash_attention_backward_dkv_reference(
            tq, tk, tv, tdo, lse, delta, causal=True, block_q=64))
    refs = (TA.flash_attention_forward_f64(tq, tk, tv, causal=True)
            + TA.flash_attention_backward_f64(tq, tk, tv, o, lse, tdo,
                                              causal=True))
    for a, b in zip((o, lse) + grads, refs):
        assert float((a.double() - b).abs().max()) <= 1e-5 * (
            1 + float(b.abs().max()))
    np.testing.assert_allclose(_np(o)[:, :, :192], _np(o_j)[:, :, :192],
                               **F32)
    k2, v2 = (torch.cat([t, t[:, :, 64:]], 2) for t in (tk, tv))
    twice = TA.attention_reference(tq, k2, v2, sm_scale=1.0)
    np.testing.assert_allclose(_np(twice)[:, :, 192:], _np(o_j)[:, :, 192:],
                               **F32)


def test_logits_past_the_cap_are_exact():
    """Scaled logits past 50: the streaming path has no cap, so the plain
    versions equal the Pallas streaming kernels and the exact softmax,
    forward and grads, where the whole-kv path clamps. The rows are near
    one-hot, so ds = p (dp - delta) cancels and the grads are held by
    chip_smoke.py's f32 rule, 1e-5 * (1 + the tensor's largest entry).
    The shape is the f32 causal case's above, whose compiled Pallas call
    this reuses."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(
        _qkvd(256, 256, 32, seed=2, scale=4.0), "float32")
    assert float(torch.einsum("bhqd,bhkd->bhqk", tq, tk).max()) > TA._CAP_HI
    o_j, lse_j, g_j = _pallas(jq, jk, jv, jdo, True)
    o, lse = TA.flash_attention_forward_reference(tq, tk, tv, causal=True,
                                                  block_k=64)
    delta = TA.attention_delta_reference(o, tdo)
    grads = (TA.flash_attention_backward_dq_reference(
        tq, tk, tv, tdo, lse, delta, causal=True, block_k=64),
        *TA.flash_attention_backward_dkv_reference(
            tq, tk, tv, tdo, lse, delta, causal=True, block_q=64))
    for a, b in zip((o, lse) + grads, (o_j, lse_j) + tuple(g_j)):
        a, b = _np(a), _np(b)
        assert np.abs(a - b).max() <= 1e-5 * (1 + np.abs(b).max())
    exact = TA.attention_reference(tq, tk, tv, causal=True, sm_scale=1.0)
    np.testing.assert_allclose(_np(o), _np(exact), **F32)
    capped, _ = TA.whole_attention_forward_reference(tq, tk, tv, causal=True)
    assert float((capped - o).abs().max()) > 1e-2


def test_public_exact_path_matches_pallas():
    """flash_attention(exact=True) in bf16, forward and grads through
    autograd, against JAX's flash_attention(force_pallas=True,
    interpret=True, exact=True) on the same scalar sum(out * w) (the f32
    public path: the top-left test below)."""
    dtype = "bfloat16"
    q, k, v, w = _inputs([(1, 2, 256, 32)] * 4, seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def loss_j(q, k, v):
        out = JA.flash_attention(q, k, v, causal=True, force_pallas=True,
                                 interpret=True, exact=True)
        return (out.astype(jnp.float32) * w).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    t = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = TA.flash_attention(*t, causal=True, exact=True)
    (out.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), _np(out_j), **BF16)
    for a, b in zip(t, g_j):
        assert a.grad.dtype == td
        np.testing.assert_allclose(_np(a.grad), _np(b), **BF16)


def test_causal_sq_ne_sk_aligns_top_left():
    """sq = 128, sk = 256, causal: the port follows the Pallas streaming
    kernels (query row r sees keys 0..r), forward and grads, and so
    differs from attention_reference's bottom-right alignment."""
    q, w = _inputs([(1, 2, 128, 32)] * 2, seed=4)
    k, v = _inputs([(1, 2, 256, 32)] * 2, seed=5)

    def loss_j(q, k, v):
        out = JA.flash_attention(q, k, v, causal=True, force_pallas=True,
                                 interpret=True, exact=True, block_q=64,
                                 block_k=64)
        return (out * w).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TA.flash_attention(*t, causal=True, exact=True, block_q=64,
                             block_k=64)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), _np(out_j), **F32)
    for a, b in zip(t, g_j):
        np.testing.assert_allclose(_np(a.grad), _np(b), **F32)
    bottom_right = TA.attention_reference(*(x.detach() for x in t),
                                          causal=True)
    assert float((bottom_right - out.detach()).abs().max()) > 1e-1


def test_long_sequence_takes_the_streaming_path_by_shape():
    """s = 2304 > 2048 with no knob: the JAX dispatch and the port's both
    leave the whole-kv path, and the port's three streaming functions
    are called once each (forward, dkv, dq). Forward and grads equal
    JAX's flash_attention on the CPU, the exact softmax in XLA (the plain
    versions are held to the Pallas streaming kernels above): out within
    1e-5, grads within 1e-5 relative and 1e-4 absolute."""
    s, d = 2304, 16
    q, k, v, w = _inputs([(1, 1, s, d)] * 4, seed=6)
    assert not TA._use_whole_kv(s, s, d) and not JA._use_whole_kv(s, s, d)
    calls = []

    def recording(fn):
        def run(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return run

    impl = TA.TrainingAttention(*(recording(f) for f in TA.TRAINING_PLAIN))

    def loss_j(q, k, v):
        out = JA.flash_attention(q, k, v, causal=True)
        return (out * w).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TA.flash_attention(*t, causal=True, impl=impl)
    (out * torch.from_numpy(w)).sum().backward()
    plain = TA.TRAINING_PLAIN
    assert sorted(calls) == sorted(f.__name__ for f in (
        plain.forward, plain.backward_dkv, plain.backward_dq, plain.delta))
    np.testing.assert_allclose(_np(out), _np(out_j), **F32)
    for a, b in zip(t, g_j):
        np.testing.assert_allclose(_np(a.grad), _np(b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_f64_yardsticks_match_the_plain_versions(causal):
    """The f64 functions the bf16 kernels are held to on the card
    compute what the f32 plain versions compute (held to the Pallas
    kernels above), sq != sk: each output within 1e-5 * (1 + its
    largest entry), chip_smoke.py's f32 rule."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkvd(128, 192, 64, seed=7))
    o, lse = TA.flash_attention_forward_reference(q, k, v, causal=causal,
                                                  block_k=64)
    delta = TA.attention_delta_reference(o, do)
    plain = (o, lse, TA.flash_attention_backward_dq_reference(
        q, k, v, do, lse, delta, causal=causal, block_k=64),
        *TA.flash_attention_backward_dkv_reference(
            q, k, v, do, lse, delta, causal=causal, block_q=64))
    refs = (TA.flash_attention_forward_f64(q, k, v, causal=causal)
            + TA.flash_attention_backward_f64(q, k, v, o, lse, do,
                                              causal=causal))
    for a, b in zip(plain, refs):
        assert b.dtype == torch.float64
        assert float((a.double() - b).abs().max()) <= 1e-5 * (
            1 + float(b.abs().max()))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["o", "lse", "dq", "dk", "dv"])
def test_bf16_rule_rejects_a_skipped_kv_tile(monkeypatch, name):
    """What chip_smoke.py's bf16 check of the streaming kernels rests
    on: a plain version that skips the first 64 keys for every row past
    them (one faulty tile loop) strays from the f64 yardstick by more
    than BF16_RATIO times the plain version's own error."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _qkvd(256, 256, 32, seed=8))

    def run():
        o, lse = TA.flash_attention_forward_reference(q, k, v, causal=True,
                                                      block_k=64)
        delta = TA.attention_delta_reference(ro, do)
        dk, dv = TA.flash_attention_backward_dkv_reference(
            q, k, v, do, rlse, delta, causal=True, block_q=64)
        dq = TA.flash_attention_backward_dq_reference(
            q, k, v, do, rlse, delta, causal=True, block_k=64)
        return dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)

    ro, rlse = TA.flash_attention_forward_reference(q, k, v, causal=True,
                                                    block_k=64)
    plain = run()
    ref = dict(zip(("o", "lse"), TA.flash_attention_forward_f64(
        q, k, v, causal=True)))
    ref.update(zip(("dq", "dk", "dv"), TA.flash_attention_backward_f64(
        q, k, v, ro, rlse, do, causal=True)))
    masked = TA._masked

    def skipping(s, rows, keys, causal):
        s = masked(s, rows, keys, causal)
        return s.masked_fill((rows[:, None] >= 64) & (keys[None, :] < 64),
                             TA._NEG_INF)

    monkeypatch.setattr(TA, "_masked", skipping)
    faulty = run()
    r_max, r_rms = TA.error_ratios(faulty[name], plain[name], ref[name])
    c_max, c_rms = _chip_smoke().BF16_RATIO
    assert r_max > c_max or r_rms > c_rms, (r_max, r_rms)


def test_wrappers_take_plain_versions_on_cpu_and_refuse_other_devices():
    """On CPU tensors each wrapper is its plain version at the blocks
    flash_attention fits by default (the whole sequence here: 128 rows,
    192 keys), with no launch counted; on another device it raises. The wrappers take
    no block sizes: the kernels use their own tiles."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkvd(128, 192, 16))
    kernels.reset_launch_counts()
    o, lse = TA.flash_attention_forward(q, k, v, causal=True)
    ro, rlse = TA.flash_attention_forward_reference(q, k, v, causal=True,
                                                    block_k=192)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    delta = TA.attention_delta_reference(o, do)
    args = (q, k, v, do, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(
        TA.flash_attention_backward_dkv(*args, causal=True),
        TA.flash_attention_backward_dkv_reference(*args, causal=True,
                                                  block_q=128)))
    assert torch.equal(
        TA.flash_attention_backward_dq(*args, causal=True),
        TA.flash_attention_backward_dq_reference(*args, causal=True,
                                                 block_k=192))
    assert torch.equal(TA.attention_delta(o, do), delta)
    assert kernels.launch_counts() == {}
    for fn in (TA.flash_attention_forward, TA.flash_attention_backward_dkv,
               TA.flash_attention_backward_dq):
        with pytest.raises(TypeError):
            fn(*args[:3 if fn is TA.flash_attention_forward else 6],
               causal=True, block_k=64, block_q=64)
    m = torch.empty(1, 2, 128, 16, device="meta")
    r = m[..., 0]
    for fn, a in ((TA.flash_attention_forward, (m, m, m)),
                  (TA.flash_attention_backward_dkv, (m, m, m, m, r, r)),
                  (TA.flash_attention_backward_dq, (m, m, m, m, r, r))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*a, causal=True)
    with pytest.raises(ValueError, match="no kernel"):
        TA.attention_delta(m, m)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_delta_matches_jax_rowsum(dtype):
    """The delta both backwards take (``attention_delta`` on CPU
    tensors: its plain version) against the JAX package's own
    expression in ``_whole_backward`` and ``_flash_backward``, sum of
    o * do in f32 over the head dim: within 1e-5 relative."""
    rng = np.random.default_rng(11)
    o, do = (rng.standard_normal((2, 3, 48, 64)).astype(np.float32)
             for _ in range(2))
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    jo, jdo = jnp.asarray(o, jdt), jnp.asarray(do, jdt)
    want = jnp.sum(jo.astype(jnp.float32) * jdo.astype(jnp.float32),
                   axis=-1)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = TA.attention_delta(torch.from_numpy(o).to(tdt),
                             torch.from_numpy(do).to(tdt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1927b273_18_flash_attention_cu_4b62497615flash_dkv_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_S1_S1_P13__nv_bfloat16S3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__1927b273_18_flash_attention_cu_4b62497615flash_dkv_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_S1_S1_P13__nv_bfloat16S3_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compile time = 351.984 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115scratch_kernelIfLi64EEEvPKT_Pfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115scratch_kernelIfLi64EEEvPKT_Pfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1927b273_18_flash_attention_cu_4b62497613flash_dkv_mmaILi16EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__1927b273_18_flash_attention_cu_4b62497613flash_dkv_mmaILi16EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiii
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__5e7c2a1b_15_paged_decode_cu_9f3d2c4118paged_decode_splitI13__nv_bfloat16Li4ELi128EEEv14CUtensorMap_stS1_PKT_PKiS6_Pffiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__5e7c2a1b_15_paged_decode_cu_9f3d2c4118paged_decode_splitI13__nv_bfloat16Li4ELi128EEEv14CUtensorMap_stS1_PKT_PKiS6_Pffiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 55 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__5e7c2a1b_15_paged_decode_cu_9f3d2c4120paged_decode_combineIfEEvPKfPT_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__5e7c2a1b_15_paged_decode_cu_9f3d2c4120paged_decode_combineIfEEvPKfPT_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__0c1d2e3f_18_attention_delta_cu_7a6b5c4d22attention_delta_kernelI13__nv_bfloat16Li64EEEvPKT_S4_Pfi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__0c1d2e3f_18_attention_delta_cu_7a6b5c4d22attention_delta_kernelI13__nv_bfloat16Li64EEEvPKT_S4_Pfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers
"""


def test_ptxas_report_is_read_per_kernel_instance():
    """``kernels.parse_ptxas`` on the report nvcc -Xptxas -v prints on
    the card (two instances of flash_attention.cu, a helper kernel
    between them, which is left out and whose lines go to no other
    entry, the paged-decode split kernel, named by its element type,
    query heads per kv head and head dim, and its combine kernel, by its
    element type, and the attention delta kernel, by its element type
    and head dim): kernel name, head dim, registers at launch, stack and
    spill bytes."""
    assert kernels.parse_ptxas(PTXAS_LOG) == [
        {"kernel": "flash_dkv_wgmma", "d": 128, "stack_bytes": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 168},
        {"kernel": "flash_dkv_mma", "d": 16, "stack_bytes": 16,
         "spill_stores": 12, "spill_loads": 12, "registers": 96},
        {"kernel": "paged_decode_split", "d": 128, "g": 4,
         "dtype": "bfloat16", "stack_bytes": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 55},
        {"kernel": "paged_decode_combine", "d": None, "dtype": "float32",
         "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 24},
        {"kernel": "attention_delta_kernel", "d": 64, "dtype": "bfloat16",
         "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 16}]
