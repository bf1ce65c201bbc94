"""The port's training attention against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``ray_tpu.ops.attention`` (its Pallas whole-kv kernels in interpret
mode) and ``ray_tpu_torch.ops.attention`` (on CPU tensors its wrappers
take the kernels' plain versions). Tolerances: 1e-5 in f32 (the two
sum in different orders); in bf16 2e-2, since both round e, p and ds
to bf16 but from f32 values that differ in their last bits, so a
rounding may land one bf16 step (2^-8 relative) apart.
"""

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
def _pinned_settings():
    """Keep PyTorch to 2 intra-op threads while this file runs (the
    suite runs in parallel workers beside timing-sensitive tests), and
    pin what the F32 tolerance assumes, full-f32 matrix products on both
    sides: torch's float32 matmul precision and JAX's default matmul
    precision "highest", whatever another file in the same worker left
    behind. Restores all three afterwards."""
    old = (torch.get_num_threads(), torch.get_float32_matmul_precision(),
           jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    torch.set_num_threads(old[0])
    torch.set_float32_matmul_precision(old[1])
    jax.config.update("jax_default_matmul_precision", old[2])


def _inputs(shape, seed=0, scale=1.0, n=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _settings():
    """The global settings an f32 comparison depends on."""
    s = {"torch float32 matmul precision":
         torch.get_float32_matmul_precision(),
         "torch threads": torch.get_num_threads(),
         "jax_default_matmul_precision":
         jax.config.jax_default_matmul_precision}
    mkldnn = getattr(torch.backends.mkldnn, "matmul", None)
    if mkldnn is not None:
        s["torch mkldnn matmul fp32_precision"] = mkldnn.fp32_precision
    return s


def _assert_close(what, got_t, got_j, ref_64, tol):
    """assert_allclose(got_t, got_j); on a failure the message also
    holds each side against the f64 function (``ref_64``, the same
    output of ``whole_attention_forward_f64``) and the settings above,
    so it says which side strays."""
    try:
        np.testing.assert_allclose(_np(got_t), _np(got_j), **tol)
    except AssertionError as err:
        ref = ref_64.numpy()
        raise AssertionError(
            f"{err}\nmax |port {what} - f64| "
            f"{np.abs(_np(got_t) - ref).max():.3e}, "
            f"max |jax {what} - f64| {np.abs(_np(got_j) - ref).max():.3e}; "
            f"settings {_settings()}") from None


@pytest.mark.parametrize("s,d,causal,dtype", [
    (s, d, c, "float32") for s in (128, 256) for d in (16, 64)
    for c in (True, False)] + [
    (256, d, c, "bfloat16") for d in (16, 64) for c in (True, False)])
def test_whole_forward_and_lse_match_jax(s, d, causal, dtype):
    q, k, v = _inputs((2, 2, s, d))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    tol = F32 if dtype == "float32" else BF16
    # the kernel pair on pre-scaled q, as flash_attention hands it over
    scale = d ** -0.5
    o_j, lse_j = JA._whole_forward((jq * scale).astype(jd), jk, jv, causal,
                                   interpret=True)
    o_t, lse_t = TA.whole_attention_forward((tq * scale).to(td), tk, tv,
                                            causal=causal)
    assert o_t.dtype == td and lse_t.dtype == torch.float32
    o_64, lse_64 = TA.whole_attention_forward_f64((tq * scale).to(td), tk,
                                                  tv, causal=causal)
    _assert_close("o", o_t, o_j, o_64, tol)
    _assert_close("lse", lse_t, lse_j, lse_64, F32)
    # and the public op, dispatch included
    out_j = JA.flash_attention(jq, jk, jv, causal=causal, force_pallas=True,
                               interpret=True)
    out_t = TA.flash_attention(tq, tk, tv, causal=causal)
    _assert_close("public op out", out_t, out_j, o_64, tol)


@pytest.mark.parametrize("d,causal,dtype", [
    (16, True, "float32"), (16, False, "float32"), (64, True, "float32"),
    (64, False, "float32"), (64, True, "bfloat16")])
def test_grads_match_jax(d, causal, dtype):
    """torch.autograd through the port against jax.grad of the same
    scalar, sum(out * w), through the Pallas kernels."""
    q, k, v, w = _inputs((1, 2, 128, d), seed=1, n=4)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def loss_j(q, k, v):
        out = JA.flash_attention(q, k, v, causal=causal, force_pallas=True,
                                 interpret=True)
        return (out.astype(jnp.float32) * w).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    t = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = TA.flash_attention(*t, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    tol = F32 if dtype == "float32" else BF16
    for a, b in zip(t, g_j):
        assert a.grad.dtype == td
        np.testing.assert_allclose(_np(a.grad), _np(b), **tol)


def test_capped_logits_match_jax():
    """Scaled logits past _CAP_HI = 50: the port clamps as the JAX
    kernels do, forward and grads, and so differs from the exact
    softmax."""
    q, k, v, w = _inputs((1, 2, 128, 64), seed=2, scale=4.0, n=4)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    s_max = float(torch.einsum("bhqd,bhkd->bhqk", *(torch.from_numpy(x)
                                                    for x in (q, k))).max())
    assert s_max / 8 > TA._CAP_HI

    def loss_j(q, k, v):
        out = JA.flash_attention(q, k, v, causal=True, force_pallas=True,
                                 interpret=True)
        return (out * w).sum(), out

    (_, out_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    out = TA.flash_attention(*t, causal=True)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), _np(out_j), **F32)
    for a, b in zip(t, g_j):
        np.testing.assert_allclose(_np(a.grad), _np(b), rtol=1e-5, atol=1e-4)
    exact = TA.attention_reference(*(x.detach() for x in t), causal=True)
    assert float((exact - out).abs().max()) > 1e-2


def test_debug_raises_on_capped_logits_on_both_sides():
    q, k, v = _inputs((1, 1, 128, 64), seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    TA.flash_attention(tq, tk, tv, causal=True, debug=True)   # in range
    with pytest.raises(FloatingPointError, match="_CAP_HI"):
        TA.flash_attention(tq * 100.0, tk, tv, causal=True, debug=True)
    with pytest.raises(FloatingPointError, match="_CAP_HI"):
        JA.flash_attention(jq * 100.0, jk, jv, causal=True,
                           force_pallas=True, interpret=True, debug=True)
    # the exact path has no cap
    out = TA.flash_attention(tq * 100.0, tk, tv, causal=True, debug=True,
                             exact=True)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("sq,sk,d,exact", [
    (128, 128, 64, None), (256, 256, 64, None), (512, 512, 64, None),
    (1024, 1024, 64, None), (2048, 2048, 64, None), (4096, 4096, 64, None),
    (1024, 1024, 64, True), (1024, 1024, 64, False), (1024, 1024, 128, None),
    (1024, 1024, 256, None), (192, 192, 64, None), (128, 256, 64, None),
    (1536, 1536, 64, None), (64, 64, 32, None)])
def test_use_whole_kv_predicate_matches_jax(sq, sk, d, exact):
    assert TA._use_whole_kv(sq, sk, d, exact) == JA._use_whole_kv(
        sq, sk, d, exact)
    assert TA._whole_block_q(sq) == JA._whole_block_q(sq)


@pytest.mark.parametrize("causal", [True, False])
def test_exact_on_cpu_matches_attention_reference(causal):
    """exact=True takes the streaming path, which on the CPU is the
    exact softmax: JAX's attention_reference, forward and grads."""
    q, k, v, w = _inputs((2, 2, 128, 32), seed=3, n=4)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TA.flash_attention(*t, causal=causal, exact=True)
    (out * torch.from_numpy(w)).sum().backward()

    def loss_j(q, k, v):
        return (JA.attention_reference(q, k, v, causal=causal) * w).sum()

    j = [jnp.asarray(x) for x in (q, k, v)]
    np.testing.assert_allclose(
        _np(out), _np(JA.attention_reference(*j, causal=causal)), **F32)
    for a, b in zip(t, jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(*j)):
        np.testing.assert_allclose(_np(a.grad), _np(b), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_segment_ids_match_jax(causal):
    q, k, v = _inputs((2, 2, 32, 16), seed=4)
    seg = np.asarray([[0] * 10 + [1] * 22, [0] * 5 + [1] * 20 + [2] * 7],
                     np.int32)
    out_j = JA.attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=causal,
                                   segment_ids=(jnp.asarray(seg),
                                                jnp.asarray(seg)))
    ts = torch.from_numpy(seg)
    out_t = TA.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal, segment_ids=(ts, ts))
    np.testing.assert_allclose(_np(out_t), _np(out_j), **F32)


def test_untileable_shapes_take_the_reference():
    """s = 24: the blocks fitted to it fall under 16, so both sides run
    attention_reference."""
    q, k, v = _inputs((1, 2, 24, 16), seed=6)
    out_j = JA.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=True)
    out_t = TA.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=True)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **F32)


def test_wrappers_take_plain_versions_on_cpu_and_launch_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((1, 2, 128, 16),
                                                         n=4))
    kernels.reset_launch_counts()
    o, lse = TA.whole_attention_forward(q, k, v, causal=True)
    ro, rlse = TA.whole_attention_forward_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    g = TA.whole_attention_backward(q, k, v, o, lse, do, causal=True)
    rg = TA.whole_attention_backward_reference(q, k, v, o, lse, do,
                                               causal=True)
    assert all(torch.equal(a, b) for a, b in zip(g, rg))
    assert kernels.launch_counts() == {}


@pytest.mark.parametrize("causal,scale", [(True, 1.0), (False, 1.0),
                                          (True, 8.0)])
def test_f64_yardsticks_match_jax(causal, scale):
    """The f64 functions that the bf16 kernels are held to on the card
    compute what JAX's whole-kv kernels compute, clamp included (f32
    inputs: nothing is rounded to bf16 on either side). Each output
    within 1e-5 * (1 + its largest entry), chip_smoke.py's f32 rule:
    JAX sums in f32, and past the cap dq reaches ~9e3."""
    q, k, v, do = _inputs((1, 2, 128, 64), seed=7, scale=scale, n=4)
    q = (q * 64 ** -0.5).astype(np.float32)
    o_j, lse_j = JA._whole_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal, interpret=True)
    g_j = JA._whole_backward(
        tuple(jnp.asarray(x) for x in (q, k, v)) + (o_j, lse_j),
        jnp.asarray(do), causal=causal, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = TA.whole_attention_forward_f64(tq, tk, tv, causal=causal)
    assert o.dtype == lse.dtype == torch.float64
    grads = TA.whole_attention_backward_f64(
        tq, tk, tv, torch.from_numpy(_np(o_j)),
        torch.from_numpy(_np(lse_j)).reshape(lse.shape), tdo, causal=causal)
    for a, b in zip((o, lse) + grads, (o_j, lse_j) + tuple(g_j)):
        a, b = a.numpy(), _np(b).reshape(a.shape)
        assert np.abs(a - b).max() <= 1e-5 * (1 + np.abs(b).max())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("skip", ["rows past the tile", "last q tile"])
@pytest.mark.parametrize("name", ["o", "lse", "dq", "dk", "dv"])
def test_bf16_rule_rejects_a_skipped_kv_tile(monkeypatch, skip, name):
    """What chip_smoke.py's bf16 check rests on: a version of the plain
    functions that skips the first 64-key tile (for every row past it,
    or for the last 64-row q tile only, as one faulty CTA would) strays
    from the f64 yardstick by more than BF16_RATIO times the plain
    version's own error, in every output it touches."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs((1, 2, 512, 64), seed=8, n=4))
    q = (q * 64 ** -0.5).to(torch.bfloat16)

    def run():
        o, lse = TA.whole_attention_forward_reference(q, k, v, causal=True)
        return dict(zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + tuple(
            TA.whole_attention_backward_reference(q, k, v, ro, rlse, do,
                                                  causal=True))))

    ro, rlse = TA.whole_attention_forward_reference(q, k, v, causal=True)
    plain = run()
    ref = dict(zip(("o", "lse"), TA.whole_attention_forward_f64(
        q, k, v, causal=True)))
    ref.update(zip(("dq", "dk", "dv"), TA.whole_attention_backward_f64(
        q, k, v, ro, rlse, do, causal=True)))
    keep = TA._causal_keep

    def skipping(s, device):
        m = keep(s, device).clone()
        m[(64 if skip == "rows past the tile" else s - 64):, :64] = False
        return m

    monkeypatch.setattr(TA, "_causal_keep", skipping)
    faulty = run()
    assert TA.error_ratios(plain[name], plain[name], ref[name]) == (1.0, 1.0)
    r_max, r_rms = TA.error_ratios(faulty[name], plain[name], ref[name])
    c_max, c_rms = _chip_smoke().BF16_RATIO
    assert r_max > c_max or r_rms > c_rms, (r_max, r_rms)


def test_whole_kv_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty(1, 2, 128, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TA.whole_attention_forward(q, q, q, causal=True)
    with pytest.raises(ValueError, match="no kernel"):
        TA.whole_attention_backward(q, q, q, q, q[..., 0], q, causal=True)
