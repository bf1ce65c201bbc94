"""The port's CUDA kernels against their plain versions, on the card
(paged decode; whole-kv attention forward and backward).

Marked ``cuda`` and skipped without a CUDA device. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    RTPU_ALLOW_MISSING_DEPS=1 python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ray_tpu_torch import kernels
from ray_tpu_torch.ops import attention as TA


def _chip_smoke():
    """chip_smoke.py, for the tolerances the kernels are held to."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

# (B, H, Hkv, D, bs, NB, lengths): the serving shape (GPT-2 small,
# ragged), a GQA shape, the JAX serving test's tiny shape, and a shape
# with a batch-padding row (length 0)
SHAPES = [
    (16, 12, 12, 64, 16, 64, list(np.linspace(1, 1024, 16).astype(int))),
    (4, 32, 8, 128, 16, 8, [1, 17, 128, 77]),
    (3, 8, 2, 16, 8, 4, [5, 17, 30]),
    (4, 8, 2, 32, 4, 6, [0, 9, 24, 13]),
]


def _inputs(B, H, Hkv, D, bs, NB, lengths, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    P = 1 + B * NB
    dev = "cuda"
    return (torch.randn(B, H, D, generator=g).to(dev, dtype),
            torch.randn(P, bs, Hkv, D, generator=g).to(dev, dtype),
            torch.randn(P, bs, Hkv, D, generator=g).to(dev, dtype),
            (1 + torch.randperm(B * NB, generator=g)).reshape(B, NB).to(
                dev, torch.int32),
            torch.as_tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["serve", "gqa", "tiny",
                                               "padding-row"])
def test_paged_decode_kernel_matches_plain_version(shape, dtype):
    """f32 within 1e-4; bf16 within 2e-2 on unit-normal inputs, since
    p is rounded to bf16 against the running max of its tile rather
    than the final max (about one bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(*shape, getattr(torch, dtype))
    kernels.reset_launch_counts()
    out = TA.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention_decode"] == 1
    ref = TA.paged_attention_reference(*args)
    live = args[4] > 0            # length-0 rows are padding: any finite
    assert bool(torch.isfinite(out).all())
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_cpu_mix():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, bt, lens = _inputs(*SHAPES[2], torch.float32)
    with pytest.raises(ValueError, match="one device"):
        TA.paged_attention_decode(q, k.cpu(), v, bt, lens)


# (B, H, S, D, causal): GPT-2 training's shape, the entry() shape, and
# small shapes for each head dim the kernels take
WHOLE_SHAPES = [
    (16, 12, 1024, 64, True),
    (4, 12, 512, 64, True),
    (2, 3, 256, 16, True),
    (2, 3, 128, 32, False),
    (1, 2, 192, 128, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WHOLE_SHAPES,
                         ids=["train", "entry", "d16", "d32-full", "d128"])
def test_whole_attention_kernels_match_plain_versions(shape, dtype):
    """Forward (o, lse) and backward (dq, dk, dv) kernels against their
    plain versions on the same inputs, by chip_smoke.py's rules. f32:
    each output within F32_TOL * (1 + its largest entry) (sums in
    another order, nothing rounded). bf16: both round e, p, ds and the
    outputs, so each is measured against the function in f64, and the
    kernel's max and rms error may be at most BF16_RATIO times the
    plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, S, D, causal = shape
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to("cuda", dt)
                   for _ in range(4))
    q = (q * D ** -0.5).to(dt)
    kernels.reset_launch_counts()
    o, lse = TA.whole_attention_forward(q, k, v, causal=causal)
    grads = TA.whole_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"whole_attention_forward": 1,
                                       "whole_attention_backward": 1}
    ro, rlse = TA.whole_attention_forward_reference(q, k, v, causal=causal)
    rgrads = TA.whole_attention_backward_reference(q, k, v, o, lse, do,
                                                   causal=causal)
    refs = (TA.whole_attention_forward_f64(q, k, v, causal=causal)
            + TA.whole_attention_backward_f64(q, k, v, o, lse, do,
                                              causal=causal))
    rules = _chip_smoke()
    for a, b, ref in zip((o, lse) + grads, (ro, rlse) + rgrads, refs):
        assert a.dtype == b.dtype and bool(torch.isfinite(a).all())
        if dtype == "float32":
            scale = 1 + float(b.float().abs().max())
            assert (float((a.float() - b.float()).abs().max())
                    <= rules.F32_TOL * scale)
        else:
            r_max, r_rms = TA.error_ratios(a, b, ref)
            c_max, c_rms = rules.BF16_RATIO
            assert r_max <= c_max and r_rms <= c_rms, (r_max, r_rms)


@pytest.mark.cuda
def test_whole_attention_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.randn(1, 2, 128, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        TA.whole_attention_forward(q, q, q, causal=True)
    q = torch.randn(1, 2, 128, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        TA.whole_attention_forward(q, q, q, causal=True)
    q = torch.randn(1, 2, 128, 64, device="cuda")
    with pytest.raises(ValueError, match="one device"):
        TA.whole_attention_forward(q, q.cpu(), q, causal=True)
    with pytest.raises(NotImplementedError, match="Queue B"):
        TA.flash_attention(q, q, q, causal=True, exact=True)
