"""The port's CUDA kernels against their plain versions, on the card
(paged decode; whole-kv and streaming attention, forward and backward).

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


# (B, H, S, D, causal): GPT-2 training's shape, the entry() shape,
# small shapes for each head dim the kernels take, and Llama-2-7B at its
# preset's max_seq_len (2048, d = 128)
WHOLE_SHAPES = [
    (16, 12, 1024, 64, True),
    (4, 12, 512, 64, True),
    (2, 3, 256, 16, True),
    (2, 3, 128, 32, False),
    (1, 2, 192, 128, True),
    (1, 32, 2048, 128, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WHOLE_SHAPES,
                         ids=["train", "entry", "d16", "d32-full", "d128",
                              "llama-2048"])
def test_whole_attention_kernels_match_plain_versions(shape, dtype):
    """Forward (o, lse) and backward (dq, dk, dv) kernels against their
    plain versions on the same inputs, by chip_smoke.py's rules
    (``_hold``): f32 outputs within F32_TOL * (1 + their largest entry)
    (sums in another order, nothing rounded); bf16 outputs, which both
    sides round, measured against the function in f64, the kernel's max
    and rms error at most BF16_RATIO times the plain version's."""
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
    _hold((o, lse) + grads, (ro, rlse) + rgrads, lambda: (
        TA.whole_attention_forward_f64(q, k, v, causal=causal)
        + TA.whole_attention_backward_f64(q, k, v, o, lse, do,
                                          causal=causal)))


def _hold(outs, plains, refs):
    """chip_smoke.py's rules (``held_outputs``): an f32 output within
    F32_TOL * (1 + the plain output's largest entry); a bf16 output's max
    and rms error against the f64 yardstick (``refs()``) at most
    BF16_RATIO times the plain version's."""
    for a, b in zip(outs, plains):
        assert a.dtype == b.dtype and bool(torch.isfinite(a).all())
    names = ["o", "lse", "dq", "dk", "dv"]
    held, bad = _chip_smoke().held_outputs(list(zip(outs, plains)), refs,
                                           names)
    assert not bad, held


# (B, H, Sq, Sk, D, causal[, scale]): Llama-2-7B training (s = 4096,
# d = 128), GPT-2's shape on the exact path, a ragged length (2064 =
# 16 * 129), sq != sk both ways (top-left causal), each head dim, and
# the edges of the wgmma backward (d 64 and 128; 128-row CTA tiles):
# 1040 (a multiple of 16, not of 64), sq != sk with ragged ends, not
# causal, and inputs scaled so that the logits pass 50
FLASH_SHAPES = [
    (2, 32, 4096, 4096, 128, True),
    (16, 12, 1024, 1024, 64, True),
    (1, 4, 2064, 2064, 64, True),
    (2, 3, 128, 256, 32, True),
    (2, 3, 320, 192, 128, True),
    (2, 3, 256, 144, 16, False),
    (2, 4, 1040, 1040, 128, True),
    (2, 3, 128, 256, 128, True),
    (2, 3, 320, 192, 64, True),
    (2, 3, 256, 144, 128, False),
    (2, 3, 144, 400, 64, False),
    (2, 2, 256, 256, 128, True, 8.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=["llama", "gpt2", "ragged", "sq<sk", "sq>sk",
                              "d16-full", "ragged-1040-d128", "sq<sk-d128",
                              "sq>sk-d64", "sq>sk-full-d128",
                              "sq<sk-full-d64", "past-50-d128"])
def test_flash_attention_kernels_match_plain_versions(shape, dtype):
    """Streaming forward (o, lse), dkv (dk, dv) and dq kernels against
    their plain versions at the blocks flash_attention fits, by
    chip_smoke.py's rules, each backward from the plain forward's o and
    lse. One launch of each kernel. bf16 at d = 64 and 128 runs the
    wgmma backward; the scaled case's logits pass 50."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Sq, Sk, D, causal, *scale = shape
    if dtype == "float32" and Sq * Sk > 1 << 23:
        Sq, Sk = Sq // 4, Sk // 4      # the CUDA-core bodies, smaller
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)

    def rand(s):
        return (torch.randn(B, H, s, D, generator=g) * (scale or [1.0])[0]
                ).to("cuda", dt)
    q, k, v, do = rand(Sq), rand(Sk), rand(Sk), rand(Sq)
    q = (q * D ** -0.5).to(dt)
    if scale:
        assert _chip_smoke().max_logit(q, k) > 50.0
    # the plain versions' default blocks are the ones flash_attention fits
    ro, rlse = TA.flash_attention_forward_reference(q, k, v, causal=causal)
    delta = TA._delta(ro, do)
    args = (q, k, v, do, rlse, delta)
    kernels.reset_launch_counts()
    o, lse = TA.flash_attention_forward(q, k, v, causal=causal)
    dk, dv = TA.flash_attention_backward_dkv(*args, causal=causal)
    dq = TA.flash_attention_backward_dq(*args, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"flash_attention_forward": 1,
                                       "flash_attention_backward_dkv": 1,
                                       "flash_attention_backward_dq": 1}
    rdk, rdv = TA.flash_attention_backward_dkv_reference(*args,
                                                         causal=causal)
    rdq = TA.flash_attention_backward_dq_reference(*args, causal=causal)
    _hold((o, lse, dq, dk, dv), (ro, rlse, rdq, rdk, rdv), lambda: (
        TA.flash_attention_forward_f64(q, k, v, causal=causal)
        + TA.flash_attention_backward_f64(q, k, v, ro, rlse, do,
                                          causal=causal)))


@pytest.mark.cuda
def test_whole_attention_kernels_refuse_what_they_do_not_take():
    """The whole-kv and streaming wrappers raise on what their kernels
    do not take; exact=True on the card goes to the streaming kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.randn(1, 2, 128, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        TA.whole_attention_forward(q, q, q, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        TA.flash_attention_forward(q, q, q, causal=True)
    q = torch.randn(1, 2, 128, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        TA.whole_attention_forward(q, q, q, causal=True)
    with pytest.raises(TypeError, match="not supported"):
        TA.flash_attention_forward(q, q, q, causal=True)
    q = torch.randn(1, 2, 128, 64, device="cuda")
    with pytest.raises(ValueError, match="one device"):
        TA.whole_attention_forward(q, q.cpu(), q, causal=True)
    with pytest.raises(ValueError, match="multiples of 16"):
        TA.flash_attention_forward(q[:, :, :100].contiguous(), q, q,
                                   causal=True)
    kernels.reset_launch_counts()
    out = TA.flash_attention(q, q, q, causal=True, exact=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert kernels.launch_counts() == {"flash_attention_forward": 1}
