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
# ragged), a GQA shape, the JAX serving test's tiny shape, a shape
# with a batch-padding row (length 0), one long sequence beside a
# short one (chip_smoke.py's case d), and lengths on and one past the
# kernel's split boundaries (case e: splits of 128 tokens in f32, 256
# in bf16) with a length-0 row and a full table
SHAPES = [
    (16, 12, 12, 64, 16, 64, list(np.linspace(1, 1024, 16).astype(int))),
    (4, 32, 8, 128, 16, 8, [1, 17, 128, 77]),
    (3, 8, 2, 16, 8, 4, [5, 17, 30]),
    (4, 8, 2, 32, 4, 6, [0, 9, 24, 13]),
    (2, 32, 8, 128, 16, 256, [4096, 1]),
    (8, 12, 12, 64, 16, 64, [0, 1, 127, 128, 129, 256, 257, 1024]),
    # Llama-2-7B serving: G = 1 at D 128, a full 128-page table
    (16, 32, 32, 128, 16, 128, [1, 17, 127, 128, 129, 255, 256, 257, 700,
                                 1023, 1024, 1025, 1536, 2000, 2047, 2048]),
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
                                               "padding-row",
                                               "long-small-batch",
                                               "split-edges",
                                               "llama-serve"])
def test_paged_decode_kernel_matches_plain_version(shape, dtype):
    """f32 within 1e-4; bf16 within 2e-2 on unit-normal inputs, since
    p is rounded to bf16 against a running max rather than the final
    max (about one bf16 ulp), and by chip_smoke.py's ratio rule against
    the function in f64. Length-0 rows (batch padding) are zeros. One
    launch counted for the split and merge kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(*shape, getattr(torch, dtype))
    kernels.reset_launch_counts()
    out = TA.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"paged_attention_decode": 1}
    ref = TA.paged_attention_reference(*args)
    live = args[4] > 0
    assert bool(torch.isfinite(out).all()) and not out[~live].any()
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=tol, atol=tol)
    if dtype == "bfloat16":
        ratio = TA.error_ratios(out[live], ref[live],
                                TA.paged_attention_f64(*args)[live])
        limit = _chip_smoke().BF16_RATIO
        assert ratio[0] <= limit[0] and ratio[1] <= limit[1], ratio
    plan = TA.paged_split_plan(*shape[:2], shape[3], shape[4], shape[5],
                               out.element_size())
    assert (TA._paged_lib().rtt_paged_decode_smem_bytes(plan.split_pages)
            == plan.smem_bytes)


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_cpu_mix():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, bt, lens = _inputs(*SHAPES[2], torch.float32)
    with pytest.raises(ValueError, match="one device"):
        TA.paged_attention_decode(q, k.cpu(), v, bt, lens)


# (B, H, S, D, causal[, scale]): GPT-2 training's shape, the entry()
# shape, small shapes for each head dim the kernels take, Llama-2-7B at
# its preset's max_seq_len (2048, d = 128), and the edges of the wgmma
# backward (d 64 and 128; 128-row CTA tiles): 192 and 320 (multiples of
# 64, not of 128), not causal, and inputs scaled so that the logits
# pass the cap
WHOLE_SHAPES = [
    (16, 12, 1024, 64, True),
    (4, 12, 512, 64, True),
    (2, 3, 256, 16, True),
    (2, 3, 128, 32, False),
    (1, 2, 192, 128, True),
    (1, 32, 2048, 128, True),
    (2, 3, 320, 64, True),
    (2, 3, 256, 64, False),
    (2, 2, 256, 128, True, 8.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WHOLE_SHAPES,
                         ids=["train", "entry", "d16", "d32-full", "d128",
                              "llama-2048", "s320-d64", "d64-full",
                              "past-cap-d128"])
def test_whole_attention_kernels_match_plain_versions(shape, dtype):
    """Forward (o, lse) and backward (dq, dk, dv) kernels against their
    plain versions on the same inputs, by chip_smoke.py's rules
    (``_hold``): f32 outputs within F32_TOL * (1 + their largest entry)
    (sums in another order, nothing rounded); bf16 outputs, which both
    sides round, measured against the function in f64, the kernel's max
    and rms error at most BF16_RATIO times the plain version's. bf16 at
    d = 64 and 128 runs the wgmma backward; the scaled case's logits
    pass the cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, S, D, causal, *scale = shape
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = ((torch.randn(B, H, S, D, generator=g)
                    * (scale or [1.0])[0]).to("cuda", dt) for _ in range(4))
    q = (q * D ** -0.5).to(dt)
    if scale:
        assert _chip_smoke().max_logit(q, k) > 50.0
    kernels.reset_launch_counts()
    o, lse = TA.whole_attention_forward(q, k, v, causal=causal)
    grads = TA.whole_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"whole_attention_forward": 1,
                                       "whole_attention_backward": 1,
                                       "attention_delta": 1}
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
    delta = TA.attention_delta_reference(ro, do)
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_attention_delta_kernel_matches_plain_version(D, dtype):
    """delta = rowsum(o * do) in f32 against its plain version, by
    chip_smoke.py's f32 rule (only the order of the sum differs), on a
    row count that does not fill the last block; one launch counted.
    It refuses a head dim it does not take and mixed shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    o, do = (torch.randn(2, 3, 100, D, generator=g).to("cuda", dt)
             for _ in range(2))
    kernels.reset_launch_counts()
    delta = TA.attention_delta(o, do)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"attention_delta": 1}
    plain = TA.attention_delta_reference(o, do)
    assert delta.dtype == torch.float32 and delta.shape == plain.shape
    held, bad = _chip_smoke().held_outputs([(delta, plain)], None,
                                           ["delta"])
    assert not bad, held
    with pytest.raises(ValueError, match="one shape"):
        TA.attention_delta(o, do[:, :, :50].contiguous())
    x = torch.randn(2, 48, device="cuda", dtype=dt)
    with pytest.raises(ValueError, match="one shape"):
        TA.attention_delta(x, x)


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
