"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a CUDA device. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    RTPU_ALLOW_MISSING_DEPS=1 python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import kernels
from ray_tpu_torch.ops import attention as TA

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
