"""The ResNet training step on the card against the same step on the
CPU (cuDNN's convs and batch norm against oneDNN's, channels_last all
through), by ``chip_smoke.resnet_parity`` and its tolerances.

Marked ``cuda`` and skipped without a CUDA device. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    RTPU_ALLOW_MISSING_DEPS=1 python -m pytest tests/test_torch_resnet_cuda.py -q
"""

import importlib.util
import os

import pytest
import torch


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_narrow_resnet_step_on_card_matches_cpu():
    """One step of the narrow bottleneck ResNet (f32, TF32 off): loss
    within RESNET_LOSS_REL relative, logits, params and batch stats
    within RESNET_TOL of each tensor's scale, every conv input
    channels_last on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cs = _chip_smoke()
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = cs.resnet_parity()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    assert res["loss_rel"] <= cs.RESNET_LOSS_REL
    assert res["worst"] <= cs.RESNET_TOL
