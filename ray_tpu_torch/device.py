"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu`` (as
the tests do). Without CUDA, asking for it raises: nothing quietly
carries on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda | cpu)")
    return dev
