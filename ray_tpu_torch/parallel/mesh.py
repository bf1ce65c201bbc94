"""Device mesh layout: the port's copy of ``ray_tpu/parallel/mesh.py``.

Named axes, outermost first (``AXIS_ORDER``):

    dp   -- data parallel (batch split; grads summed)
    fsdp -- fully-sharded data parallel (weights sharded with the batch)
    pp   -- pipeline parallel (layer groups)
    ep   -- expert parallel (MoE experts)
    sp   -- sequence parallel (ring attention over sequence shards)
    tp   -- tensor parallel (weight matrices split)

``MeshSpec`` validates the axis product against the device count with
the JAX package's errors. This slice runs one device: ``build`` takes
exactly one and raises ``NotImplementedError`` for more; dp/fsdp over
NCCL come next (ROADMAP.md Queue A item 4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXIS_ORDER = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a built ``MeshSpec``, shaped by ``AXIS_ORDER``."""
    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = AXIS_ORDER


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout, independent of physical devices."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes().values())

    def active_axes(self) -> List[str]:
        return [a for a in AXIS_ORDER if getattr(self, a) > 1]

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "MeshSpec":
        unknown = set(d) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; valid: {AXIS_ORDER}")
        return cls(**d)

    def with_auto_dp(self, num_devices: int) -> "MeshSpec":
        """Fill the dp axis to absorb remaining devices."""
        fixed = self.num_devices // max(self.dp, 1)
        if num_devices % fixed != 0:
            raise ValueError(
                f"{num_devices} devices not divisible by non-dp axes ({fixed})")
        return dataclasses.replace(self, dp=num_devices // fixed)

    def build(self, devices: Optional[Sequence] = None) -> Mesh:
        """A ``Mesh`` over the given devices (default: every visible CUDA
        device). One device in this slice."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if self.num_devices != len(devices):
            raise ValueError(
                f"MeshSpec wants {self.num_devices} devices "
                f"({self.axis_sizes()}), got {len(devices)}")
        if self.num_devices > 1:
            raise NotImplementedError(
                f"{self.describe()}: the port trains on one device so far; "
                "dp/fsdp over NCCL are ROADMAP.md Queue A item 4")
        shape = tuple(self.axis_sizes()[a] for a in AXIS_ORDER)
        return Mesh(tuple(devices), shape)

    def describe(self) -> str:
        active = {a: getattr(self, a) for a in self.active_axes()}
        return f"MeshSpec({active or 'single-device'})"
