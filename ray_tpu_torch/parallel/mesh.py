"""Device mesh layout: the port's copy of ``ray_tpu/parallel/mesh.py``.

Named axes, outermost first (``AXIS_ORDER``):

    dp   -- data parallel (batch split; grads summed)
    fsdp -- fully-sharded data parallel (weights sharded with the batch)
    pp   -- pipeline parallel (layer groups)
    ep   -- expert parallel (MoE experts)
    sp   -- sequence parallel (ring attention over sequence shards)
    tp   -- tensor parallel (weight matrices split)

``MeshSpec`` validates the axis product against the device count with
the JAX package's errors. Where the JAX package builds one
``jax.sharding.Mesh`` over every chip, the port runs one process per
device: with a process group initialised (``collectives.
initialize_distributed``: NCCL on the card, gloo on the CPU)
``MeshSpec.build`` lays its axes over the group's ranks as a torch
``DeviceMesh``, whose per-axis process groups the collectives run on.
Without a process group it takes exactly one device (the route that
needs no collective). Every axis gets its process group; so do the
tuples ``BATCH_AXES`` (what a batch's sums run over) and
``TOKEN_AXES`` (the same with sp: a causal LM's tokens are split over
(dp, fsdp) by rows and over sp by positions).

The sharding rules (``param_sharding``, ``_tp_hint``) are the JAX
package's, on the same flax-style param paths and flax shapes; they
return DTensor placements, one per mesh axis, in place of a
``PartitionSpec``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

AXIS_ORDER = ("dp", "fsdp", "pp", "ep", "sp", "tp")
BATCH_AXES = ("dp", "fsdp")     # the axes the batch dim is split over
TOKEN_AXES = ("dp", "fsdp", "sp")   # ... and with sp, the sequence dim


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A built ``MeshSpec``: its shape in ``AXIS_ORDER`` and the local
    device(s). ``device_mesh`` is the torch ``DeviceMesh`` over the
    process group's ranks (None without a process group: one device,
    every axis of size 1); ``coordinate`` is this rank's index on each
    axis; ``groups`` holds each axis's process group.

    An axis is a name of ``AXIS_ORDER`` or, as in JAX, one of the tuples
    ``BATCH_AXES`` (dp and fsdp as one, dp-major: the group that the
    batch's sums run on) and ``TOKEN_AXES`` (dp, fsdp and sp as one)."""
    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = AXIS_ORDER
    device_mesh: Any = None
    coordinate: Tuple[int, ...] = (0,) * len(AXIS_ORDER)
    groups: Mapping[Any, Any] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def size(self, axis) -> int:
        if isinstance(axis, tuple):
            return math.prod(self.size(a) for a in axis)
        return self.shape[AXIS_ORDER.index(axis)]

    def index(self, axis) -> int:
        if isinstance(axis, tuple):
            i = 0
            for a in axis:
                i = i * self.size(a) + self.index(a)
            return i
        return self.coordinate[AXIS_ORDER.index(axis)]

    def group(self, axis):
        """The process group of ``axis`` (None without a process
        group)."""
        if self.device_mesh is None:
            return None
        if axis not in self.groups:
            raise ValueError(f"axis {axis!r}: the groups are those of "
                             f"{AXIS_ORDER}, {BATCH_AXES} and {TOKEN_AXES}")
        return self.groups[axis]


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
        """A ``Mesh``. With an initialised process group: a
        ``DeviceMesh`` over its ranks (``cuda`` under NCCL, ``cpu``
        under gloo), and ``devices`` names this rank's device (default:
        the current CUDA device, or the CPU). Without one: the given
        devices (default: every visible CUDA device), which must be
        exactly one."""
        import torch.distributed as dist

        shape = tuple(self.axis_sizes()[a] for a in AXIS_ORDER)
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if self.num_devices != world:
                raise ValueError(
                    f"MeshSpec wants {self.num_devices} devices "
                    f"({self.axis_sizes()}), got {world}")
            from torch.distributed.device_mesh import DeviceMesh
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            if devices:
                dev = torch.device(devices[0])
            elif device_type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            else:
                dev = torch.device("cpu")
            if dev.type != device_type:
                raise ValueError(f"a {dist.get_backend()} process group "
                                 f"runs on {device_type}, not {dev}")
            ranks = _topology_aware_reshape(range(world), shape)
            dm = DeviceMesh(device_type, ranks, mesh_dim_names=AXIS_ORDER)
            groups = {a: dm.get_group(a) for a in AXIS_ORDER}
            for axes in (BATCH_AXES, TOKEN_AXES):
                # the same ranks as (the axes' product, the rest), those
                # axes outermost in their order: the first axis's groups
                # are the tuple's
                dims = [AXIS_ORDER.index(a) for a in axes]
                rest = [d for d in range(len(AXIS_ORDER)) if d not in dims]
                joined = DeviceMesh(device_type, ranks.permute(
                    dims + rest).reshape(math.prod(
                        shape[d] for d in dims), -1),
                    mesh_dim_names=("joined", "rest"))
                groups[axes] = joined.get_group("joined")
            return Mesh((dev,), shape, device_mesh=dm,
                        coordinate=tuple(dm.get_coordinate()),
                        groups=groups)
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if self.num_devices != len(devices):
            raise ValueError(
                f"MeshSpec wants {self.num_devices} devices "
                f"({self.axis_sizes()}), got {len(devices)}")
        if self.num_devices > 1:
            raise RuntimeError(
                f"{self.describe()}: a mesh over {self.num_devices} devices "
                "runs one process per device and needs an initialised "
                "process group of as many ranks "
                "(collectives.initialize_distributed)")
        return Mesh(tuple(devices), shape)

    def describe(self) -> str:
        active = {a: getattr(self, a) for a in self.active_axes()}
        return f"MeshSpec({active or 'single-device'})"


def _topology_aware_reshape(ranks: Sequence[int],
                            shape: Tuple[int, ...]) -> torch.Tensor:
    """The ranks in rank order, shaped by the mesh: the innermost axes
    (tp) take consecutive ranks. On a TPU the JAX package orders chips
    so that the innermost axes are ICI neighbours; the GPUs of one host
    are joined all to all by NVLink, so rank order needs no reshape."""
    return torch.as_tensor(list(ranks), dtype=torch.int64).reshape(shape)


def single_axis_mesh(axis: str, devices: Optional[Sequence] = None) -> Mesh:
    """Convenience: a 1-axis mesh (e.g. pure data parallel) over every
    rank of the process group, or over ``devices`` without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
    else:
        n = len(devices) if devices is not None else torch.cuda.device_count()
    return MeshSpec.from_dict({axis: n}).build(devices)


# ---------------------------------------------------------------------------
# Sharding rules


def _placements(assign: Sequence[Optional[str]]) -> tuple:
    """A PartitionSpec's per-dim axis names -> one DTensor placement per
    mesh axis (``Shard(dim)`` where an axis splits a dim)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(AXIS_ORDER)
    for dim, axes in enumerate(assign):
        for axis in ((axes,) if isinstance(axes, str) else axes or ()):
            out[AXIS_ORDER.index(axis)] = Shard(dim)
    return tuple(out)


def param_sharding(mesh, path: Tuple[str, ...], shape: Tuple[int, ...],
                   spec: MeshSpec) -> tuple:
    """Default parameter placements under a MeshSpec: one DTensor
    placement per mesh axis (``AXIS_ORDER``), for a param at the
    flax-style ``path`` with the flax ``shape`` (a Dense kernel [in,
    out], a conv kernel HWIO). ``mesh`` is not read: the rules need
    only the spec.

    Policy (the JAX package's, the standard megatron/fsdp hybrid):
      - tp shards the largest dim that ``_tp_hint`` allows;
      - fsdp shards the largest remaining dim;
      - 1-D params replicate, except that fsdp shards one of at least
        1,024 entries.
    """
    ndim = len(shape)
    assign: List[Optional[str]] = [None] * ndim
    if ndim >= 2:
        order = sorted(range(ndim), key=lambda i: -shape[i])
        if spec.tp > 1:
            for i in order:
                if shape[i] % spec.tp == 0 and _tp_hint(path, i, ndim):
                    assign[i] = "tp"
                    break
        if spec.fsdp > 1:
            for i in order:
                if assign[i] is None and shape[i] % spec.fsdp == 0:
                    assign[i] = "fsdp"
                    break
    elif ndim == 1 and spec.fsdp > 1 and shape[0] % spec.fsdp == 0 and \
            shape[0] >= 1024:
        assign[0] = "fsdp"
    return _placements(assign)


def _tp_hint(path: Tuple[str, ...], dim: int, ndim: int) -> bool:
    """The JAX package's heuristic: 'out' projections (names with
    out_proj, down_proj, wo, o_proj or fc2) shard their input dim,
    every other weight its output (last) dim. GPT-2's ``c_proj`` is not
    in the list, so it shards its output dim too (a quirk of the
    reference, kept)."""
    name = "/".join(str(p) for p in path).lower()
    if any(k in name
           for k in ("out_proj", "down_proj", "wo", "o_proj", "fc2")):
        return dim == 0
    return dim == ndim - 1


def data_sharding(mesh, batch_ndim: int = 1) -> tuple:
    """The batch dim split over (dp, fsdp), dp-major; the rest
    replicated."""
    return _placements([BATCH_AXES] + [None] * (batch_ndim - 1))


def replicated(mesh) -> tuple:
    return _placements([])


def shard_dims(placements) -> Dict[str, int]:
    """{axis: tensor dim} of the axes that shard a tensor."""
    return {a: p.dim for a, p in zip(AXIS_ORDER, placements)
            if p.is_shard()}


def local_shard(t: torch.Tensor, placements, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``placements`` (a view): each
    sharding axis, outermost first, takes its coordinate's chunk."""
    for axis, dim in shard_dims(placements).items():
        t = t.chunk(mesh.size(axis), dim=dim)[mesh.index(axis)]
    return t


def _tree_map(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def sharding_pytree(params, mesh, spec: MeshSpec):
    """The placements of every leaf of a flax-style params tree (nested
    dicts keyed by flax names, leaves with flax shapes)."""
    return _tree_map(lambda path, leaf: param_sharding(
        mesh, path, tuple(leaf.shape), spec), params)


def shard_params(params, mesh: Mesh, spec: MeshSpec):
    """``param_sharding`` applied across a flax-style params tree of
    tensors: each leaf becomes a DTensor holding this rank's block.
    Without a process group (one device) the leaves come back as they
    are."""
    if mesh.device_mesh is None:
        return params
    from torch.distributed.tensor import DTensor

    def put(path, leaf):
        pl = param_sharding(mesh, path, tuple(leaf.shape), spec)
        return DTensor.from_local(local_shard(torch.as_tensor(leaf), pl, mesh),
                                  mesh.device_mesh, pl, run_check=False)
    return _tree_map(put, params)
