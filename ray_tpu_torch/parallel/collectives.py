"""Collective communication facade: the port of
``ray_tpu/parallel/collectives.py``.

The JAX package lowers these to XLA collectives over the ICI mesh inside
jit/shard_map programs. The port runs one process per device, so each
op is a ``torch.distributed`` collective on the process group of one
mesh axis (NCCL on the card, gloo on the CPU).

Two layers, as in the JAX package:
1. In-program: ``psum``, ``pmean``, ``pmax``, ``all_gather``,
   ``reduce_scatter``, ``ppermute``, ``all_to_all``, ``axis_index``,
   ``ring_neighbors``, keyed by a mesh axis name of a built ``Mesh``
   (or, as JAX takes a tuple of names, ``mesh.BATCH_AXES``: dp and
   fsdp as one axis).
   On a mesh without a process group every axis has size 1 and each op
   returns its input. ``psum_forward`` and ``psum_backward`` are the
   two halves of a tensor-parallel region for autograd (Megatron's g
   and f): a sum in the forward with the gradient passed through, and
   the identity with the gradient summed; ``all_gather_forward`` is
   the gather counterpart of the first, and ``all_to_all_grad`` an
   all_to_all whose gradient is the inverse exchange (MoE's dispatch).
2. Host-level: ``init_collective_group`` / ``allreduce`` / ``barrier``
   in the reference's API shape, on a subgroup of the process group.

``initialize_distributed`` forms the process group.

Every collective this module issues adds one to its op's call count
(``call_counts()``; ``reset_call_counts()``), as the kernel wrappers
count their launches, so a run can show that the mesh route ran.
"""

from __future__ import annotations

import datetime
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_lock = threading.Lock()
_calls: Dict[str, int] = {}


def _count(name: str):
    with _lock:
        _calls[name] = _calls.get(name, 0) + 1


def call_counts() -> Dict[str, int]:
    with _lock:
        return dict(_calls)


def reset_call_counts():
    with _lock:
        _calls.clear()


# --------------------------------------------------------------------------
# Layer 1: in-program collectives over one mesh axis


def _group(mesh, axis: str):
    """The axis's process group, or None where the op is the identity
    (no process group)."""
    return mesh.group(axis)


def _all_reduce(x: torch.Tensor, op, axis: str, mesh) -> torch.Tensor:
    group = _group(mesh, axis)
    if group is None:
        return x
    out = x.detach().clone()
    _count("all_reduce")
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Sum over the axis (a new tensor). Like every op of this layer
    but ``psum_forward`` and ``psum_backward`` it records no autograd
    history."""
    return _all_reduce(x, dist.ReduceOp.SUM, axis, mesh)


def pmean(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Mean over the axis (gloo has no AVG: the sum over the size)."""
    return psum(x, axis, mesh) / mesh.size(axis)


def pmax(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MAX, axis, mesh)


def all_gather(x: torch.Tensor, axis: str, mesh, *, tiled: bool = True,
               gather_axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``gather_axis`` in axis order:
    concatenated (``tiled``) or stacked in a new dim there."""
    group = _group(mesh, axis)
    if group is None:
        return x if tiled else x.unsqueeze(gather_axis)
    n = mesh.size(axis)
    flat = x.detach().contiguous().view(-1)
    buf = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    _count("all_gather")
    dist.all_gather_into_tensor(buf, flat, group=group)
    buf = buf.view((n,) + tuple(x.shape))
    if not tiled:
        return buf.movedim(0, gather_axis)
    return torch.cat(buf.unbind(0), dim=gather_axis)


def reduce_scatter(x: torch.Tensor, axis: str, mesh, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """The sum over the axis, of which each rank keeps its chunk along
    ``scatter_axis`` (tiled)."""
    group = _group(mesh, axis)
    if group is None:
        return x
    n = mesh.size(axis)
    chunks = x.detach().movedim(scatter_axis, 0).contiguous()
    out = torch.empty((chunks.shape[0] // n,) + tuple(chunks.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("reduce_scatter")
    dist.reduce_scatter_tensor(out, chunks, group=group)
    return out.movedim(0, scatter_axis)


def ppermute(x: torch.Tensor, axis: str, mesh, perm: Sequence[tuple], *,
             async_op: bool = False):
    """Send ``x`` along each (source, destination) pair of axis indices;
    a rank that receives nothing gets zeros (``jax.lax.ppermute``).
    ``async_op=True`` returns ``(out, wait)`` at once: ``out`` holds
    what arrives after ``wait()`` (the transfer overlaps what the rank
    does meanwhile)."""
    group = _group(mesh, axis)
    if group is None:
        out = x.clone() if (0, 0) in set(map(tuple, perm)) else \
            torch.zeros_like(x)
        return (out, lambda: None) if async_op else out
    me = mesh.index(axis)
    ranks = dist.get_process_group_ranks(group)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[dst],
                                  group=group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group=group))
    reqs = []
    if ops:
        _count("ppermute")
        reqs = dist.batch_isend_irecv(ops)

    def wait(_sent=ops):      # keeps the sent buffers alive until then
        for req in reqs:
            req.wait()
    if async_op:
        return out, wait
    wait()
    return out


def all_to_all(x: torch.Tensor, axis: str, mesh, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Split ``x`` into axis-size chunks along ``split_axis``, send chunk
    j to index j, and concatenate what arrives along ``concat_axis``
    (tiled)."""
    group = _group(mesh, axis)
    if group is None:
        return x
    n = mesh.size(axis)
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    _count("all_to_all")
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def axis_index(axis: str, mesh) -> int:
    return mesh.index(axis)


def ring_neighbors(axis: str, axis_size: int):
    """(forward, backward) permutation lists for a ring over `axis`."""
    fwd = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    bwd = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    return fwd, bwd


class _PsumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis, ctx.mesh), None, None


def psum_forward(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Sum the axis's partial results into a replicated tensor; its
    gradient, the same on every rank, passes through."""
    if _group(mesh, axis) is None:
        return x
    return _PsumForward.apply(x, axis, mesh)


def psum_backward(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """The identity on a replicated tensor that each rank then uses for
    its own part of the work: the gradients of the parts are summed."""
    if _group(mesh, axis) is None:
        return x
    return _PsumBackward.apply(x, axis, mesh)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split_axis, concat_axis):
        ctx.args = axis, mesh, split_axis, concat_axis
        return all_to_all(x, axis, mesh, split_axis=split_axis,
                          concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, split_axis, concat_axis = ctx.args
        return (all_to_all(g, axis, mesh, split_axis=concat_axis,
                           concat_axis=split_axis), None, None, None, None)


def all_to_all_grad(x: torch.Tensor, axis: str, mesh, *, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    """``all_to_all`` with autograd: its gradient is the inverse
    exchange (split where the forward concatenated, and back)."""
    if _group(mesh, axis) is None:
        return x
    return _AllToAll.apply(x, axis, mesh, split_axis, concat_axis)


class _AllGatherForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, gather_axis):
        ctx.args = axis, mesh, gather_axis
        return all_gather(x, axis, mesh, gather_axis=gather_axis)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, gather_axis = ctx.args
        part = g.chunk(mesh.size(axis), dim=gather_axis)[mesh.index(axis)]
        return part, None, None, None


def all_gather_forward(x: torch.Tensor, axis: str, mesh, *,
                       gather_axis: int = 0) -> torch.Tensor:
    """Gather the axis's parts into a replicated tensor (tiled along
    ``gather_axis``); like ``psum_forward`` its gradient, the same on
    every rank, is not summed: each rank keeps its own part of it."""
    if _group(mesh, axis) is None:
        return x
    return _AllGatherForward.apply(x, axis, mesh, gather_axis)


# --------------------------------------------------------------------------
# Layer 2: host-level eager collective groups (reference-API compatible)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


class CollectiveGroup:
    """Ranks 0 .. world_size - 1 of the process group, as one named
    group. Each rank makes its own and passes its own tensor."""

    def __init__(self, name: str, world_size: int, rank: int):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"group {name}: no process group; call "
                               "initialize_distributed first")
        if world_size > dist.get_world_size():
            raise ValueError(
                f"group {name}: world_size {world_size} exceeds the "
                f"process group's {dist.get_world_size()} ranks")
        if rank != dist.get_rank():
            raise ValueError(f"group {name}: rank {rank} is process rank "
                             f"{dist.get_rank()}")
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.group = (dist.group.WORLD if world_size == dist.get_world_size()
                      else dist.new_group(list(range(world_size))))

    def allreduce(self, tensor: torch.Tensor, op: str = "sum"):
        """This rank's ``tensor`` reduced over the group (a new tensor;
        "mean" is the sum over the group's size)."""
        out = tensor.clone()
        _count("all_reduce")
        dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op],
                        group=self.group)
        return out / self.world_size if op == "mean" else out

    def barrier(self):
        _count("barrier")
        dist.barrier(group=self.group)


_groups: Dict[str, CollectiveGroup] = {}


def init_collective_group(world_size: int, rank: int,
                          backend: str = "nccl",
                          group_name: str = "default") -> CollectiveGroup:
    """Reference-parity signature (collective.py:120). ``backend`` names
    the process group's backend, which ``initialize_distributed`` chose;
    a different one is refused."""
    if dist.is_available() and dist.is_initialized() and \
            dist.get_backend() != backend:
        raise ValueError(f"group {group_name}: backend {backend!r}, but "
                         f"the process group runs {dist.get_backend()!r}")
    g = CollectiveGroup(group_name, world_size, rank)
    _groups[group_name] = g
    return g


def get_group(group_name: str = "default") -> CollectiveGroup:
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default"):
    _groups.pop(group_name, None)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(tensor, op)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()


# --------------------------------------------------------------------------
# Process-group bootstrap


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[List[int]] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 600.0):
    """Form the process group: ``dist.init_process_group``.

    ``coordinator_address`` is an init method (``tcp://host:port`` or
    ``file:///path``); with it and the other two left None the group
    reads torchrun's environment (``env://``). ``backend``: NCCL where
    CUDA is available, else gloo. ``local_device_ids[0]`` becomes this
    process's CUDA device. A collective that waits longer than
    ``timeout_s`` fails instead of hanging."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids and backend == "nccl":
        torch.cuda.set_device(local_device_ids[0])
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method=coordinator_address,
                      world_size=num_processes, rank=process_id)
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
