"""Pipeline parallelism: the port of ``ray_tpu/parallel/pipeline.py``.

A microbatched GPipe-shaped schedule over the ``pp`` mesh axis. Each pp
rank holds one stage; the stage params of all S stages are stacked on a
leading axis and rank i takes row i (the JAX package shards that axis
``P("pp")``). The forward runs T = M + S - 1 ticks: at tick t stage s
applies its slice to microbatch t - s (while there is one) and passes
the activation to stage s + 1; stage 0 takes microbatch t from the
input. The last stage's outputs are then sent to every pp rank, so what
follows (the loss) is the same on every rank. The backward runs the
ticks in reverse: the last stage starts from its outputs' gradient,
every stage backpropagates through its slice, sends its input's
gradient to the stage before it, and stage 0's input gradients are sent
to every pp rank.

Gradients, as on the rest of the mesh (``collectives.psum_forward``):
the loss is replicated over pp, so the outputs' gradient is taken once
(the last stage's), not summed over the ranks; the input's gradient
(stage 0's) reaches every pp rank whole; each rank holds its own
stage's param gradients and zeros for the other rows.

Neither ``torch.distributed``'s send and recv nor ``batch_isend_irecv``
has autograd, so the whole schedule is one ``torch.autograd.Function``
that runs the forward and then, in its backward, the reverse ticks over
the kept microbatch inputs (``remat``: each stage's forward under
``torch.utils.checkpoint``, run again in the backward) or the kept
graphs. Stages do work only on the ticks where they hold a microbatch;
M need not divide by S. ``sequential_apply`` is the pp = 1 semantics,
the parity oracle.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import collectives as C


def _flatten(tree, out=None) -> List[torch.Tensor]:
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        out.append(tree)
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, remat, mesh, axis, tree, microbatches, *leaves):
        S, s = _size(mesh, axis), _index(mesh, axis)
        M = microbatches.shape[0]
        ctx.args = fn, mesh, axis, tree, S, s, M, remat
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        fwd = [(i, i + 1) for i in range(S - 1)]
        kept, outs = [], [None] * M
        buf = None
        for t in range(M + S - 1):
            m = t - s
            send = None
            if 0 <= m < M:
                x = (microbatches[m] if s == 0 else buf).detach()
                x.requires_grad_(s > 0 or microbatches.requires_grad)
                with torch.enable_grad():
                    p_tree = _unflatten(tree, params)
                    y = (checkpoint(fn, p_tree, x, use_reentrant=False)
                         if remat else fn(p_tree, x))
                kept.append((x, y))
                send = y.detach()
                if s == S - 1:
                    outs[m] = send
            if S > 1:
                if send is None:
                    send = torch.zeros_like(microbatches[0])
                buf = C.ppermute(send, axis, mesh, fwd)
        if s == S - 1:
            out = torch.stack(outs)
        else:
            out = torch.zeros_like(microbatches)
        ctx.kept, ctx.params = kept, params
        if S > 1:
            # the last stage's outputs to every pp rank: a sum of them
            # and zeros, in f32 (exact)
            out = C.psum(out.float(), axis, mesh).to(microbatches.dtype)
        return out

    @staticmethod
    def backward(ctx, g_out):
        fn, mesh, axis, tree, S, s, M, remat = ctx.args
        kept, params = ctx.kept, ctx.params
        bwd = [(i + 1, i) for i in range(S - 1)]
        grads = [None] * len(params)
        g_in = torch.zeros_like(g_out)
        buf = None
        for b in range(M + S - 1):
            m = M - 1 - (b - (S - 1 - s))
            send = None
            if 0 <= m < M:
                x, y = kept[m]
                g_y = g_out[m] if s == S - 1 else buf
                wrt = [x] * x.requires_grad + [p for p in params
                                                if p.requires_grad]
                got = list(torch.autograd.grad(y, wrt, g_y,
                                               allow_unused=True))
                if x.requires_grad:
                    g_x = got.pop(0)
                    send = g_x
                    if s == 0:
                        g_in[m] = g_x
                it = iter(got)
                for i, p in enumerate(params):
                    if p.requires_grad:
                        g = next(it)
                        if g is not None:
                            grads[i] = g if grads[i] is None else grads[i] + g
                kept[m] = None      # free the microbatch's graph
            if S > 1:
                if send is None:
                    send = torch.zeros_like(g_out[0])
                buf = C.ppermute(send.contiguous(), axis, mesh, bwd)
        if S > 1:
            # stage 0's input gradients to every pp rank
            g_in = C.psum(g_in.float(), axis, mesh).to(g_out.dtype)
        grads = [torch.zeros_like(p) if g is None and p.requires_grad else g
                 for p, g in zip(params, grads)]
        ctx.kept = ctx.params = None
        return (None, None, None, None, None, g_in, *grads)


def _size(mesh, axis) -> int:
    return 1 if mesh is None else mesh.size(axis)


def _index(mesh, axis) -> int:
    return 0 if mesh is None else mesh.index(axis)


def pipeline_run(fn: Callable, params, microbatches: torch.Tensor, mesh,
                 *, axis: str = "pp", remat: bool = True) -> torch.Tensor:
    """The schedule on this rank's stage: ``fn(params, x) -> y`` with
    y.shape == x.shape, ``params`` this rank's stage params (a dict
    tree of tensors), ``microbatches`` [M, mb, ...] -> outputs [M, mb,
    ...] on every pp rank (module docstring)."""
    leaves = _flatten(params)
    return _Pipeline.apply(fn, remat, mesh, axis, params, microbatches,
                           *leaves)


def pipeline_apply(stage_fn: Callable, mesh, *, axis: str = "pp",
                   remat: bool = True) -> Callable:
    """Build ``apply(stage_params, microbatches) -> outputs``, the JAX
    package's signature: ``stage_params`` a tree whose leaves have the
    leading stage axis of size S = the pp size (rank i uses row i),
    ``microbatches`` [M, mb, ...]; the outputs [M, mb, ...] on every pp
    rank. ``stage_fn(params_slice, x) -> y``, ``y.shape == x.shape``;
    with ``remat`` it runs under ``torch.utils.checkpoint`` and again
    in the backward."""
    def apply(stage_params, microbatches):
        idx = _index(mesh, axis)
        local = _tree_map(lambda a: a[idx], stage_params)
        return pipeline_run(stage_fn, local, microbatches, mesh, axis=axis,
                            remat=remat)
    return apply


def stack_stage_params(init_fn: Callable[[Any], Dict],
                       generators: Sequence) -> Dict:
    """Stage params stacked on a leading axis: ``init_fn(generator)``
    for each generator, in order (the stage count is their number)."""
    stages = [init_fn(g) for g in generators]
    return _unflatten(stages[0], [torch.stack(leaves) for leaves in zip(
        *[_flatten(st) for st in stages])])


def sequential_apply(stage_fn: Callable, stage_params, microbatches):
    """pp = 1 semantics: every stage in order on each microbatch, the
    parity oracle (the same math, no pipeline)."""
    n_stages = _flatten(stage_params)[0].shape[0]
    outs = []
    for x in microbatches:
        for i in range(n_stages):
            x = stage_fn(_tree_map(lambda a: a[i], stage_params), x)
        outs.append(x)
    return torch.stack(outs)
