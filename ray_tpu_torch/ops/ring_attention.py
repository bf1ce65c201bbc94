"""Ring attention over the ``sp`` mesh axis: the port of
``ray_tpu/ops/ring_attention.py``.

Sequences are split over sp; each rank holds s_local = S / sp query
and key/value positions. The key/value shards travel around the ring
(rank r sends to r + 1) while each rank attends to the shard it holds
and merges the block into its running result with an online softmax,
so a rank never holds more than two kv shards. The result is exact
attention over the whole sequence.

Each block goes through the streaming attention triple (``impl``: the
kernels of ``kernels/csrc/flash_attention.cu`` on CUDA tensors, their
plain versions on CPU tensors, or ``TRAINING_PLAIN`` on either), never
through the whole-kv kernels, which cap logits at 50. q is pre-scaled
by ``sm_scale`` once, as ``flash_attention`` does. With ``causal``, the
block whose kv shard is this rank's own is causal (top-left, sq = sk),
earlier shards are attended whole, and later ones are skipped (not
launched; they still pass through).

  forward   each block gives (o_b, lse_b); in f32, lse = logaddexp(lse,
            lse_b), o = o e^(lse_old - lse) + o_b e^(lse_b - lse);
            o is rounded to q's dtype once, at the end.
  backward  delta = rowsum(o do) once, from the final o; each block's
            dkv and dq passes take the final (global) lse and delta, so
            p = e^(s - lse) is the true softmax of the whole row. dq
            accumulates on the rank; each kv shard's dk/dv accumulator
            (f32) travels behind the shard, gains each rank's part, and
            is home after one full turn.

The JAX package differentiates its ``fori_loop`` of ``ppermute``; here
the whole ring is one ``torch.autograd.Function``. A rank's schedule is
a generator that yields at each transfer (``_forward_steps``,
``_backward_steps``): ``_drive`` runs it over the process group
(``collectives.ppermute``, started before the block's compute and
awaited after it), and ``simulate`` runs every rank's schedule in one
process with the transfers replaced by hand-offs between them, which
is how ``chip_smoke.py`` runs a 4-rank ring on one card. At sp = 1 the
ring is one causal block with no transfer.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ray_tpu_torch.ops.attention import (DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q,
                                         TRAINING_KERNELS, TrainingAttention,
                                         _fit_block, _streaming)
from ray_tpu_torch.parallel import collectives as C


def block_causal(my_idx: int, kv_idx: int, causal: bool) -> Optional[bool]:
    """How rank ``my_idx`` attends kv shard ``kv_idx``: None (skipped:
    every key lies after every query), True (the diagonal block,
    causal) or False (whole)."""
    if not causal:
        return False
    if kv_idx > my_idx:
        return None
    return kv_idx == my_idx


def merge(o, lse, o_b, lse_b):
    """Merge block (o_b, lse_b) into the running (o f32 or None, lse):
    the online-softmax rescale, in f32."""
    if o is None:
        return o_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)
    return (o * torch.exp(lse - new)[..., None]
            + o_b.float() * torch.exp(lse_b - new)[..., None]), new


def _forward_steps(fwd, q, kv, idx: int, n: int, causal: bool):
    """Rank ``idx``'s forward schedule over an n-rank ring (a generator;
    see ``_drive``): ``kv`` = stack(k, v) of its own shard. Returns
    (o f32, lse)."""
    o = lse = None
    for i in range(n):
        if i:
            kv = yield ("recv", "kv")
        if i < n - 1:
            yield ("send", "kv", kv)
        diag = block_causal(idx, (idx - i) % n, causal)
        if diag is not None:
            o, lse = merge(o, lse, *fwd(q, kv[0], kv[1], causal=diag))
    return o, lse


def _backward_steps(fns, q, kv, do, lse, delta, idx: int, n: int,
                    causal: bool):
    """Rank ``idx``'s backward schedule: ``fns`` = (backward_dkv,
    backward_dq). The dk/dv accumulator of the shard held at step i
    arrives from the previous rank (which held it at step i - 1), gains
    this rank's part and moves on; after n moves each is home. Returns
    (dq, dk, dv) in f32."""
    dkv_pass, dq_pass = fns
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        if i:
            kv = yield ("recv", "kv")
        if i < n - 1:
            yield ("send", "kv", kv)
        diag = block_causal(idx, (idx - i) % n, causal)
        part = None
        if diag is not None:
            k, v = kv[0], kv[1]
            dk_b, dv_b = dkv_pass(q, k, v, do, lse, delta, causal=diag)
            dq += dq_pass(q, k, v, do, lse, delta, causal=diag).float()
            part = torch.stack([dk_b, dv_b]).float()
        if i:
            acc = yield ("recv", "dkv")
            if part is not None:
                acc = acc + part
        else:
            acc = part if part is not None else torch.zeros(
                kv.shape, dtype=torch.float32, device=kv.device)
        if n > 1:
            yield ("send", "dkv", acc)
    if n > 1:
        acc = yield ("recv", "dkv")
    return dq, acc[0], acc[1]


def _drive(steps, mesh, axis: str):
    """Run one rank's schedule over the axis's process group: each
    "send" starts a ppermute to the next rank (and from the previous),
    each "recv" waits for it."""
    n = mesh.size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    pending = {}
    reply = None
    while True:
        try:
            op = steps.send(reply)
        except StopIteration as stop:
            return stop.value
        reply = None
        if op[0] == "send":
            pending[op[1]] = C.ppermute(op[2], axis, mesh, perm,
                                        async_op=True)
        else:
            out, wait = pending.pop(op[1])
            wait()
            reply = out


def simulate(schedules: Sequence, on_step: Optional[Callable] = None
             ) -> List:
    """Run every rank's schedule (rank order) in this process, in
    lockstep, handing what rank r sends to rank r + 1: the ring with
    its transport replaced and nothing else. ``on_step(rank)`` is
    called before each resumption of a rank (timing). Returns the
    ranks' results."""
    n = len(schedules)
    replies = [None] * n
    results = [None] * n
    sent = {}
    while any(r is None for r in results):
        ops = []
        for r, steps in enumerate(schedules):
            if results[r] is not None:
                continue
            if on_step is not None:
                on_step(r)
            try:
                ops.append((r, steps.send(replies[r])))
            except StopIteration as stop:
                results[r] = (stop.value,)
        if on_step is not None:
            on_step(None)
        replies = [None] * n
        for r, op in ops:
            if op[0] == "send":
                sent[op[1], (r + 1) % n] = op[2]
            else:
                replies[r] = sent.pop((op[1], r))
    return [r[0] for r in results]


def simulated_ring(q, k, v, do, n: int, *, causal: bool = True,
                   impl: TrainingAttention = TRAINING_KERNELS,
                   on_step: Optional[Callable] = None):
    """The ring's forward and backward for all ``n`` ranks of a ring in
    this process, the transport replaced by ``simulate``: q
    (pre-scaled), k, v and do are the whole [b, h, S, d] sequence, of
    which rank r holds slice r. Each rank's schedule is the ring's own
    (``_forward_steps``, the delta pass once, ``_backward_steps``) on
    ``impl``'s streaming triple. ``on_step(rank)``: see ``simulate``
    (also called before each rank's delta pass). Returns the whole (o,
    lse, dq, dk, dv), dq with respect to the pre-scaled q."""
    s = q.shape[2] // n
    blocks = (_fit_block(DEFAULT_BLOCK_Q, s), _fit_block(DEFAULT_BLOCK_K, s))

    def part(t, r):
        return t[:, :, r * s:(r + 1) * s].contiguous()
    qs, dos = [part(q, r) for r in range(n)], [part(do, r) for r in range(n)]
    kvs = [torch.stack([part(k, r), part(v, r)]) for r in range(n)]
    fns = _streaming(impl, q, blocks)
    fwd = simulate([_forward_steps(fns[0], qs[r], kvs[r], r, n, causal)
                    for r in range(n)], on_step)
    o = [f[0].to(q.dtype) for f in fwd]
    deltas = []
    for r in range(n):
        if on_step is not None:
            on_step(r)
        deltas.append(impl.delta(o[r], dos[r]))
    if on_step is not None:
        on_step(None)
    bwd = simulate([_backward_steps(fns[1:], qs[r], kvs[r], dos[r], fwd[r][1],
                                    deltas[r], r, n, causal)
                    for r in range(n)], on_step)

    def cat(xs, dtype=None):
        out = torch.cat(xs, 2)
        return out if dtype is None else out.to(dtype)
    return (cat(o), cat([f[1] for f in fwd]),
            *(cat([b[i] for b in bwd], t.dtype)
              for i, t in enumerate((q, k, v))))


class _RingAttention(torch.autograd.Function):
    """The whole ring forward and backward on pre-scaled q."""

    @staticmethod
    def forward(ctx, q, k, v, causal, mesh, axis, impl, blocks):
        q = q.contiguous()
        kv = torch.stack([k, v])
        n, idx = _ring_size(mesh, axis)
        fns = _streaming(impl, q, blocks)
        o, lse = _run(_forward_steps(fns[0], q, kv, idx, n, causal),
                      mesh, axis, n)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, kv, o, lse)
        ctx.args = causal, mesh, axis, impl, fns, n, idx
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, o, lse = ctx.saved_tensors
        causal, mesh, axis, impl, fns, n, idx = ctx.args
        do = do.contiguous()
        delta = impl.delta(o, do)
        dq, dk, dv = _run(_backward_steps(fns[1:], q, kv, do, lse, delta,
                                          idx, n, causal), mesh, axis, n)
        return (dq.to(q.dtype), dk.to(kv.dtype), dv.to(kv.dtype),
                None, None, None, None, None)


def _ring_size(mesh, axis):
    if mesh is None:
        return 1, 0
    return mesh.size(axis), mesh.index(axis)


def _run(steps, mesh, axis, n):
    if n == 1:      # no transfer: the schedule never yields
        return simulate([steps])[0]
    return _drive(steps, mesh, axis)


def ring_attention(q, k, v, *, mesh=None, axis_name: str = "sp",
                   causal: bool = False, sm_scale: Optional[float] = None,
                   impl: TrainingAttention = TRAINING_KERNELS):
    """Attention over sequences split on ``axis_name`` of ``mesh`` (a
    built ``Mesh``; None: one rank). Shapes per rank: q, k, v [b, h,
    s_local, d] -> [b, h, s_local, d]; rank i holds positions i *
    s_local to (i + 1) * s_local. ``impl`` picks the blocks' streaming
    kernels (default) or their plain versions (``TRAINING_PLAIN``)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = q.shape[2]
    blocks = (_fit_block(DEFAULT_BLOCK_Q, s), _fit_block(DEFAULT_BLOCK_K, s))
    q = (q * sm_scale).to(q.dtype)
    return _RingAttention.apply(q, k, v, causal, mesh, axis_name, impl,
                                blocks)


def ring_attention_sharded(q, k, v, mesh, *, axis_name: str = "sp",
                           causal: bool = False,
                           sm_scale: Optional[float] = None,
                           impl: TrainingAttention = TRAINING_KERNELS):
    """Convenience wrapper: whole [b, h, s, d] inputs on every rank; each
    rank takes its sequence shard, runs the ring, and the outputs are
    gathered into the whole [b, h, s, d] on every rank. A rank's
    gradients reach only its own shard of q, k and v."""
    n, idx = _ring_size(mesh, axis_name)

    def shard(t):
        return t.chunk(n, dim=2)[idx]
    out = ring_attention(shard(q), shard(k), shard(v), mesh=mesh,
                         axis_name=axis_name, causal=causal,
                         sm_scale=sm_scale, impl=impl)
    if mesh is None:
        return out
    return C.all_gather_forward(out, axis_name, mesh, gather_axis=2)
