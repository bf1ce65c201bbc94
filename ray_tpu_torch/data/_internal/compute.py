"""Compute strategies for one-to-one stages.

Reference analogue: python/ray/data/_internal/compute.py —
TaskPoolStrategy (default, one task per block) and ActorPoolStrategy:34
(a pool of long-lived actors, the right shape when the map fn has
expensive per-process setup: model weights, a jit-compiled program, a
tokenizer...).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class ComputeStrategy:
    pass


class TaskPoolStrategy(ComputeStrategy):
    def __eq__(self, other):
        return isinstance(other, TaskPoolStrategy)


class ActorPoolStrategy(ComputeStrategy):
    def __init__(self, size: Optional[int] = None,
                 min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        self.size = size or min_size or 2
        self.max_size = max_size or self.size

    def __eq__(self, other):
        # equal strategies let consecutive stages FUSE into one pool run
        return (isinstance(other, ActorPoolStrategy)
                and other.size == self.size
                and other.max_size == self.max_size)

    def __hash__(self):
        return hash((self.size, self.max_size))

    def __repr__(self):
        return (f"ActorPoolStrategy(size={self.size}, "
                f"max_size={self.max_size})")


class _BlockWorker:
    """Pool actor: applies a fused fn chain to blocks. The worker process
    persists across blocks, so per-process setup inside the fns (module
    imports, jit caches) amortizes."""

    def apply(self, fns, block):
        for f in fns:
            block = f(block)
        return block

    def ping(self):
        return "ok"


def resolve_compute(compute) -> ComputeStrategy:
    if compute is None or compute == "tasks":
        return TaskPoolStrategy()
    if compute == "actors":
        return ActorPoolStrategy()
    if isinstance(compute, ComputeStrategy):
        return compute
    raise ValueError(f"bad compute strategy {compute!r}")


def run_on_actor_pool(strategy: ActorPoolStrategy, fns, block_refs,
                      remote_opts: Dict[str, Any]) -> List[Any]:
    """Execute one fused stage over a fresh actor pool. Blocks until the
    stage completes so the pool can be torn down deterministically."""
    import ray_tpu_torch
    n = len(block_refs)
    # grow toward max_size when there are more blocks than min workers
    size = max(strategy.size, min(strategy.max_size, n))
    size = min(size, max(1, n))
    opts = dict(remote_opts)
    worker_cls = (ray_tpu_torch.remote(**opts)(_BlockWorker) if opts
                  else ray_tpu_torch.remote(_BlockWorker))
    pool = [worker_cls.remote() for _ in range(size)]
    try:
        # availability-driven dispatch: the next block goes to whichever
        # worker frees up first, so a straggler block doesn't serialize
        # the blocks statically queued behind its worker
        out: List[Any] = [None] * n
        in_flight: Dict[Any, Any] = {}  # result ref -> worker
        free = list(pool)
        idx = 0
        while idx < n or in_flight:
            while free and idx < n:
                w = free.pop()
                ref = w.apply.remote(fns, block_refs[idx])
                out[idx] = ref
                in_flight[ref] = w
                idx += 1
            if in_flight:
                ready, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                        timeout=None)
                for r in ready:
                    free.append(in_flight.pop(r))
        return out
    finally:
        for a in pool:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
