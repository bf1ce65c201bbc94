"""Streaming data-plane executor: pipelined block execution with
object-store backpressure.

Reference analogue: python/ray/data/_internal/execution/streaming_executor.py
(StreamingExecutor over PhysicalOperators with per-operator queues and
resource-limited admission). The bulk path (``ExecutionPlan.execute``)
submits every stage across the whole dataset before the consumer sees a
single row; this executor walks the same stage DAG as a pull-based
pipeline instead — blocks flow from the input refs through fused map
tasks to the consumer as soon as each upstream task finishes, and a
bounded in-flight budget (max concurrent tasks AND max buffered bytes,
cross-checked against live plasma usage) provides backpressure so the
object-store footprint stays O(pipeline depth x block size) instead of
O(dataset).

Topology: the stage chain of a plan becomes a linear operator chain

    ReadOp -> [MapOp (fused one-to-one run)] -> [AllToAllOp] -> ...

``MapOp`` streams: one ``_chain_task`` per block, emitted downstream in
submission order as each head-of-line task completes.  ``AllToAllOp``
(shuffle/sort/repartition) is a barrier: it drains its upstream, runs
the stage fn once, then streams the outputs onward — everything after
the barrier still pipelines.

``RTT_DATA_STREAMING`` = "0" disables streaming wholesale (every
consumer falls back to the bulk path; read per run, so tests can flip
it); default on. The backpressure budget is ``StreamingConfig``'s:
``max_inflight_tasks`` concurrent chain tasks across the whole pipeline
(default 8), ``max_buffered_bytes`` of produced-but-unconsumed blocks
(default 256 MiB; until a task finishes its output size is a rolling
per-op estimate), and ``store_high_watermark``, the plasma
used/capacity fraction above which admission pauses (default 0.85).

Per-operator stats (rows, wall, queue depth, backpressure wait) are
recorded into the plan's ``DatasetStats`` so ``Dataset.stats()`` shows
the overlap.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

DEFAULT_MAX_INFLIGHT_TASKS = 8
DEFAULT_MAX_BUFFERED_BYTES = 256 * 1024 * 1024
DEFAULT_STORE_HIGH_WATERMARK = 0.85
# Until an op has seen a completed output, its per-block size estimate.
DEFAULT_EST_BLOCK_BYTES = 64 * 1024
_STORE_POLL_INTERVAL_S = 0.05


def streaming_enabled() -> bool:
    return os.environ.get("RTT_DATA_STREAMING", "1") != "0"


class StreamingConfig:
    """Backpressure knobs of one run."""

    def __init__(self, max_inflight_tasks: int = DEFAULT_MAX_INFLIGHT_TASKS,
                 max_buffered_bytes: int = DEFAULT_MAX_BUFFERED_BYTES,
                 store_high_watermark: float = DEFAULT_STORE_HIGH_WATERMARK):
        self.max_inflight_tasks = max(1, int(max_inflight_tasks))
        self.max_buffered_bytes = max(1, int(max_buffered_bytes))
        self.store_high_watermark = float(store_high_watermark)


class _Budget:
    """Shared admission control: a task occupies a task slot and a byte
    reservation (estimate until completion, actual after) from submission
    until the consumer pulls its output past this op."""

    def __init__(self, cfg: StreamingConfig):
        self.cfg = cfg
        self.inflight_tasks = 0
        self.buffered_bytes = 0
        self.peak_inflight_tasks = 0
        self.peak_buffered_bytes = 0
        self._last_store_poll = 0.0
        self._store_ok = True

    def has_room(self, est_bytes: int) -> bool:
        if self.inflight_tasks >= self.cfg.max_inflight_tasks:
            return False
        if self.buffered_bytes + est_bytes > self.cfg.max_buffered_bytes:
            return False
        return self._store_has_headroom()

    def on_submit(self, est_bytes: int) -> None:
        self.inflight_tasks += 1
        self.buffered_bytes += est_bytes
        self.peak_inflight_tasks = max(self.peak_inflight_tasks,
                                       self.inflight_tasks)
        self.peak_buffered_bytes = max(self.peak_buffered_bytes,
                                       self.buffered_bytes)

    def on_complete(self, est_bytes: int, actual_bytes: int) -> None:
        # swap the reservation from estimate to the real output size
        self.buffered_bytes += actual_bytes - est_bytes
        self.peak_buffered_bytes = max(self.peak_buffered_bytes,
                                       self.buffered_bytes)

    def on_consume(self, actual_bytes: int) -> None:
        self.inflight_tasks -= 1
        self.buffered_bytes -= actual_bytes

    def _store_has_headroom(self) -> bool:
        now = time.monotonic()
        if now - self._last_store_poll < _STORE_POLL_INTERVAL_S:
            return self._store_ok
        self._last_store_poll = now
        try:
            from ray_tpu_torch._private import worker as _worker_mod
            w = _worker_mod._global_worker
            st = w.plasma.stats() if (w is not None and w.plasma) else None
            if st and st.get("capacity"):
                frac = st["used_bytes"] / st["capacity"]
                self._store_ok = frac < self.cfg.store_high_watermark
            else:
                self._store_ok = True
        except Exception:
            self._store_ok = True
        return self._store_ok


class _Op:
    """Base operator: an iterator of (block_ref, bytes_or_None)."""

    name = "op"

    def __iter__(self) -> Iterator[Tuple[Any, Optional[int]]]:
        raise NotImplementedError

    def stats_entry(self) -> Optional[Tuple[str, float, int,
                                            Dict[str, Any]]]:
        return None


class ReadOp(_Op):
    """Source: the plan's input block refs (already materialized or
    produced by eagerly-submitted read tasks)."""

    name = "input"

    def __init__(self, refs: List[Any]):
        self._refs = refs

    def __iter__(self):
        for r in self._refs:
            yield r, None


class MapOp(_Op):
    """A fused run of one-to-one stages, streamed one ``_chain_task`` per
    block.  Emits outputs in submission order (deterministic, identical
    row order to the bulk path); the in-flight window means a slow tail
    block never delays earlier outputs."""

    def __init__(self, name: str, fns: List[Any],
                 remote_opts: Dict[str, Any], upstream: _Op,
                 budget: _Budget):
        self.name = name
        self.fns = fns
        self.remote_opts = {k: v for k, v in remote_opts.items()
                            if k != "_compute"}
        self.upstream = upstream
        self.budget = budget
        # observability
        self.task_stats: List[Dict[str, Any]] = []
        self.queue_depth_max = 0
        self.backpressure_wait_s = 0.0
        self.time_to_first_block_s: Optional[float] = None
        self.wall_s = 0.0
        self.blocks_out = 0
        self._avg_out_bytes: Optional[float] = None

    def _est_bytes(self) -> int:
        if self._avg_out_bytes is not None:
            return int(self._avg_out_bytes)
        return DEFAULT_EST_BLOCK_BYTES

    def __iter__(self):
        import ray_tpu_torch
        from ray_tpu_torch.data._internal.plan import _get_chain_task

        task = _get_chain_task().options(
            **dict(self.remote_opts, num_returns=2))
        pending: deque = deque()  # (out_ref, stats_ref, est_bytes)
        src = iter(self.upstream)
        src_done = False
        blocked = False
        t_start = time.monotonic()
        while True:
            # admission: top up the in-flight window
            blocked = False
            while not src_done:
                est = self._est_bytes()
                if pending and not self.budget.has_room(est):
                    blocked = True
                    break
                try:
                    in_ref, _ = next(src)
                except StopIteration:
                    src_done = True
                    break
                out_ref, stats_ref = task.remote(self.fns, in_ref)
                self.budget.on_submit(est)
                pending.append((out_ref, stats_ref, est))
                self.queue_depth_max = max(self.queue_depth_max,
                                           len(pending))
            if not pending:
                break
            out_ref, stats_ref, est = pending.popleft()
            t0 = time.monotonic()
            ray_tpu_torch.wait([out_ref], num_returns=1, timeout=None)
            waited = time.monotonic() - t0
            if blocked:
                # time spent head-of-line waiting while the budget kept
                # us from submitting more work = observed backpressure
                self.backpressure_wait_s += waited
            try:
                tstats = ray_tpu_torch.get(stats_ref)
            except Exception:
                tstats = None
            actual = int(tstats["bytes_out"]) if tstats else est
            self.budget.on_complete(est, actual)
            if tstats:
                self.task_stats.append(tstats)
                n = len(self.task_stats)
                prev = self._avg_out_bytes or 0.0
                self._avg_out_bytes = prev + (actual - prev) / n
            if self.time_to_first_block_s is None:
                self.time_to_first_block_s = time.monotonic() - t_start
            self.blocks_out += 1
            self.wall_s = time.monotonic() - t_start
            yield out_ref, actual
            # the generator resumed: downstream consumed the block
            self.budget.on_consume(actual)

    def stats_entry(self):
        extra: Dict[str, Any] = {
            "streaming": True,
            "queue_depth_max": self.queue_depth_max,
            "peak_inflight_tasks": self.budget.peak_inflight_tasks,
            "peak_buffered_bytes": self.budget.peak_buffered_bytes,
            "backpressure_wait_s": round(self.backpressure_wait_s, 4),
        }
        if self.time_to_first_block_s is not None:
            extra["time_to_first_block_s"] = round(
                self.time_to_first_block_s, 4)
        rows = self.task_stats
        if rows:
            extra["_task_stats"] = {
                "tasks": len(rows),
                "wall_s": round(sum(r["wall_s"] for r in rows), 4),
                "wall_max_s": round(max(r["wall_s"] for r in rows), 4),
                "cpu_s": round(sum(r["cpu_s"] for r in rows), 4),
                "rows_in": sum(r["rows_in"] for r in rows),
                "rows_out": sum(r["rows_out"] for r in rows),
                "bytes_out": sum(r["bytes_out"] for r in rows),
                "workers": len({r["pid"] for r in rows}),
            }
        return (self.name, self.wall_s, self.blocks_out, extra)


class AllToAllOp(_Op):
    """Barrier operator (shuffle/sort/repartition/limit): drains its
    upstream — which itself streams under the shared budget — then runs
    the stage fn over the full ref list.  Downstream ops resume
    pipelining over the outputs."""

    def __init__(self, name: str, fn: Any, extra: Optional[Dict[str, Any]],
                 upstream: _Op):
        self.name = name
        self.fn = fn
        self.extra = extra
        self.upstream = upstream
        self.wall_s = 0.0
        self.blocks_out = 0

    def __iter__(self):
        t0 = time.monotonic()
        refs = [r for r, _ in self.upstream]
        out = self.fn(refs)
        self.wall_s = time.monotonic() - t0
        self.blocks_out = len(out)
        for r in out:
            yield r, None

    def stats_entry(self):
        extra = dict(self.extra or {})
        extra["streaming"] = True
        return (self.name, self.wall_s, self.blocks_out, extra)


def build_operator_dag(plan, budget: _Budget) -> List[_Op]:
    """Walk the plan's stage chain into a linear operator chain, fusing
    consecutive one-to-one stages exactly like the bulk path does."""
    from ray_tpu_torch.data._internal.plan import AllToAllStage, OneToOneStage

    ops: List[_Op] = [ReadOp(list(plan._in_blocks))]
    stages = list(plan._stages)
    i = 0
    while i < len(stages):
        stage = stages[i]
        if isinstance(stage, OneToOneStage):
            fused = [stage]
            j = i + 1
            while (j < len(stages)
                   and isinstance(stages[j], OneToOneStage)
                   and stages[j].remote_opts == stage.remote_opts):
                fused.append(stages[j])
                j += 1
            ops.append(MapOp("+".join(s.name for s in fused),
                             [s.fn for s in fused], stage.remote_opts,
                             ops[-1], budget))
            i = j
        else:
            assert isinstance(stage, AllToAllStage)
            ops.append(AllToAllOp(stage.name, stage.fn, stage.extra,
                                  ops[-1]))
            i += 1
    return ops


class StreamingExecutor:
    """Runs an ExecutionPlan as a pull-based pipeline.  ``run()`` yields
    (block_ref, bytes_or_None) as each output block becomes available;
    operator stats are recorded into ``plan.stats`` when the stream
    finishes (or is abandoned)."""

    def __init__(self, plan, config: Optional[StreamingConfig] = None):
        self._plan = plan
        self.config = config or StreamingConfig()
        self.budget = _Budget(self.config)
        self._ops = build_operator_dag(plan, self.budget)
        self._recorded = False

    def run(self) -> Iterator[Tuple[Any, Optional[int]]]:
        try:
            for ref, nbytes in self._ops[-1]:
                yield ref, nbytes
        finally:
            self._record_stats()

    def _record_stats(self) -> None:
        if self._recorded:
            return
        self._recorded = True
        for op in self._ops:
            entry = op.stats_entry()
            if entry is None:
                continue
            name, wall_s, blocks, extra = entry
            self._plan.stats.record(name, wall_s, blocks, extra=extra)
