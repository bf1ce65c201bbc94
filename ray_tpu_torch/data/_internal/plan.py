"""Lazy execution plan with stage fusion.

Reference analogue: python/ray/data/_internal/plan.py (ExecutionPlan:74,
execute:288) and compute.py (TaskPoolStrategy). A plan is input block refs
plus a chain of stages; consecutive one-to-one stages fuse into a single
remote task per block (the reference's stage fusion), all-to-all stages
(shuffle/sort/repartition) form barriers.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.data.block import Block, BlockAccessor


class Stage:
    name: str = "stage"


class OneToOneStage(Stage):
    """block -> block, independently per block; fusable."""

    def __init__(self, name: str, fn: Callable[[Block], Block],
                 remote_opts: Optional[Dict[str, Any]] = None):
        self.name = name
        self.fn = fn
        self.remote_opts = remote_opts or {}


class AllToAllStage(Stage):
    """List[ref] -> List[ref] with a barrier (shuffle/sort/repartition).

    ``extra`` is a mutable dict the stage fn may fill with substage
    detail (push-shuffle task counts); it lands in the stats record."""

    def __init__(self, name: str,
                 fn: Callable[[List[Any]], List[Any]],
                 extra: Optional[Dict[str, Any]] = None):
        self.name = name
        self.fn = fn  # (block_refs) -> block_refs
        self.extra = extra


def _apply_chain_with_stats(fns, block):
    """Chain the fns AND return per-task stats as a second return (the
    reference's map tasks do the same — block + BlockMetadata pair) so
    Dataset.stats() can report per-stage wall/cpu/rows without extra
    round trips."""
    import os
    import time as _t
    acc_in = BlockAccessor.for_block(block)
    rows_in = acc_in.num_rows()
    wall0 = _t.perf_counter()
    cpu0 = _t.process_time()
    for f in fns:
        block = f(block)
    acc_out = BlockAccessor.for_block(block)
    return block, {
        "wall_s": _t.perf_counter() - wall0,
        "cpu_s": _t.process_time() - cpu0,
        "rows_in": rows_in,
        "rows_out": acc_out.num_rows(),
        "bytes_out": acc_out.size_bytes(),
        "pid": os.getpid(),
    }


_chain_task = None


def _get_chain_task():
    """Module-level remote task, created lazily so importing ray_tpu_torch.data
    does not require an initialized cluster."""
    global _chain_task
    if _chain_task is None:
        import ray_tpu_torch
        _chain_task = ray_tpu_torch.remote(_apply_chain_with_stats)
    return _chain_task


class DatasetStats:
    """Per-stage wall/cpu/rows breakdowns + substage task detail
    (reference: _internal/stats.py DatasetStats).  Map-stage task stats
    arrive as object refs and resolve lazily at summary time."""

    def __init__(self):
        self.stages: List[Tuple[str, float, int,
                                Optional[Dict[str, Any]]]] = []

    def record(self, name: str, seconds: float, n_blocks: int,
               extra: Optional[Dict[str, Any]] = None,
               task_stats_refs: Optional[List[Any]] = None):
        entry = dict(extra or {})
        if task_stats_refs:
            entry["_task_stats_refs"] = task_stats_refs
        self.stages.append((name, seconds, n_blocks, entry or None))

    def copy(self) -> "DatasetStats":
        out = DatasetStats()
        out.stages = list(self.stages)
        return out

    def _resolve_tasks(self, extra) -> Optional[Dict[str, Any]]:
        if extra and "_task_stats" in extra:
            return extra["_task_stats"]  # resolved once, cached
        refs = (extra or {}).get("_task_stats_refs")
        if not refs:
            return None
        import ray_tpu_torch
        try:
            rows = [r for r in ray_tpu_torch.get(list(refs), timeout=60)
                    if isinstance(r, dict)]
        except Exception:
            rows = []
        if not rows:
            extra["_task_stats"] = None  # don't re-block on lost refs
            extra.pop("_task_stats_refs", None)
            return None
        resolved = {
            "tasks": len(rows),
            "wall_s": round(sum(r["wall_s"] for r in rows), 4),
            "wall_max_s": round(max(r["wall_s"] for r in rows), 4),
            "cpu_s": round(sum(r["cpu_s"] for r in rows), 4),
            "rows_in": sum(r["rows_in"] for r in rows),
            "rows_out": sum(r["rows_out"] for r in rows),
            "bytes_out": sum(r["bytes_out"] for r in rows),
            "workers": len({r["pid"] for r in rows}),
        }
        extra["_task_stats"] = resolved
        extra.pop("_task_stats_refs", None)
        return resolved

    def to_dict(self) -> List[Dict[str, Any]]:
        out = []
        for name, secs, n, extra in self.stages:
            row = {"stage": name, "submit_s": round(secs, 4),
                   "blocks": n}
            tasks = self._resolve_tasks(extra)
            if tasks:
                row.update(tasks)
            if extra:
                row.update({k: v for k, v in extra.items()
                            if not k.startswith("_task_stats")})
            out.append(row)
        return out

    def summary_string(self) -> str:
        lines = ["Dataset stats:"]
        for row in self.to_dict():
            name, n = row["stage"], row["blocks"]
            if "wall_s" in row:
                lines.append(
                    f"  stage {name}: {n} blocks, "
                    f"{row['rows_out']} rows, "
                    f"wall {row['wall_s'] * 1e3:.1f}ms "
                    f"(max {row['wall_max_s'] * 1e3:.1f}ms), "
                    f"cpu {row['cpu_s'] * 1e3:.1f}ms, "
                    f"{row['workers']} workers")
            else:
                lines.append(f"  stage {name}: {n} blocks, "
                             f"{row['submit_s'] * 1e3:.1f}ms")
            detail = ", ".join(
                f"{k}={v}" for k, v in row.items()
                if k not in ("stage", "blocks", "submit_s", "wall_s",
                             "wall_max_s", "cpu_s", "rows_in",
                             "rows_out", "bytes_out", "workers",
                             "tasks"))
            if detail:
                lines.append(f"    {detail}")
        return "\n".join(lines)


class ExecutionPlan:
    def __init__(self, input_blocks: List[Any],
                 stages: Optional[List[Stage]] = None,
                 stats: Optional[DatasetStats] = None):
        self._in_blocks = list(input_blocks)
        self._stages: List[Stage] = list(stages or [])
        self._out_blocks: Optional[List[Any]] = None
        self._out_meta: Optional[List[Any]] = None
        self.stats = stats or DatasetStats()

    def with_stage(self, stage: Stage) -> "ExecutionPlan":
        # the stats history carries over COPIED: sibling datasets branched
        # from one plan must not append into each other's stats
        if self._out_blocks is not None:
            # already executed: new plan starts from materialized blocks
            return ExecutionPlan(self._out_blocks, [stage],
                                 stats=self.stats.copy())
        return ExecutionPlan(self._in_blocks, self._stages + [stage],
                             stats=self.stats.copy())

    def copy_to(self, blocks: List[Any]) -> "ExecutionPlan":
        return ExecutionPlan(blocks)

    def is_executed(self) -> bool:
        return self._out_blocks is not None or not self._stages

    def execute(self) -> List[Any]:
        """Materialize: returns the output block refs."""
        if self._out_blocks is not None:
            return self._out_blocks
        import ray_tpu_torch
        blocks = self._in_blocks
        i = 0
        while i < len(self._stages):
            stage = self._stages[i]
            t0 = time.time()
            if isinstance(stage, OneToOneStage):
                # fuse the run of consecutive one-to-one stages
                fused = [stage]
                j = i + 1
                while (j < len(self._stages)
                       and isinstance(self._stages[j], OneToOneStage)
                       and self._stages[j].remote_opts == stage.remote_opts):
                    fused.append(self._stages[j])
                    j += 1
                fns = [s.fn for s in fused]
                name = "+".join(s.name for s in fused)
                opts = dict(stage.remote_opts)
                compute = opts.pop("_compute", None)
                from ray_tpu_torch.data._internal.compute import (
                    ActorPoolStrategy, run_on_actor_pool)
                if isinstance(compute, ActorPoolStrategy):
                    blocks = run_on_actor_pool(compute, fns, blocks, opts)
                    self.stats.record(name, time.time() - t0, len(blocks))
                else:
                    task = _get_chain_task()
                    opts = dict(opts, num_returns=2)
                    task = task.options(**opts)
                    pairs = [task.remote(fns, b) for b in blocks]
                    blocks = [p[0] for p in pairs]
                    self.stats.record(name, time.time() - t0, len(blocks),
                                      task_stats_refs=[p[1]
                                                       for p in pairs])
                i = j
            else:
                blocks = stage.fn(blocks)
                self.stats.record(stage.name, time.time() - t0,
                                  len(blocks),
                                  extra=getattr(stage, "extra", None))
                i += 1
        # drop references to intermediates; keep outputs pinned
        self._out_blocks = blocks
        self._stages = []
        return blocks

    def supports_streaming(self) -> bool:
        """Whether every stage can run under the streaming executor.
        Actor-pool compute stages manage their own pool lifecycle in the
        bulk helper and keep the bulk path."""
        from ray_tpu_torch.data._internal.compute import ActorPoolStrategy
        for s in self._stages:
            if (isinstance(s, OneToOneStage)
                    and isinstance(s.remote_opts.get("_compute"),
                                   ActorPoolStrategy)):
                return False
        return True

    def execute_streaming(self):
        """Iterator of (block_ref, bytes_or_None), executing pending
        stages as a pull-based pipeline (streaming_executor.py): the
        first output ref is yielded as soon as the first block's fused
        chain completes, with bounded in-flight work behind it.

        Unlike ``execute()`` this does NOT cache outputs: retaining every
        output ref would pin O(dataset) in the object store, defeating
        the bounded-footprint contract.  Consumers that need the
        materialized ref list still call ``execute()``."""
        if self._out_blocks is not None:
            for r in self._out_blocks:
                yield r, None
            return
        if not self._stages:
            for r in self._in_blocks:
                yield r, None
            return
        from ray_tpu_torch.data._internal.streaming_executor import (
            StreamingExecutor)
        yield from StreamingExecutor(self).run()

    def metadata(self) -> List[Any]:
        """BlockMetadata per output block, computed once and cached."""
        if self._out_meta is None:
            self._out_meta = get_metadata(self.execute())
        return self._out_meta


def get_metadata(block_refs: List[Any]) -> List[Any]:
    """Fetch BlockMetadata for each block via small remote tasks."""
    import ray_tpu_torch

    def _meta(block):
        return BlockAccessor.for_block(block).get_metadata()

    meta_task = ray_tpu_torch.remote(_meta)
    return ray_tpu_torch.get([meta_task.remote(b) for b in block_refs])
