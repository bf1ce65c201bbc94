"""Push-based (2-stage pipelined) shuffle.

Reference analogue: python/ray/data/_internal/push_based_shuffle.py:23 —
instead of N reduce tasks each waiting on ALL M map outputs (M×N object
pulls at one barrier), map outputs are pushed through intermediate MERGE
tasks in rounds: the merge of round k overlaps the maps of round k+1
(the object-store dependency graph pipelines them), and the final reduce
consumes one merged object per round instead of M partials.

For M maps, R = ceil(M / merge_factor) rounds; per output partition the
merge chain accumulates so at most `merge_factor` map partials are alive
per round — bounding object-store footprint, which is what makes this
the right shape for ImageNet-scale ingest (SURVEY §3.5).
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

from ray_tpu_torch.data.block import BlockAccessor

_tasks = {}


def _get_tasks():
    if not _tasks:
        import ray_tpu_torch
        _tasks["merge"] = ray_tpu_torch.remote(_merge_parts)
    return _tasks


def _merge_parts(*parts):
    parts = [p for p in parts if p is not None]
    if len(parts) == 1:
        return parts[0]
    return BlockAccessor.concat(list(parts))


def push_shuffle(block_refs: List[Any], output_num_blocks: int,
                 map_one: Callable[..., Any],
                 reduce_one: Callable[..., Any],
                 map_args: Callable[[int], tuple],
                 reduce_args: Callable[[int], tuple],
                 merge_factor: int = 4,
                 stats: Optional[dict] = None) -> List[Any]:
    """Generic pipelined shuffle driver.

    map_one(ref, n_out, *map_args(i)) -> n_out partitions (a remote fn
    handle, called with num_returns=n_out; ``map_args`` is a function of
    the global map index so per-map seeds work); reduce_one(
    *reduce_args(j), merged) -> output block j.
    """
    n = output_num_blocks
    m = len(block_refs)
    if m == 0:
        return []
    tasks = _get_tasks()
    merge = tasks["merge"]
    rounds = math.ceil(m / merge_factor)
    # merged[j] = accumulated merge chain for output partition j
    merged: List[Optional[Any]] = [None] * n
    n_merges = 0
    for r in range(rounds):
        lo = r * merge_factor
        chunk = block_refs[lo:lo + merge_factor]
        # this round's map tasks (their partitions are futures; the merge
        # below depends on them and runs as they land, while the NEXT
        # round's maps already execute)
        round_parts = []
        for k, ref in enumerate(chunk):
            out = map_one.options(num_returns=n).remote(
                ref, n, *map_args(lo + k))
            round_parts.append(out if isinstance(out, list) else [out])
        for j in range(n):
            col = [p[j] for p in round_parts]
            if merged[j] is not None:
                col = [merged[j]] + col
            if len(col) == 1:
                merged[j] = col[0]
            else:
                merged[j] = merge.remote(*col)
                n_merges += 1
    if stats is not None:
        stats.update({"map_tasks": m, "merge_tasks": n_merges,
                      "reduce_tasks": n, "rounds": rounds})
    return [reduce_one.remote(*reduce_args(j), merged[j])
            for j in range(n)]
