"""All-to-all ops: random_shuffle, sort, repartition.

Reference analogue: python/ray/data/_internal/shuffle.py (pull-based
2-stage shuffle) and sort.py (sample boundaries -> range partition ->
merge). Map tasks emit one partition per reducer via ``num_returns=n``;
reduce tasks concatenate their column of partitions — the classic
map/reduce shuffle, with block refs (not bytes) flowing through the
object store.
"""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, _key_of

_tasks = {}


def _get_tasks():
    if not _tasks:
        import ray_tpu_torch
        _tasks["split_random"] = ray_tpu_torch.remote(_split_random)
        _tasks["split_range"] = ray_tpu_torch.remote(_split_range)
        _tasks["reduce_shuffle"] = ray_tpu_torch.remote(_reduce_shuffle)
        _tasks["reduce_sorted"] = ray_tpu_torch.remote(_reduce_sorted)
        _tasks["slice_block"] = ray_tpu_torch.remote(_slice_block)
        _tasks["concat_blocks"] = ray_tpu_torch.remote(_concat_blocks)
        _tasks["sample_keys"] = ray_tpu_torch.remote(_sample_keys)
    return _tasks


# ------------------------------------------------------------- map side


def _split_random(block: Block, n: int, seed: Optional[int]):
    acc = BlockAccessor.for_block(block)
    rows = acc.num_rows()
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n, size=rows)
    parts = []
    for j in range(n):
        idx = np.nonzero(assignment == j)[0].tolist()
        parts.append(acc.select(idx))
    return tuple(parts) if n > 1 else parts[0]


def _split_range(block: Block, boundaries: List[Any], key, descending: bool):
    """Partition rows into len(boundaries)+1 ranges by sort key."""
    acc = BlockAccessor.for_block(block)
    rows = acc.to_pylist()
    n = len(boundaries) + 1
    buckets: List[List[int]] = [[] for _ in range(n)]
    for i, row in enumerate(rows):
        k = _key_of(row, key)
        import bisect
        j = bisect.bisect_right(boundaries, k)
        buckets[j].append(i)
    if descending:
        buckets = buckets[::-1]
    parts = [acc.select(idx) for idx in buckets]
    return tuple(parts) if n > 1 else parts[0]


# ---------------------------------------------------------- reduce side


def _reduce_shuffle(seed: Optional[int], *parts):
    merged = BlockAccessor.concat(list(parts))
    acc = BlockAccessor.for_block(merged)
    rows = acc.num_rows()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(rows).tolist()
    return acc.select(perm)


def _reduce_sorted(key, descending: bool, *parts):
    merged = BlockAccessor.concat(list(parts))
    acc = BlockAccessor.for_block(merged)
    rows = acc.to_pylist()
    order = sorted(range(len(rows)),
                   key=lambda i: _key_of(rows[i], key), reverse=descending)
    return acc.select(order)


def _slice_block(block: Block, start: int, end: int):
    return BlockAccessor.for_block(block).slice(start, end)


def _concat_blocks(*blocks):
    return BlockAccessor.concat(list(blocks))


def _sample_keys(block: Block, key, n: int, seed):
    acc = BlockAccessor.for_block(block)
    vals = acc.sort_key_values(key)
    rng = random.Random(seed)
    if len(vals) > n:
        vals = rng.sample(vals, n)
    return vals


# ------------------------------------------------------------ drivers


def _use_push_based(num_blocks: int) -> bool:
    # pipelined merge only pays off past a handful of map tasks
    return num_blocks >= 4


def shuffle_blocks(block_refs: List[Any], output_num_blocks: int,
                   seed: Optional[int],
                   stats: Optional[dict] = None) -> List[Any]:
    tasks = _get_tasks()
    n = output_num_blocks
    if not block_refs:
        return []
    split = tasks["split_random"]
    reduce = tasks["reduce_shuffle"]
    if _use_push_based(len(block_refs)):
        from ray_tpu_torch.data._internal.push_based_shuffle import push_shuffle
        # reduce takes (seed, *parts); push hands it ONE merged part
        return push_shuffle(
            block_refs, n, split, reduce,
            map_args=lambda i: (None if seed is None else seed + i,),
            reduce_args=lambda j: (
                None if seed is None else seed + 100003 + j,),
            stats=stats)
    parts = []  # parts[m][j]
    for m, ref in enumerate(block_refs):
        s = None if seed is None else seed + m
        out = split.options(num_returns=n).remote(ref, n, s)
        parts.append(out if isinstance(out, list) else [out])
    outs = []
    for j in range(n):
        s = None if seed is None else seed + 100003 + j
        outs.append(reduce.remote(s, *[parts[m][j]
                                       for m in range(len(parts))]))
    return outs


def sort_blocks(block_refs: List[Any], key, descending: bool) -> List[Any]:
    import ray_tpu_torch
    tasks = _get_tasks()
    if not block_refs:
        return []
    n = len(block_refs)
    # 1. sample boundary keys
    samples = ray_tpu_torch.get([tasks["sample_keys"].remote(r, key, 20, i)
                           for i, r in enumerate(block_refs)])
    allkeys = sorted(k for s in samples for k in s)
    if not allkeys:
        return block_refs
    boundaries = [allkeys[int(len(allkeys) * (j + 1) / n)]
                  for j in range(n - 1)] if n > 1 else []
    # 2. range partition each block
    split = tasks["split_range"]
    parts = []
    for ref in block_refs:
        out = split.options(num_returns=n).remote(
            ref, boundaries, key, descending)
        parts.append(out if isinstance(out, list) else [out])
    # 3. merge-sort each partition column
    reduce = tasks["reduce_sorted"]
    return [reduce.remote(key, descending,
                          *[parts[m][j] for m in range(len(parts))])
            for j in range(n)]


def repartition_blocks(block_refs: List[Any], num_blocks: int,
                       counts: List[int],
                       targets: Optional[List[int]] = None) -> List[Any]:
    """Split/merge into num_blocks blocks without a full shuffle (reference:
    Dataset.repartition(shuffle=False) — splits by row ranges). ``targets``
    optionally pins exact per-output row counts (used by zip alignment)."""
    tasks = _get_tasks()
    total = sum(counts)
    if total == 0:
        return []
    if targets is None:
        targets = [total // num_blocks + (1 if i < total % num_blocks else 0)
                   for i in range(num_blocks)]
    # global row offsets of each input block
    offsets = []
    off = 0
    for c in counts:
        offsets.append((off, off + c))
        off += c
    outs = []
    pos = 0
    for t in targets:
        lo, hi = pos, pos + t
        pieces = []
        for (bs, be), ref in zip(offsets, block_refs):
            s, e = max(lo, bs), min(hi, be)
            if s < e:
                if s == bs and e == be:
                    pieces.append(ref)
                else:
                    pieces.append(tasks["slice_block"].remote(
                        ref, s - bs, e - bs))
        if len(pieces) == 1:
            outs.append(pieces[0])
        else:
            outs.append(tasks["concat_blocks"].remote(*pieces))
        pos = hi
    return outs
