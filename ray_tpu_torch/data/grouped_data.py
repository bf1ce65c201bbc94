"""GroupedData: groupby/aggregate over a sorted range partition.

Reference analogue: python/ray/data/grouped_dataset.py. Strategy: sort by
the group key (range-partitions co-locate equal keys in one block), then
aggregate group runs per block — no cross-block groups by construction.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import BlockAccessor, _key_of


class GroupedData:
    def __init__(self, dataset, key):
        self._ds = dataset
        self._key = key

    def _grouped_blocks(self):
        return self._ds.sort(self._key)

    def map_groups(self, fn: Callable[[Any], Any], *,
                   batch_format: str = "pylist"):
        """Apply fn to each group; returns a new Dataset."""
        key = self._key

        def _do(block):
            acc = BlockAccessor.for_block(block)
            rows = acc.to_pylist()
            out: List[Any] = []
            start = 0
            for i in range(1, len(rows) + 1):
                if i == len(rows) or _key_of(rows[i], key) != _key_of(
                        rows[start], key):
                    group = BlockAccessor.for_block(
                        acc.slice(start, i)).to_batch(batch_format)
                    res = fn(group)
                    if isinstance(res, list):
                        out.extend(res)
                    else:
                        out.append(res)
                    start = i
            return out
        return self._grouped_blocks()._one2one("map_groups", _do)

    def _agg(self, np_fn, name: str, on: Optional[str]):
        key = self._key

        def _do(group_rows):
            k = _key_of(group_rows[0], key)
            if on is not None:
                vals = np.asarray([r[on] for r in group_rows])
            else:
                vals = np.asarray(
                    [r for r in group_rows]) if not isinstance(
                        group_rows[0], dict) else np.asarray(
                        [[v for kk, v in sorted(r.items()) if kk != key]
                         for r in group_rows])
            col = on or name
            return {key if isinstance(key, str) else "key": k,
                    f"{name}({col})" if on else name: np_fn(vals)}
        return self.map_groups(_do)

    def count(self):
        key = self._key

        def _do(rows):
            return {key if isinstance(key, str) else "key":
                    _key_of(rows[0], key), "count()": len(rows)}
        return self.map_groups(_do)

    def sum(self, on: Optional[str] = None):
        return self._agg(np.sum, "sum", on)

    def min(self, on: Optional[str] = None):
        return self._agg(np.min, "min", on)

    def max(self, on: Optional[str] = None):
        return self._agg(np.max, "max", on)

    def mean(self, on: Optional[str] = None):
        return self._agg(np.mean, "mean", on)

    def std(self, on: Optional[str] = None):
        return self._agg(lambda a: float(np.std(a, ddof=1)) if len(a) > 1
                         else 0.0, "std", on)
