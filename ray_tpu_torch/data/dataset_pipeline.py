"""DatasetPipeline: windowed/repeated streaming over datasets.

Reference analogue: python/ray/data/dataset_pipeline.py (windowed streaming
of block sets so transform of window N overlaps consumption of N-1; here
windows execute lazily on first touch which gives the same pipelining
through the object store's async task graph).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional


class DatasetPipeline:
    def __init__(self, stages_fn: Callable[[], Iterator["Any"]]):
        self._gen_windows = stages_fn
        self._xforms: List[Callable[[Any], Any]] = []

    # ----------------------------------------------------------- factories

    @staticmethod
    def from_dataset_repeat(ds, times: Optional[int]) -> "DatasetPipeline":
        def gen():
            i = 0
            while times is None or i < times:
                yield ds
                i += 1
        return DatasetPipeline(gen)

    @staticmethod
    def from_dataset_windows(ds, blocks_per_window: int) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset import Dataset
        from ray_tpu_torch.data._internal.plan import ExecutionPlan, OneToOneStage

        def gen():
            plan = ds._plan
            if (not plan.is_executed()
                    and all(isinstance(s, OneToOneStage)
                            for s in plan._stages)):
                # carry un-executed one-to-one stages into each window's
                # plan instead of bulk-executing the whole dataset up
                # front — a window then streams its own chain
                refs, stages = plan._in_blocks, list(plan._stages)
            else:
                refs, stages = ds._blocks(), []
            for s in range(0, len(refs), blocks_per_window):
                yield Dataset(ExecutionPlan(refs[s:s + blocks_per_window],
                                            list(stages)))
        return DatasetPipeline(gen)

    # ---------------------------------------------------------- transforms

    def _chain(self, f: Callable[[Any], Any]) -> "DatasetPipeline":
        p = DatasetPipeline(self._gen_windows)
        p._xforms = self._xforms + [f]
        return p

    def map(self, fn, **kw):
        return self._chain(lambda ds: ds.map(fn, **kw))

    def map_batches(self, fn, **kw):
        return self._chain(lambda ds: ds.map_batches(fn, **kw))

    def filter(self, fn, **kw):
        return self._chain(lambda ds: ds.filter(fn, **kw))

    def random_shuffle_each_window(self, **kw):
        return self._chain(lambda ds: ds.random_shuffle(**kw))

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        base = self

        def gen():
            i = 0
            while times is None or i < times:
                yield from base._windows()
                i += 1
        p = DatasetPipeline(gen)
        return p

    # ----------------------------------------------------------- consuming

    def _windows(self) -> Iterator[Any]:
        for ds in self._gen_windows():
            for f in self._xforms:
                ds = f(ds)
            yield ds

    def iter_batches(self, **kw) -> Iterator[Any]:
        # each window rides the streaming executor via Dataset.iter_batches:
        # batches start flowing after the window's FIRST block chain
        # completes, not after the window fully executes
        for ds in self._windows():
            yield from ds.iter_batches(**kw)

    def iter_device_batches(self, **kw) -> Iterator[Any]:
        for ds in self._windows():
            yield from ds.iter_device_batches(**kw)

    def iter_rows(self) -> Iterator[Any]:
        for ds in self._windows():
            yield from ds.iter_rows()

    def iter_epochs(self) -> Iterator[Any]:
        yield from self._windows()

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        return sum(ds.count() for ds in self._windows())

    def split(self, n: int, *, equal: bool = True) -> List["DatasetPipeline"]:
        base = self

        def make(i):
            def gen():
                for ds in base._windows():
                    yield ds.split(n, equal=equal)[i]
            return DatasetPipeline(gen)
        return [make(i) for i in range(n)]
