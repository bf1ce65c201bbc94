"""ParallelIterator — sharded, lazily-transformed iteration over actors.

Reference analogue: python/ray/util/iter.py (ParallelIterator
:from_items/from_range/from_iterators, for_each, filter, batch, flatten,
gather_sync, gather_async, LocalIterator). Each shard is an actor
holding a generator; transforms compose lazily and execute inside the
shard actor, so `for_each` chains stream without materializing
intermediate lists on the driver.

The port's copy of ``ray_tpu/util/iter.py`` (imports renamed to
``ray_tpu_torch``).
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


class _ShardActor:
    """Owns one shard's iterator; applies the transform chain lazily."""

    def __init__(self, make_iter):
        self._make_iter = make_iter
        self._it: Optional[Iterator] = None

    def reset(self, transforms: List[Any]):
        it = iter(self._make_iter())
        for kind, fn in transforms:
            if kind == "for_each":
                it = builtins.map(fn, it)
            elif kind == "filter":
                it = builtins.filter(fn, it)
            elif kind == "batch":
                it = _batched(it, fn)
            elif kind == "flatten":
                it = (x for sub in it for x in sub)
        self._it = it
        return True

    def next_batch(self, n: int) -> List[Any]:
        """Up to n items; empty list = exhausted."""
        assert self._it is not None, "reset() first"
        out = []
        for _ in range(n):
            try:
                out.append(next(self._it))
            except StopIteration:
                break
        return out


def _batched(it: Iterator, size: int) -> Iterator[List[Any]]:
    buf: List[Any] = []
    for x in it:
        buf.append(x)
        if len(buf) >= size:
            yield buf
            buf = []
    if buf:
        yield buf


ShardActor = ray_tpu_torch.remote(_ShardActor)


class ParallelIterator:
    """A set of shard actors + a lazy transform chain."""

    def __init__(self, actors: List[Any], transforms: List[Any]):
        self._actors = actors
        self._transforms = transforms

    # ---- construction ----

    @staticmethod
    def from_iterators(makers: List[Callable[[], Iterable]]
                       ) -> "ParallelIterator":
        return ParallelIterator(
            [ShardActor.remote(m) for m in makers], [])

    @staticmethod
    def from_items(items: List[Any], num_shards: int = 2
                   ) -> "ParallelIterator":
        shards = [items[i::num_shards] for i in range(num_shards)]
        return ParallelIterator.from_iterators(
            [_ListMaker(s) for s in shards])

    @staticmethod
    def from_range(n: int, num_shards: int = 2) -> "ParallelIterator":
        per = [list(range(i, n, num_shards)) for i in range(num_shards)]
        return ParallelIterator.from_iterators(
            [_ListMaker(s) for s in per])

    @property
    def num_shards(self) -> int:
        return len(self._actors)

    # ---- lazy transforms ----

    def _with(self, kind: str, fn) -> "ParallelIterator":
        return ParallelIterator(self._actors,
                                self._transforms + [(kind, fn)])

    def for_each(self, fn: Callable[[Any], Any]) -> "ParallelIterator":
        return self._with("for_each", fn)

    def filter(self, fn: Callable[[Any], bool]) -> "ParallelIterator":
        return self._with("filter", fn)

    def batch(self, size: int) -> "ParallelIterator":
        return self._with("batch", size)

    def flatten(self) -> "ParallelIterator":
        return self._with("flatten", None)

    # ---- gathering ----

    def gather_sync(self, fetch: int = 64) -> Iterator[Any]:
        """Round-robin over shards, in shard order — deterministic."""
        ray_tpu_torch.get([a.reset.remote(self._transforms)
                     for a in self._actors])
        live = list(self._actors)
        while live:
            nxt = []
            for a in live:
                batch = ray_tpu_torch.get(a.next_batch.remote(fetch))
                yield from batch
                if len(batch) == fetch:
                    nxt.append(a)
            live = nxt

    def gather_async(self, fetch: int = 64) -> Iterator[Any]:
        """Items as shards produce them — order across shards is
        whatever finishes first."""
        ray_tpu_torch.get([a.reset.remote(self._transforms)
                     for a in self._actors])
        futs = {a.next_batch.remote(fetch): a for a in self._actors}
        while futs:
            ready, _ = ray_tpu_torch.wait(list(futs), num_returns=1)
            actor = futs.pop(ready[0])
            batch = ray_tpu_torch.get(ready[0])
            yield from batch
            if len(batch) == fetch:
                futs[actor.next_batch.remote(fetch)] = actor
        return

    def take(self, n: int) -> List[Any]:
        out = []
        for x in self.gather_sync():
            out.append(x)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        return sum(1 for _ in self.gather_sync())

    def stop(self):
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class _ListMaker:
    """Pickle-friendly shard source (a lambda closing over the list
    would also work, but this names the intent)."""

    def __init__(self, items: List[Any]):
        self._items = items

    def __call__(self) -> Iterable:
        return self._items


def from_items(items, num_shards: int = 2) -> ParallelIterator:
    return ParallelIterator.from_items(items, num_shards)


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return ParallelIterator.from_range(n, num_shards)


def from_iterators(makers) -> ParallelIterator:
    return ParallelIterator.from_iterators(makers)
