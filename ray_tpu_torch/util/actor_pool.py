"""ActorPool — load-balance tasks over a fixed set of actors.

Reference analogue: python/ray/util/actor_pool.py (ActorPool with
submit/get_next/map/map_unordered).

The port's copy of ``ray_tpu/util/actor_pool.py`` (imports renamed to
``ray_tpu_torch``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._pending = []  # (fn, value) waiting for a free actor
        self._next_task_index = 0
        self._next_return_index = 0

    def has_free(self) -> bool:
        return len(self._idle) > 0

    def has_next(self) -> bool:
        return bool(self._future_to_actor or self._pending)

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """fn(actor, value) -> ObjectRef; queued until an actor is idle
        (results are never consumed implicitly)."""
        if self._idle:
            self._dispatch(fn, value)
        else:
            self._pending.append((fn, value))

    def _dispatch(self, fn, value):
        actor = self._idle.pop()
        fut = fn(actor, value)
        self._future_to_actor[fut] = actor
        self._index_to_future[self._next_task_index] = fut
        self._next_task_index += 1

    def _free(self, fut):
        self._idle.append(self._future_to_actor.pop(fut))
        if self._pending and self._idle:
            fn, value = self._pending.pop(0)
            self._dispatch(fn, value)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order. On timeout the pool state is
        untouched, so the call can simply be retried."""
        if self._next_return_index >= self._next_task_index:
            raise StopIteration("no pending results")
        from ray_tpu_torch.exceptions import GetTimeoutError
        if self._next_return_index not in self._index_to_future:
            # That index was already consumed by get_next_unordered();
            # mixing the two is undefined ordering (reference ActorPool
            # raises the same guard).
            raise ValueError(
                "get_next() cannot be used after get_next_unordered() "
                "consumed an earlier result; use one mode consistently.")
        fut = self._index_to_future[self._next_return_index]
        try:
            value = ray_tpu_torch.get(fut, timeout=timeout)
        except GetTimeoutError:
            raise  # state untouched: retryable
        except Exception:
            # task failed for real: consume the slot, free the actor
            del self._index_to_future[self._next_return_index]
            self._next_return_index += 1
            self._free(fut)
            raise
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._free(fut)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result in completion order."""
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        fut = ready[0]
        self._free(fut)
        for idx, f in list(self._index_to_future.items()):
            if f == fut:
                del self._index_to_future[idx]
                break
        return ray_tpu_torch.get(fut)

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while (self._next_return_index < self._next_task_index
               or self._pending):
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self._future_to_actor or self._pending:
            yield self.get_next_unordered()
