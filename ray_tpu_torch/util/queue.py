"""Distributed FIFO queue on an actor.

Reference analogue: python/ray/util/queue.py (Queue over an async actor).

The port's copy of ``ray_tpu/util/queue.py`` (imports renamed to
``ray_tpu_torch``).
"""

from __future__ import annotations

import queue as _pyqueue
import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = _pyqueue.Queue(maxsize=maxsize)

    def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            self._q.put(item, block=timeout is not None and timeout > 0,
                        timeout=timeout or None)
            return True
        except _pyqueue.Full:
            return False

    def get(self, timeout: Optional[float] = None):
        try:
            return True, self._q.get(
                block=timeout is not None and timeout > 0,
                timeout=timeout or None)
        except _pyqueue.Empty:
            return False, None

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()


class Queue:
    """Client facade; safe to pass to tasks/actors (pickles the handle)."""

    def __init__(self, maxsize: int = 0, *, _actor=None):
        if _actor is not None:
            self.actor = _actor
            return
        cls = ray_tpu_torch.remote(max_concurrency=8)(_QueueActor)
        self.actor = cls.remote(maxsize)

    # Blocking semantics are implemented CLIENT-side: each server call
    # blocks at most ~0.2s, so N blocked callers can never starve the
    # queue actor's thread pool and deadlock producers against consumers.
    _POLL = 0.2

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None):
        deadline = (None if (block and timeout is None)
                    else time.monotonic() + (timeout or 0.0))
        while True:
            slice_t = self._POLL if block else 0.0
            if deadline is not None:
                slice_t = min(slice_t, max(0.0, deadline -
                                           time.monotonic()))
            ok = ray_tpu_torch.get(self.actor.put.remote(item, slice_t))
            if ok:
                return
            if not block or (deadline is not None
                             and time.monotonic() >= deadline):
                raise Full("queue full")

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        deadline = (None if (block and timeout is None)
                    else time.monotonic() + (timeout or 0.0))
        while True:
            slice_t = self._POLL if block else 0.0
            if deadline is not None:
                slice_t = min(slice_t, max(0.0, deadline -
                                           time.monotonic()))
            # unbounded inner get is safe: the actor transport guarantees
            # a reply (result or ActorUnavailableError — the send task's
            # last-resort handler) — and a timeout here would DROP an
            # item the actor already dequeued when the reply is merely
            # slow under a backlog
            ok, item = ray_tpu_torch.get(self.actor.get.remote(slice_t))
            if ok:
                return item
            if not block or (deadline is not None
                             and time.monotonic() >= deadline):
                raise Empty("queue empty")

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def __reduce__(self):
        return (_rebuild_queue, (self.actor,))


def _rebuild_queue(actor):
    return Queue(_actor=actor)
