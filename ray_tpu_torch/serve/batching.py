"""Request batching — @serve.batch.

Copy of ``ray_tpu/serve/batching.py``. Reference analogue:
serve/batching.py. Opt-in ``pad_to_bucket`` pads every flushed batch up
to the next power-of-two bucket so the wrapped callable sees a small
fixed set of shapes (one compiled graph or tuned kernel per bucket, not
per batch size).

Flush machinery: one background flusher thread per batcher (the old
design armed a ``threading.Timer`` per flush, so every request on an
idle queue paid the full ``batch_wait_timeout_s`` window and each flush
cost a thread spawn). The flusher's wait window adapts to load: an
arrival into an idle queue flushes immediately, and the window grows
toward ``batch_wait_timeout_s`` only while flushes are coming out full
— AIMD on observed batch occupancy. ``adaptive=False`` (or
``RTT_SERVE_ADAPTIVE_BATCH=0``) restores the fixed window.
"""

from __future__ import annotations

import functools
import os
import threading
from time import monotonic
from typing import Any, Callable, List, Optional

from ray_tpu_torch.serve.exceptions import BatchSubmitTimeoutError


def next_bucket(n: int, max_size: int, min_bucket: int = 1) -> int:
    b = max(1, min_bucket)
    while b < n:
        b *= 2
    return min(b, max_size)


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "")


def _default_submit_timeout() -> float:
    try:
        return float(os.environ.get(
            "RTT_SERVE_BATCH_SUBMIT_TIMEOUT_S", 60.0))
    except ValueError:
        return 60.0


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float,
                 pad_to_bucket: bool, min_pad_bucket: int = 1,
                 submit_timeout_s: Optional[float] = None,
                 adaptive: Optional[bool] = None):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self.pad_to_bucket = pad_to_bucket
        self.min_pad_bucket = max(1, min_pad_bucket)
        self.submit_timeout_s = (submit_timeout_s
                                 if submit_timeout_s is not None
                                 else _default_submit_timeout())
        self.adaptive = (adaptive if adaptive is not None
                         else _env_flag("RTT_SERVE_ADAPTIVE_BATCH", True))
        self._init_runtime_state()

    def _init_runtime_state(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[dict] = []
        self._window = 0.0  # adaptive wait; 0 = flush idle arrivals now
        self._num_flushes = 0
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._self_obj = None

    def __getstate__(self):
        # batchers ride along when a decorated callable is cloudpickled
        # into a replica: ship the config, rebuild locks/queue/thread
        # fresh on the other side (in-flight entries stay local)
        return {k: getattr(self, k) for k in (
            "fn", "max_batch_size", "batch_wait_timeout_s",
            "pad_to_bucket", "min_pad_bucket", "submit_timeout_s",
            "adaptive")}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_runtime_state()

    # ---- submit path ----

    def submit(self, item: Any, self_obj=None) -> Any:
        entry = {"item": item, "event": threading.Event(),
                 "result": None, "error": None}
        with self._cv:
            self._stopping = False
            if self._thread is None:
                # bound instance is fixed per batcher (method batchers
                # are per-instance), so capturing it at first submit is
                # safe and keeps the flusher signature uniform
                self._self_obj = self_obj
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name=f"serve-batch-{getattr(self.fn, '__name__', '?')}")
                self._thread.start()
            self._queue.append(entry)
            self._cv.notify_all()
        if not entry["event"].wait(self.submit_timeout_s):
            with self._cv:
                try:
                    self._queue.remove(entry)
                    where = "still queued (flusher wedged?)"
                except ValueError:
                    where = "in flight inside the batch fn"
            # a second chance: the flush may have completed between the
            # wait timeout and the lock
            if not entry["event"].is_set():
                raise BatchSubmitTimeoutError(
                    f"@serve.batch call to "
                    f"{getattr(self.fn, '__name__', self.fn)!r} got no "
                    f"result within submit_timeout_s="
                    f"{self.submit_timeout_s}s — request {where}; raise "
                    f"the timeout via submit_timeout_s= or "
                    f"RTT_SERVE_BATCH_SUBMIT_TIMEOUT_S if the batch fn "
                    f"is legitimately slow")
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]

    # ---- flusher ----

    def _current_window(self) -> float:
        return self._window if self.adaptive else self.batch_wait_timeout_s

    def _adapt(self, batch_len: int):
        """AIMD on occupancy: full flushes grow the window (traffic is
        heavy enough to fill batches — waiting buys occupancy), batches
        under half-full halve it (waiting only added latency). The
        half-full hold band keeps steady near-saturating traffic from
        oscillating between full batches and fragments."""
        if not self.adaptive:
            return
        if batch_len >= self.max_batch_size:
            floor = max(self.batch_wait_timeout_s / 16.0, 1e-4)
            self._window = min(self.batch_wait_timeout_s,
                               max(self._window * 2.0, floor))
        elif batch_len * 2 < self.max_batch_size:
            self._window *= 0.5
            if self._window < 1e-4:
                self._window = 0.0

    def stop(self, timeout_s: float = 5.0):
        """Stop the flusher thread once the queue drains (replica
        teardown). In-flight entries still complete; a later submit
        restarts the flusher."""
        with self._cv:
            t, self._thread = self._thread, None
            self._stopping = True
            self._cv.notify_all()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout_s)

    def _flush_loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    if self._stopping:
                        return
                    self._cv.wait()
                deadline = monotonic() + self._current_window()
                while len(self._queue) < self.max_batch_size:
                    remaining = deadline - monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                    if not self._queue:  # submit timeouts drained it
                        break
                batch = self._queue[:self.max_batch_size]
                del self._queue[:len(batch)]
                self._adapt(len(batch))
                self._num_flushes += 1
            if batch:
                self._run_batch(batch)
            # anything enqueued while the batch fn ran is still in
            # self._queue — the loop re-arms on it immediately

    def _run_batch(self, batch: List[dict]):
        items = [e["item"] for e in batch]
        n = len(items)
        if self.pad_to_bucket:
            # pad EVERY flush (including singletons) so the callable
            # only ever sees bucket shapes — an unpadded stray size
            # would trigger a fresh compile mid-traffic
            target = next_bucket(n, self.max_batch_size,
                                 self.min_pad_bucket)
            if target > n:
                items = items + [items[-1]] * (target - n)
        try:
            if self._self_obj is not None:
                results = self.fn(self._self_obj, items)
            else:
                results = self.fn(items)
            results = list(results)[:n]
            if len(results) < n:
                raise ValueError(
                    f"batch fn {getattr(self.fn, '__name__', self.fn)!r} "
                    f"returned {len(results)} results for {n} items")
            for e, r in zip(batch, results):
                e["result"] = r
        except Exception as err:
            # every waiter in this flush unblocks with the error —
            # a partially-assigned batch must not strand callers
            for e in batch:
                e["error"] = err
        for e in batch:
            e["event"].set()

    # ---- prewarm ----

    def bucket_sizes(self) -> List[int]:
        sizes = []
        b = self.min_pad_bucket
        while b < self.max_batch_size:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch_size)
        return sizes

    def prewarm(self, template_item: Any, self_obj=None):
        """Run the batch fn once per pad bucket so a compiled callable
        builds every shape it will ever see at startup, instead of on
        the first unlucky request (replicas call this through the
        ``__serve_prewarm__`` hook)."""
        self_obj = self_obj if self_obj is not None else self._self_obj
        for size in (self.bucket_sizes() if self.pad_to_bucket
                     else [self.max_batch_size]):
            items = [template_item] * size
            if self_obj is not None:
                self.fn(self_obj, items)
            else:
                self.fn(items)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01,
          pad_to_bucket: bool = False,
          min_pad_bucket: int = 1,
          submit_timeout_s: Optional[float] = None,
          adaptive: Optional[bool] = None):
    """Decorate ``fn(list_of_items) -> list_of_results`` (function or
    method); concurrent single-item calls are transparently batched.

    ``adaptive`` (default: env ``RTT_SERVE_ADAPTIVE_BATCH``, on)
    adapts the flush wait window to load instead of always waiting
    ``batch_wait_timeout_s``. ``submit_timeout_s`` (default: env
    ``RTT_SERVE_BATCH_SUBMIT_TIMEOUT_S``, 60s) bounds how long one
    call waits on a wedged batch fn. ``min_pad_bucket`` floors the
    ``pad_to_bucket`` bucket set (e.g. 4 → buckets 4, 8, ...).

    The returned wrapper exposes ``.prewarm(item)`` (free functions) /
    ``.prewarm(self, item)`` (methods) to compile every pad bucket
    eagerly."""

    def wrap(fn):
        attr = f"__serve_batcher_{fn.__name__}"

        def make_batcher():
            return _Batcher(fn, max_batch_size, batch_wait_timeout_s,
                            pad_to_bucket, min_pad_bucket,
                            submit_timeout_s, adaptive)

        def get_instance_batcher(self):
            # one batcher PER INSTANCE: a decoration-time batcher would
            # mix items from different instances into one flush
            batcher = getattr(self, attr, None)
            if batcher is None:
                batcher = make_batcher()
                try:
                    setattr(self, attr, batcher)
                except AttributeError:  # __slots__ etc.
                    pass
            return batcher

        @functools.wraps(fn)
        def method_wrapper(self, item):
            return get_instance_batcher(self).submit(item, self_obj=self)

        shared = make_batcher()

        @functools.wraps(fn)
        def fn_wrapper(item):
            return shared.submit(item)

        # heuristically pick method vs free-function form
        import inspect
        params = list(inspect.signature(fn).parameters)
        if params and params[0] == "self":
            wrapper = method_wrapper
            wrapper.prewarm = lambda self, item: \
                get_instance_batcher(self).prewarm(item, self_obj=self)
        else:
            wrapper = fn_wrapper
            wrapper.prewarm = lambda item: shared.prewarm(item)
        wrapper._batcher = shared
        return wrapper

    return wrap if _fn is None else wrap(_fn)
