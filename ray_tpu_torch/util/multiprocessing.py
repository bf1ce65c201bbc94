"""multiprocessing.Pool-compatible API on cluster tasks.

Reference analogue: python/ray/util/multiprocessing/ (Pool over Ray
tasks). map/starmap chunk the iterable into tasks; apply_async returns
an AsyncResult wrapping an ObjectRef.

The port's copy of ``ray_tpu/util/multiprocessing.py`` (imports renamed to
``ray_tpu_torch``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout: Optional[float] = None):
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait([self._ref], num_returns=1, timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait([self._ref], num_returns=1, timeout=0)
        return len(ready) == 1

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


def _chunk(seq: List[Any], n_chunks: int) -> List[List[Any]]:
    n = max(1, (len(seq) + n_chunks - 1) // n_chunks)
    return [seq[i:i + n] for i in range(0, len(seq), n)]


class Pool:
    def __init__(self, processes: Optional[int] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        total_cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        self._size = processes or max(1, total_cpus)
        self._closed = False

    def apply(self, fn: Callable, args: tuple = (),
              kwargs: dict = None) -> Any:
        return self.apply_async(fn, args, kwargs).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwargs: dict = None) -> AsyncResult:
        self._check_open()
        remote_fn = ray_tpu_torch.remote(fn)
        return AsyncResult(remote_fn.remote(*args, **(kwargs or {})))

    def map(self, fn: Callable, iterable: Iterable[Any],
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable[Any],
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        items = list(iterable)
        chunks = (_chunk(items, self._size) if chunksize is None
                  else [items[i:i + chunksize]
                        for i in range(0, len(items), chunksize)])

        @ray_tpu_torch.remote
        def _run_chunk(chunk):
            return [fn(x) for x in chunk]

        refs = [_run_chunk.remote(c) for c in chunks]

        @ray_tpu_torch.remote
        def _gather(*parts):
            return [x for part in parts for x in part]

        return AsyncResult(_gather.remote(*refs))

    def starmap(self, fn: Callable,
                iterable: Iterable[tuple]) -> List[Any]:
        return self.map(lambda args: fn(*args), iterable)

    def imap(self, fn: Callable, iterable: Iterable[Any]):
        self._check_open()
        remote_fn = ray_tpu_torch.remote(fn)
        refs = [remote_fn.remote(x) for x in iterable]
        for r in refs:
            yield ray_tpu_torch.get(r)

    def imap_unordered(self, fn: Callable, iterable: Iterable[Any]):
        self._check_open()
        remote_fn = ray_tpu_torch.remote(fn)
        pending = [remote_fn.remote(x) for x in iterable]
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield ray_tpu_torch.get(ready[0])

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        pass

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool is closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
