"""joblib backend: sklearn's n_jobs parallelism over cluster tasks.

Reference analogue: python/ray/util/joblib/ (register_ray +
ray_backend.py) — a joblib ParallelBackend whose apply_async submits to
the cluster, so `with joblib.parallel_backend("ray_tpu_torch"):` fans
GridSearchCV / cross_val_score / any joblib-parallel workload across
nodes unchanged.

The port's copy of ``ray_tpu/util/joblib.py`` (imports renamed to
``ray_tpu_torch``).
"""

from __future__ import annotations

from typing import Any, Callable


class _Result:
    """joblib future protocol: .get(timeout=None)."""

    def __init__(self, ref, callback=None):
        self._ref = ref
        if callback is not None:
            # joblib drives completion through the callback
            import threading

            def _wait():
                import ray_tpu_torch
                try:
                    value = ray_tpu_torch.get(ref)
                except BaseException as e:  # delivered via get() below
                    value = e
                callback(value)

            threading.Thread(target=_wait, daemon=True).start()

    def get(self, timeout=None):
        import ray_tpu_torch
        value = ray_tpu_torch.get(self._ref, timeout=timeout)
        if isinstance(value, BaseException):
            raise value
        return value


def register_ray():
    """Register the 'ray_tpu_torch' joblib backend (idempotent)."""
    from joblib import register_parallel_backend
    from joblib.parallel import ParallelBackendBase

    class RayTpuBackend(ParallelBackendBase):
        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, **kw):
            import ray_tpu_torch
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs):
            import ray_tpu_torch
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            if n_jobs is None or n_jobs == -1:
                return max(1, cpus)
            return max(1, n_jobs)

        def apply_async(self, func: Callable, callback=None) -> Any:
            import ray_tpu_torch

            # func is a joblib BatchedCalls (picklable); run it whole as
            # one task
            @ray_tpu_torch.remote
            def _run_batch(batch):
                return batch()

            ref = _run_batch.remote(func)
            return _Result(ref, callback)

        def abort_everything(self, ensure_ready=True):
            pass

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
