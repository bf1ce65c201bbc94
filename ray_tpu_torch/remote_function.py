"""``@ray_tpu_torch.remote`` functions.

Reference analogue: python/ray/remote_function.py (RemoteFunction._remote:239
→ core_worker.submit_task:385). The function is exported to GCS KV once and
referenced by key in every task spec.

Copied from the JAX package's ``ray_tpu/remote_function.py``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.worker import ObjectRef, global_worker
from ray_tpu_torch.common.options import validate_options

# bound lazily (ray_tpu_torch.util imports back into the package); cached —
# a per-call ``from ... import client_mode`` showed up in submit profiles
_client_mode = None


class RemoteFunction:
    def __init__(self, fn, default_opts: Dict[str, Any]):
        self._fn = fn
        self._default_opts = validate_options(default_opts, is_actor=False)
        self._fn_key: Optional[str] = None
        self._fn_key_mgr = None  # function manager the key was exported to
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called "
            f"directly; use .remote()")

    def options(self, **opts) -> "_BoundRemoteFunction":
        merged = {**self._default_opts,
                  **validate_options(opts, is_actor=False)}
        return _BoundRemoteFunction(self, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_opts)

    def remote_batch(self, arg_tuples):
        """Submit many invocations in one go: ``arg_tuples`` is an
        iterable of positional-arg tuples; returns a list of refs (or
        ref-lists when num_returns > 1). Amortizes per-call overhead —
        the >=10k tasks/s submission path (reference analogue: the
        batched submission the reference's scalability envelope relies
        on, release/benchmarks/README.md)."""
        return self._remote_batch(arg_tuples, self._default_opts)

    def bind(self, *args, **kwargs):
        """DAG authoring (reference: python/ray/dag FunctionNode)."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs, self._default_opts)

    def _remote(self, args, kwargs, opts: Dict[str, Any]):
        global _client_mode
        if _client_mode is None:
            from ray_tpu_torch.util.client.worker import client_mode
            _client_mode = client_mode
        c = _client_mode()
        if c is not None and c.connected:
            return c.submit_fn(self._fn, args, kwargs, opts)
        w = global_worker()
        if self._fn_key is None or self._fn_key_mgr is not w.function_manager:
            # re-export after a cluster restart: the key cache is only
            # valid for the GCS it was exported to
            self._fn_key = w.function_manager.export(self._fn, kind="fn")
            self._fn_key_mgr = w.function_manager
        refs = w.submit_task(self._fn_key, self._fn.__name__, args, kwargs,
                             opts)
        num_returns = opts.get("num_returns")
        if num_returns is None or num_returns == 1:
            return refs[0]
        return refs

    def _remote_batch(self, arg_tuples, opts: Dict[str, Any]):
        w = global_worker()
        if self._fn_key is None or self._fn_key_mgr is not w.function_manager:
            self._fn_key = w.function_manager.export(self._fn, kind="fn")
            self._fn_key_mgr = w.function_manager
        ref_lists = w.submit_task_batch(self._fn_key, self._fn.__name__,
                                        arg_tuples, opts)
        num_returns = opts.get("num_returns")
        if num_returns is None or num_returns == 1:
            return [refs[0] for refs in ref_lists]
        return ref_lists


class _BoundRemoteFunction:
    def __init__(self, remote_fn: RemoteFunction, opts: Dict[str, Any]):
        self._remote_fn = remote_fn
        self._opts = opts

    def remote(self, *args, **kwargs):
        return self._remote_fn._remote(args, kwargs, self._opts)

    def remote_batch(self, arg_tuples):
        return self._remote_fn._remote_batch(arg_tuples, self._opts)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self._remote_fn, args, kwargs, self._opts)
