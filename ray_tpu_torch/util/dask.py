"""Dask-on-ray_tpu_torch scheduler: execute dask task graphs as cluster tasks.

Reference analogue: python/ray/util/dask/scheduler.py (ray_dask_get:83)
— a drop-in `scheduler=` callable for `dask.compute`. A dask graph is a
plain dict {key: computation} where a computation is a literal, a key,
or a task tuple ``(callable, arg...)`` (possibly nested), so the
scheduler needs nothing from dask itself: each graph key becomes one
submitted task whose dependencies are ObjectRefs, giving cluster-wide
parallelism and object-store reuse of intermediates.

With dask installed: ``dask.compute(x, scheduler=ray_dask_get)``.
Without it: call ``ray_dask_get(graph_dict, keys)`` directly.

The port's copy of ``ray_tpu/util/dask.py`` (imports renamed to
``ray_tpu_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import ray_tpu_torch


def _istask(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and callable(x[0])


def _iskey(x: Any, dsk: Dict) -> bool:
    try:
        return x in dsk
    except TypeError:  # unhashable
        return False


def _find_deps(expr: Any, dsk: Dict, out: set):
    if _istask(expr):
        for a in expr[1:]:
            _find_deps(a, dsk, out)
    elif isinstance(expr, list):
        for a in expr:
            _find_deps(a, dsk, out)
    elif _iskey(expr, dsk):
        out.add(expr)


def _toposort(dsk: Dict) -> List[Any]:
    deps = {}
    for k, expr in dsk.items():
        s: set = set()
        _find_deps(expr, dsk, s)
        s.discard(k)
        deps[k] = s
    order, done, visiting = [], set(), set()

    def visit(k):
        if k in done:
            return
        if k in visiting:
            raise ValueError(f"cycle in dask graph at key {k!r}")
        visiting.add(k)
        for d in deps[k]:
            visit(d)
        visiting.discard(k)
        done.add(k)
        order.append(k)

    for k in dsk:
        visit(k)
    return order


def _eval_expr(expr: Any, env: Dict[Any, Any]) -> Any:
    """Execute a (possibly nested) dask computation inside the task."""
    if _istask(expr):
        fn = expr[0]
        args = [_eval_expr(a, env) for a in expr[1:]]
        return fn(*args)
    if isinstance(expr, list):
        return [_eval_expr(a, env) for a in expr]
    try:
        if expr in env:
            return env[expr]
    except TypeError:
        pass
    return expr


@ray_tpu_torch.remote
def _exec_node(expr, dep_keys, *dep_values):
    return _eval_expr(expr, dict(zip(dep_keys, dep_values)))


def ray_dask_get(dsk: Dict, keys, **_kwargs):
    """Compute `keys` of the graph `dsk`; one cluster task per node.

    Matches dask's scheduler-callable signature, so it plugs into
    ``dask.compute(..., scheduler=ray_dask_get)`` when dask is present.
    """
    refs: Dict[Any, Any] = {}
    for k in _toposort(dsk):
        expr = dsk[k]
        deps: set = set()
        _find_deps(expr, dsk, deps)
        deps.discard(k)
        dep_keys = sorted(deps, key=repr)
        refs[k] = _exec_node.remote(
            expr, dep_keys, *[refs[d] for d in dep_keys])

    def unpack(ks):
        if isinstance(ks, list):
            return [unpack(x) for x in ks]
        return ray_tpu_torch.get(refs[ks])

    return unpack(keys)


def enable_dask_on_ray():
    """Register ray_dask_get as dask's default scheduler (requires
    dask; reference: util/dask/__init__.py enable_dask_on_ray)."""
    try:
        import dask
    except ImportError as e:  # pragma: no cover - dask not in image
        raise ImportError(
            "dask is not installed; call ray_dask_get(graph, keys) "
            "directly on raw graphs instead") from e
    dask.config.set(scheduler=ray_dask_get)
    return ray_dask_get
