"""DAG node types.

Reference analogue: python/ray/dag/dag_node.py, function_node.py,
class_node.py, input_node.py. ``fn.bind(x)`` builds a lazy node;
``node.execute(input)`` walks the DAG, submitting tasks/actor calls and
wiring ObjectRefs as dependencies (the scheduler overlaps anything
independent).

Copied from the JAX package's ``ray_tpu/dag/dag_node.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base lazy node. Subclasses implement ``_execute_impl``."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal --

    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(
                self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _resolve_args(self, cache: Dict[int, Any], input_value: Any
                      ) -> Tuple[tuple, dict]:
        def res(v):
            if isinstance(v, DAGNode):
                return v._execute_cached(cache, input_value)
            return v
        args = tuple(res(a) for a in self._bound_args)
        kwargs = {k: res(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_cached(self, cache: Dict[int, Any], input_value: Any):
        key = id(self)
        if key not in cache:
            cache[key] = self._execute_impl(cache, input_value)
        return cache[key]

    def _execute_impl(self, cache, input_value):
        raise NotImplementedError

    def execute(self, input_value: Any = None):
        """Run the DAG rooted here; returns an ObjectRef (or value for
        InputNode roots)."""
        return self._execute_cached({}, input_value)

    def compile(self, **options) -> "CompiledDAG":
        """Pre-wire this graph into a :class:`CompiledDAG`: actors
        created once, peer-to-peer channels opened between consecutive
        stages, one trigger frame per execution (docs/COMPILED_DAGS.md).
        Graphs that cannot compile (non-actor stages, multi-upstream
        nodes, pre-1.5 peers) transparently run the dynamic path."""
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG
        return CompiledDAG(self, **options)

    # reference-parity alias (python/ray/dag experimental_compile)
    experimental_compile = compile


class InputNode(DAGNode):
    """Placeholder for the runtime input (reference: input_node.py:343).
    Usable as a context manager for parity with the reference API."""

    def __init__(self):
        super().__init__((), {})

    def _execute_impl(self, cache, input_value):
        return input_value

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    """Lazy invocation of a remote function."""

    def __init__(self, remote_fn, args, kwargs, opts=None):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._opts = opts or {}

    def _execute_impl(self, cache, input_value):
        args, kwargs = self._resolve_args(cache, input_value)
        return self._remote_fn._remote(args, kwargs, self._opts)


class ClassNode(DAGNode):
    """Lazy actor instantiation; attribute access yields method nodes.

    The actor handle is cached ON THE NODE across executions — a DAG
    instance owns one actor per ClassNode (the reference's class_node
    semantics), so repeated ``dag.execute()`` calls reuse the same actor
    instead of leaking a fresh one per run. Constructor args are
    resolved on the first execution only."""

    def __init__(self, actor_cls, args, kwargs, opts=None):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._opts = opts or {}
        self._cached_actor = None

    def _execute_impl(self, cache, input_value):
        if self._cached_actor is None:
            args, kwargs = self._resolve_args(cache, input_value)
            self._cached_actor = self._actor_cls._create(
                self._opts, args, kwargs)
        return self._cached_actor

    def _invalidate_actor(self):
        """Drop the cached handle; the next execution creates a fresh
        actor (used when the actor died — compiled-DAG fallback)."""
        self._cached_actor = None

    def _invalidate_if_dead(self):
        if self._cached_actor is None:
            return
        try:
            from ray_tpu_torch._private.worker import global_worker
            w = global_worker()
            info = w.call_sync(w.gcs, "get_actor",
                               {"actor_id": self._cached_actor._id_hex},
                               timeout=10)
            if info.get("error") or info.get("state") == "DEAD":
                self._cached_actor = None
        except Exception:
            self._cached_actor = None

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodStub(self, name)


class _ClassMethodStub:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name,
                               args, kwargs)


class ClassMethodNode(DAGNode):
    """Lazy method call on a ClassNode-created actor."""

    def __init__(self, class_node: ClassNode, method_name: str,
                 args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self):
        return super()._children() + [self._class_node]

    def _execute_impl(self, cache, input_value):
        actor = self._class_node._execute_cached(cache, input_value)
        args, kwargs = self._resolve_args(cache, input_value)
        return getattr(actor, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Aggregates several output nodes so one graph can fan out to
    multiple sinks (reference: python/ray/dag MultiOutputNode).
    ``execute()`` returns the outputs as a list (of ObjectRefs on the
    dynamic path; of values when compiled)."""

    def __init__(self, outputs):
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, cache, input_value):
        return [a._execute_cached(cache, input_value)
                if isinstance(a, DAGNode) else a
                for a in self._bound_args]
