"""Lazy task/actor DAG authoring — .bind()/.execute()/.compile().

Reference analogue: python/ray/dag (DAGNode dag_node.py:339,
FunctionNode/ClassNode/InputNode/MultiOutputNode). DAGs built here are
the substrate the workflow engine executes durably; actor-method graphs
additionally compile into pre-wired peer-to-peer channel pipelines
(compiled_dag.py, docs/COMPILED_DAGS.md) that skip the per-call
control-plane dispatch entirely.

Copied from the JAX package's ``ray_tpu/dag/__init__.py``.
"""

from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                                  FunctionNode, InputNode,
                                  MultiOutputNode)


def __getattr__(name):
    # CompiledDAG imports the worker runtime; keep dag authoring
    # importable without dragging the full runtime in
    if name in ("CompiledDAG", "CompileError"):
        from ray_tpu_torch.dag import compiled_dag
        return getattr(compiled_dag, name)
    raise AttributeError(name)


__all__ = ["DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode",
           "InputNode", "MultiOutputNode", "CompiledDAG", "CompileError"]
