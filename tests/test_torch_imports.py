"""The port stands alone: no module of ``ray_tpu_torch/`` and not
``chip_smoke.py`` imports JAX, flax, optax, the JAX package or
``transformers`` (the card machine has none of them; the HF imports
read local state_dicts).

Checked on the source (AST), not on ``sys.modules``: a process may
have JAX loaded for reasons of its own.
"""

import ast
import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "transformers")


def _port_files():
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO_ROOT,
                                                   "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _forbidden(module):
    root = module.split(".")[0]
    return root in FORBIDDEN


def test_port_files_found():
    files = _port_files()
    rel = {os.path.relpath(f, REPO_ROOT) for f in files}
    assert "chip_smoke.py" in rel
    assert "ray_tpu_torch/ops/attention.py" in rel
    for mod in ("mesh", "collectives", "dryrun", "pipeline", "moe"):
        assert f"ray_tpu_torch/parallel/{mod}.py" in rel
    assert "ray_tpu_torch/ops/ring_attention.py" in rel
    assert "ray_tpu_torch/train/spmd.py" in rel
    for mod in ("env", "sample_batch", "postprocessing", "connectors",
                "models", "policy", "rollout_worker", "algorithm",
                "algorithms/ppo", "core/rl_module", "core/learner",
                "core/learner_group", "replay_buffers",
                "execution/learner_thread", "algorithms/impala",
                "algorithms/appo", "algorithms/dqn", "algorithms/simple_q",
                "algorithms/pg", "algorithms/a3c", "algorithms/bandit",
                "algorithms/slateq", "algorithms/r2d2", "algorithms/dt",
                "algorithms/qmix", "algorithms/maddpg", "algorithms/maml",
                "algorithms/mbmpo", "algorithms/dreamer",
                "algorithms/alpha_zero", "algorithms/alpha_star",
                "algorithms/ddppo", "algorithms/apex_dqn",
                "algorithms/apex_ddpg", "algorithms/es"):
        assert f"ray_tpu_torch/rllib/{mod}.py" in rel
    assert "ray_tpu_torch/tune/trainable.py" in rel
    assert "ray_tpu_torch/air/checkpoint.py" in rel
    for mod in ("air/config", "air/session", "train/data_parallel_trainer",
                "train/torch_trainer", "train/_internal/backend_executor",
                "train/_internal/worker_group", "data/__init__", "data/block",
                "data/read_api", "data/dataset", "data/dataset_pipeline",
                "data/grouped_data", "data/_internal/plan",
                "data/_internal/compute", "data/_internal/shuffle",
                "data/_internal/push_based_shuffle",
                "data/_internal/streaming_executor"):
        assert f"ray_tpu_torch/{mod}.py" in rel
    for mod in ("checkpoint/manager", "checkpoint/async_checkpointer",
                "serve/llm/disagg"):
        assert f"ray_tpu_torch/{mod}.py" in rel
    for mod in ("serve/__init__", "serve/exceptions", "serve/api",
                "serve/batching", "serve/controller", "serve/drivers",
                "serve/handle", "serve/http_adapters", "serve/http_proxy",
                "serve/ingress", "serve/schema", "serve/_private/autoscaling",
                "serve/_private/journal", "serve/_private/long_poll",
                "serve/_private/replica", "serve/_private/router",
                "gameday/__init__", "gameday/store"):
        assert f"ray_tpu_torch/{mod}.py" in rel
    for mod in ("__init__", "actor", "remote_function", "exceptions",
                "common/ids", "common/config", "common/options",
                "util/placement_group", "util/scheduling_strategies",
                "util/events", "util/timeline", "_private/native",
                "_private/serialization", "_private/ref_serialization",
                "_private/protocol", "_private/schema", "_private/chaos",
                "_private/rpccore", "_private/netx/client",
                "_private/netx/server", "_private/netx/endpoints",
                "_private/direct", "_private/object_store",
                "_private/external_storage", "_private/storage",
                "_private/sched", "_private/gcs_store", "_private/gcs",
                "_private/gcs_main", "_private/raylet",
                "_private/raylet_main", "_private/runtime_env/__init__",
                "_private/worker", "_private/function_manager",
                "_private/default_worker", "_private/task_events",
                "_private/tracing", "_private/usage/__init__",
                "_private/node"):
        assert f"ray_tpu_torch/{mod}.py" in rel
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_no_jax_or_ray_tpu_imports(path):
    bad = [f"{os.path.relpath(path, REPO_ROOT)}:{line}: {mod}"
           for line, mod in _imported_roots(path) if _forbidden(mod)]
    assert bad == []


def test_checker_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom ray_tpu.ops import x\n"
                 "from ray_tpu_torch.ops import y\nimport flax\n"
                 "import importlib\nimportlib.import_module('optax')\n")
    found = [m for _, m in _imported_roots(str(p)) if _forbidden(m)]
    assert found == ["jax.numpy", "ray_tpu.ops", "flax", "optax"]
