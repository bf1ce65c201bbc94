"""The port stands alone: no module of ``ray_tpu_torch/`` and not
``chip_smoke.py`` imports JAX, flax, optax, the JAX package or
``transformers`` (the card machine has none of them; the HF imports
read local state_dicts). One import of ``transformers`` is allowed:
inside the train loop that ``train/transformers_trainer.py``'s
``_make_train_loop`` returns, which runs only in a train worker of a
``TransformersTrainer`` (``ALLOWED``).

Checked on the source (AST), not on ``sys.modules``: a process may
have JAX loaded for reasons of its own. A fresh interpreter then
imports ``ray_tpu_torch.train``, ``.air`` and ``.util`` with sklearn,
transformers and lightning made unimportable, and must not load torch.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "transformers")
# (file, enclosing functions, module): the forbidden imports allowed
ALLOWED = {("ray_tpu_torch/train/transformers_trainer.py",
            ("_make_train_loop", "_loop"), "transformers")}


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


def _enclosing_functions(path):
    """{lineno of an import: the names of the functions around it}."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out = {}

    def visit(node, funcs):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs = funcs + (node.name,)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out[node.lineno] = funcs
        for child in ast.iter_child_nodes(node):
            visit(child, funcs)

    visit(tree, ())
    return out


def _violations(path):
    rel = os.path.relpath(path, REPO_ROOT)
    funcs = _enclosing_functions(path)
    return [f"{rel}:{line}: {mod}" for line, mod in _imported_roots(path)
            if _forbidden(mod)
            and (rel, funcs.get(line), mod) not in ALLOWED]


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
    for mod in ("__init__", "sample", "trial", "schedulers", "logger",
                "syncer", "tune", "tuner", "search/__init__",
                "search/_space", "search/searcher", "search/basic_variant",
                "search/tpe", "search/bayesopt", "search/bohb",
                "search/external"):
        assert f"ray_tpu_torch/tune/{mod}.py" in rel
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
    for mod in ("air/preprocessor", "air/batch_predictor",
                "train/gbdt_trainer", "train/sklearn_trainer",
                "train/rl_trainer", "train/transformers_trainer",
                "train/lightning_trainer", "util/gpu_profiler",
                "util/actor_pool", "util/queue"):
        assert f"ray_tpu_torch/{mod}.py" in rel
    for mod in ("_private/cluster_utils", "_private/testing/__init__",
                "_private/testing/mocks", "dag/__init__", "dag/dag_node",
                "dag/channel", "dag/compiled_dag", "util/client/__init__",
                "util/client/common", "util/client/server",
                "util/client/worker", "util/cross_language"):
        assert f"ray_tpu_torch/{mod}.py" in rel
    for jax_file, port_file in OPS_FILES + UTIL_ANALYSIS_FILES:
        assert port_file in rel, jax_file
    assert len(files) > 10


# cluster operations: each JAX file and its port namesake
OPS_FILES = [(f"ray_tpu/{m}.py", f"ray_tpu_torch/{m}.py") for m in (
    "autoscaler/__init__", "autoscaler/node_provider",
    "autoscaler/autoscaler", "autoscaler/config", "autoscaler/commands",
    "autoscaler/aws", "autoscaler/azure", "autoscaler/kubernetes",
    "autoscaler/command_runner", "autoscaler/updater",
    "experimental/__init__", "experimental/state/__init__",
    "experimental/state/api", "job_submission", "dashboard/__init__",
    "dashboard/dashboard", "dashboard/frontend", "dashboard/grafana",
    "scripts/__init__", "scripts/cli", "_private/ray_perf",
    "util/metrics")] + [("ray_tpu/autoscaler/gcp_tpu.py",
                         "ray_tpu_torch/autoscaler/gcp_gpu.py")]


# util's last five modules and rtpulint: each JAX file and its namesake
UTIL_ANALYSIS_FILES = [(f"ray_tpu/{m}.py", f"ray_tpu_torch/{m}.py") for m in (
    "util/check_serialize", "util/multiprocessing", "util/iter", "util/dask",
    "util/joblib", "analysis/__init__", "analysis/__main__",
    "analysis/baseline", "analysis/cli", "analysis/config_registry",
    "analysis/core", "analysis/docs_gen", "analysis/reporter",
    "analysis/checkers/__init__", "analysis/checkers/blocking",
    "analysis/checkers/chaos_sites", "analysis/checkers/env_registry",
    "analysis/checkers/excepts", "analysis/checkers/locks",
    "analysis/checkers/resources", "analysis/checkers/wire_versions")]


@pytest.mark.parametrize("jax_file,port_file",
                         OPS_FILES + UTIL_ANALYSIS_FILES,
                         ids=[p for _, p in OPS_FILES + UTIL_ANALYSIS_FILES])
def test_ops_files_have_port_namesakes(jax_file, port_file):
    """Each port file names its JAX source in its docstring."""
    assert os.path.exists(os.path.join(REPO_ROOT, jax_file))
    path = os.path.join(REPO_ROOT, port_file)
    with open(path, encoding="utf-8") as f:
        doc = ast.get_docstring(ast.parse(f.read())) or ""
    assert jax_file in doc.replace("``", " ").split(), doc
    assert _violations(path) == []


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_no_jax_or_ray_tpu_imports(path):
    assert _violations(path) == []


def test_transformers_only_in_the_hf_train_loop():
    """The one allowed import is there, inside the loop, and nowhere
    else in the file."""
    path = os.path.join(REPO_ROOT, "ray_tpu_torch", "train",
                        "transformers_trainer.py")
    funcs = _enclosing_functions(path)
    found = [(funcs[line], mod) for line, mod in _imported_roots(path)
             if _forbidden(mod)]
    assert found == [(("_make_train_loop", "_loop"), "transformers")]


def test_train_air_util_import_without_optional_deps():
    code = (
        "import sys\n"
        "for m in ('sklearn', 'transformers', 'pytorch_lightning',"
        " 'lightning'):\n"
        "    sys.modules[m] = None\n"
        "import ray_tpu_torch.train, ray_tpu_torch.air, ray_tpu_torch.util\n"
        "from ray_tpu_torch.train import (RLTrainer, SklearnTrainer,"
        " TransformersTrainer, LightningTrainer, XGBoostTrainer)\n"
        "from ray_tpu_torch.air import BatchPredictor, TorchPredictor\n"
        "from ray_tpu_torch.util import ActorPool, Queue\n"
        "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_dag_and_client_import_without_torch():
    """A ``ray://`` driver and a DAG's author load neither torch nor the
    kernels."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.dag, ray_tpu_torch.util.client\n"
        "from ray_tpu_torch.dag import InputNode, MultiOutputNode,"
        " CompiledDAG\n"
        "from ray_tpu_torch.util.client import ClientObjectRef\n"
        "from ray_tpu_torch.util.client.server import ClientServer\n"
        "from ray_tpu_torch._private.cluster_utils import Cluster\n"
        "print(sorted(m for m in ('torch', 'ray_tpu_torch.kernels')"
        " if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_ops_modules_import_without_torch():
    """A job's driver, the dashboard, the CLI and the autoscaler load
    neither torch nor the kernels."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.autoscaler, ray_tpu_torch.job_submission\n"
        "import ray_tpu_torch.dashboard, ray_tpu_torch.experimental.state\n"
        "import ray_tpu_torch.util.metrics, ray_tpu_torch._private.ray_perf\n"
        "import ray_tpu_torch.scripts.cli\n"
        "from ray_tpu_torch.autoscaler import (AutoscalerMonitor,"
        " FakeMultiNodeProvider, GCPGPUNodeProvider, request_resources)\n"
        "from ray_tpu_torch.dashboard.grafana import generate_dashboards\n"
        "generate_dashboards()\n"
        "print(sorted(m for m in ('torch', 'ray_tpu_torch.kernels')"
        " if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_util_and_analysis_import_without_torch():
    """The five util modules and the whole of rtpulint (its CLI through
    ``ray-tpu-torch lint``'s module included) load neither torch nor the
    kernels."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.util.check_serialize,"
        " ray_tpu_torch.util.multiprocessing\n"
        "import ray_tpu_torch.util.iter, ray_tpu_torch.util.dask,"
        " ray_tpu_torch.util.joblib\n"
        "import ray_tpu_torch.analysis.cli, ray_tpu_torch.analysis.docs_gen\n"
        "from ray_tpu_torch.analysis.core import registry\n"
        "assert len(registry()) == 7\n"
        "print(sorted(m for m in ('torch', 'ray_tpu_torch.kernels')"
        " if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_models_export_what_jax_exports():
    """``ray_tpu_torch.models`` names every name ``ray_tpu.models``
    exports; ``causal_lm_loss`` is Llama's (the JAX name's module), not
    GPT-2's, and ``import_hf_llama`` is Llama's HF import."""
    import ray_tpu.models as J
    import ray_tpu_torch.models as T
    from ray_tpu_torch.models import gpt2, llama
    jax_names = {n for n, v in vars(J).items() if not n.startswith("_")
                 and not isinstance(v, type(J))}
    assert jax_names <= set(T.__all__), jax_names - set(T.__all__)
    assert all(hasattr(T, n) for n in T.__all__)
    assert T.causal_lm_loss is llama.causal_lm_loss
    assert T.causal_lm_loss is not gpt2.causal_lm_loss
    assert T.import_hf_llama is llama.import_hf_llama


def test_checker_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom ray_tpu.ops import x\n"
                 "from ray_tpu_torch.ops import y\nimport flax\n"
                 "import importlib\nimportlib.import_module('optax')\n")
    found = [m for _, m in _imported_roots(str(p)) if _forbidden(m)]
    assert found == ["jax.numpy", "ray_tpu.ops", "flax", "optax"]


def test_checker_allows_transformers_only_where_listed(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def _make_train_loop(f):\n"
                 "    def _loop(config):\n"
                 "        import transformers\n"
                 "    return _loop\n"
                 "import transformers\n")
    funcs = _enclosing_functions(str(p))
    assert funcs == {3: ("_make_train_loop", "_loop"), 5: ()}
    assert [(funcs[line], m) for line, m in _imported_roots(str(p))
            if _forbidden(m)
            and ("ray_tpu_torch/train/transformers_trainer.py",
                 funcs[line], m) not in ALLOWED] == [((), "transformers")]
