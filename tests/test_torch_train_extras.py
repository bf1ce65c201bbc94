"""The port's trainers beyond the gang — ``SklearnTrainer``, the GBDT
trainers, ``LightningTrainer``, ``RLTrainer`` and ``TransformersTrainer``
— against the JAX package's, on the CPU.

One cluster of each package for the module (``init(num_cpus=10)``:
room for every fit at once). The module's fits all start together, on
both packages, from driver threads (``fits``), and each test reads its
own: a fit is mostly worker processes importing sklearn, torch or
transformers, which overlap. ``SklearnTrainer``
(cv = 3) and ``SklearnGBDTTrainer`` give the same metrics, fold scores
and predictions (both sides fit the same sklearn estimators on the same
rows). XGBoost, LightGBM and Lightning raise ``ImportError`` where their
package is missing, as JAX's do. ``RLTrainer(PG, CartPole-v1,
device="cpu")`` checkpoints under JAX's keys, reports the iterations a
direct run of the port's ``PG`` with the same config gives, and
``restore_algorithm`` gives back the checkpointed policy weights.
``TransformersTrainer`` on ``tests/test_transformers_trainer.py``'s tiny
model and 2 gloo workers reports JAX's ``train_loss`` (within
``HF_LOSS_REL``: both gangs run the same HF Trainer from the same
initial weights over the same rows and seed) and ships the HF checkpoint files in the result.

Functions that workers run are defined inside the tests (cloudpickle
ships them by value). Every fit has a time limit.
"""

import concurrent.futures
import importlib
import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

STORE_BYTES = 256 * 1024 * 1024
PACKAGES = ("ray_tpu", "ray_tpu_torch")
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
TIMEOUT_S = 60
# the fits' CPUs at once: SklearnTrainer's worker and its 3 fold tasks,
# the GBDT, RL and two gated trainers' workers, 2 HF workers
CPUS = 10
HF_LOSS_REL = 1e-6
PG_CONFIG = {"env": "CartPole-v1", "num_workers": 0,
             "train_batch_size": 200, "lr": 1e-2}


@pytest.fixture(scope="module")
def clusters():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    with mock.patch.dict(os.environ, PORT_ENV):
        ray_tpu.init(num_cpus=CPUS, object_store_memory=STORE_BYTES)
        try:
            ray_tpu_torch.init(num_cpus=CPUS,
                               object_store_memory=STORE_BYTES)
            try:
                yield
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            torch.set_num_threads(old_threads)


def _mod(pkg, name=""):
    return importlib.import_module(pkg + name)


@pytest.fixture(scope="module")
def fits(clusters, tmp_path_factory):
    """Every fit of the module, started at once on both packages:
    {(program, pkg): future}."""
    hf_dir = str(tmp_path_factory.mktemp("hf_out"))
    for pkg in PACKAGES:   # imported here: not by two threads at once
        for name in (".data", ".air.config", ".train",
                     ".train.sklearn_trainer", ".train.rl_trainer"):
            _mod(pkg, name)
    programs = {"sklearn": (_sklearn_fit,), "gbdt": (_gbdt_fit,),
                "rl": (_rl_fit,), "hf": (_hf_fit, hf_dir),
                "xgboost": (_gated_fit, "XGBoostTrainer"),
                "lightgbm": (_gated_fit, "LightGBMTrainer")}
    pool = concurrent.futures.ThreadPoolExecutor(2 * len(programs))
    futures = {(name, pkg): pool.submit(prog, pkg, *args)
               for name, (prog, *args) in programs.items()
               for pkg in PACKAGES}
    yield futures
    pool.shutdown(wait=False, cancel_futures=True)


def _results(fits, name, timeout=2 * TIMEOUT_S):
    """{pkg: program ``name``'s result}, each within ``timeout`` (a hang
    fails the test, not the run)."""
    return {pkg: fits[name, pkg].result(timeout=timeout)
            for pkg in PACKAGES}


def _blobs(n=120, seed=0):
    """tests/test_train_breadth.py's rows."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    return [{"f0": float(a), "f1": float(b), "f2": float(c),
             "f3": float(d), "label": int(t)}
            for (a, b, c, d), t in zip(X, y)]


def _probe():
    return np.random.default_rng(1).normal(size=(16, 4))


def _sklearn_fit(pkg):
    from sklearn.linear_model import LogisticRegression
    data = _mod(pkg, ".data")
    cfg = _mod(pkg, ".air.config")
    mod = _mod(pkg, ".train.sklearn_trainer")
    rows = _blobs()
    trainer = mod.SklearnTrainer(
        estimator=LogisticRegression(max_iter=200),
        label_column="label", cv=3,
        scaling_config=cfg.ScalingConfig(num_workers=1),
        datasets={"train": data.from_items(rows[:100]),
                  "valid": data.from_items(rows[100:])})
    result = trainer.fit()
    assert result.error is None, result.error
    metrics = {k: v for k, v in result.metrics.items()
               if k in ("train-score", "valid-score", "cv_scores",
                        "cv_score_mean", "cv_score_std")}
    model = mod.SklearnTrainer.get_model(result.checkpoint)
    return (metrics, model.predict_proba(_probe()),
            sorted(result.checkpoint.to_dict()))


def test_sklearn_trainer_matches_jax(fits):
    got = _results(fits, "sklearn")
    (m_t, p_t, keys_t), (m_j, p_j, keys_j) = (got["ray_tpu_torch"],
                                              got["ray_tpu"])
    assert m_t == m_j and len(m_t["cv_scores"]) == 3
    assert m_t["train-score"] > 0.8
    assert np.array_equal(p_t, p_j)
    assert keys_t == keys_j == ["label_column", "model.pkl"]


def _gbdt_fit(pkg):
    data = _mod(pkg, ".data")
    cfg = _mod(pkg, ".air.config")
    train = _mod(pkg, ".train")
    rows = _blobs()
    trainer = train.SklearnGBDTTrainer(
        label_column="label", params={"random_state": 0, "max_depth": 2},
        num_boost_round=20,
        scaling_config=cfg.ScalingConfig(num_workers=1),
        datasets={"train": data.from_items(rows[:100]),
                  "valid": data.from_items(rows[100:])})
    result = trainer.fit()
    assert result.error is None, result.error
    metrics = {k: v for k, v in result.metrics.items()
               if k.endswith("-score")}
    model = train.GBDTTrainer.get_model(result.checkpoint)
    return metrics, model.predict_proba(_probe())


def test_sklearn_gbdt_trainer_matches_jax(fits):
    got = _results(fits, "gbdt")
    (m_t, p_t), (m_j, p_j) = got["ray_tpu_torch"], got["ray_tpu"]
    assert m_t == m_j and set(m_t) == {"train-score", "valid-score"}
    assert np.array_equal(p_t, p_j)


def _missing(name):
    return importlib.util.find_spec(name) is None


def _gated_fit(pkg, trainer):
    cfg = _mod(pkg, ".air.config")
    cls = getattr(_mod(pkg, ".train"), trainer)
    result = cls(label_column="label", num_boost_round=2,
                 scaling_config=cfg.ScalingConfig(num_workers=1),
                 datasets={"train": {"X": np.zeros((4, 2)),
                                     "y": np.zeros(4)}}).fit()
    return type(result.error).__name__, str(result.error)


@pytest.mark.parametrize("dep", ["xgboost", "lightgbm"])
def test_gated_gbdt_trainers_raise_as_jax(fits, dep):
    got = _results(fits, dep)
    if not _missing(dep):
        pytest.skip(f"{dep} installed; the gate is not exercised")
    for kind, msg in got.values():
        assert dep in msg and "requires" in msg, msg
    assert got["ray_tpu_torch"][0] == got["ray_tpu"][0]


def test_lightning_trainer_gates_as_jax():
    if not (_missing("pytorch_lightning") and _missing("lightning")):
        pytest.skip("lightning installed; the gate is not exercised")
    for pkg in PACKAGES:
        cls = _mod(pkg, ".train.lightning_trainer").LightningTrainer
        with pytest.raises(ImportError, match="LightningTrainer requires"):
            cls(lightning_module_cls=object)


def _same_tree(a, b) -> bool:
    """Equal nested dicts and lists whose leaves are equal arrays,
    tensors or values."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _rl_fit(pkg):
    cfg = _mod(pkg, ".air.config")
    mod = _mod(pkg, ".train.rl_trainer")
    config = dict(PG_CONFIG)
    if pkg == "ray_tpu_torch":
        config["device"] = "cpu"
    result = mod.RLTrainer(
        algorithm="PG", config=config, num_iterations=2,
        scaling_config=cfg.ScalingConfig(num_workers=1)).fit()
    assert result.error is None, result.error
    return result


def test_rl_trainer_matches_direct_port_run(fits):
    from ray_tpu_torch.rllib.algorithms import PG
    from ray_tpu_torch.train.rl_trainer import ALGO_KEY, RLTrainer
    got = _results(fits, "rl")
    port, jax_result = got["ray_tpu_torch"], got["ray_tpu"]
    # JAX's checkpoint keys, and its reports' keys
    assert sorted(port.checkpoint.to_dict()) == \
        sorted(jax_result.checkpoint.to_dict()) == \
        sorted([ALGO_KEY, "algorithm", "config"])
    assert [sorted(m) for m in port.metrics_history] == \
        [sorted(m) for m in jax_result.metrics_history]
    assert port.metrics["training_iteration"] == 2
    # the iterations a direct run of the port's PG gives
    direct = PG(config={**PG_CONFIG, "device": "cpu"})
    try:
        want = []
        for it in range(2):
            r = direct.train()
            want.append({"training_iteration": it + 1,
                         "episode_reward_mean": r["episode_reward_mean"],
                         "episodes_total": r.get("episodes_total")})
        direct_weights = direct.get_policy().get_weights()
    finally:
        direct.cleanup()
    history = [{k: m[k] for k in want[0]} for m in port.metrics_history]
    assert history == want
    # restore_algorithm: the checkpointed policy, on the CPU
    d = port.checkpoint.to_dict()
    saved = pickle.loads(d[ALGO_KEY])["policy_state"]
    algo = RLTrainer.restore_algorithm(port.checkpoint)
    try:
        assert d["algorithm"] == "PG" and d["config"]["device"] == "cpu"
        weights = algo.get_policy().get_weights()
        assert weights.keys() == direct_weights.keys()
        assert all(np.array_equal(weights[k], direct_weights[k])
                   for k in weights)
        assert _same_tree(algo.workers.local_worker.get_policy_state(),
                          saved)
        action = algo.compute_single_action(np.zeros(4, np.float32))
        assert action in (0, 1)
    finally:
        algo.cleanup()


def _hf_fit(pkg, out_dir):
    import transformers
    train = _mod(pkg, ".train")

    class TinyDataset(torch.utils.data.Dataset):
        def __init__(self, n=64, dim=8):
            g = torch.Generator().manual_seed(0)
            self.x = torch.randn(n, dim, generator=g)
            self.y = (self.x.sum(dim=1) > 0).long()

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return {"x": self.x[i], "labels": self.y[i]}

    class TinyModel(torch.nn.Module):
        def __init__(self, dim=8):
            super().__init__()
            self.lin = torch.nn.Linear(dim, 2)

        def forward(self, x=None, labels=None):
            logits = self.lin(x)
            loss = None
            if labels is not None:
                loss = torch.nn.functional.cross_entropy(logits, labels)
            return {"loss": loss, "logits": logits}

    def trainer_init(train_dataset=None, eval_dataset=None, **config):
        args = transformers.TrainingArguments(
            output_dir=os.path.join(out_dir, pkg), num_train_epochs=2,
            per_device_train_batch_size=8, logging_steps=4, report_to=[],
            save_strategy="epoch", use_cpu=True)
        torch.manual_seed(0)      # the same initial weights on both
        return transformers.Trainer(model=TinyModel(), args=args,
                                    train_dataset=train_dataset)

    result = train.TransformersTrainer(
        trainer_init, datasets={"train": TinyDataset()},
        scaling_config=train.ScalingConfig(num_workers=2)).fit()
    assert result.error is None, result.error
    return result


def test_transformers_trainer_matches_jax(fits):
    got = _results(fits, "hf")
    port, jax_result = got["ray_tpu_torch"], got["ray_tpu"]
    assert port.metrics.get("done_training")
    loss_t, loss_j = port.metrics["train_loss"], jax_result.metrics[
        "train_loss"]
    assert loss_t < 1.5
    assert abs(loss_t - loss_j) <= HF_LOSS_REL * abs(loss_j)
    files = port.checkpoint.to_dict()
    assert any(n.startswith(("model", "pytorch_model")) for n in files), \
        sorted(files)
    # each rank writes its rng_state_<rank>.pth beside rank 0's files,
    # so whether rank 1's is in rank 0's snapshot is a race on both
    def saved(names):
        return sorted(n for n in names if not n.startswith("rng_state"))
    assert saved(files) == saved(jax_result.checkpoint.to_dict())
