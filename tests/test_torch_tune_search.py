"""The port's Tune search and scheduling engine against the JAX
package's, without a cluster.

Each case feeds ``ray_tpu.tune``'s module and ``ray_tpu_torch.tune``'s
copy the same seed and the same synthetic result stream and requires the
same output, exactly: the resolution of a mixed search space and of grid
axes; the suggestions of ``BasicVariantGenerator``, ``RandomSearch``,
``TPESearcher``, ``BayesOptSearch``, BOHB and a ``ConcurrencyLimiter``;
the decisions of ASHA, HyperBand, median stopping, PBT, PB2 and
``ResourceChangingScheduler`` (continue or stop, the exploit's donor and
perturbed config, the new resources), through a runner and trials that
record what a scheduler asks of them; ``ExperimentAnalysis``'s best
trial, config and result; and the CSV and JSON loggers' files, equal up
to their time fields. The TensorBoard logger stays gated on
``tensorboardX`` on both sides, and so do the external searchers'
libraries.
"""

import csv
import json
import math
import random
import time

import pytest

import ray_tpu.tune as jtune
import ray_tpu_torch.tune as ttune
from ray_tpu.tune import logger as jlogger
from ray_tpu.tune import sample as jsample
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu.tune import trial as jtrial
from ray_tpu.tune import tune as jtune_mod
from ray_tpu_torch.tune import logger as tlogger
from ray_tpu_torch.tune import sample as tsample
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.tune import trial as ttrial
from ray_tpu_torch.tune import tune as ttune_mod

SIDES = {"jax": (jsample, jsearch, jsched), "port": (tsample, tsearch,
                                                      tsched)}
TIME_KEYS = ("time_total_s", "timestamp", "time_this_iter_s")


def _const():
    return 7


def _mixed_space(s):
    """A space with every domain kind, nested, beside constants."""
    return {"lr": s.loguniform(1e-5, 1e-1), "act": s.choice(
                ["relu", "tanh", "gelu"]),
            "n": s.randint(1, 8), "drop": s.uniform(0.0, 0.5),
            "wd": s.quniform(0.0, 1.0, 0.05), "noise": s.randn(0.0, 2.0),
            "fixed": s.sample_from(_const), "const": 3,
            "opt": {"beta": s.uniform(0.8, 0.99), "eps": 1e-8,
                    "kind": s.choice(["adam", "sgd"])}}


def _grid_space(s):
    return {"a": s.grid_search([1, 2, 3]),
            "nested": {"b": s.grid_search(["x", "y"]),
                       "c": s.uniform(0, 1)},
            "d": s.loguniform(1e-3, 1.0)}


def _objective(cfg):
    """A deterministic score of a config (max is best)."""
    v = 0.0
    if "lr" in cfg:
        v -= (math.log10(cfg["lr"]) + 3) ** 2
    if "act" in cfg:
        v -= 0 if cfg["act"] == "gelu" else 1
    if "n" in cfg:
        v -= abs(cfg["n"] - 4) * 0.1
    for k in ("x", "y"):
        if k in cfg:
            v -= (cfg[k] - 0.3) ** 2
    return v


# ---------------------------------------------------------------- sample


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_resolve_mixed_space(seed):
    got = {name: s.resolve(_mixed_space(s), random.Random(seed))
           for name, (s, _, _) in SIDES.items()}
    assert got["port"] == got["jax"]
    assert 1e-5 <= got["port"]["lr"] <= 1e-1
    assert got["port"]["fixed"] == 7 and got["port"]["opt"]["eps"] == 1e-8


def test_expand_grid_and_unexpanded_grid():
    got = {}
    for name, (s, _, _) in SIDES.items():
        variants = s.expand_grid(_grid_space(s))
        rng = random.Random(3)
        got[name] = [s.resolve(v, rng) for v in variants]
        with pytest.raises(ValueError, match="grid_search"):
            s.resolve(_grid_space(s), rng)
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 6


# -------------------------------------------------------------- searchers


def _searcher(name, kind):
    s, search, _ = SIDES[name]
    if kind == "basic":
        return search.BasicVariantGenerator(_grid_space(s), num_samples=2,
                                            seed=0)
    if kind == "random":
        return search.RandomSearch(_mixed_space(s), num_samples=12, seed=0)
    if kind == "tpe":
        return search.TPESearcher(_mixed_space(s), metric="obj", mode="max",
                                  num_samples=30, n_startup_trials=6, seed=0)
    if kind == "tpe_min":
        return search.TPESearcher(_mixed_space(s), metric="obj", mode="min",
                                  num_samples=20, n_startup_trials=5, seed=2)
    if kind == "bayesopt":
        return search.BayesOptSearch(
            {"x": s.uniform(-5, 5), "y": s.uniform(-5, 5),
             "act": s.choice(["a", "b"])}, metric="obj", mode="max",
            num_samples=24, n_startup_trials=5, seed=0)
    if kind == "bohb":
        return search.BOHBSearcher(
            {"x": s.uniform(-5, 5), "lr": s.loguniform(1e-4, 1e-1)},
            metric="obj", mode="max", num_samples=20, seed=0)
    if kind == "limiter":
        return search.ConcurrencyLimiter(search.TPESearcher(
            _mixed_space(s), metric="obj", mode="max", num_samples=12,
            n_startup_trials=3, seed=0), max_concurrent=2)
    raise ValueError(kind)


def _drive_searcher(searcher, kind, pending):
    """Suggest until exhausted, completing each trial with its objective
    (BOHB also sees per-budget results; the limiter keeps two live)."""
    out = []
    live = []
    for t in range(60):
        tid = f"t{t}"
        cfg = searcher.suggest(tid)
        if cfg is pending:
            done = live.pop(0)
            searcher.on_trial_complete(done[0], {"obj": done[1]})
            out.append("PENDING")
            cfg = searcher.suggest(tid)
        if cfg is None:
            break
        out.append(cfg)
        v = _objective(cfg)
        if kind == "bohb":
            for budget in (1, 3, 9):
                searcher.on_trial_result(tid, {
                    "obj": v * budget / 9, "training_iteration": budget})
        if kind == "limiter":
            live.append((tid, v))
            continue
        searcher.on_trial_complete(tid, {"obj": v})
    return out


@pytest.mark.parametrize("kind", ["basic", "random", "tpe", "tpe_min",
                                  "bayesopt", "bohb", "limiter"])
def test_searcher_suggestions(kind):
    got = {name: _drive_searcher(_searcher(name, kind), kind,
                                 SIDES[name][1].PENDING)
           for name in SIDES}
    assert got["port"] == got["jax"]
    assert len([c for c in got["port"] if c != "PENDING"]) >= 6


def test_searchers_take_the_space_from_run():
    """A searcher built without a space gets it through
    ``set_search_properties`` (as ``tune.run(config=...)`` hands it)."""
    got = {}
    for name, (s, search, _) in SIDES.items():
        se = search.TPESearcher(num_samples=3, seed=0)
        se.set_search_properties("obj", "min", {"x": s.uniform(0, 1)})
        got[name] = [se.suggest(f"t{i}") for i in range(4)]
    assert got["port"] == got["jax"] and got["port"][3] is None


def test_external_searchers_gated():
    for hint_cls in ("HyperOptSearch", "OptunaSearch"):
        for name, (s, search, _) in SIDES.items():
            try:
                __import__({"HyperOptSearch": "hyperopt",
                            "OptunaSearch": "optuna"}[hint_cls])
                pytest.skip(f"{hint_cls}'s library installed")
            except ImportError:
                pass
            with pytest.raises(ImportError, match="TPESearcher"):
                getattr(search, hint_cls)({"x": s.uniform(0, 1)})


# ------------------------------------------------------------- schedulers


class _FakeTrial:
    def __init__(self, trial_id, config, resources=None):
        self.trial_id = trial_id
        self.config = dict(config)
        self.resources = dict(resources or {"CPU": 1.0})
        self.latest_checkpoint = None


class _FakeRunner:
    """Records what a scheduler asks of the runner; applies an exploit's
    config as ``TrialRunner.exploit`` does."""

    def __init__(self, trials):
        self.trials = {t.trial_id: t for t in trials}
        self.calls = []

    def get_trial(self, trial_id):
        return self.trials.get(trial_id)

    def exploit(self, trial, donor, new_config):
        self.calls.append(("exploit", trial.trial_id, donor.trial_id,
                           dict(new_config)))
        trial.config = new_config
        trial.latest_checkpoint = donor.latest_checkpoint

    def update_trial_resources(self, trial, resources):
        self.calls.append(("resources", trial.trial_id, dict(resources)))
        trial.resources = dict(resources)
        return True


def _scheduler(name, kind):
    s, _, sched = SIDES[name]
    if kind == "asha":
        return sched.ASHAScheduler(metric="score", mode="max", max_t=9,
                                   grace_period=1, reduction_factor=3)
    if kind == "asha_min":
        return sched.AsyncHyperBandScheduler(metric="loss", mode="min",
                                             max_t=8, grace_period=2,
                                             reduction_factor=2)
    if kind == "hyperband":
        return sched.HyperBandScheduler(metric="score", mode="max",
                                        max_t=27, reduction_factor=3)
    if kind == "median":
        return sched.MedianStoppingRule(metric="score", mode="max",
                                        grace_period=2,
                                        min_samples_required=2)
    if kind == "pbt":
        return sched.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": s.uniform(0.001, 1.0),
                                  "bs": [16, 32, 64],
                                  "mom": _const},
            quantile_fraction=0.25, resample_probability=0.5, seed=0)
    if kind == "pb2":
        return sched.PB2(metric="loss", mode="min", perturbation_interval=2,
                         hyperparam_bounds={"lr": [1e-4, 1.0],
                                            "wd": [0.0, 0.3]},
                         log_scale_keys=["lr"], seed=0)
    if kind == "resources":
        def alloc(runner, trial, result, scheduler):
            it = result["training_iteration"]
            if it == 2:
                return {"CPU": 1.0, "GPU": 1.0}
            if it == 4 and trial.trial_id.endswith("1"):
                return {"CPU": 2.0, "GPU": 2.0}
            return None
        return sched.ResourceChangingScheduler(
            base_scheduler=sched.ASHAScheduler(max_t=6, grace_period=2,
                                               reduction_factor=2),
            resources_allocation_function=alloc)
    raise ValueError(kind)


def _score(kind, i, it):
    """Trial ``i``'s metric at iteration ``it``: trials spread apart, with
    a wobble so rungs and medians are not ties."""
    base = (i + 1) * 0.7 + it * (0.2 + 0.05 * i) + 0.13 * math.sin(3 * i + it)
    return base


def _drive_scheduler(name, kind, n_trials=8, n_iters=9):
    sched = _scheduler(name, kind)
    if kind == "resources":
        sched.set_search_properties("score", "max")
    metric = "loss" if kind in ("asha_min", "pb2") else "score"
    trials = [_FakeTrial(f"trial_{i}", {"lr": 0.01 * (i + 1), "bs": 32,
                                        "wd": 0.01 * i, "mom": 0.9})
              for i in range(n_trials)]
    runner = _FakeRunner(trials)
    stopped = set()
    decisions = []
    for it in range(1, n_iters + 1):
        for i, t in enumerate(trials):
            if t.trial_id in stopped:
                continue
            t.latest_checkpoint = f"ckpt-{t.trial_id}-{it}"
            v = _score(kind, i, it)
            result = {"training_iteration": it,
                      metric: -v if metric == "loss" else v}
            d = sched.on_trial_result(runner, t, result)
            decisions.append((t.trial_id, it, d, dict(t.config),
                              dict(t.resources)))
            if d == "STOP":
                stopped.add(t.trial_id)
                sched.on_trial_complete(runner, t, result)
    return decisions, runner.calls


@pytest.mark.parametrize("kind", ["asha", "asha_min", "hyperband", "median",
                                  "pbt", "pb2", "resources"])
def test_scheduler_decisions(kind):
    got = {name: _drive_scheduler(name, kind) for name in SIDES}
    assert got["port"] == got["jax"]
    decisions, calls = got["port"]
    seen = {d for _, _, d, _, _ in decisions}
    if kind in ("asha", "asha_min", "hyperband", "median"):
        assert "STOP" in seen
    if kind in ("pbt", "pb2"):
        assert any(c[0] == "exploit" for c in calls)
    if kind == "resources":
        assert any(c[0] == "resources" for c in calls)


def test_pb2_needs_bounds():
    for _, _, sched in SIDES.values():
        with pytest.raises(ValueError, match="hyperparam_bounds"):
            sched.PB2(metric="m")


# -------------------------------------------------------- analysis, loggers


def _trials(trial_mod, results_by_trial):
    out = []
    for i, results in enumerate(results_by_trial):
        t = trial_mod.Trial({"a": i, "lr": 0.1 * (i + 1)}, "exp")
        t.results = [dict(r) for r in results]
        t.status = "TERMINATED" if i % 3 else "ERROR"
        out.append(t)
    return out


RESULTS = [[{"score": 1.0 + 0.5 * it, "loss": 3.0 - it, "training_iteration":
             it + 1} for it in range(3)],
           [{"score": 4.0, "loss": 0.2, "training_iteration": 1},
            {"score": 2.5, "loss": 0.9, "training_iteration": 2}],
           [{"loss": 1.5, "training_iteration": 1}],
           [{"score": 3.9, "loss": 0.1, "training_iteration": it + 1}
            for it in range(4)]]


@pytest.mark.parametrize("metric,mode,scope", [
    ("score", "max", "last"), ("score", "max", "all"), ("loss", "min", "last"),
    ("loss", "max", "all"), ("score", "min", "last")])
def test_experiment_analysis_best(metric, mode, scope):
    got = {}
    for name, (mod, trial_mod) in {"jax": (jtune_mod, jtrial),
                                   "port": (ttune_mod, ttrial)}.items():
        trials = _trials(trial_mod, RESULTS)
        a = mod.ExperimentAnalysis(trials, metric=metric, mode=mode)
        best = a.get_best_trial(scope=scope)
        got[name] = (trials.index(best), a.best_config, a.best_result,
                     a.results, a.dataframe().drop(columns="trial_id")
                     .to_dict("list"))
    assert repr(got["port"]) == repr(got["jax"])


class _LogTrial:
    def __init__(self, trial_id, logdir, config):
        self.trial_id, self.logdir, self.config = trial_id, logdir, config
        self.results = []

    @property
    def last_result(self):
        return self.results[-1] if self.results else None


def _log_run(logger_mod, root):
    """Two trials' results through the CSV and JSON loggers, a restart of
    one of them included, as the runner calls them; each result carries
    this run's own clock in its time fields."""
    cbs = [logger_mod.CSVLoggerCallback(), logger_mod.JsonLoggerCallback()]
    t0 = time.time()
    trials = []
    for i in range(2):
        d = root / f"exp_{i:05d}"
        d.mkdir(parents=True)
        trials.append(_LogTrial(f"id{i}", str(d), {"a": i, "nested": {
            "b": [1, 2]}, "name": f"t{i}"}))
    for cb in cbs:
        for t in trials:
            cb.on_trial_start(t)
    for it in range(4):
        for i, t in enumerate(trials):
            result = {"score": i + it * 0.25, "flag": it % 2 == 0,
                      "tag": "x" * (it + 1), "vec": [it, i],
                      "training_iteration": it + 1,
                      "time_total_s": time.time() - t0,
                      "timestamp": time.time()}
            t.results.append(result)
            for cb in cbs:
                cb.on_trial_result(t, result)
            if it == 1 and i == 0:
                for cb in cbs:      # a restart re-enters on_trial_start
                    cb.on_trial_start(t)
    for cb in cbs:
        for t in trials:
            cb.on_trial_complete(t)
    return trials


def _read_logs(trial):
    from pathlib import Path
    d = Path(trial.logdir)
    params = json.loads((d / "params.json").read_text())
    results = [{k: v for k, v in json.loads(line).items()
                if k not in TIME_KEYS}
               for line in (d / "result.json").read_text().splitlines()]
    with open(d / "progress.csv", newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    keep = [j for j, k in enumerate(header) if k not in TIME_KEYS]
    table = [[r[j] for j in keep] for r in rows]
    return params, results, table


def test_csv_and_json_loggers_write_the_same_files(tmp_path):
    got = {name: [_read_logs(t) for t in _log_run(mod, tmp_path / name)]
           for name, mod in (("jax", jlogger), ("port", tlogger))}
    assert got["port"] == got["jax"]
    params, results, table = got["port"][0]
    assert params["nested"] == {"b": [1, 2]} and len(results) == 4
    assert len(table) == 5 and "score" in table[0] and "vec" not in table[0]


def test_default_callbacks_gate_tensorboard():
    names = {name: [type(cb).__name__ for cb in mod.default_callbacks()]
             for name, mod in (("jax", jlogger), ("port", tlogger))}
    assert names["port"] == names["jax"]
    try:
        import tensorboardX  # noqa: F401
        assert names["port"][-1] == "TBXLoggerCallback"
    except ImportError:
        assert "TBXLoggerCallback" not in names["port"]


def test_public_names():
    jax_names = {n for n in dir(jtune) if not n.startswith("_")}
    port_names = {n for n in dir(ttune) if not n.startswith("_")}
    assert jax_names <= port_names
    assert port_names - jax_names == {"with_resources"}
