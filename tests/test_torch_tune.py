"""The port's Tune on its runtime, on the CPU.

One port cluster for the module (``init(num_cpus=4)``), shut down at the
end. The cases are the port's counterparts of ``tests/test_tune.py``'s
seven and of ``tests/test_tune_ecosystem.py``'s cluster tests: function
and class trainables, stop criteria, ASHA, restore after a failure,
``Tuner`` with random sampling, PBT, more trials than CPUs, TPE through
``tune.run``, the loggers, the syncer, a resume from the experiment
snapshot, ``Tuner.restore``, PB2, HyperBand and ResourceChanging. Then
the same deterministic sweep (a seeded grid and random space under ASHA,
one trial at a time) runs on a JAX cluster through ``ray_tpu.tune`` and
on the port's through ``ray_tpu_torch.tune``: the trial order, configs,
statuses, best config and per-trial results must be equal, time keys
aside.

The trainables are defined inside the tests, so that workers receive
them by value and never import this module (which imports JAX).
"""

import json
import os
from unittest import mock

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import session
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.tune import sample as s
from ray_tpu_torch.tune.search import TPESearcher

STORE_BYTES = 128 * 1024 * 1024
# the port's processes check every inbound RPC against its wire schema
# and start workers on demand, as conftest sets for the JAX package's
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
TIME_KEYS = ("time_total_s", "timestamp", "time_this_iter_s")


@pytest.fixture(scope="module", autouse=True)
def cluster(tmp_path_factory):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    # experiment dirs go to a temp root, as conftest's RTPU_RESULTS_DIR
    # keeps the JAX package's out of $HOME
    env = {**PORT_ENV, "RTT_RESULTS_DIR": str(
        tmp_path_factory.mktemp("rtt_results"))}
    with mock.patch.dict(os.environ, env):
        ray_tpu_torch.init(num_cpus=4, object_store_memory=STORE_BYTES)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
            torch.set_num_threads(old)


# ---------------------------------------------- tests/test_tune.py's seven


def test_function_trainable_grid():
    def train_fn(config):
        for i in range(3):
            session.report({"score": config["a"] * 10 + i})

    analysis = tune.run(train_fn, config={"a": tune.grid_search([1, 2, 3])},
                        metric="score", mode="max", max_concurrent_trials=3)
    assert len(analysis.trials) == 3
    best = analysis.best_trial
    assert best.config["a"] == 3
    assert analysis.best_result["score"] == 32
    assert all(t.status == "TERMINATED" for t in analysis.trials)


def test_class_trainable_and_stop_criteria():
    class MyTrainable(tune.Trainable):
        def setup(self, config):
            self.x = config.get("start", 0)

        def step(self):
            self.x += 1
            return {"x": self.x}

        def save_checkpoint(self):
            return {"x": self.x}

        def load_checkpoint(self, state):
            self.x = state["x"]

    analysis = tune.run(MyTrainable, config={"start": 5},
                        stop={"training_iteration": 4},
                        metric="x", mode="max")
    t = analysis.trials[0]
    assert t.last_result["x"] == 9
    assert t.last_result["training_iteration"] == 4


def test_asha_stops_bad_trials():
    def train_fn(config):
        for i in range(8):
            session.report({"score": config["q"] + i * 0.01})

    sched = tune.ASHAScheduler(metric="score", mode="max", max_t=8,
                               grace_period=1, reduction_factor=2)
    analysis = tune.run(train_fn,
                        config={"q": tune.grid_search([0.0, 0.0, 0.0, 100.0])},
                        metric="score", mode="max", scheduler=sched,
                        max_concurrent_trials=2)
    best = analysis.best_trial
    assert best.config["q"] == 100.0
    iters = [len(t.results) for t in analysis.trials
             if t.config["q"] == 0.0]
    assert min(iters) < 8, iters


def test_checkpoint_restore_on_failure():
    def train_fn(config):
        from ray_tpu_torch.air.checkpoint import Checkpoint
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["i"] + 1 if ckpt else 0
        for i in range(start, 6):
            session.report({"i": i},
                           checkpoint=Checkpoint.from_dict({"i": i}))
            if i == 3 and start == 0:
                raise RuntimeError("boom")

    analysis = tune.run(train_fn, metric="i", mode="max", max_failures=1)
    t = analysis.trials[0]
    assert t.status == "TERMINATED"
    assert t.num_failures == 1
    assert t.last_result["i"] == 5
    # 4 results before the crash (i = 0..3), then i = 4, 5 after the
    # restore: training_iteration keeps counting across the restart
    assert t.last_result["training_iteration"] == 6


def test_tuner_api_and_random_sampling():
    def train_fn(config):
        session.report({"v": config["lr"]})

    tuner = tune.Tuner(
        train_fn,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(metric="v", mode="min", num_samples=4,
                                    max_concurrent_trials=2))
    grid = tuner.fit()
    assert len(grid) == 4
    best = grid.get_best_result()
    lrs = [r.metrics["v"] for r in grid]
    assert best.metrics["v"] == min(lrs)
    assert 1e-4 <= best.metrics["v"] <= 1e-1


def test_pbt_exploit():
    def train_fn(config):
        import time
        from ray_tpu_torch.air.checkpoint import Checkpoint
        ckpt = session.get_checkpoint()
        score = ckpt.to_dict()["score"] if ckpt else 0.0
        lr = config["lr"]
        for i in range(10):
            # report does not wait for the driver: without a pause the
            # first actor up can report all ten before the other's first
            # result, and PBT has no population to exploit from
            time.sleep(0.1)
            score += lr
            session.report({"score": score},
                           checkpoint=Checkpoint.from_dict({"score": score}))

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0)}, seed=0)
    analysis = tune.run(train_fn,
                        config={"lr": tune.grid_search([0.01, 1.0])},
                        metric="score", mode="max", scheduler=pbt,
                        max_concurrent_trials=2)
    assert len(analysis.trials) == 2
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    # the exploit copied the strong trial's progress into the weak one,
    # so the weak trial beats its solo trajectory (10 * 0.01)
    weak = [t for t in analysis.trials if t.config.get("lr") != 1.0]
    if weak:  # its config may have been mutated away from 0.01
        assert weak[0].last_result["score"] > 0.2


def test_trials_exceed_cluster_cpus():
    """_start_trial never blocks on the actor's creation: ten trials on
    four CPUs queue and all finish."""
    def train_fn(config):
        for i in range(3):
            session.report({"score": config["x"] * (i + 1)})

    analysis = tune.run(train_fn,
                        config={"x": tune.grid_search(list(range(1, 11)))},
                        metric="score", mode="max", verbose=0)
    assert len(analysis.trials) == 10
    bad = [(t.trial_id, t.status, (t.error or "")[:500])
           for t in analysis.trials if t.status != "TERMINATED"]
    assert not bad, f"non-terminated trials: {bad}"
    assert analysis.get_best_trial().last_result["score"] == 30


# ------------------------------- tests/test_tune_ecosystem.py's cluster tests


def test_tpe_through_tune_run():
    def train_fn(config):
        session.report({"score": -(config["x"] - 2.0) ** 2})

    analysis = tune.run(
        train_fn, config={"x": s.uniform(-10, 10)},
        search_alg=TPESearcher(num_samples=20, seed=0),
        metric="score", mode="max", max_concurrent_trials=4)
    assert len(analysis.trials) == 20
    assert analysis.best_result["score"] > -4.0


def test_loggers_write_files(tmp_path):
    def train_fn(config):
        for i in range(3):
            session.report({"score": config["a"] + i, "iter_f": float(i)})

    analysis = tune.run(
        train_fn, config={"a": tune.grid_search([1, 2])},
        metric="score", mode="max", name="log_exp",
        local_dir=str(tmp_path))
    exp_dir = tmp_path / "log_exp"
    assert exp_dir.is_dir()
    trial_dirs = [d for d in exp_dir.iterdir() if d.is_dir()]
    assert len(trial_dirs) == 2
    try:
        import tensorboardX  # noqa: F401
        has_tbx = True
    except ImportError:
        has_tbx = False
    for td in trial_dirs:
        assert (td / "params.json").exists()
        results = [json.loads(line)
                   for line in (td / "result.json").read_text().splitlines()]
        assert len(results) == 3
        assert "score" in results[0]
        csv_lines = (td / "progress.csv").read_text().splitlines()
        assert len(csv_lines) == 4  # header + 3 rows
        assert "score" in csv_lines[0]
        tb_events = [f for f in os.listdir(td)
                     if f.startswith("events.out.tfevents")]
        assert bool(tb_events) == has_tbx
    assert (exp_dir / "experiment_state.json").exists()
    assert (exp_dir / "experiment_state.pkl").exists()
    state = json.loads((exp_dir / "experiment_state.json").read_text())
    assert len(state) == 2
    assert all(t["status"] == "TERMINATED" for t in state)
    assert analysis.best_result["score"] == 4


def test_syncer_uploads_experiment_dir(tmp_path):
    from ray_tpu_torch.tune.syncer import SyncConfig

    def train_fn(config):
        session.report({"score": 1.0})

    upload = tmp_path / "upload"
    tune.run(train_fn, config={}, metric="score", mode="max",
             name="sync_exp", local_dir=str(tmp_path / "local"),
             sync_config=SyncConfig(upload_dir=f"file://{upload}"))
    synced = upload / "sync_exp"
    assert synced.is_dir()
    assert (synced / "experiment_state.json").exists()
    trial_dirs = [d for d in synced.iterdir() if d.is_dir()]
    assert trial_dirs and (trial_dirs[0] / "result.json").exists()


def test_experiment_resume_from_snapshot(tmp_path):
    class Count(tune.Trainable):
        def setup(self, config):
            self.x = 0

        def step(self):
            self.x += 1
            return {"x": self.x, "done": self.x >= 6}

        def save_checkpoint(self):
            return {"x": self.x}

        def load_checkpoint(self, state):
            self.x = state["x"]

    from ray_tpu_torch.tune.search import BasicVariantGenerator
    from ray_tpu_torch.tune.tune import TrialRunner

    space = {"a": tune.grid_search([1, 2])}
    runner = TrialRunner(
        Count, BasicVariantGenerator(space, metric="x", mode="max"),
        experiment_name="resume_exp", metric="x", mode="max",
        checkpoint_freq=1, local_dir=str(tmp_path))
    # part of the experiment, snapshotting as run_all would (forced:
    # snapshots are throttled and this test is faster than the period)
    for _ in range(5):
        runner.step()
        runner._snapshot(force=True)
    assert sum(len(t.results) for t in runner.trials) > 0
    assert not runner.is_finished()
    # a driver crash: the trial actors die with the runner
    for t in runner.trials:
        if t.actor is not None:
            ray_tpu_torch.kill(t.actor)

    runner2 = TrialRunner(
        Count, BasicVariantGenerator(space, metric="x", mode="max"),
        experiment_name="resume_exp", metric="x", mode="max",
        checkpoint_freq=1, local_dir=str(tmp_path))
    runner2.restore_from_dir(runner2.experiment_dir)
    assert len(runner2.trials) == 2  # carried over, not re-created
    runner2.run_all()
    assert all(t.status == "TERMINATED" for t in runner2.trials)
    for t in runner2.trials:
        # resumed from the checkpoint: the count went on to 6 results
        assert t.metric_history("x")[-1] == 6
        assert len(t.results) == 6


def test_tuner_restore_api(tmp_path):
    def train_fn(config):
        for i in range(2):
            session.report({"score": i})

    tuner = tune.Tuner(
        train_fn, param_space={},
        run_config=RunConfig(name="tr_exp", storage_path=str(tmp_path)))
    tuner.fit()
    # restoring a finished experiment completes at once
    restored = tune.Tuner.restore(str(tmp_path / "tr_exp"), train_fn)
    grid = restored.fit()
    assert len(grid) == 1
    assert grid[0].metrics["score"] == 1


def test_pb2_smoke():
    def train_fn(config):
        x = 0.0
        for i in range(10):
            # the reward's gradient points at lr = 0.5
            x += 1.0 - (config["lr"] - 0.5) ** 2
            session.report({"score": x})

    from ray_tpu_torch.tune.schedulers import PB2
    sched = PB2(metric="score", mode="max", perturbation_interval=3,
                hyperparam_bounds={"lr": [0.001, 1.0]}, seed=0)
    analysis = tune.run(
        train_fn, config={"lr": s.uniform(0.001, 1.0)},
        num_samples=4, metric="score", mode="max",
        scheduler=sched, checkpoint_freq=1, max_concurrent_trials=4)
    assert len(analysis.trials) == 4
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert analysis.best_result["score"] > 0


def test_hyperband_brackets_cull():
    """Weak trials stop early; a strong one reaches max_t."""
    def train_fn(config):
        for i in range(27):
            session.report({"score": config["q"] * (i + 1),
                            "training_iteration": i + 1})

    from ray_tpu_torch.tune.schedulers import HyperBandScheduler
    sched = HyperBandScheduler(metric="score", mode="max", max_t=27,
                               reduction_factor=3)
    analysis = tune.run(
        train_fn, config={"q": s.grid_search([0.1, 0.4, 0.7, 1.0])},
        metric="score", mode="max", scheduler=sched,
        max_concurrent_trials=4)
    iters = {t.config["q"]: (t.last_result or {}).get(
        "training_iteration", 0) for t in analysis.trials}
    assert max(iters.values()) == 27
    assert analysis.best_result["score"] >= 27 * 0.7


def test_resource_changing_scheduler():
    """The allocation hook moves the trial to 2 CPUs mid-run; it restarts
    from its checkpoint with the new resources and still finishes."""
    def train_fn(config):
        for i in range(6):
            session.report({"score": i + 1, "training_iteration": i + 1})

    def alloc(runner, trial, result, scheduler):
        if result.get("training_iteration") == 2:
            return {"CPU": 2.0}
        return None

    from ray_tpu_torch.tune.schedulers import ResourceChangingScheduler
    sched = ResourceChangingScheduler(resources_allocation_function=alloc)
    analysis = tune.run(
        train_fn, config={}, num_samples=1, metric="score", mode="max",
        scheduler=sched, checkpoint_freq=1)
    t = analysis.trials[0]
    assert t.status == "TERMINATED"
    assert t.resources == {"CPU": 2.0}
    assert (t.last_result or {}).get("score") == 6


# ----------------------------------------- the same sweep on both runtimes


def _sweep(rt, tmp_path):
    """A seeded grid x random space under ASHA, one trial at a time, on
    runtime package ``rt`` with its own Tune."""
    import importlib
    t = importlib.import_module(rt.__name__ + ".tune")
    sess = importlib.import_module(rt.__name__ + ".air.session")
    ckpt_mod = importlib.import_module(rt.__name__ + ".air.checkpoint")

    def train_fn(config):
        ck = sess.get_checkpoint()
        x = ck.to_dict()["x"] if ck else 0.0
        for i in range(4):
            x += config["q"] * config["scale"] - 0.01 * i
            sess.report({"score": x, "q": config["q"]},
                        checkpoint=(ckpt_mod.Checkpoint.from_dict({"x": x})
                                    if i % 2 else None))

    space = {"q": t.grid_search([0.5, 2.0, 1.0, 0.25]),
             "scale": t.uniform(0.5, 1.5), "tag": "fixed"}
    analysis = t.run(
        train_fn, config=space,
        search_alg=t.BasicVariantGenerator(space, num_samples=1, seed=0),
        scheduler=t.ASHAScheduler(max_t=4, grace_period=1,
                                  reduction_factor=2),
        metric="score", mode="max", max_concurrent_trials=1,
        name="same_sweep", local_dir=str(tmp_path / rt.__name__))
    return {
        "configs": [tr.config for tr in analysis.trials],
        "statuses": [tr.status for tr in analysis.trials],
        "results": [[{k: v for k, v in r.items() if k not in TIME_KEYS}
                     for r in tr.results] for tr in analysis.trials],
        "best_config": analysis.best_config,
        "best_index": analysis.trials.index(analysis.best_trial),
        "checkpoints": [len(tr.ckpt_manager.checkpoints)
                        for tr in analysis.trials]}


def test_same_sweep_as_jax(tmp_path):
    import concurrent.futures
    import importlib
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    for rt in (ray_tpu, ray_tpu_torch):     # not by two threads at once
        for name in (".tune", ".air.session", ".air.checkpoint"):
            importlib.import_module(rt.__name__ + name)

    def jax_sweep():
        ray_tpu.init(num_cpus=4, object_store_memory=STORE_BYTES)
        try:
            return _sweep(ray_tpu, tmp_path)
        finally:
            ray_tpu.shutdown()

    # the JAX sweep on its own cluster beside the port's: each package's
    # driver and Tune are its own
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        ref = pool.submit(jax_sweep)
        port = _sweep(ray_tpu_torch, tmp_path)
        ref = ref.result(timeout=120)
    finally:
        pool.shutdown(wait=False)
    assert port == ref
    assert len(port["configs"]) == 4
    assert min(len(r) for r in port["results"]) < 4   # ASHA stopped some
