"""What the port's Tune runs, on the CPU: an ``Algorithm``, a trainer's
``as_trainable()``, and trials granted GPUs.

One port cluster for the module, ``init(num_cpus=4, num_gpus=2)``,
started inside an inherited ``CUDA_VISIBLE_DEVICES="3,5"``, as
``tests/test_torch_runtime_gpus.py`` starts its: no GPU is present, the
raylet grants two indices and each stands for the inherited device at
its place. The cases:

- ``Tuner(PPO)`` on CartPole (``device="cpu"``): two iterations whose
  results equal ``PPO(config).train()`` twice in this process at the
  same seed, time keys aside;
- ``Tuner(DataParallelTrainer(...).as_trainable())`` with a one-worker
  CPU gang: each trial's results are its train loop's reports;
- three ``{"GPU": 1}`` trials on the two GPUs: at most two run at once,
  each on a grant of its own, and each trial's ``get_gpu_ids()``,
  ``session.get_gpu_ids()`` and ``CUDA_VISIBLE_DEVICES`` agree; four
  trials that each need both GPUs run one at a time, in the order Tune
  created them;
- ``ResourceChangingScheduler`` moving a trial from one GPU to two:
  the trial restarts from its checkpoint with the new grant;
- ``"TPU"`` resources raise ``ValueError`` naming ``"GPU"``; a trial
  whose config asks for ``device="cuda"`` with no whole GPU fails
  before its actor starts, and ``with_resources`` gives a ``Tuner``'s
  trials their resources.
"""

import os
import time
from unittest import mock

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import session
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.rllib.algorithms import ppo as TPPO

STORE_BYTES = 128 * 1024 * 1024
INHERITED = ["3", "5"]
# the port's processes check every inbound RPC against its wire schema
# and start workers on demand, as conftest sets for the JAX package's
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
TIME_KEYS = ("time_total_s", "env_steps_per_sec", "timers")
MLP = {"fcnet_hiddens": [16, 16]}


@pytest.fixture(scope="module", autouse=True)
def cluster(tmp_path_factory):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    results = str(tmp_path_factory.mktemp("rtt_results"))
    # the GCS and raylet take the inherited devices when init starts
    # them; the experiment dirs go to a temp root
    with mock.patch.dict(os.environ, {
            **PORT_ENV, "CUDA_VISIBLE_DEVICES": ",".join(INHERITED)}):
        ray_tpu_torch.init(num_cpus=4, num_gpus=2,
                           object_store_memory=STORE_BYTES)
    try:
        with mock.patch.dict(os.environ, {"RTT_RESULTS_DIR": results}):
            yield
    finally:
        ray_tpu_torch.shutdown()
        torch.set_num_threads(old)


# ---------------------------------------------------------- Tuner(PPO)


def _cartpole_config():
    return TPPO.PPOConfig().update_from_dict(dict(
        env="CartPole-v1", num_envs_per_worker=2, rollout_fragment_length=16,
        train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=2,
        model=MLP, seed=3, device="cpu")).to_dict()


def test_tuner_ppo_matches_driver():
    cfg = _cartpole_config()
    algo = TPPO.PPO(config=dict(cfg))
    try:
        here = [algo.train() for _ in range(2)]
    finally:
        algo.cleanup()
    grid = tune.Tuner(
        tune.with_resources(TPPO.PPO, {"CPU": 1}), param_space=cfg,
        run_config=RunConfig(stop={"training_iteration": 2})).fit()
    assert len(grid) == 1 and not grid.errors
    there = grid[0].trial.results
    assert len(there) == 2
    assert grid[0].trial.status == "TERMINATED"
    for want, got in zip(here, there):
        keep = set(want) - set(TIME_KEYS)
        assert {k: got[k] for k in keep} == {k: want[k] for k in keep}
    # Algorithm.step and Trainable.train each count the iteration, as in
    # the JAX package, so the stop at 2 comes after the second result
    assert there[-1]["timesteps_total"] == 128


# ------------------------------------------------ a trainer as trainable


def test_tuner_data_parallel_trainer_as_trainable():
    from ray_tpu_torch.train import DataParallelTrainer

    def loop(config):
        from ray_tpu_torch.air import session as s
        for step in range(3):
            s.report({"value": config["lr"] * (step + 1),
                      "rank": s.get_world_rank(),
                      "world": s.get_world_size(), "step": step})

    trainer = DataParallelTrainer(
        loop, train_loop_config={"lr": 0.0},
        scaling_config=ScalingConfig(num_workers=1))
    grid = tune.Tuner(
        trainer.as_trainable(),
        param_space={"lr": tune.grid_search([0.5, 2.0])},
        tune_config=tune.TuneConfig(metric="value", mode="max",
                                    max_concurrent_trials=2)).fit()
    assert not grid.errors
    by_lr = {r.config["lr"]: r.trial.results for r in grid}
    for lr, results in by_lr.items():
        assert [(r["value"], r["rank"], r["world"], r["step"])
                for r in results] == [(lr * (i + 1), 0, 1, i)
                                      for i in range(3)]
    assert grid.get_best_result().config["lr"] == 2.0


# ------------------------------------------------------------ GPU grants


def test_gpu_trials_share_two_gpus():
    def _grant_fn(config):
        """Reports its grant at each of three iterations, with the wall times
        its function ran between."""
        import os
        import time

        import ray_tpu_torch
        from ray_tpu_torch.air import session as s
        start = time.time()
        for i in range(3):
            time.sleep(0.3)
            s.report({"ids": list(ray_tpu_torch.get_gpu_ids()),
                      "session_ids": list(s.get_gpu_ids()),
                      "env": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "start": start, "end": time.time(), "i": i})

    analysis = tune.run(_grant_fn, config={"k": tune.grid_search([0, 1, 2])},
                        resources_per_trial={"CPU": 1, "GPU": 1},
                        max_concurrent_trials=3)
    assert [t.status for t in analysis.trials] == ["TERMINATED"] * 3
    spans = []
    for t in analysis.trials:
        assert len(t.results) == 3
        for r in t.results:
            assert r["ids"] == r["session_ids"]
            assert len(r["ids"]) == 1 and r["ids"][0] in (3, 5)
            assert r["env"] == ",".join(map(str, r["ids"]))
        spans.append((t.results[0]["start"], t.results[-1]["end"],
                      t.results[0]["ids"][0]))
    for a, b, gpu in spans:
        live = [g for c, d, g in spans if c < b and a < d]
        assert len(live) <= 2 and len(set(live)) == len(live), spans


def test_gpu_trials_wait_their_turn():
    """Trials that each need both GPUs queue behind one another and start
    in the order Tune created them: the GCS places pending actors of one
    demand by arrival."""
    def train_fn(config):
        import time

        import ray_tpu_torch
        from ray_tpu_torch.air import session as s
        start = time.time()
        time.sleep(0.2)
        s.report({"ids": list(ray_tpu_torch.get_gpu_ids()), "start": start,
                  "end": time.time()})

    analysis = tune.run(train_fn, config={"k": tune.grid_search(
        [0, 1, 2, 3])}, resources_per_trial={"CPU": 1, "GPU": 2},
        max_concurrent_trials=4)
    runs = [(t.results[0]["start"], t.results[0]["end"], t.config["k"])
            for t in analysis.trials]
    assert all(t.results[0]["ids"] == [3, 5] for t in analysis.trials)
    assert [k for _, _, k in sorted(runs)] == [0, 1, 2, 3]
    for (_, end, _), (start, _, _) in zip(sorted(runs), sorted(runs)[1:]):
        assert end <= start


class _Holder:
    def started(self):
        import time
        return time.time()


def test_pending_actors_start_in_arrival_order():
    """Under the trials' queue, the runtime's: with both GPUs held, an
    actor that asked for them first gets them first when they free, even
    where a later one's poll for capacity comes first (the JAX
    package's GCS gives them to whichever polls first)."""
    holder = ray_tpu_torch.remote(num_gpus=2)(_Holder).remote()
    ray_tpu_torch.get(holder.started.remote(), timeout=60)
    first = ray_tpu_torch.remote(num_gpus=2)(_Holder).remote()
    first_ref = first.started.remote()
    # the GCS polls for capacity every 0.2 s from each actor's arrival:
    # the second's polls fall halfway between the first's, and the
    # release lands just after one of the first's
    time.sleep(0.1)
    second = ray_tpu_torch.remote(num_gpus=2)(_Holder).remote()
    second_ref = second.started.remote()
    time.sleep(0.32)
    ray_tpu_torch.kill(holder)
    t_first = ray_tpu_torch.get(first_ref, timeout=60)
    ray_tpu_torch.kill(first)
    t_second = ray_tpu_torch.get(second_ref, timeout=60)
    ray_tpu_torch.kill(second)
    assert t_first < t_second


class _Sleeper:
    def __init__(self):
        import time
        self.start = time.time()
        time.sleep(2.0)
        self.end = time.time()

    def span(self):
        return self.start, self.end


def test_equal_actors_that_fit_start_together():
    """The order kept for actors that wait holds none back that fit:
    three one-CPU actors on the four CPUs are created at once (their
    constructors overlap), not one after another."""
    actors = [ray_tpu_torch.remote(num_cpus=1)(_Sleeper).remote()
              for _ in range(3)]
    spans = ray_tpu_torch.get([a.span.remote() for a in actors],
                              timeout=60)
    for a in actors:
        ray_tpu_torch.kill(a)
    assert max(s for s, _ in spans) < min(e for _, e in spans), spans


def test_resource_changing_moves_a_trial_to_two_gpus():
    def train_fn(config):
        import os

        import ray_tpu_torch
        from ray_tpu_torch.air import session as s
        from ray_tpu_torch.air.checkpoint import Checkpoint
        ck = s.get_checkpoint()
        start = ck.to_dict()["i"] + 1 if ck else 0
        for i in range(start, 4):
            s.report({"ids": list(ray_tpu_torch.get_gpu_ids()),
                      "env": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "i": i}, checkpoint=Checkpoint.from_dict({"i": i}))

    def alloc(runner, trial, result, scheduler):
        if result["training_iteration"] == 2:
            return {"CPU": 1, "GPU": 2}
        return None

    analysis = tune.run(
        train_fn, resources_per_trial={"CPU": 1, "GPU": 1},
        scheduler=tune.ResourceChangingScheduler(
            resources_allocation_function=alloc))
    t = analysis.trials[0]
    assert t.status == "TERMINATED" and t.resources == {"CPU": 1, "GPU": 2}
    assert [r["i"] for r in t.results] == [0, 1, 2, 3]
    assert all(len(r["ids"]) == 1 for r in t.results[:2])
    for r in t.results[2:]:
        assert r["ids"] == [3, 5] and r["env"] == "3,5"


def test_tpu_resources_refused():
    def train_fn(config):
        session.report({"x": 1})

    with pytest.raises(ValueError, match="'GPU'"):
        tune.run(train_fn, resources_per_trial={"CPU": 1, "TPU": 1})
    with pytest.raises(ValueError, match="'GPU'"):
        tune.with_resources(train_fn, {"TPU": 4})
    with pytest.raises(ValueError, match="'GPU'"):
        tune.Tuner(tune.with_resources(train_fn, {"TPU": 1})).fit()


@pytest.mark.parametrize("resources", [{"CPU": 1}, {"CPU": 1, "GPU": 0.5}],
                         ids=["no-gpu", "fraction"])
def test_cuda_trial_without_a_whole_gpu_fails(resources, tmp_path):
    marker = tmp_path / "ran"

    def train_fn(config):
        open(config["marker"], "w").close()
        session.report({"x": 1})

    analysis = tune.run(train_fn, config={"device": "cuda",
                                          "marker": str(marker)},
                        resources_per_trial=resources)
    t = analysis.trials[0]
    assert t.status == "ERROR"
    assert "no whole GPU" in t.error and "ValueError" in t.error
    assert not marker.exists()       # the function never ran


def test_with_resources_for_tuner():
    class Probe(tune.Trainable):
        def step(self):
            import os

            import ray_tpu_torch
            return {"ids": list(ray_tpu_torch.get_gpu_ids()),
                    "env": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "done": True}

    grid = tune.Tuner(tune.with_resources(Probe, {"CPU": 1, "GPU": 2}),
                      param_space={"device": "cuda"}).fit()
    r = grid[0].trial.results[0]
    assert grid[0].trial.resources == {"CPU": 1, "GPU": 2}
    assert r["ids"] == [3, 5] and r["env"] == "3,5"
    assert issubclass(tune.with_resources(Probe, {"CPU": 1}), Probe)
