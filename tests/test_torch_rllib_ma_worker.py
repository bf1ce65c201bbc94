"""The port's multi-agent rollout worker and multi-agent PPO
(``ray_tpu_torch.rllib``) against the JAX package's, on the CPU.

MultiAgentCartPole with 2 agents mapped to 2 policies (``pol_a``,
``pol_b``). Sampled actions never match JAX's (other RNG), so the
worker and PPO's steps are held greedy (``explore=False``), where the
trajectories are deterministic: each port policy loads its JAX
counterpart's params (``models.policy_map_from_flax``, strictly). Host
columns (obs, actions, rewards, dones, episode ids) and counts are held
equal; GAE's and the forward's floats, stats and params within F32 *
(1 + max |JAX value|). Two threads.
"""

import numpy as np
import pytest
import torch

import jax

from ray_tpu.rllib.algorithms import ppo as JPPO
from ray_tpu.rllib.rollout_worker import (
    MultiAgentRolloutWorker as JMultiAgentRolloutWorker)
from ray_tpu_torch import bench
from ray_tpu_torch import rllib as TR
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib.algorithms import ppo as TPPO
from ray_tpu_torch.rllib.rollout_worker import (
    MultiAgentRolloutWorker as TMultiAgentRolloutWorker)
from ray_tpu_torch.rllib.sample_batch import MultiAgentBatch

F32 = 1e-5
POLICIES = ("pol_a", "pol_b")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol=F32, what=""):
    got = np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = 1.0 + float(np.max(np.abs(want))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _mapping(aid, **kw):
    return "pol_a" if aid == "agent_0" else "pol_b"


def _config(**over):
    cfg = dict(env="MultiAgentCartPole", env_config={"num_agents": 2},
               rollout_fragment_length=40, train_batch_size=80,
               sgd_minibatch_size=32, num_sgd_iter=2, explore=False,
               model={"fcnet_hiddens": [32, 32]}, seed=3,
               multiagent={"policies": {"pol_a": {}, "pol_b": {"lr": 1e-3}},
                           "policy_mapping_fn": _mapping})
    cfg.update(over)
    return cfg


def _copy_policies(jmap, tmap, seed=7):
    """Each JAX policy's params redrawn apart (numpy, its own seed; two
    policies built from one config start equal, in JAX as in the port),
    then loaded into the port's counterpart by
    ``models.policy_map_from_flax`` (strict: no key left over); Adam
    restarted on the JAX side."""
    rng = np.random.default_rng(seed)
    for pid in POLICIES:
        jp = jmap[pid]
        jp.params = jax.tree_util.tree_map(
            lambda v: np.asarray(v) + 0.05 * rng.standard_normal(
                np.shape(v)).astype(np.float32), jax.device_get(jp.params))
        jp.opt_state = jp.optimizer.init(jp.params)
    sds = TM.policy_map_from_flax(
        {pid: jax.device_get(jmap[pid].params) for pid in POLICIES}, tmap)
    for pid in POLICIES:
        assert set(sds[pid]) == set(tmap[pid].model.state_dict())
        with pytest.raises(RuntimeError):
            TM.policy_map_from_flax(
                {pid: {**jax.device_get(jmap[pid].params),
                       "extra": {"kernel": np.zeros((2, 2))}}}, tmap)


def _hold_batches(jb, tb, what):
    assert isinstance(tb, MultiAgentBatch)
    assert set(tb.policy_batches) == set(jb.policy_batches), what
    assert tb.env_steps() == jb.env_steps() and tb.count == jb.count
    assert tb.agent_steps() == jb.agent_steps()
    for pid, j in jb.policy_batches.items():
        t = tb.policy_batches[pid]
        assert t.count == j.count, (what, pid)
        for k in ("obs", "new_obs", "actions", "rewards", "dones",
                  "truncateds", "eps_id"):
            np.testing.assert_array_equal(j[k], t[k],
                                          err_msg=f"{what} {pid} {k}")
        for k in ("advantages", "value_targets", "vf_preds", "action_logp",
                  "action_dist_inputs"):
            _close(t[k], j[k], F32, f"{what} {pid} {k}")


def test_ma_worker_sample_greedy_matches_jax():
    """``sample()`` over three fragments of 40 env steps (episodes end
    inside them; an agent that falls early sits out until ``__all__``):
    per policy the obs, actions, rewards, dones and episode ids equal,
    GAE and the forward's columns within F32, ``env_steps`` and
    ``agent_steps`` equal; the metrics and each policy's weights
    (``get_weights``: one dict per policy) alike."""
    cfg = _config()
    jw = JMultiAgentRolloutWorker(dict(cfg), JPPO.PPOPolicy)
    tw = TMultiAgentRolloutWorker(dict(cfg, device="cpu"), TPPO.PPOPolicy)
    assert list(tw.policy_map) == list(POLICIES)
    assert tw.policy_map["pol_b"].config["lr"] == 1e-3
    _copy_policies(jw.policy_map, tw.policy_map)
    for i in range(3):
        jb, tb = jw.sample(), tw.sample()
        assert tb.env_steps() == 40 and 40 < tb.agent_steps() <= 80
        _hold_batches(jb, tb, f"fragment {i}")
    assert tw.get_metrics() == jw.get_metrics()
    assert set(tw.get_weights()) == set(POLICIES)
    assert tw.evaluate_episodes(2) == jw.evaluate_episodes(2)


def _algos(**over):
    cfg = _config(**over)
    ja = JPPO.PPOConfig().update_from_dict(dict(cfg)).build()
    ta = TPPO.PPOConfig().update_from_dict(dict(cfg, device="cpu")).build()
    _copy_policies(ja.workers.local_worker.policy_map,
                   ta.workers.local_worker.policy_map)
    return ja, ta


def _record_samples(algo):
    seen = []
    worker = algo.workers.local_worker
    sample = worker.sample

    def recording():
        b = sample()
        seen.append(b)
        return b

    worker.sample = recording
    return seen


def test_two_ma_ppo_steps_match_jax():
    """The slice as a whole: two ``PPO.step()``s with two policies,
    greedy, from shared params. The WorkerSet takes the multi-agent
    worker; the same sampled batches (two fragments a step, joined by
    ``synchronous_parallel_sample`` with their env steps summed); each
    policy's minibatch order from ``seed + iteration``; the learner info
    per policy, the flat ``learner/{pid}/{k}`` stats and every policy's
    params within F32 after each step; the host timers kept."""
    ja, ta = _algos()
    assert isinstance(ta.workers.local_worker, TMultiAgentRolloutWorker)
    jseen, tseen = _record_samples(ja), _record_samples(ta)
    for step in range(2):
        jr, tr = ja.step(), ta.step()
        assert len(jseen) == len(tseen) == 2 * (step + 1)
        for jb, tb in zip(jseen[-2:], tseen[-2:]):
            _hold_batches(jb, tb, f"step {step}")
        for k in ("timesteps_total", "episodes_total",
                  "num_env_steps_sampled_this_iter"):
            assert jr[k] == tr[k], k
        assert tr["num_env_steps_sampled_this_iter"] == 80
        assert set(tr["info"]["learner"]) == set(POLICIES)
        for pid, st in jr["info"]["learner"].items():
            for k, v in st.items():
                _close(tr["info"]["learner"][pid][k], v, F32, f"{pid} {k}")
                _close(tr[f"learner/{pid}/{k}"], jr[f"learner/{pid}/{k}"],
                       F32, f"flat {pid} {k}")
        for pid in POLICIES:
            want = TM.params_from_flax(jax.device_get(
                ja.get_policy(pid).params))
            got = ta.get_policy(pid).get_weights()
            assert set(got) == set(want)
            for k, w in want.items():
                _close(got[k], w.numpy(), F32, f"{pid} {k} step {step}")
        assert set(tr["timers"]) == {"sample_time_ms", "postprocess_time_ms",
                                     "learn_time_ms"}
    ja.cleanup()
    ta.cleanup()


def test_policies_to_train_get_policy_and_checkpoint():
    """``policies_to_train=["pol_a"]`` trains pol_a alone (pol_b's
    weights unmoved, its stats absent); ``get_policy(pid)`` returns
    ``policy_map[pid]`` and raises KeyError for an unknown id (the
    single-agent worker's one policy stays ``"default_policy"``); a
    checkpoint restores every policy's weights and Adam state into an
    algorithm with another seed (as tests/test_rllib_multiagent.py:86);
    ``compute_single_action`` takes a policy id."""
    cfg = _config(multiagent={
        "policies": {"pol_a": {}, "pol_b": {}},
        "policy_mapping_fn": _mapping, "policies_to_train": ["pol_a"]},
        device="cpu")
    algo = TPPO.PPOConfig().update_from_dict(dict(cfg)).build()
    lw = algo.workers.local_worker
    assert algo.get_policy("pol_a") is lw.policy_map["pol_a"]
    with pytest.raises(KeyError):
        algo.get_policy("pol_c")
    b0 = algo.get_policy("pol_b").get_weights()
    a0 = algo.get_policy("pol_a").get_weights()
    r = algo.step()
    assert set(r["info"]["learner"]) == {"pol_a"}
    assert not any(k.startswith("learner/pol_b/") for k in r)
    for k, v in algo.get_policy("pol_b").get_weights().items():
        np.testing.assert_array_equal(v, b0[k])
    assert max(float(np.max(np.abs(v - a0[k]))) for k, v in
               algo.get_policy("pol_a").get_weights().items()) > 0
    state = algo.save_checkpoint()
    other = TPPO.PPOConfig().update_from_dict(dict(cfg, seed=99)).build()
    other.load_checkpoint(state)
    for pid in POLICIES:
        for k, v in algo.get_policy(pid).get_weights().items():
            np.testing.assert_array_equal(
                other.get_policy(pid).get_weights()[k], v)
        sa = algo.get_policy(pid).optimizer.state_dict()
        so = other.get_policy(pid).optimizer.state_dict()
        for i, st in sa["state"].items():
            for k, v in st.items():
                assert torch.equal(so["state"][i][k], v), (pid, i, k)
    a = other.compute_single_action(np.zeros(4, np.float32),
                                    policy_id="pol_b")
    assert a in (0, 1)
    assert "evaluation" in other.evaluate(num_episodes=1)
    single = (TR.PPOConfig().environment("CartPole-v1")
              .resources(device="cpu").build())
    assert single.get_policy("default_policy") is single.get_policy()
    with pytest.raises(KeyError):
        single.get_policy("pol_a")
    for x in (algo, other, single):
        x.cleanup()


def test_bench_ma_ppo_loop_on_cpu():
    """bench.ma_ppo_loop's CPU run: its keys, both policies in the
    learner info, finite losses, weights that moved, no launch of the
    port's kernels."""
    r = bench.ma_ppo_loop(device="cpu", profile=lambda learn: learn())
    for k in ("ma_ppo_env_steps_per_sec", "ma_ppo_agent_steps_per_sec",
              "ma_ppo_split", "ma_ppo_policies", "ma_ppo_profile"):
        assert k in r, k
    assert r["ma_ppo_policies"] == ["pol_a", "pol_b"]
    assert r["ma_ppo_losses_finite"] and r["ma_ppo_weights_moved"] > 0
    assert r["ma_ppo_launches"] == {}
