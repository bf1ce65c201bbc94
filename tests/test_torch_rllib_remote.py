"""The port's RLlib runtime half (``ray_tpu_torch.rllib`` on
``ray_tpu_torch.init``) against its local path and the JAX package's,
on the CPU.

One port cluster for the module (``init(num_cpus=4)``), shut down at the
end; every policy is on ``device="cpu"``. The JAX halves run locally,
without a JAX cluster: a remote worker's first sample is held byte for
byte to a local ``RolloutWorker`` of the same index and weights (which
the other files hold to JAX), the greedy evaluation workers' episode
rewards to JAX's ``evaluate_episodes`` from the same params, two remote
learners' state to JAX's ``Learner.compute_gradients`` on the same
shards averaged and applied (rtol 1e-5), the ES/ARS flat params to
``ravel_pytree``, the perturbation rollouts to JAX's class, the ES and
ARS gradients and Adam to JAX's (1e-6), the Ape-X ladders and replay
shard to JAX's, A3C's worker-side grads and DDPPO's average to local
runs of the same functions, and IMPALA's async branch to
``learn_on_batch`` on the batches it reaped. Each check states its
tolerance.
"""

import functools
import os
import time
import types
from unittest import mock

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.flatten_util
import jax.numpy as jnp
import optax

import ray_tpu_torch as rt
from ray_tpu.rllib import core as JCORE
from ray_tpu.rllib import env as JE
from ray_tpu.rllib import models as JM
from ray_tpu.rllib import sample_batch as JSB
from ray_tpu.rllib.algorithms import apex_ddpg as JAPEXDDPG
from ray_tpu.rllib.algorithms import apex_dqn as JAPEX
from ray_tpu.rllib.algorithms import es as JES
from ray_tpu.rllib.algorithms import ppo as JPPO
from ray_tpu.rllib.core import learner_group as JLG
from ray_tpu.rllib.rollout_worker import RolloutWorker as JRolloutWorker
from ray_tpu_torch.rllib import core as TCORE
from ray_tpu_torch.rllib import env as TE
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib import sample_batch as TSB
from ray_tpu_torch.rllib.algorithms import a3c as TA3C
from ray_tpu_torch.rllib.algorithms import apex_ddpg as TAPEXDDPG
from ray_tpu_torch.rllib.algorithms import apex_dqn as TAPEX
from ray_tpu_torch.rllib.algorithms import ddppo as TDDPPO
from ray_tpu_torch.rllib.algorithms import es as TES
from ray_tpu_torch.rllib.algorithms import impala as TIMPALA
from ray_tpu_torch.rllib.algorithms import pg as TPG
from ray_tpu_torch.rllib.algorithms import ppo as TPPO
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker as TRolloutWorker

# the learners' states against JAX's (the two sides sum in other
# orders, a few ulps per op): within RTOL * (1 + max |JAX value|)
RTOL = 1e-5
# the ES/ARS gradients and an Adam step against JAX's: numpy on both
# sides, within ES_TOL * (1 + max |JAX value|)
ES_TOL = 1e-6
# two remote learners after the same averaged updates
LEARNERS_ATOL = 1e-6
# Pendulum's perturbation returns over 60 steps: the actions carry each
# side's f32 forward rounding (~1e-7), the dynamics carry it on
PENDULUM_RTOL = 1e-5
MLP = {"fcnet_hiddens": [16, 16]}
STORE_BYTES = 256 * 1024 * 1024
# the port's processes check every inbound RPC against its wire schema
# and start workers on demand
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}


@pytest.fixture(scope="module", autouse=True)
def cluster():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    if rt.is_initialized():
        rt.shutdown()
    with mock.patch.dict(os.environ, PORT_ENV):
        rt.init(num_cpus=4, object_store_memory=STORE_BYTES)
        try:
            yield
        finally:
            rt.shutdown()
            torch.set_num_threads(old)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = 1.0 + float(np.max(np.abs(want))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _same(a, b) -> bool:
    """Byte-equal weight dicts."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _equal_batches(a, b, what):
    assert sorted(a.keys()) == sorted(b.keys()), what
    for k in a.keys():
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
            f"{what}: column {k} differs"


def _jax_flax_tree(module, obs_shape, seed):
    """A flax params tree of ``module``'s shapes drawn from numpy
    (``eval_shape``: no eager init): kernels of variance 1 / fan_in, the
    rest N(0, 0.1^2)."""
    shapes = jax.eval_shape(
        functools.partial(fnn.Module.init, module), jax.random.PRNGKey(0),
        jnp.zeros((1, *obs_shape), jnp.float32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray((1 / np.sqrt(s.shape[0]) if len(s.shape) >= 2
                               else 0.1) * rng.standard_normal(s.shape),
                              jnp.float32), shapes)


def _ppo_cartpole(**over):
    cfg = dict(env="CartPole-v1", num_envs_per_worker=2,
               rollout_fragment_length=16, train_batch_size=64,
               sgd_minibatch_size=32, num_sgd_iter=2, model=MLP, seed=3,
               device="cpu")
    cfg.update(over)
    return TPPO.PPOConfig().update_from_dict(cfg)


@pytest.fixture(scope="class")
def ppo_algo():
    """PPO with 2 remote rollout workers and 2 remote greedy evaluation
    workers: the cluster's 4 CPUs, held until the class's tests end."""
    algo = _ppo_cartpole(num_workers=2, evaluation_interval=1,
                         evaluation_num_workers=2,
                         evaluation_num_episodes=4).build()
    yield algo
    algo.cleanup()


# ---- (a) and (b): remote rollout and evaluation workers ----


class TestRemoteRolloutAndEvaluationWorkers:
    """(a) remote sampling equals local sampling; (b) greedy
    evaluation matches JAX. One PPO with remote rollout and
    evaluation workers (``ppo_algo``) for both."""

    def test_remote_sampling_equals_local(self, ppo_algo):
        """After ``sync_weights`` every remote worker holds the learner's
        weights byte for byte; each one's first sample equals, byte for
        byte, a local RolloutWorker's of the same worker index and
        weights
        (exploring: the CPU generators are seeded alike); a worker runs
        on the CPU with one torch thread; ``set_exploration`` reaches the
        local and every remote policy; a step samples through the remote
        workers only (the local worker's envs never step)."""
        algo, ws = ppo_algo, ppo_algo.workers
        policy = algo.get_policy()
        rng = np.random.default_rng(0)
        policy.set_weights({
            k: v + 0.05 * rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in policy.get_weights().items()})
        ws.sync_weights()
        held = rt.get([w.get_weights.remote() for w in ws.remote_workers])
        assert all(_same(w, policy.get_weights()) for w in held)
        assert rt.get([w.apply.remote(lambda w: (w.worker_index,
                                                 w.policy.device.type,
                                                 torch.get_num_threads()))
                       for w in ws.remote_workers]) == [(1, "cpu", 1),
                                                        (2, "cpu", 1)]
        remote = ws.sample_all()
        for i, got in enumerate(remote):
            local = TRolloutWorker(dict(algo.config), TPPO.PPOPolicy,
                                   worker_index=i + 1)
            local.set_weights(policy.get_weights())
            _equal_batches(got, local.sample(), f"worker {i + 1}")
        ws.set_exploration(exploration_epsilon=0.25)
        assert policy.exploration_epsilon == 0.25
        assert rt.get([w.apply.remote(
            lambda w: w.policy.exploration_epsilon)
            for w in ws.remote_workers]) == [0.25, 0.25]
        r = algo.step()
        assert r["num_env_steps_sampled_this_iter"] == 64
        assert ws.local_worker._episode_lens.sum() == 0

    # ---- (b) greedy evaluation matches JAX ----

    @staticmethod
    def _greedy_margin(jpolicy, seeds):
        """The smallest gap between the two greedy logits along JAX's
        evaluation episodes: what an argmax flip would have to beat."""
        env = JE.make_env("CartPole-v1")
        margin = np.inf
        for s in seeds:
            obs, _ = env.reset(seed=s)
            done = False
            while not done:
                logits, _ = jpolicy.model.apply({"params": jpolicy.params},
                                                jnp.asarray(obs)[None])
                lg = np.asarray(logits[0])
                margin = min(margin, abs(float(lg[0] - lg[1])))
                obs, _, term, trunc, _ = env.step(int(np.argmax(lg)))
                done = term or trunc
        return margin

    def test_greedy_evaluation_matches_jax(self, ppo_algo):
        """Two remote evaluation workers (``explore=False``) with JAX's
        params converted by params_from_flax: each one's episode rewards
        equal JAX's greedy ``evaluate_episodes`` for the same worker index
        (on a mismatch the message gives the smallest logit margin along
        JAX's episodes); ``_run_evaluation`` reports their summary over 4
        episodes."""
        algo = ppo_algo
        cfg = {"env": "CartPole-v1", "num_envs_per_worker": 1, "seed": 3,
               "explore": False, "model": MLP}
        per = algo.config["evaluation_num_episodes"] // 2
        jworkers = [JRolloutWorker(dict(cfg), JPPO.PPOPolicy,
                                   worker_index=i) for i in (1, 2)]
        TM.params_from_flax(jax.device_get(jworkers[0].policy.params),
                            algo.get_policy().model)
        jworkers[1].policy.params = jworkers[0].policy.params
        out = algo._run_evaluation()["evaluation"]
        evals = algo.evaluation_workers.remote_workers
        got = rt.get([w.evaluate_episodes.remote(per) for w in evals])
        for i, (jw, g) in enumerate(zip(jworkers, got)):
            want = jw.evaluate_episodes(per)
            seeds = [50_000 + (i + 1) * 1000 + ep for ep in range(per)]
            assert g == want, (
                f"eval worker {i + 1}: {g} vs JAX {want}; smallest greedy "
                f"logit margin {self._greedy_margin(jw.policy, seeds)}")
        flat = [r for g in got for r in g]
        assert out == {"episode_reward_mean": float(np.mean(flat)),
                       "episode_reward_min": float(np.min(flat)),
                       "episode_reward_max": float(np.max(flat)),
                       "episodes_this_eval": 4}
        assert rt.get([w.apply.remote(lambda w: w.config["explore"])
                       for w in evals]) == [False, False]


# ---- (c) remote learners match JAX's learner ----


def _ppo_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (n,)).astype(np.int32),
        "action_logp": rng.uniform(-1.2, -0.3, (n,)).astype(np.float32),
        "advantages": rng.standard_normal((n,)).astype(np.float32),
        "value_targets": rng.standard_normal((n,)).astype(np.float32),
    }


def test_remote_learners_match_jax():
    """Two CPU learner actors: three updates (the last batch has 1 row,
    so the first learner's shard is empty and skipped). At each update
    the learners' averaged grads (``compute_gradients`` on the non-empty
    shards, which leaves the params as they are) equal JAX's learner's
    on the same shards (RTOL); JAX's learner then applies those averaged
    grads with its ``apply_gradients``. Both learners end equal
    (LEARNERS_ATOL), and equal to JAX's learner (RTOL).

    JAX applies the port's grads, not its own: Adam's first step moves a
    param by lr * g / (|g| + eps), and some grads here are of the order
    of eps (1e-8), where a grad's last-bit rounding, which differs from
    one CPU's kernels to another's, moves the param by a sizeable share
    of lr (a 4.6e-5 gap was seen). The grads themselves are held to JAX's
    at every step, where that amplification is absent."""
    from ray_tpu_torch.rllib.core.learner_group import _avg_host_grads
    conf = {"lr": 5e-3, "grad_clip": 0.5}
    mid = JCORE.DEFAULT_MODULE_ID
    jl = JCORE.PPOLearner(module_spec=JCORE.RLModuleSpec(
        observation_space=JE.Box(-1, 1, (4,)), action_space=JE.Discrete(2),
        seed=0), config=conf)
    spec = TCORE.RLModuleSpec(observation_space=TE.Box(-1, 1, (4,)),
                              action_space=TE.Discrete(2), seed=5,
                              device="cpu")
    group = TCORE.LearnerGroup(TCORE.PPOLearner, num_learners=2,
                               learner_kwargs={"module_spec": spec,
                                               "config": conf})
    try:
        sd = {k: v.numpy() for k, v in TM.params_from_flax(
            jax.device_get(jl.module[mid].params)).items()}
        group.set_state({"module": {mid: sd}})
        for i, n in enumerate((48, 48, 1)):
            batch = _ppo_batch(n, seed=i)
            pairs = [(w, s) for w, s in zip(group._workers,
                                            group._shard(batch, 2))
                     if group._shard_rows(s) > 0]
            port_avg = _avg_host_grads([g[mid] for g in rt.get(
                [w.compute_gradients.remote(s) for w, s in pairs])])
            out = group.update_from_batch(batch)
            shards = [s for s in JLG.LearnerGroup._shard(batch, 2)
                      if JLG.LearnerGroup._shard_rows(s) > 0]
            assert out == {mid: {"workers": float(len(shards))}}
            assert len(pairs) == len(shards)
            grads = [jl.compute_gradients(s) for s in shards]
            jax_avg = JLG._avg_pytrees([g[mid] for g in grads])
            for k, w in TM.params_from_flax(
                    jax.device_get(jax_avg)).items():
                _close(port_avg[k], w.numpy(), RTOL,
                       f"update {i} averaged grad {k}")
            # the port's averaged grads as a flax tree (Dense kernels
            # [in, out] are the port's weights transposed)
            tree = {name: {"kernel": port_avg[f"{name}.weight"].T,
                           "bias": port_avg[f"{name}.bias"]}
                    for name in jax_avg}
            jl.apply_gradients({mid: tree})
        states = rt.get([w.get_state.remote() for w in group._workers])
        for k in sd:
            np.testing.assert_allclose(states[1]["module"][mid][k],
                                       states[0]["module"][mid][k],
                                       rtol=0, atol=LEARNERS_ATOL)
        want = TM.params_from_flax(jax.device_get(jl.module[mid].params))
        got = group.get_state()["module"][mid]
        for k, w in want.items():
            _close(got[k], w.numpy(), RTOL, f"learner param {k}")
    finally:
        group.shutdown()


def test_apply_gradients_leaves_the_grads_as_they_were():
    """A learner's ``apply_gradients`` clips a copy: the driver's
    averaged grads (which it sends to every learner) and a policy's grads
    come back unchanged, byte for byte, with the clip active."""
    learner = TCORE.PPOLearner(
        module_spec=TCORE.RLModuleSpec(
            observation_space=TE.Box(-1, 1, (4,)),
            action_space=TE.Discrete(2), device="cpu"),
        config={"grad_clip": 1e-4})
    grads = learner.compute_gradients(_ppo_batch(32, seed=7))
    before = {mid: {k: v.copy() for k, v in g.items()}
              for mid, g in grads.items()}
    learner.apply_gradients(grads)
    for mid, g in grads.items():
        assert _same(g, before[mid])
    policy = TPPO.PPOPolicy(TE.Box(-1, 1, (4,)), TE.Discrete(2),
                            {"device": "cpu", "grad_clip": 1e-4,
                             "model": MLP})
    g = {k: np.full_like(v, 3.0) for k, v in policy.get_weights().items()}
    kept = {k: v.copy() for k, v in g.items()}
    policy.apply_gradients(g)
    assert _same(g, kept)


# ---- (d) ES and ARS match JAX ----


@pytest.mark.parametrize("space", ["discrete", "continuous", "pixels"])
def test_flat_params_match_ravel_pytree(space):
    """``flat_params`` of a model loaded by params_from_flax equals
    ``ravel_pytree`` of the flax tree (order and layout: sorted keys,
    kernels [in, out] and HWIO); ``load_flat_params`` of that vector
    gives the same model back."""
    spaces = {
        "discrete": ((4,), TE.Discrete(2), JE.Discrete(2)),
        "continuous": ((3,), TE.Box(-2, 2, (1,)), JE.Box(-2, 2, (1,))),
        "pixels": ((21, 21, 2), TE.Discrete(3), JE.Discrete(3))}[space]
    shape, tact, jact = spaces
    model_cfg = {"fcnet_hiddens": [16, 12, 8, 8, 8, 8, 8, 8, 8, 8, 8, 6]}
    jmodel = JM.make_model(JE.Box(-1, 1, shape), jact, model_cfg)
    tree = _jax_flax_tree(jmodel, shape, seed=1)
    want, _ = jax.flatten_util.ravel_pytree(tree)
    tmodel = TM.make_model(TE.Box(-1, 1, shape), tact, model_cfg)
    TM.params_from_flax(jax.device_get(tree), tmodel)
    theta = TM.flat_params(tmodel)
    assert theta.dtype == np.float32
    np.testing.assert_array_equal(theta, np.asarray(want))
    again = TM.load_flat_params(
        TM.make_model(TE.Box(-1, 1, shape), tact, model_cfg), theta)
    for (k, a), b in zip(tmodel.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="entries"):
        TM.load_flat_params(tmodel, np.zeros(theta.size + 1, np.float32))


def test_perturbation_rollouts_match_jax():
    """The port's ``_PerturbationWorker.do_rollouts`` (the plain class)
    for one theta equals JAX's plain ``_PerturbationWorker``: the same
    noise indices, returns and steps, on CartPole (argmax actions: equal
    returns) and on Pendulum (the clipped mean: the two forwards' f32
    rounding moves the returns, held within PENDULUM_RTOL)."""
    noise = TES.create_shared_noise(50_000, 7)
    np.testing.assert_array_equal(noise, JES.create_shared_noise(50_000, 7))
    for env, obs_shape in (("CartPole-v1", (4,)), ("Pendulum-v1", (3,))):
        cfg = {"env": env, "env_config": {}, "model": MLP}
        jw = JES._PerturbationWorker(dict(cfg), noise, 11)
        tw = TES._PerturbationWorker(dict(cfg), noise, 11)
        assert tw.dim == jw.dim
        tree = _jax_flax_tree(jw.model, obs_shape, seed=2)
        theta = np.asarray(jax.flatten_util.ravel_pytree(tree)[0])
        want = jw.do_rollouts(theta, 3, 0.05, 60)
        got = tw.do_rollouts(theta, 3, 0.05, 60)
        if env == "CartPole-v1":
            assert got == want, (env, got, want)
            continue
        assert [(i, n) for i, _, _, n in got] == \
            [(i, n) for i, _, _, n in want]
        np.testing.assert_allclose([g[1:3] for g in got],
                                   [w[1:3] for w in want],
                                   rtol=PENDULUM_RTOL, atol=0)


def _returns(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 10_000, n).tolist(),
            rng.normal(20, 5, n).astype(np.float32),
            rng.normal(20, 5, n).astype(np.float32))


@pytest.mark.parametrize("algo", ["ES", "ARS"])
def test_es_gradient_and_adam_match_jax(algo):
    """``_gradient`` (ES: centered ranks; ARS: the top 4 of 7 directions
    over the elite std) on the same returns and noise, then three Adam
    steps on theta: equal to JAX's within ES_TOL."""
    dim = 37
    noise = TES.create_shared_noise(20_000, 3)
    cfg = {"sigma": 0.05, "num_top_directions": 4}
    idxs, rp, rn = _returns(7, seed=1)
    jfake = types.SimpleNamespace(noise=noise, dim=dim, config=cfg)
    tfake = types.SimpleNamespace(noise=noise, dim=dim, config=cfg)
    jg = getattr(JES, algo)._gradient(jfake, idxs, rp, rn)
    tg = getattr(TES, algo)._gradient(tfake, idxs, rp, rn)
    _close(tg, jg, ES_TOL, "gradient")
    theta = np.random.default_rng(5).standard_normal(dim).astype(
        np.float32)
    jtheta, ttheta = theta.copy(), theta.copy()
    opt = optax.adam(0.02)
    jstate, tstate = opt.init(jtheta), TES.adam_init(ttheta)
    for step in range(3):
        g = (tg * (step + 1) - 0.005 * ttheta).astype(np.float32)
        updates, jstate = opt.update(-g, jstate, jtheta)
        jtheta = np.asarray(optax.apply_updates(jtheta, updates), np.float32)
        ttheta, tstate = TES.adam_update(ttheta, -g, tstate, 0.02)
        _close(ttheta, jtheta, ES_TOL, f"theta after Adam step {step}")
    assert tstate["count"] == 3


@pytest.mark.parametrize("algo", ["ES", "ARS"])
def test_es_training_step_through_remote_workers(algo):
    """One training step through two remote perturbation workers (the
    noise table put once): steps counted, theta moved, the local policy
    holding theta, and save/load keeping theta and the Adam state."""
    config = getattr(TES, f"{algo}Config")().update_from_dict(dict(
        env="CartPole-v1", num_workers=2, model=MLP, rollouts_per_worker=2,
        episode_horizon=40, noise_table_size=100_000, device="cpu"))
    es = config.build()
    try:
        assert len(es._es_workers) == 2 and es.config["num_workers"] == 0
        assert es.workers.remote_workers == []
        theta0 = es.theta.copy()
        r = es.step()
        assert r["episodes_this_iter"] == 8
        assert 8 <= r["num_env_steps_sampled_this_iter"] <= 8 * 40
        assert float(np.max(np.abs(es.theta - theta0))) > 0
        np.testing.assert_array_equal(
            TM.flat_params(es.get_policy().model), es.theta)
        state = es.save_checkpoint()
        es.theta = theta0.copy()
        es.opt_state = TES.adam_init(theta0)
        es.load_checkpoint(state)
        np.testing.assert_array_equal(es.theta, state["theta"])
        assert es.opt_state["count"] == 1
        np.testing.assert_array_equal(es.opt_state["mu"],
                                      state["es_opt_state"]["mu"])
    finally:
        es.cleanup()


# ---- (e) Ape-X matches JAX ----


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_apex_ladders_match_jax(n):
    """The per-worker epsilon (DQN) and noise (DDPG) ladders, base **
    (1 + 7 i / (n - 1)), equal JAX's ``_worker_exploration``."""
    fake = types.SimpleNamespace(config={"epsilon_base": 0.3,
                                         "exploration_noise": 0.5})
    for i in range(n):
        assert (TAPEX.ApexDQN._worker_exploration(fake, i, n)
                == JAPEX.ApexDQN._worker_exploration(fake, i, n))
        assert (TAPEXDDPG.ApexDDPG._worker_exploration(fake, i, n)
                == JAPEXDDPG.ApexDDPG._worker_exploration(fake, i, n))


def test_replay_shard_matches_jax():
    """The plain ``_ReplayShard`` classes from one seed: sizes, sampled
    rows, importance weights and indexes byte-equal across adds, samples
    and priority updates (wrapping the 40-row capacity)."""
    jshard, tshard = JAPEX._ReplayShard(40, 0.6, 4), TAPEX._ReplayShard(
        40, 0.6, 4)
    rng = np.random.default_rng(0)
    for step in range(6):
        cols = {"obs": rng.standard_normal((12, 3)).astype(np.float32),
                "actions": rng.integers(0, 2, 12).astype(np.int32),
                "rewards": rng.standard_normal(12).astype(np.float32)}
        assert (jshard.add(JSB.SampleBatch(dict(cols)))
                == tshard.add(TSB.SampleBatch(dict(cols))))
        assert jshard.size() == tshard.size()
        js, ts = jshard.sample(10, 0.4), tshard.sample(10, 0.4)
        _equal_batches(js, ts, f"sample {step}")
        prio = rng.uniform(0, 3, 10).astype(np.float32)
        assert (jshard.update_priorities(js["batch_indexes"], prio)
                == tshard.update_priorities(ts["batch_indexes"], prio))
    assert jshard.sample(1000, 0.4).count == tshard.sample(1000, 0.4).count \
        == 0


def _apex(kind):
    if kind == "dqn":
        return TAPEX.ApexDQNConfig().update_from_dict(dict(
            env="CartPole-v1", num_workers=2, num_envs_per_worker=2,
            rollout_fragment_length=16, train_batch_size=32,
            learning_starts=128, replay_buffer_capacity=2000,
            train_intensity_per_iter=2, model=MLP, seed=0, device="cpu"))
    return TAPEXDDPG.ApexDDPGConfig().update_from_dict(dict(
        env="Pendulum-v1", num_workers=2, rollout_fragment_length=16,
        train_batch_size=32, learning_starts=64, replay_buffer_capacity=2000,
        train_intensity_per_iter=2, seed=0, device="cpu"))


@pytest.mark.parametrize("kind", ["dqn", "ddpg"])
def test_apex_learns_and_updates_priorities(kind):
    """Ape-X DQN on CartPole and Ape-X DDPG on Pendulum with 2 remote
    workers and the replay actor: the replay reaches learning_starts,
    the learner steps, the learner's weights move, the replay's
    importance weights are no longer all 1 (priorities updated from
    td_errors), the workers hold their ladder and the learner acts
    greedily."""
    algo = _apex(kind).build()
    try:
        key = "exploration_epsilon" if kind == "dqn" else "exploration_noise"
        assert getattr(algo.get_policy(), key) == 0.0
        w0 = algo.get_policy().get_weights()
        for _ in range(12):
            r = algo.step()
            if r["num_learner_steps"] >= 4:
                break
        assert r["replay_size"] >= algo.config["learning_starts"]
        assert r["num_learner_steps"] >= 4
        w1 = algo.get_policy().get_weights()
        assert max(float(np.max(np.abs(w1[k] - w0[k]))) for k in w0) > 0
        sample = rt.get(algo.replay_actor.sample.remote(256, 0.4))
        assert len(np.unique(sample["weights"])) > 1
        base = algo.config["epsilon_base" if kind == "dqn"
                           else "exploration_noise"]
        got = rt.get([w.apply.remote(lambda w, key=key: getattr(
            w.policy, key)) for w in algo.workers.remote_workers])
        assert got == [TAPEX.exploration_ladder(base, i, 2)
                       for i in range(2)]
    finally:
        algo.cleanup()


# ---- (f) A3C matches local gradients ----


def test_a3c_remote_grads_match_local():
    """A remote worker's first ``_sample_and_grad`` (in flight from
    setup) equals the same function on a local worker of the same index
    and initial weights, grads byte-equal; a step applies at most
    ``max_grads_per_step`` grads and moves the learner's weights; A3C
    without workers raises ValueError, as JAX's does."""
    cfg = dict(env="CartPole-v1", num_workers=2, rollout_fragment_length=20,
               max_grads_per_step=3, model=MLP, seed=1, device="cpu")
    algo = TA3C.A3CConfig().update_from_dict(cfg).build()
    try:
        fut, worker = next(iter(algo._grad_futs.items()))
        index = algo.workers.remote_workers.index(worker) + 1
        grads, stats, count = rt.get(fut)
        local = TRolloutWorker(dict(algo.config), TPG.A2CPolicy,
                               worker_index=index)
        want, want_stats, want_count = TA3C._sample_and_grad(local)
        assert count == want_count == 20
        assert grads.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(grads[k], want[k], err_msg=k)
        assert stats == want_stats
        w0 = algo.get_policy().get_weights()
        r = algo.step()
        assert 1 <= r["num_grads_applied"] <= 3
        assert r["num_env_steps_sampled_this_iter"] == \
            20 * r["num_grads_applied"]
        w1 = algo.get_policy().get_weights()
        assert max(float(np.max(np.abs(w1[k] - w0[k]))) for k in w0) > 0
    finally:
        algo.cleanup()
    with pytest.raises(ValueError, match="num_workers"):
        TA3C.A3CConfig().update_from_dict(dict(cfg, num_workers=0)).build()


# ---- (g) DDPPO averages exactly ----


def test_ddppo_parameter_average():
    """One DDPPO step with 2 remote workers: the learner's weights equal
    the mean of ``_local_sgd`` run on local workers of the same indices
    with the same seeds (byte-equal), and every remote worker holds
    them."""
    cfg = dict(env="CartPole-v1", num_workers=2, rollout_fragment_length=32,
               sgd_minibatch_size=16, num_sgd_iter=2, model=MLP, seed=2,
               device="cpu")
    algo = TDDPPO.DDPPOConfig().update_from_dict(cfg).build()
    try:
        r = algo.step()
        assert r["num_ddppo_workers"] == 2
        assert r["num_env_steps_sampled_this_iter"] == 64
        seed = 2 * 100_003 + 0
        outs = []
        for i in range(2):
            local = TRolloutWorker(dict(algo.config), TPPO.PPOPolicy,
                                   worker_index=i + 1)
            outs.append(TDDPPO._local_sgd(local, 2, 16, seed + i)[0])
        want = {k: np.mean(np.stack([o[k] for o in outs]), axis=0)
                for k in outs[0]}
        learner = algo.get_policy().get_weights()
        assert _same(learner, want)
        held = rt.get([w.get_weights.remote()
                       for w in algo.workers.remote_workers])
        assert all(_same(w, learner) for w in held)
    finally:
        algo.cleanup()


# ---- (h) IMPALA's async branch ----


def _record_reaps(algo):
    """Wraps ``algo._reap_one`` to keep a copy of every reaped batch."""
    reaped, inner = [], algo._reap_one

    def reap(timeout):
        got = inner(timeout)
        if got is not None:
            reaped.append(got[1].copy())
        return got
    algo._reap_one = reap
    return reaped


def _impala(**over):
    cfg = dict(env="CartPole-v1", num_workers=2, num_envs_per_worker=2,
               rollout_fragment_length=16, max_sample_batches_per_iter=4,
               model=MLP, seed=0, device="cpu")
    cfg.update(over)
    return TIMPALA.IMPALAConfig().update_from_dict(cfg).build()


def test_impala_async_learner_consumes_reaped_batches():
    """Two remote samplers feeding the learner thread: each iteration's
    ``num_env_steps_sampled_this_iter`` equals the rows it reaped, and
    the learner thread trains on every reaped row; samplers stay in
    flight."""
    algo = _impala()
    try:
        assert algo._learner is not None and algo._learner.is_alive()
        reaped = _record_reaps(algo)
        total = 0
        for _ in range(2):
            n0 = len(reaped)
            r = algo.step()
            rows = sum(b.count for b in reaped[n0:])
            assert len(reaped) - n0 == 4
            assert r["num_env_steps_sampled_this_iter"] == rows == 4 * 32
            total += rows
        deadline = time.time() + 60
        while (algo._learner.num_samples_trained < total
               and time.time() < deadline):
            time.sleep(0.05)
        assert algo._learner.num_samples_trained == total
        assert algo._learner.num_steps == len(reaped)
        assert len(algo._in_flight) == 2
        assert set(r["timers"]) == {"sample_wait_time_ms",
                                    "postprocess_time_ms", "learn_time_ms",
                                    "broadcast_time_ms"}
    finally:
        algo.cleanup()
    assert algo._learner.stopped


def test_impala_inline_learner_matches_learn_on_batch():
    """``async_learner=False`` with one remote worker: the learner's
    stats and weights after two iterations equal ``learn_on_batch`` of
    a fresh local IMPALAPolicy (same config and initial weights) on the
    batches the algorithm reaped, with their cuts."""
    algo = _impala(num_workers=1, async_learner=False,
                   max_sample_batches_per_iter=2)
    try:
        assert algo._learner is None
        ref = TIMPALA.IMPALAPolicy(algo.get_policy().observation_space,
                                   algo.get_policy().action_space,
                                   algo.config)
        ref.set_weights(algo.get_policy().get_weights())
        reaped = _record_reaps(algo)
        for _ in range(2):
            r = algo.step()
        assert len(reaped) == 4
        for b in reaped:
            stats = ref.learn_on_batch(TIMPALA._mark_cuts(b))
        assert {k[len("learner/"):]: v for k, v in r.items()
                if k.startswith("learner/")} == stats
        assert _same(ref.get_weights(), algo.get_policy().get_weights())
    finally:
        algo.cleanup()


# ---- (i) misplaced learners raise ----


def test_more_cuda_learners_than_gpus_raise():
    """A learner on cuda asks for a GPU; more of them than the cluster
    has (here none) raise at construction, naming both counts."""
    spec = TCORE.RLModuleSpec(observation_space=TE.Box(-1, 1, (4,)),
                              action_space=TE.Discrete(2), device="cuda")
    with pytest.raises(ValueError, match="2 learners on cuda need 2 GPUs; "
                       "the cluster has 0"):
        TCORE.LearnerGroup(TCORE.PPOLearner, num_learners=2,
                           learner_kwargs={"module_spec": spec})


# ---- the benches' remote loops at their CPU sizes ----


def test_bench_remote_loops_on_cpu():
    """bench.ppo_remote_loop and impala_remote_loop on this module's
    cluster at their CPU sizes (2 remote workers of 2 envs; 21 x 21 x 2
    frames): their keys, finite losses, weights that moved, the workers
    holding the learner's weights after PPO's sync, the learner thread's
    steps and rows, and no launch of the port's kernels."""
    from ray_tpu_torch import bench
    p = bench.ppo_remote_loop(device="cpu")
    assert p["ppo_remote_num_workers"] == 2
    assert p["ppo_remote_num_envs"] == 4
    assert p["ppo_remote_env_steps_per_iter"] == 64
    assert len(p["ppo_remote_actor_start_s"]) == 2
    assert 0 < p["ppo_remote_sample_share"] < 1
    assert p["ppo_remote_workers_hold_learner_weights"]
    assert all(np.isfinite(p["ppo_remote_total_losses"]))
    assert p["ppo_remote_weights_moved"] > 0
    assert p["ppo_remote_launches"] == {}
    i = bench.impala_remote_loop(device="cpu")
    assert i["impala_remote_num_workers"] == 2
    assert i["impala_remote_env_steps_per_iter"] == 8 * 2 * 16
    assert i["impala_remote_learner_steps"] > 0
    assert i["impala_remote_learner_rows_trained"] > 0
    assert i["impala_remote_learner_queue_capacity"] == 16
    assert all(np.isfinite(i["impala_remote_total_losses"]))
    assert i["impala_remote_weights_moved"] > 0
    assert i["impala_remote_launches"] == {}
    assert rt.is_initialized()
