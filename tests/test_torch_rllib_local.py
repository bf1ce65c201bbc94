"""The port's ``LocalAlgorithm`` (the algorithms that run their own env
loop), the contextual bandits (LinUCB, LinTS) and SlateQ
(``ray_tpu_torch.rllib``) against the JAX package's, on the CPU.

Both sides are numpy where the reference is (envs, replay draws,
epsilon, the bandits' exact ridge updates): those are held bit-equal.
SlateQ's net crosses with ``models.params_from_flax``; its f32 update is
held within F32 * (1 + max |JAX value|). The JAX SlateQ is built by its
own setup with its net's ``init`` drawing the params from numpy on
flax's shapes (``eval_shape``: flax's eager init compiles op by op);
two threads.
"""

import copy
import functools

import flax.linen as fnn
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from ray_tpu.rllib import algorithm as JALGO
from ray_tpu.rllib import env as JE
from ray_tpu.rllib import replay_buffers as JRB
from ray_tpu.rllib.algorithms import bandit as JB
from ray_tpu.rllib.algorithms import slateq as JSQ
from ray_tpu_torch import bench
from ray_tpu_torch import rllib as TR
from ray_tpu_torch.rllib import algorithm as TALGO
from ray_tpu_torch.rllib import env as TE
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib import replay_buffers as TRB
from ray_tpu_torch.rllib.algorithms import bandit as TB
from ray_tpu_torch.rllib.algorithms import slateq as TSQ
from ray_tpu_torch.rllib.policy import weights_of

F32 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _numpy_tree(tree, seed):
    """A tree of ``tree``'s shapes from numpy: kernels of variance
    1 / fan_in, the rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        scale = (1 / np.sqrt(leaf.shape[0]) if len(leaf.shape) >= 2
                 else 0.1)
        return jnp.asarray(scale * rng.standard_normal(leaf.shape),
                           jnp.float32)

    return jax.tree_util.tree_map(draw, tree)


def _shaped(module, *dummy, seed=0):
    shapes = jax.eval_shape(functools.partial(fnn.Module.init, module),
                            jax.random.PRNGKey(0), *dummy)
    return _numpy_tree(shapes["params"], seed)


@pytest.fixture(autouse=True, scope="module")
def _numpy_init():
    """The JAX SlateQ's net draws its params from numpy (``_shaped``)
    while this file runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSQ._ItemQNet, "init", lambda self, rng, *dummy: {
            "params": _shaped(self, *dummy)})
        yield


def _close(got, want, tol=F32, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = 1.0 + float(np.max(np.abs(want))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _close_tree(got_sd, want_tree, what=""):
    want = TM.params_from_flax(jax.device_get(want_tree))
    assert set(got_sd) == set(want), (sorted(got_sd), sorted(want))
    for k, w in want.items():
        _close(got_sd[k], w.numpy(), F32, f"{what} {k}")


def _load(model, tree):
    sd = TM.params_from_flax(jax.device_get(tree))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return model


def _bare(cls, **config):
    """A ``LocalAlgorithm`` with only its shared state: no setup."""
    algo = cls.__new__(cls)
    algo.config = dict(config)
    algo._init_local_state()
    return algo


# ---- LocalAlgorithm ----

SCHEDULE = dict(seed=3, initial_epsilon=1.0, final_epsilon=0.05,
                epsilon_timesteps=1000, target_network_update_freq=300)


def test_epsilon_and_target_sync_match_jax():
    """The epsilon schedule at counters before, inside and past it; the
    target-sync period over uneven step counts: the same counters
    after every call, the target equal to the online net right after
    each sync and apart before it."""
    ja = _bare(JALGO.LocalAlgorithm, **SCHEDULE)
    ta = _bare(TALGO.LocalAlgorithm, **SCHEDULE)
    for t in (0, 1, 250, 999, 1000, 5000):
        ja._timesteps_total = ta._timesteps_total = t
        assert ta._epsilon() == ja._epsilon(), t
    ja.params = {"w": jnp.ones(3)}
    ja.target_params = {"w": jnp.zeros(3)}
    ta.model = nn.Linear(3, 3)
    ta.target_model = copy.deepcopy(ta.model).requires_grad_(False)
    syncs = 0
    for steps in (64, 100, 200, 7, 299, 300, 1, 350):
        with torch.no_grad():
            ta.model.weight.add_(1.0)
        ja._maybe_sync_target(steps)
        ta._maybe_sync_target(steps)
        assert ta._steps_since_target_sync == ja._steps_since_target_sync
        equal = torch.equal(ta.model.weight, ta.target_model.weight)
        assert equal == (ta._steps_since_target_sync == 0)
        syncs += equal
    assert syncs == 4


def _joint_act(obs):
    """Each agent pushes toward its pole's lean: every pole stays up to
    the 500-step limit, so the agents' episodes end together (the
    collector reads every agent's reward each step)."""
    acts = {a: int(o[2] + 0.4 * o[3] + 0.05 * o[1] + 0.01 * o[0] > 0)
            for a, o in obs.items()}
    return acts, np.array([acts[a] for a in sorted(obs)], np.int64)


def _joint(pkg_algo, pkg_env, pkg_rb):
    algo = _bare(pkg_algo.LocalAlgorithm, seed=0)
    algo.env = pkg_env.MultiAgentCartPole({"num_agents": 3})
    algo.agent_ids = list(algo.env.agent_ids)
    algo._obs, _ = algo.env.reset(seed=11)
    algo._episode_reward = 0.0
    algo.replay = pkg_rb.ReplayBuffer(1000, seed=0)
    return algo


def test_collect_joint_matches_jax():
    """``_collect_joint`` on MultiAgentCartPole (3 agents, two 500-step
    episodes ending inside the fragments): the replay's rows bit-equal
    to JAX's, the terminal rows and the team returns equal."""
    ja = _joint(JALGO, JE, JRB)
    ta = _joint(TALGO, TE, TRB)
    for n in (700, 400):
        assert (ta._collect_joint(_joint_act, n)
                == ja._collect_joint(_joint_act, n) == n)
    assert len(ta.replay) == len(ja.replay) == 1000
    assert ta.replay._cols["dones"].sum() == 2
    assert set(ta.replay._cols) == set(ja.replay._cols)
    for k, col in ja.replay._cols.items():
        assert ta.replay._cols[k].dtype == col.dtype, k
        np.testing.assert_array_equal(ta.replay._cols[k], col)
    assert len(ja._episode_reward_window) >= 2
    assert ta._episode_reward_window == ja._episode_reward_window
    assert ta._episode_reward == ja._episode_reward


@pytest.mark.parametrize("multi", [False, True])
def test_eval_episodes_matches_jax(multi):
    """``_eval_episodes`` in both branches (a CartPole, a 2-agent
    MultiAgentCartPole) with a deterministic policy of the obs: equal
    results, ``on_reset`` once an episode."""
    out, resets = [], []
    for pkg_algo, pkg_env in ((JALGO, JE), (TALGO, TE)):
        algo = _bare(pkg_algo.LocalAlgorithm, seed=0)
        algo.env = (pkg_env.MultiAgentCartPole({"num_agents": 2}) if multi
                    else pkg_env.CartPoleEnv())

        def act(obs):
            lean = lambda o: int(o[2] + 0.1 * o[3] > 0)  # noqa: E731
            return ({a: lean(o) for a, o in obs.items()} if multi
                    else lean(obs))

        n = []
        out.append(algo._eval_episodes(act, 3, seed_base=7,
                                       on_reset=lambda: n.append(1)))
        resets.append(len(n))
    assert out[1] == out[0]
    assert resets == [3, 3]


def _slateq_pair(**over):
    """A JAX and a port SlateQ from one config, the port's online and
    target nets loaded from the JAX algorithm's (a target apart from
    the online params)."""
    cfg = dict(seed=0, **over)
    ja = JSQ.SlateQConfig().training(**cfg).build()
    ja.target_params = _numpy_tree(ja.params, 9)
    ta = TSQ.SlateQConfig().training(**cfg).resources(device="cpu").build()
    _load(ta.model, ja.params)
    _load(ta.target_model, ja.target_params)
    return ja, ta


@pytest.mark.parametrize("algo", ["SlateQ", "R2D2"])
def test_checkpoint_round_trip(algo):
    """``save_checkpoint`` after updates, ``load_checkpoint`` into a
    fresh algorithm: online and target params, Adam's state (step,
    moments) and the counters restored exactly; the checkpoint is host
    numpy (params) and host tensors (Adam)."""
    if algo == "SlateQ":
        cfg = TSQ.SlateQConfig().training(
            rollout_fragment_length=32, train_batch_size=16,
            learning_starts=32, target_network_update_freq=1000)
    else:
        cfg = TR.R2D2Config().environment("CartPole-v1").training(
            lstm_size=8, agent_hidden=8, seq_len=6, burn_in=1,
            train_batch_size=4, learning_starts=20,
            rollout_fragment_length=32, target_network_update_freq=1000)
    cfg.resources(device="cpu").debugging(seed=0)
    a = cfg.build()
    for _ in range(3):
        a.step()
    with torch.no_grad():  # the target apart from the online net
        for p in a.target_model.parameters():
            p.mul_(0.5)
    state = a.save_checkpoint()
    assert all(isinstance(v, np.ndarray) for v in state["params"].values())
    fresh = cfg.build()
    fresh.load_checkpoint(state)
    for m in ("model", "target_model"):
        want, got = weights_of(getattr(a, m)), weights_of(getattr(fresh, m))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    sa, sf = a.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sf["param_groups"]
    assert set(sa["state"]) == set(sf["state"]) and sa["state"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(sf["state"][i][k], v), (i, k)
    assert (fresh._iteration, fresh._timesteps_total) == (3, 96)


# ---- bandits ----


@pytest.mark.parametrize("kind", ["LinUCB", "LinTS"])
def test_bandit_steps_match_jax(kind):
    """15 ``step()``s at the JAX oracle's config (4 features, 3 arms,
    payoff seed 7): each step's batch (contexts, actions, rewards), the
    results and the sufficient statistics A, b bit-equal; a checkpoint
    round trip keeps them."""
    seen = {"jax": [], "port": []}
    algos = []
    for side, mod in (("jax", JB), ("port", TB)):
        algo = (getattr(mod, f"Bandit{kind}Config")()
                .environment(mod.LinearDiscreteBanditEnv,
                             env_config={"feature_dim": 4, "num_arms": 3,
                                         "payoff_seed": 7})
                .debugging(seed=0).build())
        pol = algo.get_policy()
        learn = pol.learn_on_batch

        def record(batch, learn=learn, side=side):
            seen[side].append({k: np.array(batch[k]) for k in (
                "obs", "actions", "rewards")})
            return learn(batch)

        pol.learn_on_batch = record
        results = [algo.step() for _ in range(15)]
        algos.append((algo, results))
    (ja, jres), (ta, tres) = algos
    for jr, tr in zip(jres, tres):
        for k in ("learner/mean_reward", "learner/arms_pulled",
                  "num_env_steps_sampled_this_iter", "timesteps_total"):
            assert tr[k] == jr[k], k
    assert np.mean([r["learner/mean_reward"] for r in tres[-5:]]) > 0.5
    for jb, tb in zip(seen["jax"], seen["port"]):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    jp, tp = ja.get_policy(), ta.get_policy()
    np.testing.assert_array_equal(tp.A, jp.A)
    np.testing.assert_array_equal(tp.b, jp.b)
    state = ta.save_checkpoint()
    A = tp.A.copy()
    tp.A[:] = 0
    ta.load_checkpoint(state)
    np.testing.assert_array_equal(ta.get_policy().A, A)
    ja.cleanup()
    ta.cleanup()


def test_bandits_need_no_card():
    """The bandits are host numpy: they build with the default
    ``device`` ("cuda") where there is no card, and ``bench.bandit_loop``
    runs on the host."""
    assert TB.BanditLinUCBConfig().to_dict()["device"] == "cuda"
    TB.BanditLinTSConfig().debugging(seed=0).build().cleanup()
    out = bench.bandit_loop(timed=2)
    for name in ("linucb", "lints"):
        assert out[f"bandit_{name}_arms"] == 4
        assert out[f"bandit_{name}_env_steps_per_sec"] > 0


# ---- SlateQ ----


def test_interest_evolution_env_and_slates_match_jax():
    """The simulator's trajectories under random slates (clicks, drifts,
    horizon) and ``_build_slate`` on shared q-values: bit-equal."""
    cfg = {"num_docs": 12, "slate_size": 4, "doc_seed": 3}
    je, te = JSQ.InterestEvolutionEnv(cfg), TSQ.InterestEvolutionEnv(cfg)
    np.testing.assert_array_equal(te.doc_topics, je.doc_topics)
    np.testing.assert_array_equal(te.doc_quality, je.doc_quality)
    rng = np.random.default_rng(0)
    for ep in range(3):
        jo, _ = je.reset(seed=ep)
        to, _ = te.reset(seed=ep)
        np.testing.assert_array_equal(to, jo)
        for _ in range(je.horizon):
            slate = rng.choice(12, 4, replace=False)
            jr, tr = je.step(slate), te.step(slate)
            np.testing.assert_array_equal(tr[0], jr[0])
            assert tr[1:] == jr[1:]
            np.testing.assert_array_equal(te.choice_scores(tr[0]),
                                          je.choice_scores(jr[0]))
    ja, ta = _slateq_pair()
    obs, _ = ja.env.reset(seed=1)
    for q in (np.linspace(-1, 2, 20, dtype=np.float32),
              rng.standard_normal(20).astype(np.float32)):
        slate = ta._build_slate(q, obs)
        np.testing.assert_array_equal(slate, ja._build_slate(q, obs))
        want = np.argsort(-(ta.env.choice_scores(obs) * np.maximum(q, 0)))
        np.testing.assert_array_equal(slate, want[:3])


def test_slateq_collect_and_update_match_jax():
    """The SARSA collector at epsilon 0.5 from shared params (greedy
    slates through the nets): the replay's rows bit-equal; then one
    update on a batch drawn from both replays (bit-equal draws): loss,
    stats and the new params within F32 of scale."""
    ja, ta = _slateq_pair()
    for eps in (1.0, 0.5):
        assert ta._collect(60, eps) == ja._collect(60, eps)
    assert set(ta.replay._cols) == set(ja.replay._cols)
    for k, col in ja.replay._cols.items():
        np.testing.assert_array_equal(ta.replay._cols[k], col)
    jb, tb = ja.replay.sample(32), ta.replay.sample(32)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    assert 0 < float(np.mean(tb["clicked"] >= 0)) < 1
    params, _, jstats = ja._jit_update(
        ja.params, ja.target_params, ja.opt_state,
        {k: jnp.asarray(v) for k, v in jb.items()})
    tstats = {k: float(v) for k, v in ta._update(tb).items()}
    assert set(tstats) == set(jstats)
    for k in jstats:
        _close(tstats[k], float(jstats[k]), F32, k)
    _close_tree(weights_of(ta.model), params, "params")


def test_slateq_steps_and_defaults():
    """The default config equals JAX's (the port adds only ``device``);
    bench.slateq_loop's CPU run learns past ``learning_starts``: finite
    losses, weights that moved, epsilon falling, a target sync equal to
    the online net, no launches; the exports."""
    jd, td = JSQ.SlateQConfig().to_dict(), TSQ.SlateQConfig().to_dict()
    assert td.pop("device") == "cuda"
    assert td == jd
    phases = []
    r = bench.slateq_loop(device="cpu", timed=2,
                          profile=lambda learn: phases.append(learn()))
    assert r["slateq_num_docs"] == 20 and r["slateq_slate_size"] == 3
    assert r["slateq_losses_finite"] and r["slateq_weights_moved"] > 0
    assert r["slateq_epsilon"][1] < r["slateq_epsilon"][0]
    assert r["slateq_replay_size"][1] > r["slateq_replay_size"][0]
    assert r["slateq_target_syncs"] >= 1
    assert r["slateq_target_equals_online_after_sync"] is True
    assert r["slateq_launches"] == {} and "loss" in phases[0]
    from ray_tpu.rllib import algorithms as JALG
    from ray_tpu_torch.rllib import algorithms as TALG
    names = ("BanditLinUCB", "BanditLinTS", "SlateQ", "R2D2", "DT")
    for name in names + tuple(f"{n}Config" for n in names):
        assert name in JALG.__all__ and name in TALG.__all__, name
        assert getattr(TR, name) is getattr(TALG, name)
    assert TR.LocalAlgorithm is TALGO.LocalAlgorithm
