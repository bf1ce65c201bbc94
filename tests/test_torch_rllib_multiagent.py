"""The port's cooperative multi-agent algorithms (``ray_tpu_torch.rllib``:
QMIX, MADDPG) and the converter of agent-stacked flax trees, against
the JAX package's, on the CPU.

Numpy draws (the envs, epsilon, the warm-up and exploration noise, the
replay) are held bit-equal. QMIX's params cross with
``models.params_from_flax``; MADDPG's per-agent actors and critics,
stacked on a leading agent axis as in JAX, with
``models.stacked_params_from_flax``; both load with no key left over.
f32 values are held within F32 * (1 + max |JAX value|). The JAX
optimizer is chained around a transformation that keeps the grads it is
handed in its state (before and after the clip). The JAX algorithms are
built by their own setup, with their flax nets' ``init`` drawing the
params from numpy on flax's shapes (``eval_shape``: nothing compiles);
two threads.
"""

import functools

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib import env as JE
from ray_tpu.rllib.algorithms import maddpg as JMD
from ray_tpu.rllib.algorithms import qmix as JQ
from ray_tpu_torch import bench
from ray_tpu_torch import rllib as TR
from ray_tpu_torch.rllib import env as TE
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib.algorithms import maddpg as TMD
from ray_tpu_torch.rllib.algorithms import qmix as TQ
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


def _close(got, want, tol=F32, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = 1.0 + float(np.max(np.abs(want))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _close_sd(got_sd, want_sd, what=""):
    assert set(got_sd) == set(want_sd), (sorted(got_sd), sorted(want_sd))
    for k, w in want_sd.items():
        _close(got_sd[k], w.numpy(), F32, f"{what} {k}")


def _recording():
    """An optax transformation that passes the updates through and keeps
    them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _numpy_tree(tree, seed):
    """A tree of ``tree``'s shapes from numpy: kernels of variance
    1 / fan_in (their axis -2: stacked kernels too), the rest
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        scale = (1 / np.sqrt(leaf.shape[-2]) if path[-1].key == "kernel"
                 else 0.1)
        return jnp.asarray(scale * rng.standard_normal(leaf.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _shaped(module, *dummy, seed=0):
    """``module``'s params tree from numpy on flax's shapes."""
    shapes = jax.eval_shape(functools.partial(fnn.Module.init, module),
                            jax.random.PRNGKey(0), *dummy)
    return _numpy_tree(shapes["params"], seed)


@pytest.fixture(autouse=True, scope="module")
def _numpy_init():
    """The JAX algorithms' nets draw their params from numpy
    (``_shaped``) while this file runs."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JQ._AgentQNet, JQ._QMixer, JMD._Actor,
                    JMD._CentralCritic):
            mp.setattr(cls, "init", lambda self, rng, *dummy: {
                "params": _shaped(self, *dummy)})
        yield


def _load(model, tree, stacked=False):
    """A JAX tree into ``model``, strictly: no key left over on either
    side."""
    convert = (TM.stacked_params_from_flax if stacked
               else TM.params_from_flax)
    sd = convert(jax.device_get(tree))
    assert set(sd) == set(model.state_dict()), (
        sorted(set(sd) ^ set(model.state_dict())))
    model.load_state_dict(sd)
    return model


# ---- the converters ----


def _maddpg_tree(n, seed):
    """MADDPG's params for ``n`` agents: each agent's actor and critic
    drawn apart, then stacked on a leading axis as JAX's setup does."""
    per_agent = [{
        "actor": _shaped(JMD._Actor(1), jnp.zeros((1, 1)), seed=seed + i),
        "critic": _shaped(JMD._CentralCritic(), jnp.zeros((1, n)),
                          jnp.zeros((1, n)), seed=seed + 100 + i)}
        for i in range(n)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_agent)


@pytest.mark.parametrize("algo", ["MADDPG", "MBMPO"])
def test_stacked_converter_loads_stacked_trees(algo):
    """MADDPG's agent-stacked actors and critics (3 agents) and MBMPO's
    vmapped ensemble (4 members, whose Dense_0 kernel (4, 4, 64) with
    bias (4, 64) is also a valid DenseGeneral layout): every key loads,
    each stacked weight is flax's [m, in, out] as it stands, and slice m
    computes what JAX's member m computes, alone (``member``) and in the
    batched forward. A flat tree is refused."""
    from ray_tpu.rllib.algorithms import mbmpo as JMB
    from ray_tpu_torch.rllib.algorithms import mbmpo as TMB
    rng = np.random.default_rng(0)
    if algo == "MADDPG":
        n = 3
        tree = _maddpg_tree(n, 0)
        nets = _load(TMD._MADDPGNets(n, 1, 1), tree, stacked=True)
        cases = [(JMD._Actor(1), tree["actor"], nets.actor, 1),
                 (JMD._CentralCritic(), tree["critic"], nets.critic, 2 * n)]
    else:
        n = 4
        model = JMB._DynamicsModel(2)
        keys = jax.random.split(jax.random.PRNGKey(0), n)
        shapes = jax.eval_shape(jax.vmap(lambda k: model.init(
            k, jnp.zeros((1, 2)), jnp.zeros((1, 2)))), keys)
        tree = _numpy_tree(shapes["params"], 3)
        assert tree["Dense_0"]["kernel"].shape == (4, 4, 64)
        dyn = _load(TMB._DynamicsModel(n, 2, 2), tree, stacked=True)
        cases = [(model, tree, dyn, 4)]
    for module, sub, port, width in cases:
        np.testing.assert_array_equal(
            port.Dense_0.weight.detach().numpy(),
            np.asarray(sub["Dense_0"]["kernel"]))
        x = rng.standard_normal((n, 5, width)).astype(np.float32)
        batched = port(torch.from_numpy(x))
        for m in range(n):
            one = jax.tree_util.tree_map(lambda v: v[m], sub)
            args = ((x[m][:, :width // 2], x[m][:, width // 2:])
                    if width > 1 else (x[m],))
            want = np.asarray(module.apply({"params": one}, *args))
            if want.ndim == 1:
                want = want[:, None]
            _close(port.member(m, torch.from_numpy(x[m])), want, F32,
                   f"member {m}")
            _close(batched[m], want, F32, f"batched {m}")
    flat = _shaped(JQ._AgentQNet(2), jnp.zeros((1, 4)))
    with pytest.raises(ValueError, match="not stacked"):
        TM.stacked_params_from_flax(jax.device_get(flat))


def _plain_rule(tree, prefix=""):
    """``params_from_flax``'s documented rule, written out: Dense kernels
    [in..., out...] -> [prod(out), prod(in)] with the bias's axes as the
    out axes (one out axis without a bias), conv kernels HWIO -> OIHW,
    ``layers_{i}`` -> ``{i}``, ``scale``/``embedding`` -> ``weight``."""
    out = {}
    for name, v in tree.items():
        key = prefix + name.replace("layers_", "")
        if isinstance(v, dict) and "kernel" in v:
            k = np.asarray(v["kernel"], np.float32)
            if k.ndim == 4:
                w = k.transpose(3, 2, 0, 1)
            else:
                n_out = np.ndim(v["bias"]) if "bias" in v else 1
                n_in = int(np.prod(k.shape[:k.ndim - n_out]))
                w = k.reshape(n_in, -1).T
            out[f"{key}.weight"] = np.array(w, order="C")
            if "bias" in v:
                out[f"{key}.bias"] = np.array(v["bias"],
                                              np.float32).reshape(-1)
        elif isinstance(v, dict):
            out.update(_plain_rule(v, key + "."))
        else:
            name = {"scale": "weight", "embedding": "weight"}.get(name, name)
            out[prefix + name.replace("layers_", "")] = np.array(
                v, np.float32)
    return out


def test_params_from_flax_keeps_earlier_trees_byte_equal():
    """The trees PRs 11-14's algorithms convert (MLPNet, AtariCNN, SAC's
    ``layers_{i}``, R2D2's LSTM, DT's attention and norms, SlateQ) and
    QMIX's nested tree come out byte-equal to the documented rule, and
    load into the port's nets with no key left over."""
    from ray_tpu.rllib import models as JM
    from ray_tpu.rllib.algorithms import dt as JDT
    from ray_tpu.rllib.algorithms import r2d2 as JR2
    from ray_tpu.rllib.algorithms import sac as JSAC
    from ray_tpu.rllib.algorithms import slateq as JSQ
    from ray_tpu_torch.rllib.algorithms import dt as TDT
    from ray_tpu_torch.rllib.algorithms import r2d2 as TR2
    from ray_tpu_torch.rllib.algorithms import sac as TSAC
    from ray_tpu_torch.rllib.algorithms import slateq as TSQ

    qmix = {"agent": _shaped(JQ._AgentQNet(2), jnp.zeros((1, 4))),
            "mixer": _shaped(JQ._QMixer(2), jnp.zeros((1, 2)),
                             jnp.zeros((1, 8)))}
    trees = [
        (_shaped(JM.MLPNet(2, (8, 8), free_log_std=True),
                 jnp.zeros((1, 3))), None),
        (_shaped(JM.AtariCNN(3), jnp.zeros((1, 21, 21, 2))), None),
        (_shaped(JSAC._SACNets(2, 8), jnp.zeros((1, 3)), jnp.zeros((1, 2))),
         TSAC._SACNets(3, 2, 8)),
        (_shaped(JR2._RecurrentQNet(2, 8, 8), jnp.zeros((1, 3, 4))),
         TR2._RecurrentQNet(4, 2, 8, 8)),
        (_shaped(JDT._DTNet(4, 2, 4, 16, 2, 1), jnp.zeros((1, 4, 1)),
                 jnp.zeros((1, 4, 4)), jnp.zeros((1, 4), jnp.int32),
                 jnp.zeros((1, 4), jnp.int32)),
         TDT._DTNet(4, 2, 4, 16, 2, 1)),
        (_shaped(JSQ._ItemQNet(5, 8), jnp.zeros((1, 3))),
         TSQ._ItemQNet(3, 5, 8)),
        (qmix, TQ._QMixNets(4, 2, 2)),
    ]
    for tree, port in trees:
        tree = jax.device_get(tree)
        got, want = TM.params_from_flax(tree), _plain_rule(tree)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        if port is not None:
            assert set(got) == set(port.state_dict())


# ---- QMIX ----


def test_coop_cartpole_matches_jax():
    """CooperativeCartPole (3 agents) under random joint actions over
    several seeded episodes: observations, team rewards and the
    any-pole-falls termination bit-equal; both registered by name."""
    je = JE.make_env("CoopCartPole", {"num_agents": 3})
    te = TE.make_env("CoopCartPole", {"num_agents": 3})
    assert isinstance(te, TQ.CooperativeCartPole)
    rng = np.random.default_rng(0)
    ends = 0
    for ep in range(4):
        jo, _ = je.reset(seed=ep)
        to, _ = te.reset(seed=ep)
        for a in jo:
            np.testing.assert_array_equal(to[a], jo[a])
        done = False
        while not done:
            acts = {a: int(rng.integers(2)) for a in je.agent_ids}
            jr, tr = je.step(acts), te.step(acts)
            for j, t in zip(jr, tr):
                assert set(t) == set(j)
                for a in j:
                    np.testing.assert_array_equal(t[a], j[a])
            done = jr[2]["__all__"] or jr[3]["__all__"]
        ends += 1
    assert ends == 4


def _qmix_pair(**over):
    """A JAX and a port QMIX from one config (2 agents), the port's
    online and target nets loaded from the JAX algorithm's (a target
    apart from the online params)."""
    cfg = dict(seed=0, **over)
    ja = (JQ.QMixConfig().environment("CoopCartPole",
                                      env_config={"num_agents": 2})
          .training(**cfg).build())
    ja.target_params = _numpy_tree(ja.params, 9)
    ta = (TQ.QMixConfig().environment("CoopCartPole",
                                      env_config={"num_agents": 2})
          .training(**cfg).resources(device="cpu").build())
    _load(ta.model, ja.params)
    _load(ta.target_model, ja.target_params)
    return ja, ta


def test_qmix_collect_joint_matches_jax():
    """``_collect`` at epsilon 1, 0.5 and 0 from shared params (greedy
    joint actions through the agent nets): the replay's rows, the
    episode rewards and the numpy stream bit-equal; greedy deployment
    actions equal."""
    ja, ta = _qmix_pair()
    for eps in (1.0, 0.5, 0.0):
        assert ta._collect(80, eps) == ja._collect(80, eps) == 80
    assert set(ta.replay._cols) == set(ja.replay._cols)
    for k, col in ja.replay._cols.items():
        assert ta.replay._cols[k].dtype == col.dtype, k
        np.testing.assert_array_equal(ta.replay._cols[k], col)
    assert ta._episode_reward_window == ja._episode_reward_window
    assert ta._np_rng.random() == ja._np_rng.random()
    obs = {a: np.full(4, 0.1 * i, np.float32)
           for i, a in enumerate(ja.agent_ids)}
    assert ta.compute_joint_actions(obs) == ja.compute_joint_actions(obs)


def test_qmix_mixer_matches_jax_and_is_monotonic():
    """The mixer (3 agents, embedding 16) on seeded Q-values and states:
    Q_tot within F32 of JAX's, and ∂Q_tot/∂Q_i ≥ 0 for every agent and
    row (the counterpart of ``test_qmix_mixer_is_monotonic``), equal to
    JAX's gradient within F32."""
    mixer = JQ._QMixer(n_agents=3, embed=16)
    params = _shaped(mixer, jnp.zeros((1, 3)), jnp.zeros((1, 12)), seed=4)
    rng = np.random.default_rng(1)
    qs = rng.standard_normal((8, 3)).astype(np.float32)
    state = rng.standard_normal((8, 12)).astype(np.float32)
    want = np.asarray(mixer.apply({"params": params}, qs, state))
    jgrad = np.asarray(jax.vmap(jax.grad(lambda q, s: mixer.apply(
        {"params": params}, q[None], s[None])[0]))(qs, state))
    port = _load(TQ._QMixer(3, 12, 16), params)
    tq = torch.from_numpy(qs).requires_grad_()
    got = port(tq, torch.from_numpy(state))
    _close(got, want, F32, "q_tot")
    got.sum().backward()
    assert (tq.grad >= 0).all(), tq.grad.min()
    _close(tq.grad, jgrad, F32, "dq_tot/dq_i")


def _qmix_batch(seed=2, b=64, n=2, reward_scale=1.0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((b, n, 4)).astype(np.float32),
            "next_obs": rng.standard_normal((b, n, 4)).astype(np.float32),
            "actions": rng.integers(2, size=(b, n)).astype(np.int64),
            "rewards": (reward_scale * rng.standard_normal(b)
                        ).astype(np.float32),
            "dones": rng.random(b) < 0.2}


@pytest.mark.parametrize("double_q,param_scale", [(True, 1.0),
                                                  (False, 0.3)])
def test_qmix_update_matches_jax(double_q, param_scale):
    """One update on a fixed batch from shared params and a target apart
    from them: loss and stats, the grads after the ONE clip over agent
    and mixer (active at the drawn params: the norm passes 10; not with
    every param x 0.3), the new params within F32 of scale."""
    ja, ta = _qmix_pair(double_q=double_q)
    for name in ("params", "target_params"):
        setattr(ja, name, jax.tree_util.tree_map(
            lambda v: v * param_scale, getattr(ja, name)))
    _load(ta.model, ja.params)
    _load(ta.target_model, ja.target_params)
    ja.optimizer = optax.chain(optax.clip_by_global_norm(10.0), _recording(),
                               optax.adam(ja.config["lr"]))
    ja.opt_state = ja.optimizer.init(ja.params)
    batch = _qmix_batch(reward_scale=0.1)
    params, opt_state, jstats = jax.jit(ja._update_impl)(
        ja.params, ja.target_params, ja.opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()})
    tstats = {k: float(v) for k, v in ta._update(batch).items()}
    assert set(tstats) == set(jstats)
    for k in jstats:
        _close(tstats[k], float(jstats[k]), F32, k)
    jgrads = jax.device_get(opt_state[1])
    gnorm = float(optax.global_norm(jgrads))
    assert (gnorm == pytest.approx(10.0, rel=1e-5)) == (param_scale == 1)
    _close_sd({n: p.grad for n, p in ta.model.named_parameters()},
              TM.params_from_flax(jgrads), "clipped grads")
    _close_sd(weights_of(ta.model), TM.params_from_flax(
        jax.device_get(params)), "params")


def test_qmix_steps_match_jax_and_checkpoint_round_trips():
    """Three whole ``step()``s past ``learning_starts`` (epsilon from 1
    to 0.5 over 128 steps, so greedy actions run too; a target sync
    every 64 steps): the numpy draws agree, so the replays are
    bit-equal; the results, params and target within F32 of scale.
    Then a checkpoint round trip into a fresh port QMIX is exact."""
    over = dict(learning_starts=64, train_batch_size=16,
                rollout_fragment_length=64, epsilon_timesteps=128,
                final_epsilon=0.5, target_network_update_freq=64)
    ja, ta = _qmix_pair(**over)
    for i in range(3):
        jr, tr = ja.step(), ta.step()
        assert set(tr.pop("timers")) == {"sample_time_ms", "replay_time_ms",
                                         "learn_time_ms"}
        for k in ("num_env_steps_sampled_this_iter", "epsilon",
                  "replay_size", "episodes_total"):
            assert jr[k] == tr[k], (i, k)
        for k, v in jr.items():
            if k.startswith("learner/"):
                _close(tr[k], v, F32, f"step {i} {k}")
    assert "learner/loss" in jr
    for k, col in ja.replay._cols.items():
        np.testing.assert_array_equal(ta.replay._cols[k], col)
    _close_sd(weights_of(ta.model), TM.params_from_flax(
        jax.device_get(ja.params)), "params")
    _close_sd(weights_of(ta.target_model), TM.params_from_flax(
        jax.device_get(ja.target_params)), "target")
    state = ta.save_checkpoint()
    fresh = (TQ.QMixConfig().environment("CoopCartPole",
                                         env_config={"num_agents": 2})
             .training(seed=0, **over).resources(device="cpu").build())
    fresh.load_checkpoint(state)
    for m in ("model", "target_model"):
        want, got = weights_of(getattr(ta, m)), weights_of(getattr(fresh, m))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    sa, sf = ta.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["state"] and sa["param_groups"] == sf["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(sf["state"][i][k], v), (i, k)
    assert (fresh._iteration, fresh._timesteps_total) == (3, 192)


# ---- MADDPG ----


def test_target1d_env_and_warmup_collect_match_jax():
    """MultiAgentTarget1D (3 agents) under random velocities: obs, team
    rewards and the horizon bit-equal; then a MADDPG warm-up fragment
    (uniform(-1, 1) joint actions, replay below ``learning_starts``): the
    replay's rows and the episode rewards bit-equal."""
    je = JE.make_env("MultiAgentTarget1D", {"num_agents": 3})
    te = TE.make_env("MultiAgentTarget1D", {"num_agents": 3})
    rng = np.random.default_rng(0)
    for ep in range(2):
        jo, _ = je.reset(seed=ep)
        to, _ = te.reset(seed=ep)
        for a in jo:
            np.testing.assert_array_equal(to[a], jo[a])
        for _ in range(te.HORIZON):
            acts = {a: rng.uniform(-1.5, 1.5, 1).astype(np.float32)
                    for a in je.agent_ids}
            jr, tr = je.step(acts), te.step(acts)
            for j, t in zip(jr, tr):
                for a in j:
                    np.testing.assert_array_equal(t[a], j[a])
        assert tr[3]["__all__"]
    ja, ta = _maddpg_pair()
    for _ in range(2):
        assert ta._collect(40, 0.3) == ja._collect(40, 0.3) == 40
    for k, col in ja.replay._cols.items():
        assert ta.replay._cols[k].dtype == col.dtype, k
        np.testing.assert_array_equal(ta.replay._cols[k], col)
    assert ta._episode_reward_window == ja._episode_reward_window


def _maddpg_pair(n=2, **over):
    """A JAX and a port MADDPG (``n`` agents) from one config, the JAX
    params drawn per agent and stacked, the target apart from them; the
    port's nets loaded with the stacked converter."""
    cfg = dict(seed=0, **over)
    ja = (JMD.MADDPGConfig().environment("MultiAgentTarget1D",
                                         env_config={"num_agents": n})
          .training(**cfg).build())
    ja.params = _maddpg_tree(n, 0)
    ja.target_params = _maddpg_tree(n, 50)
    ja.opt_state = ja.optimizer.init(ja.params)
    ta = (TMD.MADDPGConfig().environment("MultiAgentTarget1D",
                                         env_config={"num_agents": n})
          .training(**cfg).resources(device="cpu").build())
    _load(ta.model, ja.params, stacked=True)
    _load(ta.target_model, ja.target_params, stacked=True)
    return ja, ta


def test_maddpg_noisy_actions_match_jax():
    """Past the warm-up: the actors' forward (stacked) then
    ``normal(0, 0.3)`` clipped: the raw tanh-space actions within F32 of
    JAX's and the scaled ones sent to the env likewise, the numpy stream
    in step; at noise 0, the deterministic actions."""
    ja, ta = _maddpg_pair(n=3)
    rng = np.random.default_rng(5)
    for noise in (0.3, 0.0):
        for _ in range(5):
            obs = {a: rng.uniform(-2, 2, 1).astype(np.float32)
                   for a in ja.agent_ids}
            (jd, jraw), (td, traw) = (ja._joint_actions(obs, noise),
                                      ta._joint_actions(obs, noise))
            _close(traw, jraw, F32, "raw")
            for a in jd:
                _close(td[a], jd[a], F32, "scaled")
            assert ta._np_rng.random() == ja._np_rng.random()


def _maddpg_batch(seed=3, b=32, n=2, reward_scale=1.0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.uniform(-2, 2, (b, n, 1)).astype(np.float32),
            "next_obs": rng.uniform(-2, 2, (b, n, 1)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (b, n, 1)).astype(np.float32),
            "rewards": (reward_scale * rng.standard_normal(b)
                        ).astype(np.float32),
            "dones": rng.random(b) < 0.2}


def _label_state(opt_state, label, i):
    """The ``i``-th state of ``label``'s chain in optax's
    ``multi_transform`` state."""
    return opt_state.inner_states[label].inner_state[i]


@pytest.mark.parametrize("reward_scale", [30.0, 1.0])
def test_maddpg_update_matches_jax(reward_scale):
    """One update (3 agents) on a fixed batch from shared stacked params
    and a target apart from them: critic, actor and total loss, mean Q;
    the two joint clip norms (one over all actors, one over all critics;
    the critics' passes 10 with rewards x 30); the clipped grads, the new
    params and the Polyak targets within F32 of scale."""
    ja, ta = _maddpg_pair(n=3)
    lab = {"actor": "actor", "critic": "critic"}
    ja.optimizer = optax.multi_transform(
        {k: optax.chain(_recording(), optax.clip_by_global_norm(10.0),
                        _recording(), optax.adam(ja.config[f"{k}_lr"]))
         for k in lab}, param_labels=lab)
    ja.opt_state = ja.optimizer.init(ja.params)
    batch = _maddpg_batch(n=3, reward_scale=reward_scale)
    params, target, opt_state, jstats = jax.jit(ja._update_impl)(
        ja.params, ja.target_params, ja.opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()})
    tstats = {k: float(v) for k, v in ta._update(batch).items()}
    for k in jstats:
        _close(tstats[k], float(jstats[k]), F32, k)
    for label in lab:
        raw = jax.device_get(_label_state(opt_state, label, 0)[label])
        norm = float(optax.global_norm(raw))
        _close(tstats[f"{label}_grad_norm"], norm, F32, f"{label} norm")
        clipped = jax.device_get(_label_state(opt_state, label, 2)[label])
        _close_sd({n: p.grad for n, p in
                   getattr(ta.model, label).named_parameters()},
                  TM.stacked_params_from_flax(clipped), f"{label} grads")
    assert (tstats["critic_grad_norm"] > 10) == (reward_scale > 1)
    want = TM.stacked_params_from_flax(jax.device_get(params))
    _close_sd(weights_of(ta.model), want, "params")
    _close_sd(weights_of(ta.target_model),
              TM.stacked_params_from_flax(jax.device_get(target)), "target")


def test_maddpg_critic_gets_no_gradient_from_actor_loss():
    """The actor loss reaches the critics' params not at all (they are
    detached) and each actor only through its own slot: the update's
    critic grads equal those of the critic loss alone, and the actor
    loss by itself leaves every critic grad empty and gives actor i a
    grad that does not depend on the other agents' actors."""
    ja, ta = _maddpg_pair(n=3)
    batch = _maddpg_batch(n=3)
    nets, tnets = ta.model, ta.target_model
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    state = b["obs"].reshape(32, -1)
    with torch.no_grad():
        na = tnets.actor(b["next_obs"].transpose(0, 1)).transpose(0, 1)
        y = (b["rewards"] + 0.99 * (1.0 - b["dones"].float())
             * tnets.q(b["next_obs"].reshape(32, -1), na.reshape(32, -1)))
    critic_loss = torch.mean((nets.q(state, b["actions"].reshape(32, -1))
                              - y) ** 2)
    want = torch.autograd.grad(critic_loss, list(nets.critic.parameters()))
    own = nets.actor(b["obs"].transpose(0, 1))
    eye = torch.eye(3)[:, None, :, None]
    mixed = b["actions"][None] * (1 - eye) + own[:, :, None, :] * eye
    actor_loss = -torch.mean(nets.q(state.expand(3, *state.shape),
                                    mixed.reshape(3, 32, -1), detach=True))
    actor_loss.backward()
    assert all(p.grad is None for p in nets.critic.parameters())
    g0 = [p.grad.clone() for p in nets.actor.parameters()]
    with torch.no_grad():  # another agent's actor changes
        nets.actor.Dense_0.weight[1].mul_(3.0)
    nets.zero_grad(set_to_none=True)
    own = nets.actor(b["obs"].transpose(0, 1))
    mixed = b["actions"][None] * (1 - eye) + own[:, :, None, :] * eye
    (-torch.mean(nets.q(state.expand(3, *state.shape),
                        mixed.reshape(3, 32, -1), detach=True))).backward()
    for p, g in zip(nets.actor.parameters(), g0):
        torch.testing.assert_close(p.grad[0], g[0], rtol=0, atol=0)
        torch.testing.assert_close(p.grad[2], g[2], rtol=0, atol=0)
    with torch.no_grad():
        nets.actor.Dense_0.weight[1].div_(3.0)
    ta._update(batch)
    norm = torch.nn.utils.get_total_norm(want)
    scale = min(1.0, 10.0 / float(norm))
    for p, g in zip(nets.critic.parameters(), want):
        _close(p.grad, (g * scale).numpy(), F32, "critic grad")


def test_defaults_exports_and_bench_loops():
    """The default configs equal JAX's (the port adds only ``device``),
    the nets build on ``config["device"]`` ("cuda" by default); the
    exports; bench.qmix_loop's and maddpg_loop's CPU runs learn past
    ``learning_starts``: finite losses, weights that moved, replays that
    grew, QMIX's epsilon falling and its target synced equal to the
    online net, MADDPG's targets moved by Polyak, no launches."""
    for jc, tc in ((JQ.QMixConfig, TQ.QMixConfig),
                   (JMD.MADDPGConfig, TMD.MADDPGConfig)):
        jd, td = jc().to_dict(), tc().to_dict()
        assert td.pop("device") == "cuda"
        assert td == jd
    from ray_tpu.rllib import algorithms as JALG
    from ray_tpu_torch.rllib import algorithms as TALG
    names = ("QMix", "MADDPG", "MAML", "MBMPO")
    for name in names + tuple(f"{n}Config" for n in names):
        assert name in JALG.__all__ and name in TALG.__all__, name
        assert getattr(TR, name) is getattr(TALG, name)
    phases = []
    q = bench.qmix_loop(device="cpu", timed=2,
                        profile=lambda learn: phases.append(learn()))
    assert q["qmix_agents"] == 2 and q["qmix_agent_hidden"] == 64
    assert q["qmix_losses_finite"] and q["qmix_weights_moved"] > 0
    assert q["qmix_replay_size"][1] > q["qmix_replay_size"][0]
    assert q["qmix_epsilon"][1] < q["qmix_epsilon"][0]
    assert q["qmix_target_syncs"] >= 1
    assert q["qmix_target_equals_online_after_sync"] is True
    m = bench.maddpg_loop(device="cpu", timed=2,
                          profile=lambda learn: phases.append(learn()))
    assert m["maddpg_agents"] == 2 and "maddpg_epsilon" not in m
    assert m["maddpg_losses_finite"] and m["maddpg_weights_moved"] > 0
    assert m["maddpg_replay_size"][1] > m["maddpg_replay_size"][0]
    assert m["maddpg_target_moved"] > 0
    assert q["qmix_launches"] == m["maddpg_launches"] == {}
    assert "loss" in phases[0] and "critic_loss" in phases[1]
