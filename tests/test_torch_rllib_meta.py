"""The port's meta-learning algorithms (``ray_tpu_torch.rllib``: MAML,
MBMPO) against the JAX package's, on the CPU.

Numpy draws (the point-goal env, the tasks, the bootstrap indices) are
held bit-equal. The action and imagination noise that JAX draws from
its keys is computed here from the same keys, in the same order, and
fed to the port. The policy's params cross with
``models.params_from_flax``, MBMPO's ensemble (stacked on a leading
member axis as in JAX) with ``models.stacked_params_from_flax``; both
load with no key left over. f32 values are held within F32 * (1 + max
|JAX value|). The meta-gradient is second order: the MAML test runs at
an inner step where dropping it moves the gradient by far more than the
tolerance. The JAX optimizer is chained around a transformation that
keeps the grads it is handed in its state. The JAX algorithms are built
by their own setup, with their flax nets' ``init`` drawing the params
from numpy on flax's shapes (``eval_shape``: nothing compiles); JAX
compiles its meta-update over every task, so the tests use 2 tasks or
members; two threads.
"""

import functools

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import maml as JMA
from ray_tpu.rllib.algorithms import mbmpo as JMB
from ray_tpu_torch import bench
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib.algorithms import maml as TMA
from ray_tpu_torch.rllib.algorithms import mbmpo as TMB
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
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(
        got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = 1.0 + float(np.max(np.abs(want))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _gap(got, want) -> float:
    """max |got - want| over 1 + max |want|, worst over a state dict."""
    return max(float(np.max(np.abs(got[k].detach().numpy() - w.numpy())))
               / (1 + float(np.max(np.abs(w.numpy()))))
               for k, w in want.items())


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


def _numpy_tree(tree, seed, scale=1.0):
    """A tree of ``tree``'s shapes from numpy: kernels of variance
    scale² / fan_in (their axis -2: stacked kernels too), the rest
    N(0, (0.1 scale)²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        s = (1 / np.sqrt(leaf.shape[-2]) if path[-1].key == "kernel"
             else 0.1)
        return jnp.asarray(scale * s * rng.standard_normal(leaf.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _shaped(module, *dummy, seed=0):
    shapes = jax.eval_shape(functools.partial(fnn.Module.init, module),
                            jax.random.PRNGKey(0), *dummy)
    return _numpy_tree(shapes["params"], seed)


@pytest.fixture(autouse=True, scope="module")
def _numpy_init():
    """The JAX algorithms' nets draw their params from numpy
    (``_shaped``) while this file runs; under MBMPO's ``vmap`` every
    member gets the same draw (the tests draw the ensemble apart)."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JMA._GaussianPolicy, JMB._DynamicsModel):
            mp.setattr(cls, "init", lambda self, rng, *dummy: {
                "params": _shaped(self, *dummy)})
        yield


def _load(model, tree, stacked=False):
    """A JAX tree into ``model``, strictly: no key left over."""
    convert = (TM.stacked_params_from_flax if stacked
               else TM.params_from_flax)
    sd = convert(jax.device_get(tree))
    assert set(sd) == set(model.state_dict()), (
        sorted(set(sd) ^ set(model.state_dict())))
    model.load_state_dict(sd)
    return model


def _sd(tree, stacked=False):
    convert = (TM.stacked_params_from_flax if stacked
               else TM.params_from_flax)
    return convert(jax.device_get(tree))


class _JaxKeys:
    """The subkeys a JAX algorithm's ``_next_key`` will hand out, in
    order, from a copy of its key (the algorithm's own is untouched)."""

    def __init__(self, algo):
        self.key = algo._rng

    def next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def act_noise(self, episodes, steps, act_dim=2):
        """One (1, act_dim) normal draw a step, as ``act_impl``."""
        return np.stack([[np.asarray(jax.random.normal(
            self.next(), (1, act_dim)))[0] for _ in range(steps)]
            for _ in range(episodes)])

    def imagine_noise(self, T, E, act_dim=2):
        """``_imagine_impl``'s draws: the key split into T, one (E,
        act_dim) normal draw a step."""
        return np.stack([np.asarray(jax.random.normal(k, (E, act_dim)))
                         for k in jax.random.split(self.next(), T)])


def _batch(rng, n, adv_scale=1.0):
    return {"obs": rng.uniform(-2, 2, (n, 2)).astype(np.float32),
            "actions": rng.normal(0, 0.5, (n, 2)).astype(np.float32),
            "advantages": (adv_scale * rng.standard_normal(n)
                           ).astype(np.float32)}


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ---- MAML ----


def test_point_goal_env_and_tasks_match_jax():
    """PointGoalEnv under random actions past the arena's bounds (the
    env clips actions and positions): positions, rewards and the horizon
    bit-equal; ``sample_task`` draws from numpy bit-equal."""
    je, te = JMA.PointGoalEnv({"horizon": 30}), TMA.PointGoalEnv(
        {"horizon": 30})
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        goal = je.sample_task(rj)
        np.testing.assert_array_equal(te.sample_task(rt), goal)
        je.set_task(goal)
        te.set_task(goal)
        jo, to = je.reset()[0], te.reset()[0]
        np.testing.assert_array_equal(to, jo)
        done = False
        while not done:
            a = rj.normal(0, 1.5, 2).astype(np.float32)
            rt.normal(0, 1.5, 2)
            jr, tr = je.step(a), te.step(a)
            np.testing.assert_array_equal(tr[0], jr[0])
            assert tr[1:] == jr[1:]
            done = jr[3]
        assert np.abs(jr[0]).max() <= 2.0


def _maml_pair(**over):
    """A JAX and a port MAML from one config, the port's policy loaded
    from the JAX algorithm's params."""
    cfg = dict(seed=0, **over)
    ja = JMA.MAMLConfig().training(**cfg).build()
    ja.params = _numpy_tree(ja.params, 1)
    ta = TMA.MAMLConfig().training(**cfg).resources(device="cpu").build()
    _load(ta.model, ja.params)
    return ja, ta


def test_maml_collect_task_and_surrogate_match_jax():
    """``_collect_task`` (3 episodes of 20 steps) with JAX's action noise
    fed to the port: the obs, the UNCLIPPED actions and the
    per-timestep-baselined advantages, the mean reward within F32; the
    surrogate (ddof-0 std) and its gradient on that batch within F32;
    the adapted params likewise."""
    ja, ta = _maml_pair(episodes_per_task=3)
    goal = ja.env.sample_task(np.random.default_rng(0))
    noise = _JaxKeys(ja).act_noise(3, 20)
    jb, jrw = ja._collect_task(ja.params, goal)
    tb, trw = ta._collect_task(ta.params, goal, noise=noise)
    for k in ("obs", "actions", "advantages"):
        _close(tb[k], np.asarray(jb[k]), F32, k)
    assert np.abs(np.asarray(jb["actions"])).max() > 1.0  # unclipped
    _close(trw, jrw, F32, "reward")
    jloss, jgrad = jax.value_and_grad(ja._surrogate)(ja.params, jb)
    tp = ta.params
    tloss = TMA.surrogate(ta.model, tp, tb)
    tgrad = torch.autograd.grad(tloss, list(tp.values()))
    _close(tloss, float(jloss), F32, "surrogate")
    _close_sd(dict(zip(tp, tgrad)), _sd(jgrad), "surrogate grad")
    _close_sd(ta._adapt(tp, tb), _sd(jax.jit(ja._adapt_impl)(ja.params, jb)),
              "adapted")


@pytest.mark.parametrize("steps", [1, 2])
def test_maml_meta_update_matches_jax(steps):
    """One meta-update over 2 tasks (fixed pre/post batches of 40 rows)
    with ``inner_adaptation_steps`` 1 and 2: meta-loss, the unclipped
    grad norm, the grads and the new params within F32 of scale. At this
    inner_lr the first-order gradient (inner grads detached) is more
    than 100 x F32 of scale from JAX's, so a port that drops the
    second-order terms fails here."""
    inner_lr = 0.5
    ja, ta = _maml_pair(meta_batch_size=2, inner_lr=inner_lr,
                        inner_adaptation_steps=steps)
    ja.optimizer = optax.chain(_recording(), optax.adam(ja.config["lr"]))
    ja.opt_state = ja.optimizer.init(ja.params)
    rng = np.random.default_rng(7)
    pre = [_batch(rng, 40) for _ in range(2)]
    post = [_batch(rng, 40) for _ in range(2)]
    jnp_b = lambda bs: [{k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
                        for b in bs]
    params, opt_state, jstats = jax.jit(ja._meta_impl)(
        ja.params, ja.opt_state, jnp_b(pre), jnp_b(post))
    jgrads = _sd(opt_state[0])
    tp = ta.params
    first = []
    for p_b, q_b in zip(pre, post):  # first order: inner grads detached
        fp = tp
        for _ in range(steps):
            g = torch.autograd.grad(
                TMA.surrogate(ta.model, fp, _torch_batch(p_b)),
                list(fp.values()))
            fp = {k: v - inner_lr * gi.detach()
                  for (k, v), gi in zip(fp.items(), g)}
        first.append(TMA.surrogate(ta.model, fp, _torch_batch(q_b)))
    fo = torch.autograd.grad(torch.mean(torch.stack(first)), list(tp.values()))
    assert _gap(dict(zip(tp, fo)), jgrads) > 100 * F32
    tstats = {k: float(v) for k, v in ta._meta_update(
        [_torch_batch(b) for b in pre], [_torch_batch(b) for b in post]
    ).items()}
    assert set(tstats) == set(jstats)
    for k in jstats:
        _close(tstats[k], float(jstats[k]), F32, k)
    _close_sd({n: p.grad for n, p in ta.model.named_parameters()}, jgrads,
              "grads")
    _close_sd(weights_of(ta.model), _sd(params), "params")


def test_maml_steps_checkpoint_and_defaults():
    """The default config equals JAX's (the port adds only ``device``);
    two port ``step()``s (2 tasks x 2 episodes): finite stats, the tasks
    drawn in JAX's numpy order; a checkpoint round trip restores the
    policy, the frozen initial copy (JAX's ``target_params``) and Adam;
    ``adaptation_eval`` draws its tasks from ``seed=500``;
    bench.maml_loop's CPU run."""
    jd, td = JMA.MAMLConfig().to_dict(), TMA.MAMLConfig().to_dict()
    assert td.pop("device") == "cuda"
    assert td == jd
    cfg = TMA.MAMLConfig().training(meta_batch_size=2, episodes_per_task=2)
    ta = cfg.resources(device="cpu").debugging(seed=0).build()
    init = weights_of(ta.model)
    rng = np.random.default_rng(0)
    for _ in range(2):
        r = ta.step()
        assert np.isfinite(r["learner/meta_loss"]) and r[
            "learner/grad_norm"] > 0
        assert set(r["timers"]) == {"sample_time_ms", "adapt_time_ms",
                                    "learn_time_ms"}
        JMA.PointGoalEnv().sample_task(rng)
        JMA.PointGoalEnv().sample_task(rng)
    assert r["num_env_steps_sampled_this_iter"] == 2 * 2 * 2 * 20
    assert ta._np_rng.random() == rng.random()
    state = ta.save_checkpoint()
    assert set(state) == {"params", "target_params", "opt_state",
                          "iteration", "timesteps_total"}
    for k, v in init.items():
        np.testing.assert_array_equal(state["target_params"][k], v)
    fresh = cfg.build()
    fresh.load_checkpoint(state)
    for k, v in weights_of(ta.model).items():
        np.testing.assert_array_equal(weights_of(fresh.model)[k], v)
    sa, sf = ta.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(sf["state"][i][k], v), (i, k)
    out = ta.adaptation_eval(num_tasks=2)
    assert np.isfinite(out["post_adaptation_reward"])
    r = bench.maml_loop(device="cpu", timed=1,
                        profile=lambda learn: learn())
    assert r["maml_losses_finite"] and r["maml_weights_moved"] > 0
    assert r["maml_launches"] == {} and r["maml_meta_updates_per_sec"] > 0
    assert "meta_loss" in r["maml_profile"]


# ---- MBMPO ----

MB_SMALL = dict(seed=0, ensemble_size=2, imagined_episodes=4,
                real_episodes_per_iter=2, model_train_iters=3,
                buffer_size=50)


def _mbmpo_pair(scale=1.0):
    """A JAX and a port MBMPO (2 members, 4 imagined episodes of 20
    steps), the JAX policy and ensemble drawn from numpy (the members
    apart; kernels of variance scale² / fan_in), the port's loaded from
    them."""
    ja = JMB.MBMPOConfig().training(**MB_SMALL).build()
    ja.params = _numpy_tree(ja.params, 1, scale)
    ja.model_params = _numpy_tree(ja.model_params, 2, scale)
    ja.opt_state = ja.optimizer.init(ja.params)
    ja.model_opt_state = ja.model_opt.init(ja.model_params)
    ta = (TMB.MBMPOConfig().training(**MB_SMALL).resources(device="cpu")
          .build())
    _load(ta.model, ja.params)
    _load(ta.dynamics, ja.model_params, stacked=True)
    return ja, ta


@pytest.fixture(scope="module")
def mbmpo_pair():
    return _mbmpo_pair()


def test_mbmpo_model_update_and_imagine_match_jax(mbmpo_pair):
    """On copies of the pair: one ensemble update on fixed (K, 256, ·)
    draws (the mean over members, one Adam over the stack): loss and the
    new stacked params within F32; then ``_imagine`` through member 1
    with JAX's noise (``split(key, T)``, one (E, 2) draw a step): the
    batch (obs, clipped actions, advantages) and the mean imagined
    return within F32."""
    import copy
    ja, ta = copy.copy(mbmpo_pair[0]), copy.deepcopy(mbmpo_pair[1])
    rng = np.random.default_rng(4)
    obs = rng.uniform(-2, 2, (2, 256, 2)).astype(np.float32)
    act = rng.uniform(-1, 1, (2, 256, 2)).astype(np.float32)
    nxt = np.clip(obs + 0.25 * act, -2, 2).astype(np.float32)
    mp, _, jloss = ja._jit_model_update(ja.model_params, ja.model_opt_state,
                                        obs, act, nxt)
    _close(ta._model_update(obs, act, nxt), float(jloss), F32, "model loss")
    _close_sd(weights_of(ta.dynamics), _sd(mp, stacked=True), "model params")
    key = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.normal(k, (4, 2)))
                      for k in jax.random.split(key, 20)])
    member = jax.tree_util.tree_map(lambda v: v[1], mp)
    jb, jrw = ja._jit_imagine(ja.params, member, key)
    tb, trw = ta._imagine(ta.params, 1, noise=noise)
    for k in ("obs", "actions", "advantages"):
        _close(tb[k], np.asarray(jb[k]), F32, k)
    assert np.abs(np.asarray(jb["actions"])).max() == 1.0  # clipped
    _close(trw, float(jrw), F32, "imagined return")


class _Recorded:
    """A numpy Generator whose ``integers`` draws are kept."""

    def __init__(self, rng):
        self.rng, self.seen = rng, []

    def integers(self, *args, **kw):
        out = self.rng.integers(*args, **kw)
        self.seen.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.rng, name)


def test_mbmpo_steps_match_jax():
    """Two whole ``training_step``s (2 real episodes into a 50-row buffer,
    so the second trims it; 3 ensemble updates; 2 members x 2
    imaginations, the second iteration's deployed policy adapted on
    member 0's; one meta-update over both members), the port fed JAX's
    action and imagination noise in JAX's key order: the bootstrap
    indices bit-equal, the buffer's rows within F32 (its length and
    trimming exact), the results, the policy and the ensemble within F32
    of scale. The nets are drawn at half the usual scale: at full scale
    a 20-step imagination through a barely trained model magnifies f32
    rounding to ~2e-5 of scale by its last step (the one-step pieces
    are held at full scale above and below)."""
    ja, ta = _mbmpo_pair(scale=0.5)
    keys = _JaxKeys(ja)
    collect, imagine = ta._collect_real, ta._imagine
    ta._collect_real = lambda params, episodes: collect(
        params, episodes, noise=keys.act_noise(episodes, 20))
    ta._imagine = lambda params, k: imagine(
        params, k, noise=keys.imagine_noise(20, 4))
    ja._np_rng, ta._np_rng = _Recorded(ja._np_rng), _Recorded(ta._np_rng)
    for i in range(2):
        jr, tr = ja.training_step(), ta.training_step()
        assert set(tr.pop("timers")) == {"sample_time_ms", "model_time_ms",
                                         "imagine_time_ms", "learn_time_ms"}
        assert set(tr) == set(jr)
        for k, v in jr.items():
            _close(tr[k], v, F32, f"step {i} {k}")
    assert len(ja._np_rng.seen) == len(ta._np_rng.seen) == 6
    for j, t in zip(ja._np_rng.seen, ta._np_rng.seen):
        np.testing.assert_array_equal(t, j)
    assert ja._np_rng.seen[-1].shape == (2, 50)
    for k in ("_buf_obs", "_buf_act", "_buf_next"):
        assert getattr(ta, k).shape == getattr(ja, k).shape == (50, 2)
        _close(getattr(ta, k), getattr(ja, k), F32, k)
    assert np.abs(ta._buf_act).max() <= 1.0
    _close_sd(weights_of(ta.model), _sd(ja.params), "policy")
    _close_sd(weights_of(ta.dynamics), _sd(ja.model_params, stacked=True),
              "ensemble")


def test_mbmpo_meta_update_and_checkpoint(mbmpo_pair):
    """One meta-update over the 2 members' imagined pre/post batches:
    meta-loss, grad norm, grads and new params within F32 of scale; the
    checkpoint holds what JAX's holds (the policy, the frozen initial
    copy, Adam, the counters), not the ensemble; the default config
    equals JAX's; bench.mbmpo_loop's CPU run: the model loss falls, the
    buffer grows."""
    import copy
    ja, ta = copy.copy(mbmpo_pair[0]), copy.deepcopy(mbmpo_pair[1])
    _load(ta.model, ja.params)
    ja.optimizer = optax.chain(_recording(), optax.adam(ja.config["lr"]))
    ja.opt_state = ja.optimizer.init(ja.params)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    pre, post = [], []
    for k in range(2):
        member = jax.tree_util.tree_map(lambda v: v[k], ja.model_params)
        p, _ = ja._jit_imagine(ja.params, member, keys[2 * k])
        q, _ = ja._jit_imagine(ja._jit_adapt(ja.params, p), member,
                               keys[2 * k + 1])
        pre.append(p)
        post.append(q)
    params, opt_state, jstats = jax.jit(ja._meta_impl)(
        ja.params, ja.opt_state, pre, post)
    tb = lambda bs: [{k: torch.as_tensor(np.array(v))  # noqa: E731
                      for k, v in b.items()} for b in bs]
    tstats = ta._meta_update(tb(pre), tb(post))
    for k in jstats:
        _close(tstats[k], float(jstats[k]), F32, k)
    _close_sd({n: p.grad for n, p in ta.model.named_parameters()},
              _sd(opt_state[0]), "grads")
    _close_sd(weights_of(ta.model), _sd(params), "params")
    state = ta.save_checkpoint()
    assert set(state) == set(ja.save_checkpoint())
    assert not any(k.startswith("Dense") and v.ndim == 3
                   for k, v in state["params"].items())
    dyn = weights_of(ta.dynamics)
    fresh = (TMB.MBMPOConfig().training(**MB_SMALL).resources(device="cpu")
             .build())
    fresh.load_checkpoint(state)
    for k, v in weights_of(ta.model).items():
        np.testing.assert_array_equal(weights_of(fresh.model)[k], v)
    assert any(not np.array_equal(weights_of(fresh.dynamics)[k], v)
               for k, v in dyn.items())
    jd, td = JMB.MBMPOConfig().to_dict(), TMB.MBMPOConfig().to_dict()
    assert td.pop("device") == "cuda"
    assert td == jd
    r = bench.mbmpo_loop(device="cpu", timed=1,
                         profile=lambda learn: learn())
    assert r["mbmpo_losses_finite"] and r["mbmpo_weights_moved"] > 0
    assert r["mbmpo_model_loss"][1] < r["mbmpo_model_loss"][0]
    assert r["mbmpo_buffer_rows"][1] > r["mbmpo_buffer_rows"][0]
    assert r["mbmpo_launches"] == {} and "meta_loss" in r["mbmpo_profile"]
