"""The port's Dreamer (``ray_tpu_torch.rllib.algorithms.dreamer``)
against the JAX package's, on the CPU.

The three nets cross with ``dreamer_params_from_flax`` (the GRU keeps
flax's six layers) and load with no key left over. The Gaussian draws
that JAX takes from its keys are computed here from the same keys, in
the same order (``_JaxKeys``), and fed to the port through its
``_draw_noise``; the numpy draws (exploration noise, sequence indices)
are held bit-equal. f32 values are held within F32 * (1 + max |JAX
value|). The JAX algorithm is built by its own setup with its flax nets'
``init`` drawing the params from numpy on flax's shapes (``eval_shape``:
nothing compiles; the biases nonzero, so no gradient is zero by
construction); a small config (seq 4, batch 3, horizon 3) keeps JAX's
compiles short; two threads.
"""

import copy

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib.algorithms import dreamer as JD
from ray_tpu_torch import bench
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib.algorithms import dreamer as TD
from ray_tpu_torch.rllib.policy import weights_of

F32 = 1e-5
SMALL = dict(seed=0, seq_len=4, batch_size=3, imagine_horizon=3)


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


def _close_sd(got_sd, want_tree, what=""):
    want = TM.params_from_flax(jax.device_get(want_tree))
    assert set(got_sd) == set(want), sorted(set(got_sd) ^ set(want))
    for k, w in want.items():
        _close(got_sd[k], w.numpy(), F32, f"{what} {k}")


def _numpy_tree(tree, seed):
    """A tree of ``tree``'s shapes from numpy: kernels of variance
    1 / fan_in, the rest N(0, 0.1²) (``logstd`` included)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        s = (1 / np.sqrt(leaf.shape[-2]) if path[-1].key == "kernel"
             else 0.1)
        return jnp.asarray(s * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(autouse=True, scope="module")
def _numpy_init():
    """The JAX Dreamer's nets draw their params from numpy on flax's
    shapes while this file runs."""
    orig = fnn.Module.init

    def init(self, rngs, *args, method=None, **kw):
        shapes = jax.eval_shape(
            lambda r, *a: orig(self, r, *a, method=method, **kw), rngs, *args)
        return {"params": _numpy_tree(shapes["params"], 0)}

    with pytest.MonkeyPatch.context() as mp:
        for cls in (JD._WorldModel, JD._Actor, JD._Value):
            mp.setattr(cls, "init", init)
        yield


class _JaxKeys:
    """The Gaussian draws of a JAX Dreamer, from a copy of its key
    chain (the algorithm's own is untouched), in the port's
    ``_draw_noise`` form."""

    def __init__(self, algo):
        self.key = algo._rng
        cfg = algo.config
        T, B, H = cfg["seq_len"], cfg["batch_size"], cfg["imagine_horizon"]
        stoch, act = cfg["stoch_size"], algo.act_dim

        def filt(key):
            k1, k2 = jax.random.split(key)
            return {"z": jax.random.normal(k1, (1, stoch)),
                    "a": jax.random.normal(k2, (1, act))}

        def update(key):
            k_model, k_imagine = jax.random.split(key)
            obs, k = [], k_model
            for _ in range(T):
                k, sub = jax.random.split(k)
                obs.append(jax.random.normal(sub, (B, stoch)))
            acts, lats = [], []
            for kk in jax.random.split(k_imagine, H):
                k1, k2 = jax.random.split(kk)
                acts.append(jax.random.normal(k1, (B * T, act)))
                lats.append(jax.random.normal(k2, (B * T, stoch)))
            return {"obs": jnp.stack(obs), "act": jnp.stack(acts),
                    "latent": jnp.stack(lats)}

        self._draw = {"filter": jax.jit(filt), "update": jax.jit(update)}
        self.calls = 0

    def next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def draw(self, kind):
        self.calls += 1
        return {k: torch.from_numpy(np.array(v))
                for k, v in self._draw[kind](self.next()).items()}


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


def _pair(**over):
    """A JAX and a port Dreamer from one config, the port's nets loaded
    from the JAX algorithm's params (strictly) and fed JAX's noise."""
    cfg = dict(SMALL, **over)
    ja = JD.DreamerConfig().training(**cfg).build()
    ta = TD.DreamerConfig().training(**cfg).resources(device="cpu").build()
    TD.dreamer_params_from_flax(jax.device_get(ja.params), ta)
    keys = _JaxKeys(ja)
    ta._draw_noise = keys.draw
    return ja, ta, keys


def _seq_batch(rng, B=3, T=4):
    return {"obs": rng.standard_normal((B, T, 3)).astype(np.float32),
            "prev_actions": rng.uniform(-1, 1, (B, T, 1)).astype(np.float32),
            "rewards": rng.standard_normal((B, T)).astype(np.float32)}


def _flax_gru_params(rng, din, d):
    tree = {}
    for name in ("ir", "iz", "in", "hr", "hz", "hn"):
        k = rng.standard_normal((din if name[0] == "i" else d, d)) / np.sqrt(d)
        tree[name] = {"kernel": jnp.asarray(k, jnp.float32)}
        if name not in ("hr", "hz"):
            tree[name]["bias"] = jnp.asarray(
                0.3 * rng.standard_normal(d), jnp.float32)
    return tree


def test_gru_cell_matches_flax():
    """flax's ``GRUCell`` (biases on ``ir``, ``iz``, ``in`` and ``hn``
    only, all nonzero) against the port's six-layer cell over 5 steps:
    the state within F32 of its scale; the converter loads the cell
    with no key left over, and a torch.nn.GRUCell-style r/z bias on the
    recurrent side does not exist."""
    rng = np.random.default_rng(0)
    tree = _flax_gru_params(rng, 6, 5)
    cell = TD._GRUCell(6, 5)
    sd = TM.params_from_flax(tree)
    assert set(sd) == set(cell.state_dict())
    assert "hr.bias" not in sd and "hz.bias" not in sd
    cell.load_state_dict(sd)
    fcell = fnn.GRUCell(features=5)
    h_j = jnp.asarray(rng.standard_normal((4, 5)), jnp.float32)
    h_t = torch.from_numpy(np.array(h_j))
    for t in range(5):
        x = rng.standard_normal((4, 6)).astype(np.float32)
        h_j, _ = fcell.apply({"params": tree}, h_j, jnp.asarray(x))
        h_t = cell(h_t, torch.from_numpy(x))
        _close(h_t, h_j, F32, f"h step {t}")


def test_rssm_observe_and_imagine_match_jax():
    """On the JAX algorithm's params: ``step_prior`` and ``posterior``
    (softplus + 0.1), ``observe`` over T = 4 with fed noise (features
    and the KL terms), the decoder and reward heads, then 3 imagined
    steps (actor sample, ``imagine_step``) within F32."""
    ja, ta, _ = _pair()
    p = ja.wm_params
    rng = np.random.default_rng(1)
    b = _seq_batch(rng)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    a = rng.uniform(-1, 1, (3, 1)).astype(np.float32)
    e = rng.standard_normal((3, 64)).astype(np.float32)
    jh, jm, js = ja.wm.apply({"params": p}, h, z, a, method=(
        lambda m, *x: m.rssm.step_prior(*x)))
    th, tm, ts = ta.wm.rssm.step_prior(*map(torch.from_numpy, (h, z, a)))
    for got, want, what in ((th, jh, "h"), (tm, jm, "prior mean"),
                            (ts, js, "prior std")):
        _close(got, want, F32, what)
    jq = ja.wm.apply({"params": p}, jh, e, method=(
        lambda m, *x: m.rssm.posterior(*x)))
    tq = ta.wm.rssm.posterior(th, torch.from_numpy(e))
    for got, want in zip(tq, jq):
        _close(got, want, F32, "posterior")
    key = jax.random.PRNGKey(3)
    noise, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (3, 8))))
    jf, jkl = ja.wm.apply({"params": p}, b["obs"], b["prev_actions"], key,
                          method=JD._WorldModel.observe)
    with torch.no_grad():
        tf, tkl = ta.wm.observe(torch.from_numpy(b["obs"]),
                                torch.from_numpy(b["prev_actions"]),
                                torch.from_numpy(np.stack(noise)))
        _close(tf, jf, F32, "features")
        _close(tkl, jkl, F32, "kl")
        _close(ta.wm.decode(tf), ja.wm.apply(
            {"params": p}, jf, method=JD._WorldModel.decode), F32, "decode")
        _close(ta.wm.reward(tf), ja.wm.apply(
            {"params": p}, jf, method=JD._WorldModel.reward), F32, "reward")
        jfeat, tfeat = jf.reshape(-1, 72), tf.reshape(-1, 72)
        jhz = (jfeat[:, :64], jfeat[:, 64:])
        thz = (tfeat[:, :64], tfeat[:, 64:])
        for kk in jax.random.split(jax.random.PRNGKey(4), 3):
            k1, k2 = jax.random.split(kk)
            jmean, jstd = ja.actor.apply({"params": ja.actor_params},
                                         jnp.concatenate(jhz, -1))
            ja_ = jmean + jstd * jax.random.normal(k1, jmean.shape)
            jhz = ja.wm.apply({"params": p}, *jhz, ja_, k2, method=(
                lambda m, h_, z_, a_, k_: m.imagine_step(h_, z_, a_, k_)))
            tmean, tstd = ta.actor(torch.cat(thz, -1))
            _close(tstd, jstd, F32, "actor std")
            ta_ = tmean + tstd * torch.from_numpy(
                np.array(jax.random.normal(k1, jmean.shape)))
            thz = ta.wm.imagine_step(*thz, ta_, torch.from_numpy(
                np.array(jax.random.normal(k2, (12, 8)))))
            _close(thz[0], jhz[0], F32, "imagined h")
            _close(thz[1], jhz[1], F32, "imagined z")


def test_dreamer_update_matches_jax():
    """Two updates on fixed sequence batches, JAX's keys fed as noise:
    the six stats and each of the three param trees after its Adam
    within F32 (the actor's step takes its grads over the actor alone,
    so the world model's and value's Adams see only their own losses)."""
    ja, ta, keys = _pair()
    rng = np.random.default_rng(2)
    for i in range(2):
        b = _seq_batch(rng)
        key = ja._next_key()
        out = ja._jit_update(ja.wm_params, ja.actor_params, ja.value_params,
                             ja.wm_opt_state, ja.actor_opt_state,
                             ja.value_opt_state,
                             {k: jnp.asarray(v) for k, v in b.items()}, key)
        (ja.wm_params, ja.actor_params, ja.value_params, ja.wm_opt_state,
         ja.actor_opt_state, ja.value_opt_state, jstats) = out
        tstats = TD.stats_to_host(ta._update(b))
        assert set(tstats) == set(jstats)
        for k, v in jstats.items():
            _close(tstats[k], float(v), F32, f"update {i} {k}")
        _close_sd(weights_of(ta.wm), ja.wm_params, f"update {i} wm")
        _close_sd(weights_of(ta.actor), ja.actor_params, f"update {i} actor")
        _close_sd(weights_of(ta.value), ja.value_params, f"update {i} value")
    assert keys.calls == 2


class _DampedPoint:
    """A contractive 1-D point mass for the whole-step test (the same
    class serves both packages, as ``make_env`` takes a callable):
    v <- 0.9 v + 0.1 a, x <- clip(x + 0.1 v, -2, 2), reward -x² - 0.01 a²,
    obs (x, v, t / 200), 200 steps an episode. Pendulum's swing
    amplifies the f32 rounding of the actor's output (~1e-7) to ~1e-3 by
    step 200 (``test_pendulum_collection_matches_jax`` holds its exact
    parts); this env damps it, so whole steps are held within F32."""

    def __init__(self, config=None):
        from ray_tpu_torch.rllib.env import Box
        self.observation_space = Box(-np.inf, np.inf, (3,))
        self.action_space = Box(-1.0, 1.0, (1,))
        self._rng = np.random.default_rng(0)

    def _obs(self):
        return np.array([self._x, self._v, self._t / 200.0], np.float32)

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._x, self._v, self._t = self._rng.uniform(-1, 1), 0.0, 0
        return self._obs(), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -1.0, 1.0))
        self._v = 0.9 * self._v + 0.1 * a
        self._x = float(np.clip(self._x + 0.1 * self._v, -2.0, 2.0))
        self._t += 1
        r = -self._x ** 2 - 0.01 * a ** 2
        return self._obs(), r, False, self._t >= 200, {}


def test_two_training_steps_match_jax():
    """Two whole ``training_step``s (``prefill_steps`` 200: the first
    collects one whole episode with noise 1.0, the second 100 steps with
    ``expl_noise``; one update each) on ``_DampedPoint``, both key
    streams fed: the sequence indices and the final numpy state
    bit-equal, the episode store, the collector's state, the stats and
    the three nets within F32. (Each Adam step turns the rounding of
    near-zero grads into steps of up to lr, and the imagined returns
    pass it on: at 3 updates a step the second step's value loss lies
    ~1e-5 of its scale from JAX's; 2 updates in a row are held on fixed
    batches above.)"""
    ja, ta, keys = _pair(env=_DampedPoint, prefill_steps=200,
                         rollout_fragment_length=100,
                         train_steps_per_iteration=1)
    ja._np_rng, ta._np_rng = _Recorded(ja._np_rng), _Recorded(ta._np_rng)
    for i in range(2):
        jr, tr = ja.training_step(), ta.training_step()
        assert set(tr.pop("timers")) == {"sample_time_ms", "replay_time_ms",
                                         "learn_time_ms"}
        assert set(tr) == set(jr)
        for k, v in jr.items():
            _close(tr[k], v, F32, f"step {i} {k}")
    assert len(ta._np_rng.seen) == len(ja._np_rng.seen) == 2 * 3 * 2
    for a, b in zip(ta._np_rng.seen, ja._np_rng.seen):
        assert a == b
    assert ta._np_rng.random() == ja._np_rng.random()
    assert keys.calls == 300 + 2
    assert len(ta._episodes) == len(ja._episodes) == 1
    for k in ("obs", "actions", "rewards"):
        _close(ta._episodes[0][k], ja._episodes[0][k], F32, k)
    _close(ta._h, ja._h, F32, "collector h")
    for name in ("wm", "actor", "value"):
        _close_sd(weights_of(getattr(ta, name)), ja.params[name], name)


def test_pendulum_collection_matches_jax():
    """``_collect`` on Pendulum-v1 (200 steps, noise 1.0: one whole
    episode), both key streams fed: the keys and the exploration normals
    consumed alike, one episode stored on each side, its first 40 steps
    within F32 (later the swing amplifies the f32 rounding of the
    actions), and the sequence draws that follow bit-equal."""
    ja, ta, keys = _pair()
    assert ja._collect(200, 1.0) == ta._collect(200, 1.0) == 200
    assert keys.calls == 200
    np.testing.assert_array_equal(np.asarray(keys.key), np.asarray(ja._rng))
    assert len(ta._episodes) == len(ja._episodes) == 1
    for k in ("obs", "actions", "rewards"):
        assert ta._episodes[0][k].shape == ja._episodes[0][k].shape
        _close(ta._episodes[0][k][:40], ja._episodes[0][k][:40], F32, k)
    ja._np_rng, ta._np_rng = _Recorded(ja._np_rng), _Recorded(ta._np_rng)
    jb, tb = ja._sample_sequences(), ta._sample_sequences()
    assert [int(x) for x in ja._np_rng.seen] == [int(x) for x in
                                                ta._np_rng.seen]
    assert tb["obs"].shape == (3, 4, 3) and tb["prev_actions"].shape == (
        3, 4, 1)
    assert set(tb) == set(jb)


def test_evaluate_streams_and_checkpoint_roundtrip():
    """``evaluate(1)`` on both: the reward within F32, and it advances
    the training streams as JAX's does (200 keys, 200 exploration
    normals scaled by 0), so the next draws agree. A checkpoint holds
    the three nets as ``params`` and ``target_params`` and the three
    Adams' state; a fresh Dreamer (another seed) loaded from it holds
    the same weights and takes the same next update."""
    ja, ta, keys = _pair()
    jr, tr = ja.evaluate(1), ta.evaluate(1)
    _close(tr["evaluation"]["episode_reward_mean"],
           jr["evaluation"]["episode_reward_mean"], F32, "eval reward")
    assert keys.calls == 200
    np.testing.assert_array_equal(np.asarray(keys.key), np.asarray(ja._rng))
    assert ta._np_rng.random() == ja._np_rng.random()
    b = _seq_batch(np.random.default_rng(5))
    ta._update(b)
    state = ta.save_checkpoint()
    assert set(state) == {"params", "target_params", "opt_state",
                          "iteration", "timesteps_total"}
    assert set(state["params"]) == {"wm", "actor", "value"}
    for k in state["params"]:
        for n, v in state["params"][k].items():
            np.testing.assert_array_equal(state["target_params"][k][n], v)
    assert len(state["opt_state"]) == 3
    fresh = TD.DreamerConfig().training(**dict(SMALL, seed=1)).resources(
        device="cpu").build()
    fresh.load_checkpoint(copy.deepcopy(state))
    noise = ta._draw_noise("update")
    fresh_stats = TD.stats_to_host(fresh._update(b, noise))
    ta_stats = TD.stats_to_host(ta._update(b, noise))
    assert fresh_stats == ta_stats
    for name in ("wm", "actor", "value"):
        for k, v in weights_of(getattr(ta, name)).items():
            np.testing.assert_array_equal(
                weights_of(getattr(fresh, name))[k], v)


def test_defaults_and_bench_loop_on_cpu():
    """The default config equals JAX's (the port adds only ``device``);
    the port's default nets have JAX's param shapes and ``logstd`` -1;
    bench.dreamer_loop's CPU run: its keys, finite losses, weights that
    moved, no launch of the port's kernels. Without a card the default
    (``"cuda"``) build raises."""
    jd, td = JD.DreamerConfig().to_dict(), TD.DreamerConfig().to_dict()
    assert td.pop("device") == "cuda"
    assert td == jd
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TD.DreamerConfig().build()
    ta = TD.DreamerConfig().resources(device="cpu").build()
    ja = JD.DreamerConfig().build()
    for name in ("wm", "actor", "value"):
        want = TM.params_from_flax(jax.device_get(ja.params[name]))
        got = getattr(ta, name).state_dict()
        assert {k: tuple(v.shape) for k, v in want.items()} == {
            k: tuple(v.shape) for k, v in got.items()}
    assert torch.equal(ta.actor.logstd, torch.full((1,), -1.0))
    r = bench.dreamer_loop(device="cpu", profile=lambda learn: learn())
    for k in ("dreamer_env_steps_per_sec", "dreamer_updates_per_sec",
              "dreamer_split", "dreamer_recon_loss", "dreamer_profile"):
        assert k in r, k
    assert r["dreamer_losses_finite"] and r["dreamer_weights_moved"] > 0
    assert r["dreamer_launches"] == {}

