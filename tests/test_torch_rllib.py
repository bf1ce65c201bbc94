"""The port's RLlib local path (``ray_tpu_torch.rllib``) against the JAX
package's, on the CPU.

The copied host modules (envs, SampleBatch, GAE, connectors) give equal
arrays on the same seeds. The networks cross with ``params_from_flax``
and are held in f32 within 1e-5 and in bf16 by their error against an
f64 forward. The PPO loss, its stats and grads (with and without
``pad_to``'s ``_valid_mask``), one ``learn_on_batch`` (with and without
optax's global-norm clip) and the split ``compute_gradients`` /
``apply_gradients`` are held on fixed batches from shared params. The
rollout worker and two ``PPO.step()``s are held greedy
(``explore=False``), where the trajectories are deterministic; sampled
actions are not compared (``jax.random`` and ``torch.Generator`` draw
other bits), only the sampling laws. Inputs come from numpy seeds; each
check states its tolerance.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib import connectors as JC
from ray_tpu.rllib import env as JE
from ray_tpu.rllib import models as JM
from ray_tpu.rllib import postprocessing as JPP
from ray_tpu.rllib import sample_batch as JSB
from ray_tpu.rllib.algorithms import ppo as JPPO
from ray_tpu.rllib.rollout_worker import RolloutWorker as JRolloutWorker
from ray_tpu_torch import bench
from ray_tpu_torch import rllib as TR
from ray_tpu_torch.rllib import connectors as TC
from ray_tpu_torch.rllib import env as TE
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib import postprocessing as TPP
from ray_tpu_torch.rllib import sample_batch as TSB
from ray_tpu_torch.rllib.algorithms import ppo as TPPO
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker as TRolloutWorker

# f32 forwards, losses, stats and grads: the two sides sum in other
# orders, a few ulps per op; held within F32 * (1 + max |JAX value|)
F32 = 1e-5
# bf16 forwards: the port's max error against the f64 forward at most
# BF16_RATIO times JAX's bf16 forward's (both round every layer's output
# to bf16, at other points: torch adds the conv bias before it rounds)
BF16_RATIO = 3.0


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
    scale = 1.0 + float(np.max(np.abs(want))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _close_tree(got_sd, want_tree, tol=F32, what=""):
    """A port state dict (numpy) against a flax tree (converted)."""
    want = TM.params_from_flax(want_tree)
    assert set(got_sd) == set(want), (sorted(got_sd), sorted(want))
    for k, w in want.items():
        _close(got_sd[k], w.numpy(), tol, f"{what} {k}")


# ---- the copied host modules: equal arrays ----


@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1",
                                  "PixelCatcher-v0"])
def test_envs_match_jax(name):
    """The same seeds and actions through both copies of each env and of
    VectorEnv (auto-reset included): equal observations, rewards and
    flags."""
    rng = np.random.default_rng(0)
    venvs = [VE(lambda m=m: m.make_env(name, {"seed": 3}), 3, seed=7)
             for m, VE in ((JE, JE.VectorEnv), (TE, TE.VectorEnv))]
    outs = [v.reset_all() for v in venvs]
    np.testing.assert_array_equal(outs[0], outs[1])
    space = venvs[1].action_space
    for _ in range(120):
        if isinstance(space, TE.Discrete):
            a = rng.integers(0, space.n, 3)
        else:
            a = rng.uniform(-2, 2, (3, 1)).astype(np.float32)
        js, ts = venvs[0].step(a), venvs[1].step(a)
        for x, y in zip(js[:4], ts[:4]):
            np.testing.assert_array_equal(x, y)
        for ix, iy in zip(js[4], ts[4]):
            assert ix.keys() == iy.keys()
            if "terminal_observation" in ix:
                np.testing.assert_array_equal(ix["terminal_observation"],
                                              iy["terminal_observation"])


def test_multi_agent_env_matches_jax():
    envs = [m.MultiAgentCartPole({"num_agents": 3}) for m in (JE, TE)]
    obs = [e.reset(seed=5)[0] for e in envs]
    for k in obs[0]:
        np.testing.assert_array_equal(obs[0][k], obs[1][k])
    for t in range(30):
        acts = {aid: t % 2 for aid in obs[0]}
        outs = [e.step(acts) for e in envs]
        for a, b in zip(outs[0][:4], outs[1][:4]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _columns(rng, n):
    return {"obs": rng.standard_normal((n, 3)).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "eps_id": np.repeat(np.arange(4), [3, 1, n - 6, 2]),
            "actions": rng.integers(0, 3, n).astype(np.int32)}


def test_sample_batch_matches_jax():
    """concat, slice, shuffle, minibatches (the permutation), pad_to
    (``_valid_mask``), split_by_episode, MultiAgentBatch: equal."""
    rng = np.random.default_rng(1)
    cols = [_columns(rng, 13), _columns(rng, 9)]
    sides = []
    for SB in (JSB, TSB):
        b = SB.SampleBatch.concat_samples([SB.SampleBatch(dict(c))
                                           for c in cols])
        out = [b, b.slice(2, 7), b[3:10], b.shuffle(np.random.default_rng(4)),
               *b.minibatches(5, rng=np.random.default_rng(5)),
               b.pad_to(30), b.pad_to(10), *b.split_by_episode()]
        ma = SB.MultiAgentBatch.concat_samples(
            [SB.MultiAgentBatch({"p": b, "q": b.slice(0, 4)}, 22)] * 2)
        out += [ma.policy_batches["p"], ma.policy_batches["q"],
                SB.convert_ma_batch_to_sample_batch(ma)]
        sides.append((out, b.count, b.total_reward(), ma.env_steps(),
                      ma.agent_steps()))
    (jout, *jn), (tout, *tn) = sides
    assert jn == tn
    assert len(jout) == len(tout)
    for x, y in zip(jout, tout):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("use_gae", [True, False])
@pytest.mark.parametrize("standardize", [False, True])
def test_gae_matches_jax(use_gae, standardize):
    rng = np.random.default_rng(2)
    n = 17
    cols = {"rewards": rng.standard_normal(n).astype(np.float32),
            "vf_preds": rng.standard_normal(n).astype(np.float32)}
    outs = [m.compute_advantages(SB.SampleBatch(dict(cols)), 0.37, 0.97,
                                 0.9, use_gae, standardize)
            for m, SB in ((JPP, JSB), (TPP, TSB))]
    for k in ("advantages", "value_targets"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_connectors_match_jax():
    """Grayscale, resize, frame stack (with auto-reset rows and the
    state-preserving ``transform``), mean/std (and its state), flatten,
    clip: equal arrays, spaces and states."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (6, 3, 84, 84, 3)).astype(np.uint8)
    dones = rng.random((6, 3)) < 0.3
    vec = rng.standard_normal((5, 4, 2))
    sides = []
    for C, E in ((JC, JE), (TC, TE)):
        pipe = C.ConnectorPipeline([C.GrayscaleObsConnector(),
                                    C.ResizeObsConnector(21, 21),
                                    C.FrameStackConnector(4)])
        space = pipe.observation_space(E.Box(0, 255, (84, 84, 3), np.uint8))
        out = [np.array(space.shape)]
        for f, d in zip(frames, dones):
            out += [pipe.transform(f), pipe(f, d)]
        out.append(pipe.clone_for_eval()(frames[0]))
        ms = C.MeanStdObsConnector()
        for v in vec:
            out.append(ms(v))
        out += [ms.transform(vec[0]), ms.state()["mean"], ms.state()["m2"],
                C.FlattenObsConnector()(vec),
                C.ClipActionConnector(-0.5, 0.5)(vec)]
        sides.append(out)
    for x, y in zip(*sides):
        np.testing.assert_array_equal(x, y)


# ---- networks through params_from_flax ----


def _flax_params(model, obs_shape, seed=0):
    return jax.device_get(model.init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, *obs_shape)))["params"])


@pytest.mark.parametrize("kind", ["discrete", "continuous_shared", "relu",
                                  "swish"])
def test_mlp_forward_matches_jax(kind):
    """MLPNet's logits (with the free log-std for continuous actions) and
    value, f32 within 1e-5."""
    n_out = 3 if kind == "discrete" else 2
    kw = dict(hiddens=(32, 16))
    if kind == "continuous_shared":
        kw.update(free_log_std=True, vf_share_layers=True)
    elif kind != "discrete":
        kw["activation"] = kind
    jm = JM.MLPNet(num_outputs=n_out, **kw)
    params = _flax_params(jm, (5,), seed=1)
    if "log_std" in params:
        params["log_std"] = np.linspace(-1, 1, n_out).astype(np.float32)
    tm = TM.MLPNet(5, n_out, **kw)
    TM.params_from_flax(params, tm)
    x = np.random.default_rng(4).standard_normal((9, 5)).astype(np.float32)
    want = jm.apply({"params": params}, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w, what in zip(got, want, ("logits", "value")):
        assert tuple(g.shape) == w.shape
        _close(g, w, F32, what)


def _frames(shape, n=6, seed=5):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *shape)).astype(np.uint8)


@pytest.mark.parametrize("shape", [(21, 21, 2), (84, 84, 4), (21, 28, 2)])
def test_atari_cnn_f32_matches_jax(shape):
    """AtariCNN in f32 (flax's SAME pads: 84 -> 21 -> 11 -> 11, the
    asymmetric (1, 2) on 21; the NHWC flatten, held on the non-square
    3 x 4 x 64 map of 21 x 28 too), logits and value within 1e-5."""
    jm = JM.AtariCNN(3, compute_dtype=jnp.float32)
    params = _flax_params(jm, shape)
    tm = TM.AtariCNN(shape, 3, compute_dtype=torch.float32)
    TM.params_from_flax(params, tm)
    x = _frames(shape)
    want = jm.apply({"params": params}, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w, what in zip(got, want, ("logits", "value")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w, F32, what)


@pytest.mark.parametrize("shape", [(21, 21, 2), (84, 84, 4)])
def test_atari_cnn_bf16_within_ratio_of_f64(shape):
    """AtariCNN as make_model builds it (bf16 trunk, f32 heads, f32
    outputs): the port's max error against the port's f64 forward of the
    same params at most BF16_RATIO times JAX's bf16 forward's; the f64
    forward itself against JAX's f32 forward within 1e-5."""
    jm = JM.AtariCNN(3)
    params = _flax_params(jm, shape)
    tm = TM.make_model(TE.Box(0, 255, shape, np.uint8), TE.Discrete(3))
    assert tm.compute_dtype == torch.bfloat16
    TM.params_from_flax(params, tm)
    t64 = TM.AtariCNN(shape, 3, compute_dtype=torch.float64).double()
    t64.load_state_dict(tm.state_dict())
    x = _frames(shape, n=16)
    with torch.no_grad():
        got = [t.detach() for t in tm(torch.from_numpy(x))]
        ref = [t.numpy() for t in t64(torch.from_numpy(x))]
    jax_bf16 = jm.apply({"params": params}, x)
    jax_f32 = JM.AtariCNN(3, compute_dtype=jnp.float32).apply(
        {"params": params}, x)
    for g, j, r, j32, what in zip(got, jax_bf16, ref, jax_f32,
                                  ("logits", "value")):
        assert g.dtype == torch.float32
        _close(r, j32, F32, f"f64 {what}")
        port_err = float(np.max(np.abs(g.numpy() - r)))
        jax_err = float(np.max(np.abs(np.asarray(j, np.float64) - r)))
        assert port_err <= BF16_RATIO * jax_err, (what, port_err, jax_err)


def test_distribution_functions_match_jax():
    """logp and entropy of the categorical and the diagonal Gaussian
    (log-std clipped to [-20, 2]) within 1e-5; the samplers' laws:
    categorical frequencies within 0.01 of softmax, Gaussian mean and
    std within 0.02, the port's draws from its generator reproducible."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((7, 4)).astype(np.float32) * 2
    acts = rng.integers(0, 4, 7).astype(np.int32)
    gin = np.concatenate([rng.standard_normal((7, 3)),
                          rng.uniform(-25, 4, (7, 3))], -1).astype(np.float32)
    gact = rng.standard_normal((7, 3)).astype(np.float32)
    pairs = [
        (TM.categorical_logp(torch.from_numpy(logits), torch.from_numpy(acts)),
         JM.categorical_logp(logits, acts)),
        (TM.categorical_entropy(torch.from_numpy(logits)),
         JM.categorical_entropy(logits)),
        (TM.diag_gaussian_logp(torch.from_numpy(gin), torch.from_numpy(gact)),
         JM.diag_gaussian_logp(gin, gact)),
        (TM.diag_gaussian_entropy(torch.from_numpy(gin)),
         JM.diag_gaussian_entropy(gin))]
    for i, (g, w) in enumerate(pairs):
        _close(g, w, F32, f"pair {i}")
    row = torch.tensor([[0.5, -1.0, 2.0, 0.0]]).expand(200_000, 4)
    gen = torch.Generator().manual_seed(0)
    draws = TM.categorical_sample(gen, row)
    freq = np.bincount(draws.numpy(), minlength=4) / len(draws)
    np.testing.assert_allclose(freq, torch.softmax(row[0], 0).numpy(),
                               atol=0.01)
    again = TM.categorical_sample(torch.Generator().manual_seed(0), row)
    assert torch.equal(draws, again)
    ginp = torch.tensor([[1.5, -0.7]]).expand(200_000, 2)
    s = TM.diag_gaussian_sample(gen, ginp)
    assert abs(float(s.mean()) - 1.5) < 0.02
    assert abs(float(s.std()) - math.exp(-0.7)) < 0.02


# ---- the PPO policy on fixed batches ----


def _spaces(kind):
    if kind == "discrete":
        return ((JE.Box(-1, 1, (4,)), JE.Discrete(2)),
                (TE.Box(-1, 1, (4,)), TE.Discrete(2)))
    return ((JE.Box(-1, 1, (3,)), JE.Box(-2, 2, (1,))),
            (TE.Box(-1, 1, (3,)), TE.Box(-2, 2, (1,))))


PPO_CFG = {"seed": 0, "lr": 3e-4, "clip_param": 0.2, "entropy_coeff": 0.01,
           "vf_clip_param": 10.0, "model": {"fcnet_hiddens": [64, 64]}}


def _policies(kind, **over):
    (jo, ja), (to, ta) = _spaces(kind)
    cfg = dict(PPO_CFG, **over)
    jp = JPPO.PPOPolicy(jo, ja, dict(cfg))
    tp = TPPO.PPOPolicy(to, ta, dict(cfg, device="cpu"))
    TM.params_from_flax(jax.device_get(jp.params), tp.model)
    return jp, tp


def _ppo_batch(kind, n=48, seed=7, pad_to=None):
    """A fixed batch whose ratios pass the clip range and whose value
    errors pass vf_clip_param, so every branch of the loss is taken."""
    rng = np.random.default_rng(seed)
    obs_dim = 4 if kind == "discrete" else 3
    cols = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "action_logp": rng.uniform(-1.5, -0.2, n).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": (5 * rng.standard_normal(n)).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32)}
    if kind == "discrete":
        cols["actions"] = rng.integers(0, 2, n).astype(np.int32)
    else:
        cols["actions"] = rng.standard_normal((n, 1)).astype(np.float32)
    jb, tb = JSB.SampleBatch(dict(cols)), TSB.SampleBatch(dict(cols))
    if pad_to:
        jb, tb = jb.pad_to(pad_to), tb.pad_to(pad_to)
    return jb, tb


@pytest.mark.parametrize("pad", [None, 64])
@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_ppo_loss_and_grads_match_jax(kind, pad):
    """PPOPolicy's loss, stats and grads (``compute_gradients``) on a
    fixed batch from shared params, with and without ``pad_to``'s
    padding rows: within 1e-5 * (1 + max |JAX value|). The padded rows
    change nothing: the padded batch's loss equals the unpadded one's."""
    jp, tp = _policies(kind)
    if kind == "continuous":
        log_std = np.array([-0.3], np.float32)
        jp.params = dict(jp.params, log_std=jnp.asarray(log_std))
        TM.params_from_flax(jax.device_get(jp.params), tp.model)
    jb, tb = _ppo_batch(kind, pad_to=pad)
    jg, js = jp.compute_gradients(jb)
    tg, ts = tp.compute_gradients(tb)
    assert set(js) == set(ts)
    for k in js:
        _close(ts[k], js[k], F32, k)
    _close_tree(tg, jg, F32, "grad")
    if pad:
        _, unpadded = tp.compute_gradients(_ppo_batch(kind)[1])
        _close(ts["total_loss"], unpadded["total_loss"], F32, "padded")


def test_ppo_loss_cnn_f32_matches_jax():
    """The PPO loss through AtariCNN in f32 at 21 x 21 x 2 (both sides'
    model swapped for an f32 one with the same params): loss, stats and
    grads within 1e-5 * (1 + max |JAX value|)."""
    shape = (21, 21, 2)
    cfg = dict(PPO_CFG)
    jp = JPPO.PPOPolicy(JE.Box(0, 255, shape, np.uint8), JE.Discrete(3),
                        dict(cfg))
    tp = TPPO.PPOPolicy(TE.Box(0, 255, shape, np.uint8), TE.Discrete(3),
                        dict(cfg, device="cpu"))
    jp.model = JM.AtariCNN(3, compute_dtype=jnp.float32)
    tp.model = TM.AtariCNN(shape, 3, compute_dtype=torch.float32)
    TM.params_from_flax(jax.device_get(jp.params), tp.model)
    rng = np.random.default_rng(8)
    n = 24
    cols = {"obs": _frames(shape, n),
            "actions": rng.integers(0, 3, n).astype(np.int32),
            "action_logp": rng.uniform(-1.6, -0.6, n).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": (5 * rng.standard_normal(n)).astype(np.float32)}
    jg, js = jp.compute_gradients(JSB.SampleBatch(dict(cols)))
    tg, ts = tp.compute_gradients(TSB.SampleBatch(dict(cols)))
    for k in js:
        _close(ts[k], js[k], F32, k)
    _close_tree(tg, jg, F32, "grad")


# One Adam step moves each param by lr * g / (|g| + 1e-8): about lr
# whatever |g| is, so a gradient near 0 amplifies the two sides'
# differences in it (seen: 1e-6 on a tanh layer whose smallest |g| is
# 7e-11). The params after steps are still held within 1e-5 * (1 + max
# |param|), the same bound; nothing is masked.
@pytest.mark.parametrize("grad_clip", [None, 0.5])
@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_learn_on_batch_matches_jax(kind, grad_clip):
    """Two ``learn_on_batch`` calls (the second with Adam's moments):
    stats (``grad_gnorm`` before clipping) and params within 1e-5 *
    (1 + max |JAX value|); with ``grad_clip`` 0.5 the norm passes the
    clip, so optax's scaling is taken."""
    jp, tp = _policies(kind, grad_clip=grad_clip)
    for seed in (7, 8):
        jb, tb = _ppo_batch(kind, seed=seed)
        js, ts = jp.learn_on_batch(jb), tp.learn_on_batch(tb)
        assert set(js) == set(ts)
        for k in js:
            _close(ts[k], js[k], F32, k)
        if grad_clip:
            assert js["grad_gnorm"] > grad_clip
        _close_tree(tp.get_weights(), jax.device_get(jp.params), F32,
                    f"params after batch {seed}")
    assert tp.global_timestep == jp.global_timestep == 96


def test_compute_then_apply_gradients_matches_jax():
    """``compute_gradients`` on one policy, ``apply_gradients`` of those
    grads (clip included) on both sides: params within 1e-5."""
    jp, tp = _policies("discrete", grad_clip=0.5)
    jb, tb = _ppo_batch("discrete")
    jg, _ = jp.compute_gradients(jb)
    tg, _ = tp.compute_gradients(tb)
    jp.apply_gradients(jg)
    tp.apply_gradients(tg)
    _close_tree(tp.get_weights(), jax.device_get(jp.params), F32, "params")


def test_policy_state_roundtrip():
    """get_state/set_state carry the weights, Adam's moments and step:
    a restored policy takes the same next step as the original."""
    _, tp = _policies("discrete")
    _, tb = _ppo_batch("discrete")
    tp.learn_on_batch(tb)
    state = tp.get_state()
    _, other = _policies("discrete", seed=5)
    other.set_state(state)
    a, b = tp.learn_on_batch(tb), other.learn_on_batch(tb)
    assert a == b
    for k, v in tp.get_weights().items():
        np.testing.assert_array_equal(v, other.get_weights()[k])
    assert other.global_timestep == tp.global_timestep


# ---- the worker and the algorithm, greedy ----


def _copy_policy(jpolicy, tpolicy):
    TM.params_from_flax(jax.device_get(jpolicy.params), tpolicy.model)


def _hold_batches(jb, tb, what):
    """Trajectory columns equal; GAE's and the forward's floats within
    1e-5 of their scale."""
    assert jb.count == tb.count
    for k in ("obs", "new_obs", "actions", "rewards", "dones",
              "truncateds", "eps_id"):
        np.testing.assert_array_equal(jb[k], tb[k], err_msg=f"{what} {k}")
    for k in ("advantages", "value_targets", "vf_preds", "action_logp",
              "action_dist_inputs"):
        _close(tb[k], jb[k], F32, f"{what} {k}")


def test_rollout_worker_greedy_matches_jax():
    """RolloutWorker.sample() on CartPole, explore=False, from shared
    params: the same obs, actions, rewards, dones and episode ids (two
    fragments, across auto-resets), advantages and value targets within
    1e-5."""
    cfg = {"env": "CartPole-v1", "num_envs_per_worker": 3,
           "rollout_fragment_length": 40, "seed": 2, "explore": False,
           "model": {"fcnet_hiddens": [32, 32]}}
    jw = JRolloutWorker(dict(cfg), JPPO.PPOPolicy)
    tw = TRolloutWorker(dict(cfg, device="cpu"), TPPO.PPOPolicy)
    _copy_policy(jw.policy, tw.policy)
    for i in range(2):
        _hold_batches(jw.sample(), tw.sample(), f"fragment {i}")
    assert jw.get_metrics() == tw.get_metrics()


def test_pixel_rollout_worker_greedy_matches_jax():
    """The image path: PixelCatcher through Resize(21) and FrameStack(2)
    into AtariCNN (f32 on both sides, shared params), explore=False: the
    same stacked frames, actions, rewards and dones over two fragments
    (episodes end and stacks restart inside them); GAE within 1e-5."""
    def cfg(C):
        return {"env": "PixelCatcher-v0", "num_envs_per_worker": 2,
                "rollout_fragment_length": 40, "seed": 1, "explore": False,
                "connectors": {"obs": [C.ResizeObsConnector(21, 21),
                                       C.FrameStackConnector(2)]}}
    jw = JRolloutWorker(cfg(JC), JPPO.PPOPolicy)
    tw = TRolloutWorker(dict(cfg(TC), device="cpu"), TPPO.PPOPolicy)
    jw.policy.model = JM.AtariCNN(3, compute_dtype=jnp.float32)
    tw.policy.model = TM.AtariCNN((21, 21, 2), 3, compute_dtype=torch.float32)
    _copy_policy(jw.policy, tw.policy)
    for i in range(2):
        jb, tb = jw.sample(), tw.sample()
        assert tb["obs"].shape == (80, 21, 21, 2)
        assert tb["obs"].dtype == np.uint8
        _hold_batches(jb, tb, f"fragment {i}")
    assert tw.get_metrics()["episode_rewards"]


def _algos(**over):
    cfg = dict(env="CartPole-v1", num_envs_per_worker=2,
               rollout_fragment_length=48, train_batch_size=96,
               sgd_minibatch_size=32, num_sgd_iter=2, explore=False,
               model={"fcnet_hiddens": [32, 32]}, seed=3, **over)
    ja = JPPO.PPOConfig().update_from_dict(dict(cfg)).build()
    ta = TPPO.PPOConfig().update_from_dict(dict(cfg, device="cpu")).build()
    _copy_policy(ja.get_policy(), ta.get_policy())
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


def test_two_ppo_steps_match_jax():
    """The slice as a whole: two PPO.step()s on CartPole with
    explore=False from shared params. The same sampled batches (the
    second sampled with the params the first step trained), the same
    minibatch order, and stats and params after each step within 1e-5
    of their scale."""
    ja, ta = _algos()
    jseen, tseen = _record_samples(ja), _record_samples(ta)
    for step in range(2):
        jr, tr = ja.step(), ta.step()
        assert len(jseen) == len(tseen) == step + 1
        _hold_batches(jseen[-1], tseen[-1], f"step {step}")
        for k in ("timesteps_total", "episodes_total",
                  "num_env_steps_sampled_this_iter"):
            assert jr[k] == tr[k], k
        for k, v in jr["info"]["learner"]["default_policy"].items():
            _close(tr["info"]["learner"]["default_policy"][k], v, F32, k)
        _close_tree(ta.get_policy().get_weights(),
                    jax.device_get(ja.get_policy().params), F32,
                    f"params after step {step}")
        assert set(tr["timers"]) == {"sample_time_ms", "postprocess_time_ms",
                                     "learn_time_ms"}
    ja.cleanup()
    ta.cleanup()


def test_algorithm_checkpoint_roundtrip():
    """As tests/test_rllib.py's: a second algorithm loaded from the
    first's checkpoint holds the same weights; through Trainable.save /
    restore too, which also carry the iteration."""
    def build():
        return (TR.PPOConfig().environment("CartPole-v1")
                .rollouts(rollout_fragment_length=32, num_envs_per_worker=1)
                .training(train_batch_size=32, sgd_minibatch_size=16,
                          num_sgd_iter=1)
                .resources(device="cpu").build())
    algo = build()
    algo.step()
    state = algo.save_checkpoint()
    w0 = algo.get_policy().get_weights()
    algo2 = build()
    algo2.load_checkpoint(state)
    w1 = algo2.get_policy().get_weights()
    assert sorted(w0) == sorted(w1)
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])
    algo.train()
    ckpt = algo.save()
    algo3 = build()
    algo3.restore(ckpt)
    # step() and train() each count the iteration, as the JAX
    # package's Algorithm and Trainable do: 1 step + 1 train() = 3
    assert algo3._iteration == algo._iteration == 3
    for k, v in algo.get_policy().get_weights().items():
        np.testing.assert_array_equal(v, algo3.get_policy().get_weights()[k])
    assert np.isfinite(algo3.compute_single_action(np.zeros(4, np.float32)))
    assert "evaluation" in algo3.evaluate(num_episodes=1)
    for a in (algo, algo2, algo3):
        a.cleanup()


# ---- init laws ----


def test_init_laws():
    """flax's laws from a seeded generator. MLPNet: every kernel a
    partial isometry (W W^T or W^T W = gain^2 I, gains sqrt(2), 0.01, 1)
    and zero biases. AtariCNN at the published widths (84 x 84 x 4):
    each kernel's mean within 4 standard errors of 0 and its std within
    3% of lecun-normal's sqrt(1 / fan_in), nothing past 2 sigma; zero
    biases. The same seed gives the same weights."""
    gen = torch.Generator().manual_seed(0)
    mlp = TM.MLPNet(4, 2, hiddens=(64, 32)).init_weights(gen)
    gains = {"pi_0": math.sqrt(2), "pi_1": math.sqrt(2), "vf_0": math.sqrt(2),
             "vf_1": math.sqrt(2), "Dense_0": 0.01, "Dense_1": 1.0}
    for name, gain in gains.items():
        w = getattr(mlp, name).weight.detach().double()
        small = min(w.shape)
        gram = w @ w.T if w.shape[0] == small else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(small),
                                   atol=1e-5 * gain ** 2 + 1e-12)
        assert torch.count_nonzero(getattr(mlp, name).bias) == 0
    cnn = TM.AtariCNN((84, 84, 4), 6).init_weights(
        torch.Generator().manual_seed(0))
    assert cnn.Dense_0.weight.shape == (512, 11 * 11 * 64)
    for name, mod in cnn.named_children():
        w = mod.weight.detach().double()
        fan_in = w[0].numel()
        std = math.sqrt(1 / fan_in)
        assert abs(float(w.mean())) < 4 * std / math.sqrt(w.numel()), name
        assert abs(float(w.std()) / std - 1) < 0.03 + 3 / math.sqrt(
            w.numel()), name
        assert float(w.abs().max()) <= 2 * std / .87962566103423978 + 1e-6
        assert torch.count_nonzero(mod.bias) == 0
    again = TM.AtariCNN((84, 84, 4), 6).init_weights(
        torch.Generator().manual_seed(0))
    for (k, a), b in zip(cnn.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


# ---- what the port refuses ----


def test_remote_eval_and_cardless_paths_raise():
    """Remote rollout workers and evaluation workers raise
    NotImplementedError (they never sample locally in their place); a
    cuda policy without a card raises instead of running on the CPU."""
    base = TR.PPOConfig().environment("CartPole-v1").resources(device="cpu")
    with pytest.raises(NotImplementedError, match="A1"):
        TR.PPOConfig().update_from_dict(
            dict(base.to_dict(), num_workers=2)).build()
    with pytest.raises(NotImplementedError, match="evaluation workers"):
        TR.PPOConfig().update_from_dict(dict(
            base.to_dict(), evaluation_interval=1,
            evaluation_num_workers=1)).build()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TPPO.PPOPolicy(TE.Box(-1, 1, (4,)), TE.Discrete(2), {})


def test_bench_ppo_loop_on_cpu():
    """bench.ppo_loop's CPU run: a narrow PixelCatcher PPO (21 x 21 x 2),
    its keys, finite losses, the split of the iteration's host time and
    weights that moved."""
    out = bench.ppo_loop(device="cpu")
    for k in ("ppo_env_steps_per_sec", "ppo_sample_time_ms",
              "ppo_postprocess_time_ms", "ppo_learn_time_ms",
              "ppo_env_steps_per_iter", "ppo_obs_shape"):
        assert k in out, k
    assert out["ppo_platform"] == "cpu"
    assert out["ppo_env_steps_per_sec"] > 0
    assert all(np.isfinite(out["ppo_total_losses"]))
    assert out["ppo_weights_moved"] > 0
    assert out["ppo_launches"] == {}
