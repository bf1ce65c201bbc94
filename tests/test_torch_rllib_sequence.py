"""The port's recurrent and sequence algorithms (``ray_tpu_torch.rllib``:
R2D2, DT) and the flax trees they convert, against the JAX package's,
on the CPU.

Params cross with ``models.params_from_flax`` (the LSTM's input kernels
without bias, ``SelfAttention``'s 3-D kernels, ``LayerNorm``'s
``scale``, ``Embed``'s ``embedding``) and load with no key left over.
Numpy draws (the sequence replay, DT's windows, epsilon) are held
bit-equal; f32 values within F32 * (1 + max |JAX value|). The JAX
optimizer is chained around a transformation that keeps the grads it
is handed in its state (after R2D2's clip: the clipped grads). Nets are
narrow where a test holds a single update (widths are constructor
arguments of the nets and config keys of the JAX package); two
threads. The JAX algorithms are built by their own setup, with their
flax nets' ``init`` drawing the params from numpy on flax's shapes
(``eval_shape``, nothing compiles): flax's eager init compiles op by op,
5-7 s a net here.
"""

import functools


import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib import env as JE
from ray_tpu.rllib import offline as JOFF
from ray_tpu.rllib import sample_batch as JSB
from ray_tpu.rllib.algorithms import dt as JDT
from ray_tpu.rllib.algorithms import r2d2 as JR2
from ray_tpu_torch import bench
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib.algorithms import dt as TDT
from ray_tpu_torch.rllib.algorithms import r2d2 as TR2
from ray_tpu_torch.rllib.algorithms.sac import _SACNets
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


def _close_tree(got_sd, want_tree, what=""):
    want = TM.params_from_flax(jax.device_get(want_tree))
    assert set(got_sd) == set(want), (sorted(got_sd), sorted(want))
    for k, w in want.items():
        _close(got_sd[k], w.numpy(), F32, f"{what} {k}")


def _close_stats(got, want, what=""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        _close(got[k], want[k], F32, f"{what} {k}")


def _load(model, tree):
    """``params_from_flax`` into ``model``, strictly: no key left over
    on either side."""
    sd = TM.params_from_flax(jax.device_get(tree))
    assert set(sd) == set(model.state_dict()), (
        sorted(set(sd) ^ set(model.state_dict())))
    model.load_state_dict(sd)
    return model


def _recording():
    """An optax transformation that passes the updates through and keeps
    them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


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
    """``module``'s params tree from numpy on flax's shapes
    (``eval_shape``: nothing compiles)."""
    shapes = jax.eval_shape(functools.partial(fnn.Module.init, module),
                            jax.random.PRNGKey(0), *dummy)
    return _numpy_tree(shapes["params"], seed)


@pytest.fixture(autouse=True, scope="module")
def _numpy_init():
    """The JAX algorithms' nets draw their params from numpy
    (``_shaped``) while this file runs."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JR2._RecurrentQNet, JDT._DTNet):
            mp.setattr(cls, "init", lambda self, rng, *dummy: {
                "params": _shaped(self, *dummy)})
        yield


# ---- the converter ----


def test_params_from_flax_keeps_earlier_trees_byte_equal():
    """The trees the earlier RL algorithms convert (MLPNet's flat tree
    with log_std, AtariCNN's convs, SAC's nested ``layers_{i}``) come
    out as the plain rule writes them: Dense kernels transposed, conv
    kernels HWIO -> OIHW, leaves as they are; byte-equal."""
    from ray_tpu.rllib import models as JM
    from ray_tpu.rllib.algorithms import sac as JSAC

    def old_rule(tree, prefix=""):
        out = {}
        for name, v in tree.items():
            key = prefix + name.replace("layers_", "")
            if isinstance(v, dict) and "kernel" in v:
                k = np.asarray(v["kernel"], np.float32)
                k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
                out[f"{key}.weight"] = np.array(k, order="C")
                out[f"{key}.bias"] = np.array(v["bias"], np.float32)
            elif isinstance(v, dict):
                out.update(old_rule(v, key + "."))
            else:
                out[key] = np.array(v, np.float32)
        return out

    trees = [_shaped(JM.MLPNet(2, (8, 8), free_log_std=True),
                     jnp.zeros((1, 3))),
             _shaped(JM.AtariCNN(3), jnp.zeros((1, 21, 21, 2))),
             _shaped(JSAC._SACNets(2, 8), jnp.zeros((1, 3)),
                     jnp.zeros((1, 2)))]
    for tree in trees:
        tree = jax.device_get(tree)
        got, want = TM.params_from_flax(tree), old_rule(tree)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
    # and the port's nets take them as before
    assert set(TM.params_from_flax(jax.device_get(trees[2]))) == set(
        _SACNets(3, 2, 8).state_dict())


# ---- R2D2 ----

OBS, ACTS, W = 4, 2, 16


@pytest.fixture(scope="module")
def r2d2_net():
    """The flax ``_RecurrentQNet`` (16 wide) with numpy params, and the
    port's loaded from them."""
    jnet = JR2._RecurrentQNet(ACTS, W, W)
    params = _shaped(jnet, jnp.zeros((1, 5, OBS)), seed=1)
    tnet = _load(TR2._RecurrentQNet(OBS, ACTS, W, W), params)
    return jnet, params, tnet


def test_r2d2_tree_names():
    """The flax tree at the default widths (``_RecurrentQNet(2).init``)
    converts and loads into the port's net with no key left over: the
    LSTM's input kernels alone, its hidden kernels with biases."""
    tree = _shaped(JR2._RecurrentQNet(2), jnp.zeros((1, 3, 4)))
    assert "bias" not in tree["cell"]["if"]
    assert tree["cell"]["hf"]["bias"].shape == (64,)
    net = _load(TR2._RecurrentQNet(4, 2), tree)
    np.testing.assert_array_equal(net.cell._modules["if"].weight.detach(),
                                  np.asarray(tree["cell"]["if"]["kernel"]).T)


def test_r2d2_step_and_unroll_match_jax(r2d2_net):
    """One ``step`` from a nonzero carry and a 7-step ``unroll`` of 3
    sequences: carry (c, h) and Q within F32."""
    jnet, params, tnet = r2d2_net
    rng = np.random.default_rng(2)
    c0 = rng.standard_normal((3, W)).astype(np.float32)
    h0 = rng.standard_normal((3, W)).astype(np.float32)
    x = rng.standard_normal((3, OBS)).astype(np.float32)
    (jc, jh), jq = jnet.apply({"params": params}, (c0, h0), x,
                              method=JR2._RecurrentQNet.step)
    with torch.no_grad():
        (tc, th), tq = tnet.step((torch.tensor(c0), torch.tensor(h0)),
                                 torch.tensor(x))
    for got, want, what in ((tc, jc, "c"), (th, jh, "h"), (tq, jq, "q")):
        _close(got, want, F32, f"step {what}")
    seq = rng.standard_normal((3, 7, OBS)).astype(np.float32)
    (jc, jh), jq = jnet.apply({"params": params}, JR2.zero_carry(3, W), seq,
                              method=JR2._RecurrentQNet.unroll)
    with torch.no_grad():
        (tc, th), tq = tnet.unroll(TR2.zero_carry(3, W), torch.tensor(seq))
    for got, want, what in ((tc, jc, "c"), (th, jh, "h"), (tq, jq, "q")):
        _close(got, want, F32, f"unroll {what}")


def _episode(rng, n):
    return {"obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "next_obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "actions": rng.integers(ACTS, size=n).astype(np.int64),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": np.arange(n) == n - 1}


def test_sequence_replay_matches_jax():
    """``_SequenceReplay``: episodes longer and shorter than the
    sequence, past the capacity (the oldest leave); ``sample`` bit-equal
    and ``num_steps`` equal."""
    rng = np.random.default_rng(3)
    eps = [_episode(rng, n) for n in (3, 12, 30, 8, 21)]
    jr, tr = JR2._SequenceReplay(4, 10, seed=5), TR2._SequenceReplay(4, 10,
                                                                     seed=5)
    for ep in eps:
        jr.add_episode(ep)
        tr.add_episode(ep)
    assert jr.num_steps == tr.num_steps == 12 + 30 + 8 + 21
    for _ in range(3):
        want, got = jr.sample(16), tr.sample(16)
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


R2D2_SMALL = dict(lstm_size=W, agent_hidden=W, seq_len=8, burn_in=2,
                  train_batch_size=6, lr=1e-3)


def _r2d2_pair(**over):
    """A JAX and a port R2D2 on CartPole with 16-wide nets, the port's
    params, target and Adam loaded from the JAX algorithm's."""
    from ray_tpu.rllib.algorithms.r2d2 import R2D2Config as JConfig
    from ray_tpu_torch.rllib.algorithms import R2D2Config as TConfig
    cfg = dict(R2D2_SMALL, **over)
    ja = JConfig().environment("CartPole-v1").training(**cfg).debugging(
        seed=0).build()
    ta = (TConfig().environment("CartPole-v1").training(**cfg)
          .resources(device="cpu").debugging(seed=0).build())
    _load(ta.model, ja.params)
    _load(ta.target_model, ja.target_params)
    return ja, ta


def _r2d2_batch(seed=4, b=6, t=8, reward_scale=1.0):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), np.float32)
    mask[0, 5:] = 0.0
    mask[3, 2:] = 0.0
    return {"obs": rng.standard_normal((b, t, OBS)).astype(np.float32),
            "next_obs": rng.standard_normal((b, t, OBS)).astype(np.float32),
            "actions": rng.integers(ACTS, size=(b, t)).astype(np.int64),
            "rewards": (reward_scale * rng.standard_normal((b, t))
                        ).astype(np.float32),
            "dones": rng.random((b, t)) < 0.2,
            "mask": mask}


@pytest.mark.parametrize("double_q,reward_scale", [(True, 300.0),
                                                   (False, 1.0)])
def test_r2d2_update_matches_jax(double_q, reward_scale):
    """One update on a fixed batch (padding and terminals inside) from
    shared params and a target apart from them: loss and stats, the
    grads after the clip (active with rewards x 300: the norm passes
    10), the new params within F32 of scale."""
    ja, ta = _r2d2_pair(double_q=double_q)
    ja.target_params = _numpy_tree(ja.target_params, 6)
    _load(ta.target_model, ja.target_params)
    ja.optimizer = optax.chain(optax.clip_by_global_norm(10.0), _recording(),
                               optax.adam(ja.config["lr"]))
    ja.opt_state = ja.optimizer.init(ja.params)
    update = jax.jit(ja._update_impl)
    batch = _r2d2_batch(reward_scale=reward_scale)
    params, opt_state, jstats = update(
        ja.params, ja.target_params, ja.opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()})
    tstats = {k: float(v) for k, v in ta._update(batch).items()}
    _close_stats(tstats, {k: float(v) for k, v in jstats.items()}, "stats")
    jgrads = jax.device_get(opt_state[1])
    gnorm = float(optax.global_norm(jgrads))
    assert (gnorm == pytest.approx(10.0, rel=1e-5)) == (reward_scale > 1)
    _close_tree({n: p.grad for n, p in ta.model.named_parameters()}, jgrads,
                "clipped grads")
    _close_tree(weights_of(ta.model), params, "params")


def test_r2d2_steps_match_jax():
    """Two whole ``step()``s past ``learning_starts`` (epsilon from 1 to
    0.5 over 64 steps, so greedy actions run too; a target sync every 48
    steps): the numpy draws agree, so the episodes in the replay are
    bit-equal; the results, params and target within F32 of scale."""
    over = dict(learning_starts=40, rollout_fragment_length=48,
                training_intensity=2, epsilon_timesteps=64,
                final_epsilon=0.5, target_network_update_freq=48)
    ja, ta = _r2d2_pair(**over)
    for i in range(3):
        jr, tr = ja.step(), ta.step()
        tr.pop("timers")
        for k in ("num_env_steps_sampled_this_iter", "epsilon",
                  "replay_episodes", "replay_steps", "episodes_total"):
            assert jr[k] == tr[k], (i, k)
        _close_stats({k: v for k, v in tr.items() if k.startswith("learner/")},
                     {k: v for k, v in jr.items() if k.startswith("learner/")},
                     f"step {i}")
    assert "learner/loss" in jr
    assert len(ja.replay._episodes) == len(ta.replay._episodes)
    for je, te in zip(ja.replay._episodes, ta.replay._episodes):
        for k in je:
            np.testing.assert_array_equal(te[k], je[k])
    _close_tree(weights_of(ta.model), ja.params, "params")
    _close_tree(weights_of(ta.target_model), ja.target_params, "target")


# ---- DT ----


def _jax_fixture_set(path, episodes):
    """tests/test_rllib_dt.py's CartPole fixture, by its own code (the
    JAX package's env and writer), at ``episodes`` episodes."""
    rng = np.random.default_rng(0)
    env = JE.CartPoleEnv({"seed": 0})
    cols = {k: [] for k in ("obs", "act", "rew", "done")}
    for ep in range(episodes):
        o, _ = env.reset(seed=ep)
        noise = 0.6 if ep % 2 else 0.15
        for t in range(120):
            a = int(o[2] + 0.4 * o[3] > 0)
            if rng.random() < noise:
                a = int(rng.integers(2))
            no, r, term, trunc, _ = env.step(a)
            ended = term or trunc or t == 119
            cols["obs"].append(o)
            cols["act"].append(a)
            cols["rew"].append(r)
            cols["done"].append(ended)
            o = no
            if ended:
                break
    SB = JSB.SampleBatch
    w = JOFF.JsonWriter(path)
    w.write(SB({SB.OBS: np.asarray(cols["obs"], np.float32),
                SB.ACTIONS: np.asarray(cols["act"], np.int64),
                SB.REWARDS: np.asarray(cols["rew"], np.float32),
                SB.DONES: np.asarray(cols["done"], bool)}))
    w.close()


@pytest.fixture(scope="module")
def dt_set(tmp_path_factory):
    """The fixture's 120 episodes written by ``bench.write_cartpole_dataset``
    (held byte-equal to the fixture's own code in
    ``test_cartpole_set_matches_fixture``)."""
    path = str(tmp_path_factory.mktemp("dt_set"))
    info = bench.write_cartpole_dataset(path)
    return path, info


def test_cartpole_set_matches_fixture(dt_set, tmp_path):
    """``bench.write_cartpole_dataset`` is the JAX DT fixture's law:
    byte-equal files from the same seeds; the fixture's returns (best
    120)."""
    path, info = dt_set
    _jax_fixture_set(str(tmp_path), 120)
    with open(tmp_path / "output-00001.json", "rb") as a, \
            open(f"{path}/output-00001.json", "rb") as b:
        assert a.read() == b.read()
    assert info["best_return"] == 120.0 and info["rows"] > 5000


DT_SMALL = dict(context_length=4, embed_dim=32, num_heads=4, num_layers=2,
                train_batch_size=16, num_iters_per_step=1)


@pytest.fixture(scope="module")
def dt_pair(dt_set):
    """A JAX and a port DT (context 4, width 32, 4 heads, 2 layers) on
    the fixture's set; the port's params loaded from the JAX
    algorithm's."""
    from ray_tpu.rllib.algorithms.dt import DTConfig as JConfig
    from ray_tpu_torch.rllib.algorithms import DTConfig as TConfig
    path, _ = dt_set
    ja = (JConfig().environment("CartPole-v1").offline_data(input_path=path)
          .training(**DT_SMALL).debugging(seed=0).build())
    ta = (TConfig().environment("CartPole-v1").offline_data(input_path=path)
          .training(**DT_SMALL).resources(device="cpu").debugging(seed=0)
          .build())
    _load(ta.model, ja.params)
    return ja, ta


def test_dt_tree_names():
    """``_DTNet(4, 2, 8).init``'s tree (3-D attention kernels, LayerNorm
    scales, Embed tables) converts and loads into the port's net with no
    key left over; a query kernel [d, heads, head_dim] becomes the
    Linear weight [heads * head_dim, d], ``out``'s [heads, head_dim, d]
    the weight [d, heads * head_dim]."""
    K = 8
    tree = _shaped(JDT._DTNet(4, 2, K), jnp.zeros((1, K, 1)),
                   jnp.zeros((1, K, 4)), jnp.zeros((1, K), jnp.int32),
                   jnp.zeros((1, K), jnp.int32))
    attn = tree["_CausalBlock_0"]["SelfAttention_0"]
    assert attn["query"]["kernel"].shape == (64, 4, 16)
    assert attn["out"]["kernel"].shape == (4, 16, 64)
    net = _load(TDT._DTNet(4, 2, K), tree)
    tattn = net._modules["_CausalBlock_0"].SelfAttention_0
    np.testing.assert_array_equal(
        tattn.query.weight.detach(),
        np.asarray(attn["query"]["kernel"]).reshape(64, 64).T)
    np.testing.assert_array_equal(tattn.query.bias.detach(),
                                  np.asarray(attn["query"]["bias"]).ravel())
    np.testing.assert_array_equal(
        tattn.out.weight.detach(),
        np.asarray(attn["out"]["kernel"]).reshape(64, 64).T)
    np.testing.assert_array_equal(net.Embed_1.weight.detach(),
                                  np.asarray(tree["Embed_1"]["embedding"]))
    np.testing.assert_array_equal(net.LayerNorm_0.weight.detach(),
                                  np.asarray(tree["LayerNorm_0"]["scale"]))


def test_dt_segment_and_sample_batch_match_jax(dt_pair):
    """``_segment``'s flat store (left pads, sentinel action -1,
    returns-to-go) and the episode table, the best return, then three
    ``_sample_batch``es: bit-equal."""
    ja, ta = dt_pair
    assert set(ja._flat) == set(ta._flat)
    for k in ja._flat:
        assert ja._flat[k].dtype == ta._flat[k].dtype, k
        np.testing.assert_array_equal(ta._flat[k], ja._flat[k])
    np.testing.assert_array_equal(ta._ep_bases, ja._ep_bases)
    np.testing.assert_array_equal(ta._ep_lengths, ja._ep_lengths)
    assert ta.target_return == ja.target_return == 120.0
    for _ in range(3):
        want, got = ja._sample_batch(32), ta._sample_batch(32)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_dt_segment_drops_partial_and_short_episodes():
    """A trailing fragment without done and an episode of one step are
    dropped, as in JAX (``_segment`` alone, context 3)."""
    from ray_tpu_torch.rllib.sample_batch import SampleBatch as SB
    dones = np.array([0, 0, 1, 1, 0, 0, 0, 1, 0, 0], bool)
    data = {SB.OBS: np.arange(40, dtype=np.float32).reshape(10, 4),
            SB.ACTIONS: np.arange(10) % 2,
            SB.REWARDS: np.ones(10, np.float32), SB.DONES: dones}
    ja, ta = JDT.DT.__new__(JDT.DT), TDT.DT.__new__(TDT.DT)
    ja.K = ta.K = 3
    ja._segment(JSB.SampleBatch(data))
    ta._segment(SB(data))
    np.testing.assert_array_equal(ta._ep_lengths, [3, 4])
    np.testing.assert_array_equal(ta._ep_lengths, ja._ep_lengths)
    np.testing.assert_array_equal(ta._ep_bases, ja._ep_bases)
    for k in ja._flat:
        np.testing.assert_array_equal(ta._flat[k], ja._flat[k])


def _dt_batch(ja, bs=16):
    """A JAX ``_sample_batch`` as numpy."""
    return {k: np.array(v) for k, v in ja._sample_batch(bs).items()}


def test_dt_forward_matches_jax(dt_pair):
    """The net's logits on a drawn batch (pads, sentinel actions, early
    timesteps) and past ``max_timestep`` (clipped to 1023) within F32."""
    ja, ta = dt_pair
    b = _dt_batch(ja)
    b["ts"] = b["ts"].copy()
    b["ts"][0, -1] = 5000
    args = [b[k] for k in ("rtg", "obs", "acts", "ts")]
    want = ja._jit_logits(ja.params, *map(jnp.asarray, args))
    _close(ta._logits(*args), want, F32, "logits")


def test_dt_update_matches_jax(dt_pair):
    """One update (the clip at 1, AdamW with decay 1e-4 on every leaf)
    on a drawn batch: NLL, accuracy, the new params within F32 of
    scale; the clip is active (the grads' norm passes 1)."""
    ja, ta = dt_pair
    ja.optimizer = optax.chain(_recording(), ja.optimizer)
    start = {**ja.params, "Dense_2": {
        k: v * 40 for k, v in ja.params["Dense_2"].items()}}
    _load(ta.model, start)
    opt_state = ja.optimizer.init(start)
    b = _dt_batch(ja)
    params, opt_state, jstats = jax.jit(ja._update_impl)(
        start, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
    assert float(optax.global_norm(opt_state[0])) > 1.0
    tstats = ta._update({k: torch.as_tensor(v) for k, v in b.items()})
    _close_stats({k: float(v) for k, v in tstats.items()},
                 {k: float(v) for k, v in jstats.items()}, "dt stats")
    _close_tree(weights_of(ta.model), params, "dt params")
    _load(ta.model, ja.params)  # back to the shared params
    ta.optimizer = torch.optim.AdamW(ta.model.parameters(), lr=1e-3,
                                     eps=1e-8, weight_decay=1e-4)


def test_dt_evaluate_windows_match_jax(dt_pair):
    """``evaluate`` on one episode: every rolling window (the current
    action -1 before the forward) and its logits within F32, the same
    actions, the same return."""
    ja, ta = dt_pair
    seen = {"jax": [], "port": []}
    jfn, tfn = ja._jit_logits, ta._logits

    def jrec(p, *args):
        out = jfn(p, *args)
        seen["jax"].append(([np.array(a) for a in args], np.asarray(out)))
        return out

    def trec(*args):
        out = tfn(*args)
        seen["port"].append(([np.array(a) for a in args], out.numpy()))
        return out

    ja._jit_logits, ta._logits = jrec, trec
    try:
        jev = ja.evaluate(num_episodes=1, target_return=60.0)
        tev = ta.evaluate(num_episodes=1, target_return=60.0)
    finally:
        ja._jit_logits, ta._logits = jfn, tfn
    assert tev == jev
    assert len(seen["port"]) == len(seen["jax"]) > 5
    for (targs, tout), (jargs, jout) in zip(seen["port"], seen["jax"]):
        for t, j in zip(targs, jargs):
            np.testing.assert_array_equal(t, j)
        assert targs[2][0, -1] == -1
        _close(tout, jout, F32, "window logits")


def test_r2d2_and_dt_defaults_and_device():
    """The configs' defaults equal the JAX configs' (the port adds only
    ``device``, "cuda" unless the caller asks for "cpu")."""
    from ray_tpu.rllib.algorithms.dt import DTConfig as JD
    from ray_tpu.rllib.algorithms.r2d2 import R2D2Config as JR
    from ray_tpu_torch.rllib.algorithms import DTConfig, R2D2Config
    for jc, tc in ((JR, R2D2Config), (JD, DTConfig)):
        jd, td = jc().to_dict(), tc().to_dict()
        assert td.pop("device") == "cuda"
        assert td == jd


def test_bench_r2d2_and_dt_loops_on_cpu():
    """bench.r2d2_loop / dt_loop's CPU runs: learning past
    ``learning_starts``, finite losses, weights that moved, a target
    sync that equals the online net, epsilon falling, no launches; the
    profile hook gets a learn phase."""
    phases = []
    prof = lambda learn: phases.append(learn())  # noqa: E731
    r = bench.r2d2_loop(device="cpu", profile=prof, timed=1)
    assert r["r2d2_platform"] == "cpu" and r["r2d2_lstm_size"] == 64
    assert r["r2d2_losses_finite"] and r["r2d2_weights_moved"] > 0
    assert r["r2d2_replay_size"][1] > r["r2d2_replay_size"][0] >= 64
    assert r["r2d2_epsilon"][1] < r["r2d2_epsilon"][0]
    assert r["r2d2_target_syncs"] == 1
    assert r["r2d2_target_equals_online_after_sync"] is True
    assert r["r2d2_launches"] == {}
    d = bench.dt_loop(device="cpu", profile=prof)
    assert d["dt_episodes"] == 12 and d["dt_data_best_return"] == 120.0
    assert d["dt_losses_finite"] and d["dt_weights_moved"] > 0
    assert d["dt_launches"] == {} and d["dt_learn_steps_per_sec"] > 0
    assert "loss" in phases[0] and "learner/action_nll" in phases[1]
