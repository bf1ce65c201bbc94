"""The port's AlphaZero and AlphaStar (``ray_tpu_torch.rllib.algorithms``)
against the JAX package's, on the CPU.

The board games and the PUCT search are host code copied as they are:
they are held bit-equal through one shared numpy evaluator. The nets
(``_PVNet``, ``_PolicyNet``: plain ``Dense_i`` trees) cross with
``models.params_from_flax`` and load with no key left over; JAX's are
drawn from numpy on flax's shapes (nonzero biases, so the L2 term on
the biases counts). Numpy draws (Dirichlet noise, moves, replay
indices, matchmaking) and host results (visit counts, the replay's pi
and z, matches, the payoff table) are held bit-equal; f32 values within
F32 * (1 + max |JAX value|). Two threads.
"""

import copy

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib.algorithms import alpha_star as JS
from ray_tpu.rllib.algorithms import alpha_zero as JZ
from ray_tpu_torch import bench
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib.algorithms import alpha_star as TS
from ray_tpu_torch.rllib.algorithms import alpha_zero as TZ
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


def _load(model, tree):
    """A JAX tree into ``model``, strictly: no key left over."""
    sd = TM.params_from_flax(jax.device_get(tree))
    assert set(sd) == set(model.state_dict()), (
        sorted(set(sd) ^ set(model.state_dict())))
    model.load_state_dict(sd)
    return model


def _close_sd(got_sd, want_tree, what=""):
    want = TM.params_from_flax(jax.device_get(want_tree))
    assert set(got_sd) == set(want)
    for k, w in want.items():
        _close(got_sd[k], w.numpy(), F32, f"{what} {k}")


def _numpy_tree(tree, seed, scale=1.0):
    """A tree of ``tree``'s shapes from numpy: kernels of variance
    scale² / fan_in, biases N(0, (0.1 scale)²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        s = (1 / np.sqrt(leaf.shape[-2]) if path[-1].key == "kernel"
             else 0.1)
        return jnp.asarray(scale * s * rng.standard_normal(leaf.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(autouse=True, scope="module")
def _numpy_init():
    """The JAX nets draw their params from numpy on flax's shapes while
    this file runs (flax's eager init compiles op by op)."""
    def init(self, rng, *dummy):
        shapes = jax.eval_shape(
            lambda r, *d: fnn.Module.init(self, r, *d), rng, *dummy)
        return {"params": _numpy_tree(shapes["params"], 0)}

    with pytest.MonkeyPatch.context() as mp:
        for cls in (JZ._PVNet, JS._PolicyNet):
            mp.setattr(cls, "init", init)
        yield


class _Recorded:
    """A numpy Generator whose draws of ``integers`` and ``choice`` are
    kept."""

    def __init__(self, rng):
        self.rng, self.seen = rng, []

    def integers(self, *args, **kw):
        out = self.rng.integers(*args, **kw)
        self.seen.append(("integers", np.asarray(out).tolist()))
        return out

    def choice(self, *args, **kw):
        out = self.rng.choice(*args, **kw)
        self.seen.append(("choice", np.asarray(out).tolist()))
        return out

    def __getattr__(self, name):
        return getattr(self.rng, name)


# ---- the games and the search: host code, bit-equal ----


def _evaluator(seed, n_actions):
    """A numpy net: fixed logits and value from the obs, as floats both
    searches read alike."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((1000, n_actions)).astype(np.float32)

    def evaluate(obs):
        x = obs.reshape(obs.shape[0], -1)
        logits = x @ w[:x.shape[1]]
        return logits, np.tanh(logits.sum(-1) / 7).astype(np.float32)

    return evaluate


@pytest.mark.parametrize("game", ["tictactoe", "connect4"])
def test_games_and_mcts_match_jax(game):
    """Random playouts through both copies of the game: legal moves,
    next states, terminal values and observations equal. Then a
    self-play game of PUCT searches (Dirichlet noise on, 30 sims) with
    one numpy evaluator on both sides and one seed: the visit counts of
    every move and the moves equal, the rng states after equal."""
    jg, tg = JZ.GAMES[game](), TZ.GAMES[game]()
    assert (jg.num_actions, jg.obs_shape) == (tg.num_actions, tg.obs_shape)
    rng = np.random.default_rng(0)
    for _ in range(20):
        js, ts = jg.initial_state(), tg.initial_state()
        while True:
            jv, tv = jg.terminal_value(js), tg.terminal_value(ts)
            assert jv == tv
            np.testing.assert_array_equal(jg.observation(js),
                                          tg.observation(ts))
            if jv is not None:
                break
            legal = jg.legal_actions(js)
            np.testing.assert_array_equal(legal, tg.legal_actions(ts))
            a = int(rng.choice(legal))
            js, ts = jg.next_state(js, a), tg.next_state(ts, a)
            np.testing.assert_array_equal(js[0], ts[0])
            assert js[1] == ts[1]
    ev = _evaluator(1, jg.num_actions)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    mj, mt = JZ.MCTS(jg, ev, rng=rj), TZ.MCTS(tg, ev, rng=rt)
    js, ts = jg.initial_state(), tg.initial_state()
    moves = 0
    while jg.terminal_value(js) is None and moves < 12:
        cj, ct = mj.run(js, 30, add_noise=True), mt.run(ts, 30,
                                                        add_noise=True)
        np.testing.assert_array_equal(cj, ct)
        a = int(np.argmax(cj))
        js, ts = jg.next_state(js, a), tg.next_state(ts, a)
        moves += 1
    assert rj.random() == rt.random()


def test_connect4_terminal_machinery():
    """As the JAX oracle (test_rllib_modelbased.py:36): each of the four
    win directions ends the game with -1 for the player to move, on both
    copies; a full board with no line is a draw."""
    for G in (JZ.Connect4, TZ.Connect4):
        g = G()
        for moves in ([0, 1, 0, 1, 0, 1, 0],            # vertical
                      [0, 0, 1, 1, 2, 2, 3],            # horizontal
                      [0, 1, 1, 2, 2, 3, 2, 3, 3, 6, 3],  # diagonal /
                      [6, 5, 5, 4, 4, 3, 4, 3, 3, 0, 3]):  # diagonal \
            s = g.initial_state()
            for a in moves[:-1]:
                s = g.next_state(s, a)
                assert g.terminal_value(s) is None
            assert g.terminal_value(g.next_state(s, moves[-1])) == -1.0
        board = np.array([[1, 1, -1, -1, 1, 1, -1],
                          [-1, -1, 1, 1, -1, -1, 1]] * 3, np.int8)
        assert g.terminal_value((board, 1)) == 0.0


# ---- AlphaZero ----


def _az_pair(**over):
    cfg = dict(seed=0, **over)
    ja = JZ.AlphaZeroConfig().training(**cfg).build()
    ja.params = _numpy_tree(ja.params, 1)
    ja.opt_state = ja.optimizer.init(ja.params)
    ta = TZ.AlphaZeroConfig().training(**cfg).resources(device="cpu").build()
    _load(ta.model, ja.params)
    return ja, ta


@pytest.mark.parametrize("game", ["tictactoe", "connect4"])
def test_pvnet_evaluate_matches_jax(game):
    """``_evaluate`` (one position a call, logits and tanh value) on
    every position of a random game, within F32 of JAX's; the count of
    net calls kept."""
    ja, ta = _az_pair(env=game)
    g = ta.game
    s, rng, n = g.initial_state(), np.random.default_rng(2), 0
    while g.terminal_value(s) is None:
        obs = g.observation(s)[None]
        jl, jv = ja._evaluate(obs)
        tl, tv = ta._evaluate(obs)
        _close(tl, jl, F32, "logits")
        _close(tv, jv, F32, "value")
        s = g.next_state(s, int(rng.choice(g.legal_actions(s))))
        n += 1
    assert ta.evaluations == n


@pytest.mark.parametrize("game", ["tictactoe", "connect4"])
def test_alphazero_update_matches_jax(game):
    """Two updates on fixed batches (64 rows, pi on the simplex, z in
    {-1, 0, 1}): total, policy and value losses, and the params after
    Adam within F32; the L2 term covers every param, biases included
    (dropping the biases' share moves the total by far more than F32)."""
    ja, ta = _az_pair(env=game, l2_coeff=0.05)
    rng = np.random.default_rng(4)
    g = ta.game
    for i in range(2):
        obs = rng.integers(0, 2, (64,) + g.obs_shape).astype(np.float32)
        pi = rng.dirichlet(np.ones(g.num_actions), 64).astype(np.float32)
        z = rng.integers(-1, 2, 64).astype(np.float32)
        if i == 0:
            biases = sum(float(np.sum(np.asarray(v["bias"]) ** 2))
                         for v in ja.params.values())
            assert 0.05 * biases > 100 * F32
        ja.params, ja.opt_state, jst = ja._jit_update(
            ja.params, ja.opt_state, jnp.asarray(obs), jnp.asarray(pi),
            jnp.asarray(z))
        tst = TZ.stats_to_host(ta._update(obs, pi, z))
        for k, v in jst.items():
            _close(tst[k], float(v), F32, f"update {i} {k}")
        _close_sd(weights_of(ta.model), ja.params, f"update {i}")


def test_alphazero_training_steps_match_jax():
    """Two whole ``training_step``s (2 self-play games of 8 sims, 2 SGD
    iterations of 16 rows): the replay's obs, pi and z and the stored
    games bit-equal (the search reads the nets within F32), the replay
    indices and the numpy state bit-equal, the stats and the params
    within F32."""
    ja, ta = _az_pair(games_per_iteration=2, num_sims=8, sgd_iters=2,
                      train_batch_size=16)
    ja._np_rng, ta._np_rng = _Recorded(ja._np_rng), _Recorded(ta._np_rng)
    for i in range(2):
        jr, tr = ja.training_step(), ta.training_step()
        assert set(tr.pop("timers")) == {"search_time_ms", "replay_time_ms",
                                         "learn_time_ms"}
        assert set(tr) == set(jr)
        for k, v in jr.items():
            _close(tr[k], v, F32, f"step {i} {k}")
        assert len(ta._replay) == len(ja._replay)
        for (jo, jp, jz), (to, tp, tz) in zip(ja._replay, ta._replay):
            np.testing.assert_array_equal(jo, to)
            np.testing.assert_array_equal(jp, tp)
            assert jz == tz
        _close_sd(weights_of(ta.model), ja.params, f"step {i}")
    assert ta._np_rng.seen == ja._np_rng.seen
    assert ta._episode_reward_window == ja._episode_reward_window
    assert ta._np_rng.random() == ja._np_rng.random()


def test_alphazero_checkpoint_helpers_and_defaults():
    """The default config equals JAX's (the port adds only ``device``);
    the default net has JAX's shapes (Connect4's 84-wide obs too); a
    checkpoint (params twice, Adam's state) restores into a fresh
    algorithm with another seed; ``compute_action``, ``policy_action``
    and ``play_vs_random`` agree with JAX's on shared params;
    bench.alphazero_loop's CPU run. Without a card the default
    (``"cuda"``) build raises."""
    jd, td = JZ.AlphaZeroConfig().to_dict(), TZ.AlphaZeroConfig().to_dict()
    assert td.pop("device") == "cuda"
    assert td == jd
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TZ.AlphaZeroConfig().build()
    for game in ("tictactoe", "connect4"):
        ja, ta = _az_pair(env=game)
        assert {k: tuple(v.shape) for k, v in TM.params_from_flax(
            jax.device_get(ja.params)).items()} == {
            k: tuple(v.shape) for k, v in ta.model.state_dict().items()}
    ja, ta = _az_pair()
    s = ta.game.initial_state()
    s = ta.game.next_state(s, 4)
    assert ta.policy_action(s) == ja.policy_action(s)
    assert ta.compute_action(s, 20) == ja.compute_action(s, 20)
    assert ta.play_vs_random(6, seed=3) == ja.play_vs_random(6, seed=3)
    rng = np.random.default_rng(0)
    ta._update(rng.integers(0, 2, (8, 18)).astype(np.float32),
               np.full((8, 9), 1 / 9, np.float32), np.zeros(8, np.float32))
    state = ta.save_checkpoint()
    assert set(state) == {"params", "target_params", "opt_state",
                          "iteration", "timesteps_total"}
    for k, v in state["params"].items():
        np.testing.assert_array_equal(state["target_params"][k], v)
    fresh = TZ.AlphaZeroConfig().resources(device="cpu").debugging(
        seed=5).build()
    fresh.load_checkpoint(copy.deepcopy(state))
    for k, v in weights_of(ta.model).items():
        np.testing.assert_array_equal(weights_of(fresh.model)[k], v)
    sa, sf = ta.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(sf["state"][i][k], v), (i, k)
    r = bench.alphazero_loop(device="cpu", profile=lambda learn: learn())
    for k in ("alphazero_env_steps_per_sec", "alphazero_evals_per_sec",
              "alphazero_split", "alphazero_profile"):
        assert k in r, k
    assert r["alphazero_losses_finite"] and r["alphazero_weights_moved"] > 0
    assert r["alphazero_launches"] == {}


# ---- AlphaStar ----


def _as_pair(**over):
    """A JAX and a port AlphaStar, each JAX player drawn from numpy on its
    own seed (its Adam restarted), every port player loaded from it."""
    cfg = dict(seed=0, **over)
    ja = JS.AlphaStar(JS.AlphaStarConfig().to_dict() | cfg)
    for i, (pid, p) in enumerate(ja.league.items()):
        p.params = _numpy_tree(p.params, 10 + i)
        ja._opt_states[pid] = ja.optimizer.init(p.params)
    ja.params = ja.league[JS.MAIN].params
    ta = TS.AlphaStar(TS.AlphaStarConfig().to_dict() | cfg | {"device": "cpu"})
    assert list(ta.league) == list(ja.league)
    for pid, p in ja.league.items():
        _load(ta.league[pid].params, p.params)
    return ja, ta


def _hold_league(ja, ta, what):
    assert list(ta.league) == list(ja.league), what
    for pid, p in ja.league.items():
        tp = ta.league[pid]
        assert (tp.ptype, tp.games) == (p.ptype, p.games), (what, pid)
        _close_sd(weights_of(tp.params), p.params, f"{what} {pid}")
    assert ta.payoff == ja.payoff, what
    assert ta._snapshots == ja._snapshots


def test_alphastar_act_and_update_match_jax():
    """``_act`` on every position of a random game, sampled and greedy,
    from one seed: the moves, the observations and the numpy state
    after bit-equal. Then one update on a trajectory of 5 moves: the
    loss (pg with the advantage detached, vf_coeff 0.5, entropy 0.01)
    and the params after Adam within F32."""
    ja, ta = _as_pair()
    jp, tp = ja.league[JS.MAIN].params, ta.league[TS.MAIN].params
    g = ta.game
    s, rng = g.initial_state(), np.random.default_rng(6)
    ja._np_rng, ta._np_rng = np.random.default_rng(1), np.random.default_rng(1)
    while g.terminal_value(s) is None:
        for greedy in (False, True):
            (ja_, jo), (ta_, to) = (ja._act(jp, s, greedy),
                                    ta._act(tp, s, greedy))
            assert ja_ == ta_
            np.testing.assert_array_equal(jo, to)
        s = g.next_state(s, int(rng.choice(g.legal_actions(s))))
    assert ja._np_rng.random() == ta._np_rng.random()
    obs = rng.integers(0, 2, (5, 18)).astype(np.float32)
    acts = rng.integers(0, 9, 5).astype(np.int32)
    rets = np.full(5, -1.0, np.float32)
    new, _, jloss = ja._jit_update(jp, ja._opt_states[JS.MAIN],
                                   jnp.asarray(obs), jnp.asarray(acts),
                                   jnp.asarray(rets))
    tloss = ta._update(tp, ta._opt_states[TS.MAIN], obs, acts, rets)
    _close(tloss, float(jloss), F32, "loss")
    _close_sd(weights_of(tp), new, "main after update")


def test_alphastar_two_steps_match_jax():
    """Two whole ``step``s of 8 matches (a snapshot after each: interval
    1): the matchmaking, the moves (hence the matches), the payoff
    table, the roster and the games per player bit-equal; every
    player's params within F32; the results equal (the evaluations
    against a random player drawn in JAX's order)."""
    ja, ta = _as_pair(matches_per_iter=8, snapshot_interval=1)
    ja._np_rng, ta._np_rng = _Recorded(ja._np_rng), _Recorded(ta._np_rng)
    for i in range(2):
        jr, tr = ja.step(), ta.step()
        assert set(tr.pop("timers")) == {"play_time_ms", "learn_time_ms",
                                         "eval_time_ms"}
        jr.pop("time_total_s"), tr.pop("time_total_s")
        assert tr == jr, i
        _hold_league(ja, ta, f"step {i}")
    assert ta._np_rng.seen == ja._np_rng.seen
    assert ta._np_rng.random() == ja._np_rng.random()
    assert ta.model is ta.league[TS.MAIN].params
    assert ta.optimizer is ta._opt_states[TS.MAIN]


def test_alphastar_snapshot_is_a_copy():
    """After a snapshot the next updates step main in place: the
    snapshot keeps the weights main had (a clone, with no grad and no
    optimizer), and main moves away from it."""
    ta = TS.AlphaStar(TS.AlphaStarConfig().to_dict() | {
        "device": "cpu", "matches_per_iter": 6, "snapshot_interval": 1})
    ta.step()
    snap = ta.league["historical_0"]
    assert snap.ptype == TS.HISTORICAL and "historical_0" not in \
        ta._opt_states
    at_snapshot = weights_of(snap.params)
    for (n, p), q in zip(ta.league[TS.MAIN].params.named_parameters(),
                         snap.params.parameters()):
        assert p.data_ptr() != q.data_ptr(), n
        assert not q.requires_grad
    ta.step()
    for k, v in weights_of(snap.params).items():
        np.testing.assert_array_equal(at_snapshot[k], v)
    main = weights_of(ta.league[TS.MAIN].params)
    assert max(float(np.max(np.abs(main[k] - v)))
               for k, v in at_snapshot.items()) > 0


def test_alphastar_league_checkpoint_and_defaults():
    """The default config equals JAX's (the port adds only ``device``);
    ``pfsp_weights`` equals JAX's in its three modes; the checkpoint
    covers the whole league (roster, per-player weights and Adam state,
    payoff, snapshot counter, counters) as host copies; a fresh
    AlphaStar with another seed loaded from it holds the same league
    and takes the same next update for each learner;
    bench.alphastar_loop's CPU run. Without a card the default
    (``"cuda"``) build raises."""
    jd, td = JS.AlphaStarConfig().to_dict(), TS.AlphaStarConfig().to_dict()
    assert td.pop("device") == "cuda"
    assert td == jd
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TS.AlphaStarConfig().build()
    rates = np.array([0.9, 0.5, 0.1, 0.0])
    for mode in ("squared", "variance", "linear"):
        np.testing.assert_array_equal(TS.pfsp_weights(rates, mode),
                                      JS.pfsp_weights(rates, mode))
    ta = TS.AlphaStar(TS.AlphaStarConfig().to_dict() | {
        "device": "cpu", "matches_per_iter": 6, "snapshot_interval": 1})
    ta.step()
    state = ta.save_checkpoint()
    assert set(state) == {"league", "opt_states", "payoff", "snapshots",
                          "iteration", "timesteps_total"}
    assert set(state["opt_states"]) == {
        pid for pid, p in ta.league.items() if p.learnable}
    fresh = TS.AlphaStar(TS.AlphaStarConfig().to_dict() | {
        "device": "cpu", "seed": 1})
    fresh.load_checkpoint(copy.deepcopy(state))
    assert list(fresh.league) == list(ta.league)
    assert fresh.payoff == ta.payoff and fresh._snapshots == 1
    assert fresh._iteration == 1 and fresh.model is fresh.league[
        TS.MAIN].params
    obs = np.random.default_rng(0).integers(0, 2, (4, 18)).astype(np.float32)
    acts, rets = np.array([0, 4, 8, 2]), np.ones(4, np.float32)
    for pid, p in ta.league.items():
        f = fresh.league[pid]
        assert f.ptype == p.ptype and f.games == p.games
        for k, v in weights_of(p.params).items():
            np.testing.assert_array_equal(weights_of(f.params)[k], v)
        if p.learnable:
            assert float(ta._update(p.params, ta._opt_states[pid], obs, acts,
                                    rets)) == float(fresh._update(
                f.params, fresh._opt_states[pid], obs, acts, rets))
            for k, v in weights_of(p.params).items():
                np.testing.assert_array_equal(weights_of(f.params)[k], v)
    r = bench.alphastar_loop(device="cpu", profile=lambda learn: learn())
    for k in ("alphastar_games_per_sec", "alphastar_split",
              "alphastar_snapshot_gap", "alphastar_profile"):
        assert k in r, k
    assert r["alphastar_losses_finite"] and r["alphastar_weights_moved"] > 0
    assert r["alphastar_snapshot_gap"] > 0 and r["alphastar_launches"] == {}
