"""The port's V-trace and value-based algorithms (``ray_tpu_torch.rllib``:
IMPALA, APPO, the learner thread, DQN/SimpleQ with the replay buffers,
PG/A2C, A3C) against the JAX package's, on the CPU.

V-trace is held against ``vtrace_scan`` and against an f64 row loop
(random cuts and terminals, active rho/c clips). The losses, stats and
grads come from shared params (``params_from_flax``) on fixed batches;
``learn_on_batch`` and the learner thread's updates are held by their
stats and params. The replay buffers are copies: equal seeds and adds
give equal contents, indexes and weights. Whole algorithms are held
step by step where both sides' streams agree: IMPALA, APPO and A2C
greedy (``explore=False``: the port's sampling draws from a
``torch.Generator``), DQN with its numpy epsilon draws and uniform
replay (prioritized draws could land on the other side of a sum-tree
boundary after updates that differ by an ulp; the buffers are held
with equal priorities instead). f32 values are held within
F32 * (1 + max |JAX value|).
"""

import copy
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib import env as JE
from ray_tpu.rllib import models as JM
from ray_tpu.rllib import replay_buffers as JRB
from ray_tpu.rllib import sample_batch as JSB
from ray_tpu.rllib.algorithms import a3c as JA3C
from ray_tpu.rllib.algorithms import appo as JAPPO
from ray_tpu.rllib.algorithms import dqn as JDQN
from ray_tpu.rllib.algorithms import impala as JIMPALA
from ray_tpu.rllib.algorithms import pg as JPG
from ray_tpu.rllib.algorithms import simple_q as JSQ
from ray_tpu.rllib.execution import LearnerThread as JLearnerThread
from ray_tpu_torch import bench
from ray_tpu_torch import rllib as TR
from ray_tpu_torch.rllib import env as TE
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib import replay_buffers as TRB
from ray_tpu_torch.rllib import sample_batch as TSB
from ray_tpu_torch.rllib.algorithms import a3c as TA3C
from ray_tpu_torch.rllib.algorithms import appo as TAPPO
from ray_tpu_torch.rllib.algorithms import dqn as TDQN
from ray_tpu_torch.rllib.algorithms import impala as TIMPALA
from ray_tpu_torch.rllib.algorithms import pg as TPG
from ray_tpu_torch.rllib.algorithms import simple_q as TSQ
from ray_tpu_torch.rllib.execution import LearnerThread as TLearnerThread

# f32 losses, stats, grads and params: the two sides sum in other orders
# (and V-trace's scan composes its products in another order), a few
# ulps per op; held within F32 * (1 + max |JAX value|)
F32 = 1e-5
MLP = {"fcnet_hiddens": [32, 32]}


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
    want = TM.params_from_flax(want_tree)
    assert set(got_sd) == set(want), (sorted(got_sd), sorted(want))
    for k, w in want.items():
        _close(got_sd[k], w.numpy(), F32, f"{what} {k}")


def _close_stats(got, want, what=""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        _close(got[k], want[k], F32, f"{what} {k}")


def _copy_params(jpolicy, tpolicy):
    TM.params_from_flax(jax.device_get(jpolicy.params), tpolicy.model)


# ---- V-trace ----


def _vtrace_inputs(n, seed, p_term=0.1, p_cut=0.15):
    rng = np.random.default_rng(seed)
    terms = (rng.random(n) < p_term).astype(np.float32)
    cuts = np.maximum(terms, rng.random(n) < p_cut).astype(np.float32)
    cuts[-1] = 1.0
    return [rng.uniform(-2.0, -0.1, n).astype(np.float32),
            rng.uniform(-2.0, -0.1, n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            (3 * rng.standard_normal(n)).astype(np.float32),
            (3 * rng.standard_normal(n)).astype(np.float32),
            terms, cuts]


@pytest.mark.parametrize("n,gamma,clip_rho,clip_c", [
    (1, 0.9, 1.0, 1.0), (37, 0.99, 1.0, 1.0), (64, 0.9, 0.8, 0.6),
    (500, 0.99, 1.0, 1.0), (500, 0.97, 1.5, 0.9)])
def test_vtrace_matches_jax_and_f64_loop(n, gamma, clip_rho, clip_c):
    """``vtrace`` (an associative scan) against ``vtrace_scan`` (a
    reverse ``lax.scan``) and against the f64 row loop, with random
    cuts and terminals and the rho/c clips taken (the log-ratios span
    about +-1.9): vs and pg_adv within 1e-5 of scale; no gradient."""
    args = _vtrace_inputs(n, seed=n)
    want = JIMPALA.vtrace_scan(*args, gamma, clip_rho=clip_rho,
                               clip_c=clip_c)
    f64 = TIMPALA.vtrace_f64(*args, gamma, clip_rho=clip_rho, clip_c=clip_c)
    targs = [torch.from_numpy(a) for a in args]
    targs[1].requires_grad_(True)
    got = TIMPALA.vtrace(*targs, gamma, clip_rho=clip_rho, clip_c=clip_c)
    for g, w, r, what in zip(got, want, f64, ("vs", "pg_adv")):
        assert not g.requires_grad
        _close(g, w, F32, f"{what} vs jax")
        _close(g, r, F32, f"{what} vs f64")
        _close(r, w, F32, f"f64 {what} vs jax")


def test_vtrace_reduces_to_td_when_on_policy():
    """tests/test_rllib.py's case: rho = c = 1, a one-row fragment:
    vs = value + delta, pg_adv = delta."""
    z = torch.zeros(1)
    vs, adv = TIMPALA.vtrace(z, z, torch.tensor([2.0]), torch.tensor([0.5]),
                             torch.tensor([1.0]), z, torch.ones(1), 0.9)
    assert float(vs[0]) == pytest.approx(2.9)
    assert float(adv[0]) == pytest.approx(2.4)


def test_reverse_linear_scan_matches_loop():
    """acc_t = b_t + a_t acc_{t+1} at lengths on and off powers of two."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 8, 9, 100):
        a = rng.uniform(0, 1, n)
        b = rng.standard_normal(n)
        want = np.zeros(n)
        acc = 0.0
        for t in range(n - 1, -1, -1):
            acc = b[t] + a[t] * acc
            want[t] = acc
        got = TIMPALA.reverse_linear_scan(torch.from_numpy(a),
                                          torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# ---- IMPALA / APPO policies on fixed batches ----


def _spaces(kind):
    if kind == "discrete":
        return ((JE.Box(-1, 1, (4,)), JE.Discrete(2)),
                (TE.Box(-1, 1, (4,)), TE.Discrete(2)))
    return ((JE.Box(-1, 1, (3,)), JE.Box(-2, 2, (1,))),
            (TE.Box(-1, 1, (3,)), TE.Box(-2, 2, (1,))))


def _policy_pair(jcls, tcls, kind, **cfg):
    (jo, ja), (to, ta) = _spaces(kind)
    cfg = dict({"seed": 0, "lr": 5e-4, "grad_clip": 40.0, "model": MLP},
               **cfg)
    jp = jcls(jo, ja, dict(cfg))
    tp = tcls(to, ta, dict(cfg, device="cpu"))
    if kind == "continuous":
        jp.params = dict(jp.params,
                         log_std=jnp.asarray([-0.3], jnp.float32))
    _copy_params(jp, tp)
    return jp, tp


def _vtrace_batch(kind, n=40, seed=7, obs=None):
    """A fixed IMPALA batch: the behaviour log-probs put the ratios on
    both sides of the clips; terminals and cuts inside it."""
    rng = np.random.default_rng(seed)
    obs_dim = 4 if kind == "discrete" else 3
    terms = rng.random(n) < 0.1
    cuts = np.maximum(terms, rng.random(n) < 0.15).astype(np.float32)
    cuts[-1] = 1.0
    cols = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "new_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "action_logp": rng.uniform(-2.5, -0.2, n).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": terms, "cuts": cuts,
            "eps_id": np.cumsum(cuts).astype(np.int64)}
    if obs is not None:
        cols["obs"], cols["new_obs"] = obs
    if kind == "discrete":
        cols["actions"] = rng.integers(0, 2 if obs is None else 3,
                                       n).astype(np.int32)
    else:
        cols["actions"] = rng.standard_normal((n, 1)).astype(np.float32)
    return JSB.SampleBatch(dict(cols)), TSB.SampleBatch(dict(cols))


ALGOS = {"IMPALA": (JIMPALA.IMPALAPolicy, TIMPALA.IMPALAPolicy),
         "APPO": (JAPPO.APPOPolicy, TAPPO.APPOPolicy)}


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
@pytest.mark.parametrize("algo", ["IMPALA", "APPO"])
def test_vtrace_loss_and_grads_match_jax(algo, kind):
    """IMPALAPolicy's / APPOPolicy's loss, stats (``mean_vtrace_adv``,
    ``mean_is_ratio``) and grads from shared params on a fixed batch,
    MLP with a categorical or a Gaussian head."""
    jp, tp = _policy_pair(*ALGOS[algo], kind)
    jb, tb = _vtrace_batch(kind)
    jg, js = jp.compute_gradients(jb)
    tg, ts = tp.compute_gradients(tb)
    _close_stats(ts, js, algo)
    _close_tree(tg, jg, "grad")


@pytest.mark.parametrize("algo", ["IMPALA", "APPO"])
def test_vtrace_loss_cnn_f32_matches_jax(algo):
    """The IMPALA / APPO loss through AtariCNN in f32 at 21 x 21 x 2 (both
    sides' model swapped for an f32 one with the same params; the
    bootstrap forward on ``new_obs`` included): loss, stats and grads."""
    shape = (21, 21, 2)
    jcls, tcls = ALGOS[algo]
    cfg = {"seed": 0, "lr": 5e-4, "grad_clip": 40.0}
    jp = jcls(JE.Box(0, 255, shape, np.uint8), JE.Discrete(3), dict(cfg))
    tp = tcls(TE.Box(0, 255, shape, np.uint8), TE.Discrete(3),
              dict(cfg, device="cpu"))
    jp.model = JM.AtariCNN(3, compute_dtype=jnp.float32)
    tp.model = TM.AtariCNN(shape, 3, compute_dtype=torch.float32)
    _copy_params(jp, tp)
    rng = np.random.default_rng(9)
    n = 24
    frames = rng.integers(0, 256, (2, n, *shape)).astype(np.uint8)
    jb, tb = _vtrace_batch("discrete", n=n, obs=(frames[0], frames[1]))
    jg, js = jp.compute_gradients(jb)
    tg, ts = tp.compute_gradients(tb)
    _close_stats(ts, js, algo)
    _close_tree(tg, jg, "grad")


@pytest.mark.parametrize("algo", ["IMPALA", "APPO"])
def test_vtrace_learn_on_batch_matches_jax(algo):
    """Two ``learn_on_batch`` calls (Adam's moments in the second):
    stats and params, and the integer columns stay on the host."""
    jp, tp = _policy_pair(*ALGOS[algo], "discrete")
    assert "eps_id" not in tp.loss_columns
    for seed in (7, 8):
        jb, tb = _vtrace_batch("discrete", seed=seed)
        _close_stats(tp.learn_on_batch(tb), jp.learn_on_batch(jb),
                     f"batch {seed}")
        _close_tree(tp.get_weights(), jax.device_get(jp.params),
                    f"params after batch {seed}")


# ---- the algorithms, greedy ----


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


def _hold_batches(jb, tb, what, float_cols=("action_logp", "vf_preds")):
    assert jb.count == tb.count, what
    for k in ("obs", "new_obs", "actions", "rewards", "dones",
              "truncateds", "eps_id"):
        np.testing.assert_array_equal(jb[k], tb[k], err_msg=f"{what} {k}")
    for k in float_cols:
        _close(tb[k], jb[k], F32, f"{what} {k}")


def _build(jcfg_cls, tcfg_cls, cfg):
    ja = jcfg_cls().update_from_dict(dict(cfg)).build()
    ta = tcfg_cls().update_from_dict(dict(cfg, device="cpu")).build()
    _copy_params(ja.get_policy(), ta.get_policy())
    return ja, ta


@pytest.mark.parametrize("algo", ["IMPALA", "APPO"])
def test_two_greedy_vtrace_steps_match_jax(algo):
    """Two IMPALA.step()s / APPO.step()s on test_impala_sync_smoke's
    config (CartPole, 2 envs x 25 steps, the sync path) with
    explore=False from shared params: the same batches (the second
    sampled with the trained params), stats and params after each."""
    cfgs = {"IMPALA": (JIMPALA.IMPALAConfig, TIMPALA.IMPALAConfig),
            "APPO": (JAPPO.APPOConfig, TAPPO.APPOConfig)}[algo]
    ja, ta = _build(*cfgs, dict(env="CartPole-v1", num_workers=0,
                                num_envs_per_worker=2,
                                rollout_fragment_length=25, seed=0,
                                explore=False))
    jseen, tseen = _record_samples(ja), _record_samples(ta)
    for step in range(2):
        jr, tr = ja.step(), ta.step()
        _hold_batches(jseen[-1], tseen[-1], f"step {step}")
        np.testing.assert_array_equal(jseen[-1]["cuts"], tseen[-1]["cuts"])
        assert tr["num_env_steps_sampled_this_iter"] == 50
        assert jr["timesteps_total"] == tr["timesteps_total"]
        _close_stats({k: v for k, v in tr.items() if k.startswith("learner/")},
                     {k: v for k, v in jr.items() if k.startswith("learner/")})
        _close_tree(ta.get_policy().get_weights(),
                    jax.device_get(ja.get_policy().params),
                    f"params after step {step}")
        assert set(tr["timers"]) == {"sample_time_ms", "postprocess_time_ms",
                                     "learn_time_ms"}
    ja.cleanup()
    ta.cleanup()


def test_impala_remote_branch_needs_the_runtime():
    """The default config (num_workers=1) raises A1's
    NotImplementedError; the async branch is never run locally."""
    with pytest.raises(NotImplementedError, match="A1"):
        TIMPALA.IMPALAConfig().environment("CartPole-v1").resources(
            device="cpu").build()
    algo = (TIMPALA.IMPALAConfig().environment("CartPole-v1")
            .rollouts(num_workers=0).resources(device="cpu").build())
    assert algo._learner is None
    with pytest.raises(NotImplementedError, match="A1"):
        algo._async_step()
    algo.cleanup()


# ---- the learner thread ----


def _learner_batches(k):
    return [_vtrace_batch("discrete", seed=20 + i) for i in range(k)]


def _wait_steps(thread, n, timeout=60.0):
    """Until the thread has learned ``n`` batches (``stop`` ends it after
    its current batch, queue or not)."""
    deadline = time.monotonic() + timeout
    while thread.num_steps < n and thread.is_alive():
        assert time.monotonic() < deadline, "learner thread stalled"
        time.sleep(0.005)


def _drain(thread, batches):
    thread.start()
    for b in batches:
        assert thread.put(b, timeout=10.0)
    _wait_steps(thread, len(batches))
    thread.stop()
    thread.join(timeout=60.0)
    assert not thread.is_alive()
    thread.check_error()


def test_learner_thread_matches_inline_and_jax():
    """Three fixed batches through the port's LearnerThread: the same
    params as ``learn_on_batch`` inline on a second policy from the same
    seed, and as JAX's LearnerThread on the JAX policy; the last stats,
    the counters and ``metrics()``' keys as JAX's."""
    batches = _learner_batches(3)
    jp, tp = _policy_pair(*ALGOS["IMPALA"], "discrete")
    _, inline = _policy_pair(*ALGOS["IMPALA"], "discrete")
    jt, tt = JLearnerThread(jp), TLearnerThread(tp)
    _drain(jt, [j for j, _ in batches])
    _drain(tt, [t for _, t in batches])
    for _, tb in batches:
        last = inline.learn_on_batch(tb)
    for k, v in inline.get_weights().items():
        _close(tt.get_weights()[k], v, F32, f"inline {k}")
    _close_tree(tt.get_weights(), jax.device_get(jp.params), "vs jax")
    _close_stats(tt.stats, jt.stats, "stats")
    _close_stats(tt.stats, last, "inline stats")
    assert set(tt.metrics()) == set(jt.metrics())
    assert tt.num_steps == jt.num_steps == 3
    assert tt.num_samples_trained == jt.num_samples_trained == 120


def test_learner_thread_surfaces_errors():
    """An error inside ``learn_on_batch`` (a batch without its ``cuts``)
    stops the thread and comes out of ``check_error`` and ``put`` with
    the original error as the cause, as the JAX thread's does."""
    _, tp = _policy_pair(*ALGOS["IMPALA"], "discrete")
    bad = _vtrace_batch("discrete")[1]
    del bad["cuts"]
    thread = TLearnerThread(tp)
    thread.start()
    assert thread.put(bad, timeout=10.0)
    thread.join(timeout=60.0)
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="learner thread died") as err:
        thread.check_error()
    assert isinstance(err.value.__cause__, KeyError)
    with pytest.raises(RuntimeError, match="learner thread died"):
        thread.put(_vtrace_batch("discrete")[1])


def test_learner_thread_weights_lock():
    """The main thread reads weights under the lock while the thread learns:
    every read is one whole state (all params from the same step),
    checked against the inline states after each step."""
    batches = [t for _, t in _learner_batches(6)]
    _, tp = _policy_pair(*ALGOS["IMPALA"], "discrete")
    _, inline = _policy_pair(*ALGOS["IMPALA"], "discrete")
    states = [inline.get_weights()]
    for b in batches:
        inline.learn_on_batch(b)
        states.append(inline.get_weights())
    thread = TLearnerThread(tp)
    thread.start()
    reads = []
    done = threading.Event()

    def feed():
        for b in batches:
            thread.put(b, timeout=10.0)
        _wait_steps(thread, len(batches))
        thread.stop()
        done.set()

    feeder = threading.Thread(target=feed)
    feeder.start()
    while not done.is_set() or thread.is_alive():
        reads.append(thread.get_weights())
        thread.join(timeout=0.001)
    feeder.join(timeout=60.0)
    thread.check_error()
    reads.append(thread.get_weights())
    for w in reads:
        assert any(all(np.array_equal(w[k], s[k]) for k in s)
                   for s in states)
    assert all(np.array_equal(reads[-1][k], states[-1][k])
               for k in states[-1])


# ---- replay buffers ----


def _replay_rows(i, n=3):
    return {"obs": np.full((n, 2), i, np.float32) + np.arange(n)[:, None],
            "rewards": np.full(n, i, np.float32),
            "actions": np.arange(n, dtype=np.int32) + i}


def test_replay_buffer_matches_jax():
    """Uniform: the same adds (wrapping around a capacity of 8) and seed
    give equal columns, sizes and draws."""
    bufs = [m.ReplayBuffer(capacity=8, seed=0) for m in (JRB, TRB)]
    for i in range(4):
        for buf, SB in zip(bufs, (JSB, TSB)):
            buf.add(SB.SampleBatch(_replay_rows(i)))
    assert len(bufs[0]) == len(bufs[1]) == 8
    for k in bufs[0]._cols:
        np.testing.assert_array_equal(bufs[0]._cols[k], bufs[1]._cols[k])
    for _ in range(3):
        js, ts = bufs[0].sample(16), bufs[1].sample(16)
        for k in js:
            np.testing.assert_array_equal(js[k], ts[k])
    assert set(np.unique(ts["rewards"])) <= {1.0, 2.0, 3.0}


def test_prioritized_replay_matches_jax():
    """Prioritized: equal adds and seed give equal indexes and weights;
    equal priority updates give equal sum trees and equal later draws
    (which the updated rows dominate)."""
    bufs = [m.PrioritizedReplayBuffer(capacity=64, alpha=0.6, seed=0)
            for m in (JRB, TRB)]
    for i, (buf, SB) in enumerate(zip(bufs, (JSB, TSB))):
        for j in range(4):
            buf.add(SB.SampleBatch(_replay_rows(j, n=8)))
    draws = [b.sample(8, beta=0.4) for b in bufs]
    for k in draws[0]:
        np.testing.assert_array_equal(draws[0][k], draws[1][k])
    prios = np.random.default_rng(1).uniform(50, 100, 8)
    for buf, d in zip(bufs, draws):
        buf.update_priorities(d["batch_indexes"], prios)
    np.testing.assert_array_equal(bufs[0]._tree.tree, bufs[1]._tree.tree)
    assert bufs[0]._max_priority == bufs[1]._max_priority
    again = [b.sample(64, beta=0.4) for b in bufs]
    for k in again[0]:
        np.testing.assert_array_equal(again[0][k], again[1][k])
    hot = set(draws[1]["batch_indexes"].tolist())
    assert np.mean([i in hot for i in again[1]["batch_indexes"]]) > 0.5


def test_sum_tree_matches_jax():
    trees = [m.SumTree(5) for m in (JRB, TRB)]
    for t in trees:
        for i, p in enumerate([1.0, 2.0, 3.0, 4.0, 0.5]):
            t.set(i, p)
    assert trees[1].capacity == 8 and trees[1].total() == 10.5
    for mass in (0.0, 0.5, 1.5, 5.99, 9.9, 10.4):
        assert (trees[0].find_prefixsum_idx(mass)
                == trees[1].find_prefixsum_idx(mass))


# ---- DQN ----


DQN_CFG = {"seed": 0, "lr": 5e-4, "gamma": 0.99, "model": MLP}


def _dqn_pair(**over):
    jp, tp = _policy_pair(JDQN.DQNPolicy, TDQN.DQNPolicy, "discrete",
                          **dict(DQN_CFG, **over))
    # a target unlike the online params, so double-Q's argmax differs
    tree = jax.device_get(jp.params)
    target = jax.tree_util.tree_map(
        lambda x: x + 0.3 * np.random.default_rng(x.size).standard_normal(
            x.shape).astype(np.float32), tree)
    jp.target_params = jax.tree_util.tree_map(jnp.asarray, target)
    TM.params_from_flax(target, tp.target_model)
    return jp, tp


def _dqn_batch(n=32, seed=3, weights=False):
    rng = np.random.default_rng(seed)
    cols = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "new_obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int64),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": rng.random(n) < 0.2,
            "batch_indexes": np.arange(n, dtype=np.int64)}
    if weights:
        cols["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return JSB.SampleBatch(dict(cols)), TSB.SampleBatch(dict(cols))


def _jax_dqn_grads(jp, jb):
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
    jbatch["_target_params"] = jp.target_params
    (loss, stats), grads = jax.value_and_grad(jp.loss, has_aux=True)(
        jp.params, jbatch)
    return loss, jax.device_get(stats), jax.device_get(grads)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_loss_and_grads_match_jax(double_q, weights):
    """DQNPolicy's loss, stats, per-sample ``td_errors`` and grads (the
    unreached value head's grads zero), double-Q on and off, with and
    without prioritized-replay ``weights``; ``compute_td_errors``."""
    jp, tp = _dqn_pair(double_q=double_q)
    jb, tb = _dqn_batch(weights=weights)
    jloss, jstats, jgrads = _jax_dqn_grads(jp, jb)
    tgrads, tstats = tp.compute_gradients(tb)
    _close(tstats["total_loss"], jloss, F32, "loss")
    for k, v in jstats.items():
        _close(tstats[k], v, F32, k)
    assert tstats["td_errors"].shape == (32,)
    _close_tree(tgrads, jgrads, "grad")
    assert not np.any(tgrads["Dense_1.weight"])
    assert tp.compute_td_errors(tb) == pytest.approx(
        jp.compute_td_errors(jb), rel=F32, abs=F32)


def test_dqn_loss_cnn_f32_matches_jax():
    """The DQN loss through AtariCNN in f32 at 21 x 21 x 2 (online and
    target swapped for f32 models on both sides), double-Q, weights."""
    shape = (21, 21, 2)
    jp = JDQN.DQNPolicy(JE.Box(0, 255, shape, np.uint8), JE.Discrete(3),
                        dict(DQN_CFG))
    tp = TDQN.DQNPolicy(TE.Box(0, 255, shape, np.uint8), TE.Discrete(3),
                        dict(DQN_CFG, device="cpu"))
    jp.model = JM.AtariCNN(3, compute_dtype=jnp.float32)
    tp.model = TM.AtariCNN(shape, 3, compute_dtype=torch.float32)
    _copy_params(jp, tp)
    tp.target_model = copy.deepcopy(tp.model)
    rng = np.random.default_rng(4)
    n = 16
    jb, tb = _dqn_batch(n=n, weights=True)
    frames = rng.integers(0, 256, (2, n, *shape)).astype(np.uint8)
    actions = rng.integers(0, 3, n)
    for b in (jb, tb):
        b["obs"], b["new_obs"], b["actions"] = frames[0], frames[1], actions
    jloss, jstats, jgrads = _jax_dqn_grads(jp, jb)
    tgrads, tstats = tp.compute_gradients(tb)
    _close(tstats["total_loss"], jloss, F32, "loss")
    for k, v in jstats.items():
        _close(tstats[k], v, F32, k)
    _close_tree(tgrads, jgrads, "grad")


def test_dqn_learn_target_and_state():
    """Two ``learn_on_batch`` against JAX's (stats with ``td_errors``,
    params); the target is its own module: learning leaves it alone,
    ``update_target`` copies the online params into it without aliasing
    them; ``get_state`` does not carry it (as JAX's)."""
    jp, tp = _dqn_pair()
    assert "batch_indexes" not in tp.loss_columns
    target0 = {k: v.clone() for k, v in tp.target_model.state_dict().items()}
    for seed in (3, 4):
        jb, tb = _dqn_batch(seed=seed, weights=True)
        _close_stats(tp.learn_on_batch(tb), jp.learn_on_batch(jb),
                     f"batch {seed}")
        _close_tree(tp.get_weights(), jax.device_get(jp.params),
                    f"params after batch {seed}")
    for k, v in tp.target_model.state_dict().items():
        assert torch.equal(v, target0[k]), k
    tp.update_target()
    jp.update_target()
    online = tp.model.state_dict()
    for k, v in tp.target_model.state_dict().items():
        assert torch.equal(v, online[k])
        assert v.data_ptr() != online[k].data_ptr()
    assert not any(p.requires_grad for p in tp.target_model.parameters())
    tp.learn_on_batch(_dqn_batch(seed=5)[1])
    assert not torch.equal(tp.target_model.state_dict()["Dense_0.weight"],
                           tp.model.state_dict()["Dense_0.weight"])
    assert set(tp.get_state()) == {"weights", "opt_state", "global_timestep"}


def test_dqn_epsilon_greedy_draws_match_jax():
    """compute_actions(explore=True) draws numpy's uniform and integers
    in JAX's order: with equal greedy actions the actions are equal,
    at epsilon 0.5 and after ``WorkerSet.set_exploration``-style
    updates."""
    jp, tp = _dqn_pair()
    obs = np.random.default_rng(5).standard_normal((64, 4)).astype(np.float32)
    for eps in (1.0, 0.5, 0.0):
        jp.exploration_epsilon = tp.exploration_epsilon = eps
        ja, _ = jp.compute_actions(obs, explore=True)
        ta, _ = tp.compute_actions(obs, explore=True)
        np.testing.assert_array_equal(ja, ta)
    greedy, _ = tp.compute_actions(obs, explore=False)
    np.testing.assert_array_equal(greedy, ta)


def _dqn_algos(cfg_cls=(JDQN.DQNConfig, TDQN.DQNConfig), **over):
    cfg = dict(dict(env="CartPole-v1", num_workers=0, num_envs_per_worker=2,
                    rollout_fragment_length=16, train_batch_size=32,
                    learning_starts=64, target_network_update_freq=64,
                    prioritized_replay=False, seed=0, model=MLP), **over)
    ja, ta = _build(*cfg_cls, cfg)
    TM.params_from_flax(jax.device_get(ja.get_policy().target_params),
                        ta.get_policy().target_model)
    return ja, ta


@pytest.mark.parametrize("double_q", [True, False])
def test_five_dqn_steps_match_jax(double_q):
    """test_dqn_smoke's config with uniform replay: five DQN.step()s from
    shared params (epsilon-greedy with numpy's draws): the same sampled
    batches (actions included), replay size, epsilon, stats, online and
    target params after each step; the target synced."""
    ja, ta = _dqn_algos(double_q=double_q)
    jseen, tseen = _record_samples(ja), _record_samples(ta)
    for step in range(5):
        jr, tr = ja.step(), ta.step()
        _hold_batches(jseen[-1], tseen[-1], f"step {step}",
                      float_cols=("vf_preds",))
        for k in ("epsilon", "replay_size", "timesteps_total"):
            assert jr[k] == tr[k], (step, k)
        _close_stats({k: v for k, v in tr.items() if k.startswith("learner/")},
                     {k: v for k, v in jr.items() if k.startswith("learner/")})
        jpol, tpol = ja.get_policy(), ta.get_policy()
        _close_tree(tpol.get_weights(), jax.device_get(jpol.params),
                    f"params after step {step}")
        _close_tree({k: v.numpy() for k, v in
                     tpol.target_model.state_dict().items()},
                    jax.device_get(jpol.target_params), f"target {step}")
    assert tr["timesteps_total"] == 5 * 32 and tr["replay_size"] == 160
    assert ta.num_target_updates == 2
    assert set(tr["timers"]) == {"sample_time_ms", "replay_time_ms",
                                 "learn_time_ms"}
    ja.cleanup()
    ta.cleanup()


def test_dqn_prioritized_steps():
    """Prioritized replay (test_dqn_smoke's config): the first learning
    step draws from equal priorities, so its stats equal JAX's; the
    port's td_errors then update the priorities and five steps run
    (later draws may differ from JAX's by a sum-tree boundary)."""
    ja, ta = _dqn_algos(prioritized_replay=True)
    for step in range(5):
        jr, tr = ja.step(), ta.step()
        if step == 1:
            _close_stats(
                {k: v for k, v in tr.items() if k.startswith("learner/")},
                {k: v for k, v in jr.items() if k.startswith("learner/")})
    assert tr["timesteps_total"] == 5 * 32 and tr["replay_size"] > 0
    assert ta.replay._max_priority > 1.0
    assert np.isfinite(tr["learner/total_loss"])
    ja.cleanup()
    ta.cleanup()


def test_simple_q_matches_jax():
    """SimpleQ pins double-Q and prioritized replay off (the JAX config's
    values) and its steps equal JAX's."""
    cfg = TSQ.SimpleQConfig()
    assert cfg["double_q"] is False and not cfg["prioritized_replay"]
    ja, ta = _dqn_algos((JSQ.SimpleQConfig, TSQ.SimpleQConfig))
    for _ in range(4):
        jr, tr = ja.step(), ta.step()
    assert "learner/mean_q" in tr
    _close_stats({k: v for k, v in tr.items() if k.startswith("learner/")},
                 {k: v for k, v in jr.items() if k.startswith("learner/")})
    _close_tree(ta.get_policy().get_weights(),
                jax.device_get(ja.get_policy().params), "params")
    ja.cleanup()
    ta.cleanup()


# ---- PG / A2C / A3C ----


def _pg_batch(n, seed=11):
    rng = np.random.default_rng(seed)
    cols = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "advantages": (2 + 3 * rng.standard_normal(n)).astype(np.float32),
            "value_targets": (5 * rng.standard_normal(n)).astype(np.float32),
            "eps_id": np.zeros(n, np.int64)}
    return JSB.SampleBatch(dict(cols)), TSB.SampleBatch(dict(cols))


@pytest.mark.parametrize("n", [5, 48])
@pytest.mark.parametrize("algo", ["PG", "A2C"])
def test_pg_a2c_loss_and_grads_match_jax(algo, n):
    """PG's and A2C's losses, stats and grads from shared params. The
    advantages are normalised by the population std (ddof 0, as
    ``jnp.std``): at n = 5 ddof 1 would move the loss by ~10%, far past
    the bound."""
    jcls, tcls = {"PG": (JPG.PGPolicy, TPG.PGPolicy),
                  "A2C": (JPG.A2CPolicy, TPG.A2CPolicy)}[algo]
    jp, tp = _policy_pair(jcls, tcls, "discrete")
    jb, tb = _pg_batch(n)
    jg, js = jp.compute_gradients(jb)
    tg, ts = tp.compute_gradients(tb)
    _close_stats(ts, js, algo)
    _close_tree(tg, jg, "grad")
    if n == 5:
        adv = torch.from_numpy(tb["advantages"])
        ddof1 = (adv - adv.mean()) / (adv.std() + 1e-8)
        assert float(torch.max(torch.abs(TPG.normalize(adv) - ddof1))) > 0.1


@pytest.mark.parametrize("algo", ["A2C", "PG"])
def test_greedy_pg_a2c_steps_match_jax(algo):
    """test_a2c_smoke's config (CartPole, 4 envs x 32 steps, batch 128)
    with explore=False: two steps' batches (GAE columns), stats and
    params."""
    cfgs = {"A2C": (JPG.A2CConfig, TPG.A2CConfig),
            "PG": (JPG.PGConfig, TPG.PGConfig)}[algo]
    ja, ta = _build(*cfgs, dict(env="CartPole-v1", num_envs_per_worker=4,
                                rollout_fragment_length=32,
                                train_batch_size=128, seed=0, explore=False,
                                model=MLP))
    jseen, tseen = _record_samples(ja), _record_samples(ta)
    for step in range(2):
        jr, tr = ja.step(), ta.step()
        assert tr["num_env_steps_sampled_this_iter"] == 128
        _hold_batches(jseen[-1], tseen[-1], f"step {step}")
        for k in ("advantages", "value_targets"):
            _close(tseen[-1][k], jseen[-1][k], F32, k)
        _close_stats({k: v for k, v in tr.items() if k.startswith("learner/")},
                     {k: v for k, v in jr.items() if k.startswith("learner/")})
        _close_tree(ta.get_policy().get_weights(),
                    jax.device_get(ja.get_policy().params),
                    f"params after step {step}")
    ja.cleanup()
    ta.cleanup()


def test_a3c_raises_as_jax():
    """num_workers=0: ValueError naming num_workers, as JAX's A3C; the
    default num_workers=2: the WorkerSet's A1 NotImplementedError comes
    first. The worker-side half (``_sample_and_grad``) runs on a local
    worker and gives JAX's grads from shared params (greedy)."""
    base = dict(env="CartPole-v1", device="cpu")
    with pytest.raises(ValueError, match="num_workers"):
        TA3C.A3CConfig().update_from_dict(dict(base, num_workers=0)).build()
    with pytest.raises(ValueError, match="num_workers"):
        JA3C.A3CConfig().environment("CartPole-v1").rollouts(
            num_workers=0).build()
    with pytest.raises(NotImplementedError, match="A1"):
        TA3C.A3CConfig().update_from_dict(base).build()
    from ray_tpu.rllib.rollout_worker import RolloutWorker as JRW
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker as TRW
    cfg = dict(env="CartPole-v1", rollout_fragment_length=20, seed=1,
               explore=False, model=MLP)
    jw, tw = JRW(dict(cfg), JPG.A2CPolicy), TRW(dict(cfg, device="cpu"),
                                                 TPG.A2CPolicy)
    _copy_params(jw.policy, tw.policy)
    (jg, js, jn), (tg, ts, tn) = (JA3C._sample_and_grad(jw),
                                  TA3C._sample_and_grad(tw))
    assert jn == tn == 20
    _close_stats(ts, js)
    _close_tree(tg, jg, "a3c grad")


@pytest.mark.parametrize("name", ["IMPALA", "APPO", "DQN", "SimpleQ", "PG",
                                  "A2C", "A3C"])
def test_default_configs_match_jax(name):
    """Each config's defaults equal the JAX config's (the port adds only
    ``device``)."""
    mods = {"IMPALA": (JIMPALA, TIMPALA), "APPO": (JAPPO, TAPPO),
            "DQN": (JDQN, TDQN), "SimpleQ": (JSQ, TSQ), "PG": (JPG, TPG),
            "A2C": (JPG, TPG), "A3C": (JA3C, TA3C)}[name]
    jd, td = (getattr(m, f"{name}Config")().to_dict() for m in mods)
    assert td.pop("device") == "cuda"
    assert td == jd


def test_exports_match_jax():
    """``ray_tpu_torch.rllib`` exports what ``ray_tpu.rllib`` does of these
    algorithms and buffers; the algorithms package, every one."""
    import ray_tpu.rllib as JR
    from ray_tpu_torch.rllib import algorithms as TALG
    for name in ("DQN", "DQNConfig", "IMPALA", "IMPALAConfig",
                 "ReplayBuffer", "PrioritizedReplayBuffer"):
        assert name in JR.__all__ and name in TR.__all__, name
    for name in ("IMPALA", "APPO", "DQN", "SimpleQ", "PG", "A2C", "A3C"):
        assert hasattr(TALG, name) and hasattr(TALG, f"{name}Config")


def test_worker_set_set_exploration():
    algo = (TR.DQNConfig().environment("CartPole-v1")
            .rollouts(num_workers=0).resources(device="cpu").build())
    algo.workers.set_exploration(exploration_epsilon=0.25)
    assert algo.get_policy().exploration_epsilon == 0.25
    assert algo.workers.remote_workers == []
    algo.cleanup()


# ---- the bench loops at the tests' size ----


@pytest.mark.parametrize("algo", ["IMPALA", "APPO"])
def test_bench_impala_loop_on_cpu(algo):
    """bench.impala_loop's CPU run (21 x 21 x 2, 2 envs x 16 steps): its
    keys, finite losses, the split, weights that moved, no launches; the
    profile hook gets a learn phase."""
    phases = []
    out = bench.impala_loop(device="cpu", algo=algo,
                            profile=lambda learn: phases.append(learn()))
    for k in ("impala_env_steps_per_sec", "impala_sample_time_ms",
              "impala_postprocess_time_ms", "impala_learn_time_ms"):
        assert k in out, k
    assert out["impala_platform"] == "cpu" and out["impala_algo"] == algo
    assert out["impala_obs_shape"] == [21, 21, 2]
    assert out["impala_env_steps_per_iter"] == 32
    assert all(np.isfinite(out["impala_total_losses"]))
    assert out["impala_weights_moved"] > 0
    assert out["impala_launches"] == {}
    assert "total_loss" in phases[0]


def test_bench_dqn_loop_on_cpu():
    """bench.dqn_loop's CPU run: it fills the buffer, learns, syncs the
    target and lowers epsilon; finite losses, weights that moved, no
    launches."""
    phases = []
    out = bench.dqn_loop(device="cpu",
                         profile=lambda learn: phases.append(learn()))
    assert out["dqn_platform"] == "cpu"
    assert out["dqn_obs_shape"] == [21, 21, 2]
    assert out["dqn_fill_iters"] == 8 and out["dqn_iters_timed"] == 8
    assert out["dqn_replay_size"][1] > out["dqn_replay_size"][0] >= 64
    assert out["dqn_epsilon"][1] < out["dqn_epsilon"][0] < 1.0
    assert out["dqn_target_updates"][1] > out["dqn_target_updates"][0]
    assert all(np.isfinite(out["dqn_total_losses"]))
    assert out["dqn_weights_moved"] > 0
    assert out["dqn_launches"] == {}
    assert out["dqn_env_steps_per_sec"] > 0
    assert phases == [None]
