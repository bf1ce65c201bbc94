"""The port's continuous-control and offline algorithms
(``ray_tpu_torch.rllib``: SAC, DDPG/TD3, offline JSON IO, BC/MARWIL,
CQL, CRR) against the JAX package's, on the CPU.

Each update is held from shared params (``params_from_flax``, the
target params and ``log_alpha`` too) on a fixed batch. The JAX update
draws its noise from the key ``learn_on_batch`` hands it; the test
computes those draws from the same key by JAX's own splits and gives
them to the port. The JAX optimizer is chained after a transformation
that keeps the gradients in its state, so one JAX update yields its
grads and its updated params. Whole DDPG steps are held where both
sides' streams agree: numpy exploration, the copied replay buffer and
deterministic updates. f32 values are held within F32 * (1 + max |JAX
value|). Where updates are held, both sides' policies get nets 32 wide
of their own classes (the width is a constructor argument of the port's
nets and a field of the flax modules, 256 by default) and optimizers
rebuilt over them; two threads.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib import env as JE
from ray_tpu.rllib import offline as JOFF
from ray_tpu.rllib import sample_batch as JSB
from ray_tpu.rllib.algorithms import bc as JBC
from ray_tpu.rllib.algorithms import cql as JCQL
from ray_tpu.rllib.algorithms import crr as JCRR
from ray_tpu.rllib.algorithms import ddpg as JDDPG
from ray_tpu.rllib.algorithms import sac as JSAC
from ray_tpu_torch import bench
from ray_tpu_torch import rllib as TR
from ray_tpu_torch.rllib import env as TE
from ray_tpu_torch.rllib import models as TM
from ray_tpu_torch.rllib import offline as TOFF
from ray_tpu_torch.rllib import sample_batch as TSB
from ray_tpu_torch.rllib.algorithms import bc as TBC
from ray_tpu_torch.rllib.algorithms import cql as TCQL
from ray_tpu_torch.rllib.algorithms import crr as TCRR
from ray_tpu_torch.rllib.algorithms import ddpg as TDDPG
from ray_tpu_torch.rllib.algorithms import sac as TSAC

F32 = 1e-5
H = 32
OBS_DIM, ACT_DIM = 3, 2


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


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _recording():
    """An optax transformation that passes the updates through and keeps
    them (the grads, first in a chain) as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _record_only():
    """Keeps the grads as its state and updates nothing."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


def _next_key(jp):
    """The key the JAX policy's next ``_next_rng()`` hands its update."""
    return jax.random.split(jp._rng)[1]


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def _per_key(key, n, shape):
    """``jax.vmap`` of a draw over ``split(key, n)``, one key at a time."""
    return np.stack([_normal(k, shape) for k in jax.random.split(key, n)])


def _sac_noise(key, b):
    r1, r2 = jax.random.split(key)
    return {"next": _normal(r1, (b, ACT_DIM)), "new": _normal(r2, (b, ACT_DIM))}


def _cql_noise(key, b, n=4):
    k = jax.random.split(key, 5)
    return {"next": _normal(k[0], (b, ACT_DIM)),
            "uniform": np.asarray(jax.random.uniform(
                k[1], (n, b, ACT_DIM), minval=-1.0, maxval=1.0)),
            "pi": _per_key(k[2], n, (b, ACT_DIM)),
            "next_pi": _per_key(k[3], n, (b, ACT_DIM)),
            "new": _normal(k[4], (b, ACT_DIM))}


def _crr_noise(key, b, n=4):
    k = jax.random.split(key, 3)
    return {"next": _normal(k[0], (b, ACT_DIM)),
            "pi": _per_key(k[1], n, (b, ACT_DIM))}


def _spaces():
    return ((JE.Box(-1, 1, (OBS_DIM,)), JE.Box(-2, 2, (ACT_DIM,))),
            (TE.Box(-1, 1, (OBS_DIM,)), TE.Box(-2, 2, (ACT_DIM,))))


def _narrow_params(model, act_dim=ACT_DIM, obs_dim=OBS_DIM):
    """(params, target) for ``model`` from numpy draws on flax's shapes
    (``eval_shape``: nothing compiles): kernels of variance 1 / fan_in,
    biases of 0.1. The target lies apart from the params, so that
    reading the wrong one shows."""
    dummy = (jnp.zeros((1, obs_dim)), jnp.zeros((1, act_dim)))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *dummy)
    rng = np.random.default_rng(1)

    def draw(leaf):
        scale = (1 / np.sqrt(leaf.shape[0]) if len(leaf.shape) == 2
                 else 0.1)
        return jnp.asarray(scale * rng.standard_normal(leaf.shape),
                           jnp.float32)

    return tuple(jax.tree_util.tree_map(draw, shapes["params"])
                 for _ in range(2))


def _unsaturated(params):
    """``params`` with pi's head scaled by 1/4, so that tanh(mean + std
    eps) stays off saturation: XLA's f32 tanh on the CPU is less exact
    than PyTorch's (test_squash_saturated_against_f64), and log(1 -
    tanh^2 + 1e-6) magnifies their last bits near |tanh| = 1."""
    head = params["pi_net"]["layers_4"]
    return {**params, "pi_net": {**params["pi_net"], "layers_4": {
        k: v / 4 for k, v in head.items()}}}


def _narrow_port(tp):
    """The port's SAC-family or DDPG policy ``tp`` on 32-wide nets: its
    model, target copy and Adam(s) rebuilt as its constructor builds
    them."""
    obs_dim = tp.observation_space.shape[-1]
    if isinstance(tp, TSAC.SACPolicy):
        tp.model = TSAC._SACNets(obs_dim, tp.act_dim, H)
        tp.optimizer = torch.optim.Adam(
            [*tp.model.parameters(), tp.log_alpha],
            lr=tp.config.get("lr", 3e-4), eps=1e-8)
    else:
        tp.model = TDDPG._DDPGNets(obs_dim, tp.act_dim,
                                   bool(tp.config.get("twin_q")), H)
        tp.pi_optimizer = torch.optim.Adam(
            tp.model.pi_net.parameters(),
            lr=tp.config.get("actor_lr", 1e-3), eps=1e-8)
        tp.q_optimizer = torch.optim.Adam(
            tp._q_params(), lr=tp.config.get("critic_lr", 1e-3), eps=1e-8)
    tp.target_model = copy.deepcopy(tp.model).requires_grad_(False)
    return tp


def _sac_pair(jcls, tcls, **over):
    """A JAX SAC-family policy on 32-wide nets (pi's head unsaturated)
    with its optimizer chained after ``_recording``, and the port's on
    32-wide nets from its params, target and ``log_alpha`` (-0.5)."""
    cfg = dict({"seed": 0, "lr": 3e-4}, **over)
    (jo, ja), (to, ta) = _spaces()
    jp = jcls(jo, ja, dict(cfg))
    jp.model = JSAC._SACNets(ACT_DIM, H)
    jp.params, jp.target_params = map(_unsaturated, _narrow_params(jp.model))
    jp.log_alpha = jnp.asarray(-0.5, jnp.float32)
    jp.optimizer = optax.chain(_recording(), jp.optimizer)
    jp.opt_state = jp.optimizer.init((jp.params, jp.log_alpha))
    tp = _narrow_port(tcls(to, ta, dict(cfg, device="cpu")))
    TM.load_offpolicy_from_flax(tp, jax.device_get(jp.params),
                                jax.device_get(jp.target_params),
                                float(jp.log_alpha))
    return jp, tp


def _sac_batch(n=24, seed=3, bc_weight=None):
    rng = np.random.default_rng(seed)
    b = TSB.SampleBatch({
        "obs": rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        "new_obs": rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        "raw_actions": rng.uniform(-0.999, 0.999,
                                   (n, ACT_DIM)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.2})
    if bc_weight is not None:
        b["_bc_weight"] = np.full((), bc_weight, np.float32)
    return b


def _hold_sac_update(jp, tp, batch, noise_fn, what):
    """One update on both sides: stats, grads (``log_alpha``'s too),
    params, target and ``log_alpha`` after it."""
    noise = noise_fn(_next_key(jp), batch.count)
    tgrads, gstats = tp.compute_gradients(batch, noise)
    jstats = jp.learn_on_batch(batch)
    _close_stats(tp.learn_on_batch(batch, noise), jstats, what)
    _close_stats(gstats, jstats, f"{what} compute_gradients")
    jgrads, jla_grad = jp.opt_state[0]
    _close(tgrads.pop("log_alpha"), jla_grad, F32, f"{what} log_alpha grad")
    _close_tree(tgrads, jgrads, f"{what} grad")
    _close_tree(tp.get_weights(), jp.params, f"{what} params")
    _close_tree(_state(tp.target_model), jp.target_params, f"{what} target")
    _close(tp.log_alpha, jp.log_alpha, F32, f"{what} log_alpha")
    return jgrads, jla_grad


# ---- the shared functions ----


def test_squash_and_dataset_logp_match_jax():
    """``_squash`` (one draw and, as CQL/CRR vmap it, 4 draws at once)
    off tanh's saturation (|mean + std eps| < 2.5) and
    ``_dataset_action_logp`` (actions up to the clip at 1 - 1e-6)
    against JAX's."""
    rng = np.random.default_rng(0)
    mean = rng.uniform(-0.5, 0.5, (16, ACT_DIM)).astype(np.float32)
    log_std = rng.uniform(-3, -0.3, (16, ACT_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = _normal(key, mean.shape)
    ja, jl = JSAC._squash(jnp.asarray(mean), jnp.asarray(log_std), key)
    ta, tl = TSAC._squash(*map(torch.tensor, (mean, log_std, eps)))
    _close(ta, ja, F32, "act")
    _close(tl, jl, F32, "logp")
    keys = jax.random.split(key, 4)
    ja, jl = jax.vmap(lambda k: JSAC._squash(jnp.asarray(mean),
                                            jnp.asarray(log_std), k))(keys)
    ta, tl = TSAC._squash(torch.tensor(mean), torch.tensor(log_std),
                          torch.tensor(_per_key(key, 4, mean.shape)))
    _close(ta, ja, F32, "act x4")
    _close(tl, jl, F32, "logp x4")
    mean = rng.standard_normal((16, ACT_DIM)).astype(np.float32)
    log_std = rng.uniform(-3, 1.5, (16, ACT_DIM)).astype(np.float32)
    acts = rng.uniform(-1, 1, mean.shape).astype(np.float32)
    acts[0] = [1.0, -1.0]
    acts[1] = [0.9999999, -0.999]
    want = JSAC._dataset_action_logp(*map(jnp.asarray, (acts, mean, log_std)))
    got = TSAC._dataset_action_logp(*map(torch.tensor,
                                         (acts, mean, log_std)))
    _close(got, want, F32, "dataset logp")


def test_squash_saturated_against_f64():
    """Where tanh saturates (|mean + std eps| up to ~12) the log-prob's
    log(1 - tanh^2 + 1e-6) magnifies tanh's last bits: there the port's
    ``_squash`` is held to the function in f64 on the same f32 inputs:
    no farther from it than JAX's, and within 0.1 (half an ulp of an f32
    tanh at 1 - 1e-6 moves the log term by ~0.02)."""
    rng = np.random.default_rng(1)
    mean = (3 * rng.standard_normal((256, ACT_DIM))).astype(np.float32)
    log_std = rng.uniform(-3, 1.5, mean.shape).astype(np.float32)
    key = jax.random.PRNGKey(6)
    eps = _normal(key, mean.shape)
    m, ls, e = (x.astype(np.float64) for x in (mean, log_std, eps))
    act = np.tanh(m + np.exp(ls) * e)
    want = np.sum(-0.5 * e ** 2 - ls - 0.5 * np.log(2 * np.pi)
                  - np.log(1 - act ** 2 + 1e-6), axis=-1)
    _, jl = JSAC._squash(jnp.asarray(mean), jnp.asarray(log_std), key)
    ta, tl = TSAC._squash(*map(torch.tensor, (mean, log_std, eps)))
    t_err = float(np.max(np.abs(tl.numpy() - want)))
    j_err = float(np.max(np.abs(np.asarray(jl) - want)))
    assert np.max(np.abs(act)) > 0.99999
    assert t_err <= min(0.1, j_err), (t_err, j_err)
    _close(ta, act, F32, "act")


def test_pi_and_q_match_jax():
    """``_SACNets.pi`` (log_std clipped to [-20, 2]) and ``q`` of both
    twins, and ``_DDPGNets.pi`` (tanh head) / ``q`` without ``q2_net``,
    from shared params."""
    rng = np.random.default_rng(1)
    obs = (5 * rng.standard_normal((8, OBS_DIM))).astype(np.float32)
    act = rng.uniform(-1, 1, (8, ACT_DIM)).astype(np.float32)
    jm = JSAC._SACNets(ACT_DIM, H)
    params, _ = _narrow_params(jm)
    params = jax.tree_util.tree_map(lambda x: 4 * x, params)  # pass the clips
    tm = TSAC._SACNets(OBS_DIM, ACT_DIM, H)
    TM.params_from_flax(jax.device_get(params), tm)
    apply = jax.jit(jm.apply, static_argnames="method")
    jmean, jls = apply({"params": params}, obs, method=JSAC._SACNets.pi)
    tmean, tls = tm.pi(torch.from_numpy(obs))
    assert float(jnp.max(jls)) == 2.0 or float(jnp.min(jls)) == -20.0
    _close(tmean, jmean, F32, "mean")
    _close(tls, jls, F32, "log_std")
    for g, w in zip(tm.q(*map(torch.from_numpy, (obs, act))),
                    apply({"params": params}, obs, act,
                          method=JSAC._SACNets.q)):
        _close(g, w, F32, "q")
    jd = JDDPG._DDPGNets(ACT_DIM, False, H)
    params, _ = _narrow_params(jd)
    td = TDDPG._DDPGNets(OBS_DIM, ACT_DIM, False, H)
    TM.params_from_flax(jax.device_get(params), td)
    assert not hasattr(td, "q2_net")
    apply = jax.jit(jd.apply, static_argnames="method")
    _close(td.pi(torch.from_numpy(obs)),
           apply({"params": params}, obs, method=JDDPG._DDPGNets.pi),
           F32, "ddpg pi")
    tq1, tq2 = td.q(*map(torch.from_numpy, (obs, act)))
    jq1, _ = apply({"params": params}, obs, act, method=JDDPG._DDPGNets.q)
    _close(tq1, jq1, F32, "ddpg q1")
    assert torch.equal(tq1, tq2)


def test_polyak_update_matches_jax():
    """The target blend (1 - tau) t + tau p over every param, as JAX's
    tree_map, at tau 0.005 and 0.3."""
    jm = JSAC._SACNets(ACT_DIM, H)
    params, target = _narrow_params(jm)
    for tau in (0.005, 0.3):
        want = jax.tree_util.tree_map(lambda t, p: (1 - tau) * t + tau * p,
                                      target, params)
        t_mod = TSAC._SACNets(OBS_DIM, ACT_DIM, H)
        p_mod = TSAC._SACNets(OBS_DIM, ACT_DIM, H)
        TM.params_from_flax(jax.device_get(target), t_mod)
        TM.params_from_flax(jax.device_get(params), p_mod)
        TSAC.polyak_update(t_mod, p_mod, tau)
        _close_tree(_state(t_mod), want, f"tau {tau}")


@pytest.mark.parametrize("twin_q", [True, False])
def test_params_from_flax_names_every_leaf(twin_q):
    """The nested flax trees (``pi_net.layers_0`` ...) map onto the port
    nets' state_dicts key for key (``pi_net.0`` ...): SAC's, DDPG's with
    and without ``q2_net``; the default width is 256."""
    nets = ((JSAC._SACNets(ACT_DIM), TSAC._SACNets(OBS_DIM, ACT_DIM)),
            (JDDPG._DDPGNets(ACT_DIM, twin_q),
             TDDPG._DDPGNets(OBS_DIM, ACT_DIM, twin_q)))
    for jm, tm in nets:
        params, _ = _narrow_params(jm)
        sd = TM.params_from_flax(jax.device_get(params), tm)
        assert set(sd) == set(tm.state_dict())
        assert tm.pi_net[0].weight.shape == (256, OBS_DIM)
        assert hasattr(tm, "q2_net") == (twin_q or isinstance(
            tm, TSAC._SACNets))


# ---- SAC, CQL, CRR updates ----


def test_sac_updates_match_jax():
    """Two SAC updates: the critic, actor and alpha losses summed under
    one Adam over (params, log_alpha); the target action from the target
    params; Polyak after the step."""
    jp, tp = _sac_pair(JSAC.SACPolicy, TSAC.SACPolicy)
    for seed in (3, 4):
        _hold_sac_update(jp, tp, _sac_batch(seed=seed), _sac_noise,
                         f"batch {seed}")


def test_cql_updates_match_jax():
    """A CQL update in each phase, in order (the BC warm-up's
    ``_bc_weight`` 1, then the SAC actor's 0): the conservative penalty
    over 4 uniform, policy and next-policy actions, the bellman loss,
    grads and params."""
    jp, tp = _sac_pair(JCQL.CQLPolicy, TCQL.CQLPolicy, cql_alpha=0.7)
    for seed, bc_weight in ((3, 1.0), (4, 0.0)):
        jgrads, _ = _hold_sac_update(
            jp, tp, _sac_batch(seed=seed, bc_weight=bc_weight), _cql_noise,
            f"bc {bc_weight}")
        assert np.any(np.asarray(jgrads["pi_net"]["layers_0"]["kernel"]))


@pytest.mark.parametrize("weight_type", ["exp", "binary"])
def test_crr_update_matches_jax(weight_type):
    """A CRR update per ``weight_type`` (exp at temperature 0.5 with its
    clip taken): the advantage against the mean min-Q of 4 policy
    samples; ``log_alpha``'s gradient is zero and it stays."""
    jp, tp = _sac_pair(JCRR.CRRPolicy, TCRR.CRRPolicy,
                       weight_type=weight_type, temperature=0.5, max_weight=3.0)
    batch = _sac_batch()
    batch["rewards"] = 4 * batch["rewards"]
    _, la_grad = _hold_sac_update(jp, tp, batch, _crr_noise, weight_type)
    assert float(la_grad) == 0.0 and float(tp.log_alpha.detach()) == -0.5


def test_sac_draws_its_own_noise_when_none_given():
    """Without ``noise`` the port draws from its generator: a finite
    update whose draws differ from a second policy's with another
    seed."""
    (_, _), (to, ta) = _spaces()
    stats = [TCQL.CQLPolicy(to, ta, {"seed": s, "device": "cpu"})
             .learn_on_batch(_sac_batch(bc_weight=0.0)) for s in (0, 1)]
    assert all(np.isfinite(v) for s in stats for v in s.values())
    assert stats[0]["actor_loss"] != stats[1]["actor_loss"]


# ---- DDPG / TD3 ----


def _ddpg_pair(algo, opt=_recording, **over):
    cfg = {"DDPG": JDDPG.DDPGConfig, "TD3": JDDPG.TD3Config}[algo]().to_dict()
    cfg.update(seed=0, **over)
    (jo, ja), (to, ta) = _spaces()
    jp = JDDPG.DDPGPolicy(jo, ja, dict(cfg))
    jp.model = JDDPG._DDPGNets(ACT_DIM, cfg["twin_q"], H)
    jp.params, jp.target_params = _narrow_params(jp.model)
    jp.pi_optimizer = optax.chain(opt(), jp.pi_optimizer)
    jp.q_optimizer = optax.chain(opt(), jp.q_optimizer)
    jp.pi_opt_state = jp.pi_optimizer.init(jp.params)
    jp.q_opt_state = jp.q_optimizer.init(jp.params)
    tp = _narrow_port(TDDPG.DDPGPolicy(to, ta, dict(cfg, device="cpu")))
    TM.load_offpolicy_from_flax(tp, jax.device_get(jp.params),
                                jax.device_get(jp.target_params))
    return jp, tp


def _ddpg_batch(seed=3, weights=False):
    b = _sac_batch(seed=seed)
    if weights:
        b["weights"] = np.random.default_rng(seed).uniform(
            0.2, 1.0, b.count).astype(np.float32)
    return b


@pytest.mark.parametrize("algo,weights", [("DDPG", True), ("TD3", False)])
def test_ddpg_grads_match_jax(algo, weights):
    """Critic and actor grads at shared params (a JAX optimizer that
    records and moves nothing, the actor every step): TD3's smoothing
    noise from the key, the replay weights, per-sample td_errors."""
    jp, tp = _ddpg_pair(algo, _record_only, policy_delay=1)
    batch = _ddpg_batch(weights=weights)
    noise = _normal(_next_key(jp), (batch.count, ACT_DIM))
    tgrads, tstats = tp.compute_gradients(batch, noise)
    jstats = jp.learn_on_batch(batch)
    _close_stats(tstats, jstats, algo)
    assert tstats["td_errors"].shape == (batch.count,)
    _close_tree(tgrads["critic"], jp.q_opt_state[0], "critic grad")
    _close_tree(tgrads["actor"], jp.pi_opt_state[0], "actor grad")
    assert not np.any(tgrads["critic"]["pi_net.0.weight"])
    assert not np.any(tgrads["actor"]["q1_net.0.weight"])


@pytest.mark.parametrize("algo", ["DDPG", "TD3"])
def test_ddpg_updates_match_jax(algo):
    """Three learn steps: the critic step and Polyak blend every step,
    the actor every ``policy_delay`` (TD3: steps 2 only); stats with
    td_errors, critic grads, params and target after each. The port's
    per-net Adams equal JAX's whole-tree ones (zero grads move nothing)."""
    jp, tp = _ddpg_pair(algo)
    for step in range(3):
        batch = _ddpg_batch(seed=10 + step, weights=step == 1)
        noise = _normal(_next_key(jp), (batch.count, ACT_DIM))
        jstats = jp.learn_on_batch(batch)
        tstats = tp.learn_on_batch(batch, noise)
        _close_stats(tstats, jstats, f"step {step}")
        assert ("actor_loss" in tstats) == (algo == "DDPG" or step == 1)
        _close_tree(tp.get_weights(), jp.params, f"params {step}")
        _close_tree(_state(tp.target_model), jp.target_params,
                    f"target {step}")
    assert tp.get_state()["learn_steps"] == 3


def test_ddpg_exploration_matches_jax():
    """compute_actions(explore=True) adds numpy's normal draws in JAX's
    order, clips to (-1, 1) and scales to the Box; greedy actions are
    the tanh head's."""
    jp, tp = _ddpg_pair("DDPG", exploration_noise=0.6)
    obs = np.random.default_rng(2).standard_normal((16, OBS_DIM)).astype(
        np.float32)
    for explore in (True, True, False):
        ja, jx = jp.compute_actions(obs, explore=explore)
        ta, tx = tp.compute_actions(obs, explore=explore)
        _close(ta, ja, F32, "actions")
        _close(tx["raw_actions"], jx["raw_actions"], F32, "raw")
        assert ta.dtype == np.float32 and set(tx) == set(jx)
    assert np.all(np.abs(tx["raw_actions"]) < 1.0)


def test_policy_state_round_trip():
    """SAC's and DDPG's ``get_state``/``set_state`` carry the weights,
    target, log_alpha and optimizers: a restored policy updates as the
    original does."""
    (_, _), (to, ta) = _spaces()
    for cls in (TSAC.SACPolicy, TDDPG.DDPGPolicy):
        cfg = {"seed": 0, "device": "cpu", "twin_q": True,
               "smooth_target_policy": True}
        a, b = cls(to, ta, dict(cfg)), cls(to, ta, dict(cfg, seed=1))
        a.learn_on_batch(_sac_batch(seed=5))
        b.set_state(a.get_state())
        noise = ({"next": np.zeros((24, ACT_DIM), np.float32),
                  "new": np.ones((24, ACT_DIM), np.float32)}
                 if cls is TSAC.SACPolicy else
                 np.zeros((24, ACT_DIM), np.float32))
        sa = a.learn_on_batch(_sac_batch(seed=6), noise)
        sb = b.learn_on_batch(_sac_batch(seed=6), noise)
        assert set(sa) == set(sb)
        for k, v in sa.items():
            np.testing.assert_array_equal(sb[k], v)
        for k, v in a.get_weights().items():
            np.testing.assert_array_equal(b.get_weights()[k], v)
        for k, v in _state(a.target_model).items():
            np.testing.assert_array_equal(_state(b.target_model)[k], v)


# ---- MARWIL / BC ----


def _marwil_pair(kind, beta):
    cfg = {"seed": 0, "lr": 1e-3, "beta": beta, "model":
           {"fcnet_hiddens": [H, H]}}
    if kind == "discrete":
        spaces = ((JE.Box(-1, 1, (4,)), JE.Discrete(2)),
                  (TE.Box(-1, 1, (4,)), TE.Discrete(2)))
    else:
        spaces = ((JE.Box(-1, 1, (3,)), JE.Box(-2, 2, (1,))),
                  (TE.Box(-1, 1, (3,)), TE.Box(-2, 2, (1,))))
    jp = JBC.MARWILPolicy(*spaces[0], dict(cfg))
    if kind == "box":
        jp.params = dict(jp.params, log_std=jnp.asarray([-0.3], jnp.float32))
    jp.optimizer = optax.chain(_recording(), jp.optimizer)
    jp.opt_state = jp.optimizer.init(jp.params)
    tp = TBC.MARWILPolicy(*spaces[1], dict(cfg, device="cpu"))
    TM.params_from_flax(jax.device_get(jp.params), tp.model)
    return jp, tp


def _marwil_batch(kind, n=40, seed=7):
    rng = np.random.default_rng(seed)
    obs_dim = 4 if kind == "discrete" else 3
    acts = (rng.integers(0, 2, n) if kind == "discrete"
            else rng.uniform(-2, 2, (n, 1)).astype(np.float32))
    return TSB.SampleBatch({
        "obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "actions": acts,
        "returns": (10 * rng.standard_normal(n)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32)})


@pytest.mark.parametrize("kind", ["discrete", "box"])
@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_bc_update_matches_jax(kind, beta):
    """MARWIL (beta 1: the advantage normalised with ddof 0, clipped at
    5, weights clipped at 20) and BC (beta 0) on discrete and
    diagonal-Gaussian actions: loss, stats, grads and one update."""
    jp, tp = _marwil_pair(kind, beta)
    batch = _marwil_batch(kind)
    tgrads, gstats = tp.compute_gradients(batch)
    jstats = jp.learn_on_batch(batch)
    tstats = tp.learn_on_batch(batch)
    _close_stats(tstats, jstats)
    _close_stats(gstats, {k: v for k, v in jstats.items()
                          if k != "grad_gnorm"})
    _close_tree(tgrads, jp.opt_state[0], "grad")
    _close_tree(tp.get_weights(), jp.params, "params")
    assert ("vf_loss" in tstats) == (beta > 0)


def _write_discrete_set(path, n=400, seed=0):
    """tests/test_rllib_algos2.py's MARWIL data: random CartPole-shaped
    rows with 5% terminals."""
    rng = np.random.default_rng(seed)
    w = JOFF.JsonWriter(path)
    w.write(JSB.SampleBatch({
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(2, size=n),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": rng.random(n) < 0.05,
        "new_obs": rng.normal(size=(n, 4)).astype(np.float32)}))
    w.close()


@pytest.mark.parametrize("algo", ["MARWIL", "BC"])
def test_marwil_bc_steps_match_jax(algo, tmp_path):
    """Two MARWIL.step()s / BC.step()s from one JSON set and shared
    params: the Monte Carlo returns bit-equal, the same numpy
    minibatches, stats and params after each."""
    path = str(tmp_path / "d")
    _write_discrete_set(path)
    cls = {"MARWIL": (JBC.MARWILConfig, TBC.MARWILConfig),
           "BC": (JBC.BCConfig, TBC.BCConfig)}[algo]
    cfg = dict(env="CartPole-v1", input_path=path, seed=0, lr=1e-3,
               train_batch_size=32, num_iters_per_step=3,
               model={"fcnet_hiddens": [H, H]})
    ja = cls[0]().update_from_dict(dict(cfg)).build()
    ta = cls[1]().update_from_dict(dict(cfg, device="cpu")).build()
    TM.params_from_flax(jax.device_get(ja.get_policy().params),
                        ta.get_policy().model)
    np.testing.assert_array_equal(ta._data["returns"], ja._data["returns"])
    for step in range(2):
        jr, tr = ja.step(), ta.step()
        assert jr["timesteps_total"] == tr["timesteps_total"] == 96 * (step + 1)
        _close_stats({k: v for k, v in tr.items() if k.startswith("learner/")},
                     {k: v for k, v in jr.items() if k.startswith("learner/")})
        _close_tree(ta.get_policy().get_weights(),
                    ja.get_policy().params, f"params {step}")
    assert set(tr["timers"]) == {"replay_time_ms", "learn_time_ms"}
    ja.cleanup()
    ta.cleanup()


# ---- offline IO ----


def _io_batch(sb, seed=0, n=7):
    rng = np.random.default_rng(seed)
    return sb.SampleBatch({
        "obs": rng.standard_normal((n, 3)).astype(np.float32),
        "actions": rng.integers(0, 5, n),
        "rewards": rng.standard_normal(n),
        "dones": rng.random(n) < 0.5,
        "frames": rng.integers(0, 256, (n, 2, 2, 3)).astype(np.uint8),
        "eps_id": np.arange(n, dtype=np.int64),
        "infos": np.array([{}] * n, dtype=object)})


def test_json_files_cross_packages(tmp_path):
    """A batch written by each package's JsonWriter gives byte-equal
    files (two files: rolled at a small ``max_file_size``); each
    package's JsonReader reads the other's bit-equal (object columns are
    not written)."""
    dirs = {}
    for name, mod, sb in (("jax", JOFF, JSB), ("torch", TOFF, TSB)):
        d = str(tmp_path / name)
        w = mod.JsonWriter(d, max_file_size=100)
        w.write(_io_batch(sb, 0))
        w.write(_io_batch(sb, 1))
        w.close()
        dirs[name] = d
    files = sorted(os.listdir(dirs["jax"]))
    assert files == sorted(os.listdir(dirs["torch"])) and len(files) == 2
    for f in files:
        with open(os.path.join(dirs["jax"], f), "rb") as a, \
                open(os.path.join(dirs["torch"], f), "rb") as b:
            assert a.read() == b.read()
    for reader, d in ((TOFF.JsonReader, dirs["jax"]),
                      (JOFF.JsonReader, dirs["torch"])):
        got = reader(d).read_all()
        want = TSB.SampleBatch.concat_samples(
            [_io_batch(TSB, 0), _io_batch(TSB, 1)])
        assert set(got) == set(want) - {"infos"}
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    single = TOFF.JsonReader(os.path.join(dirs["jax"], files[0])).read_all()
    assert single.count == 7
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="no offline data"):
        TOFF.JsonReader(str(tmp_path / "empty"))


def _write_pendulum_set(path):
    bench.write_pendulum_dataset(path, episodes=2, steps=60)


def test_pendulum_set_law_matches_fixture(tmp_path):
    """``bench.write_pendulum_dataset`` is the JAX fixture's noisy PD law
    (``tests/test_rllib_algos4.py``), computed here with the JAX
    package's env and writer from the same seeds: byte-equal files."""
    _write_pendulum_set(str(tmp_path / "port"))
    env, rng = JE.PendulumEnv({"seed": 0}), np.random.default_rng(0)
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones", "new_obs")}
    for ep in range(2):
        obs, _ = env.reset(seed=ep)
        for _ in range(60):
            cos_th, sin_th, thdot = obs
            th = np.arctan2(sin_th, cos_th)
            a = np.clip(-8.0 * th - 2.0 * thdot + rng.normal(0, 0.4), -2, 2)
            nobs, r, term, trunc, _ = env.step(np.array([a], np.float32))
            for k, v in zip(cols, (obs, [a], r, term or trunc, nobs)):
                cols[k].append(v)
            obs = nobs
    w = JOFF.JsonWriter(str(tmp_path / "jax"))
    w.write(JSB.SampleBatch({k: np.asarray(v, bool if k == "dones"
                                           else np.float32)
                             for k, v in cols.items()}))
    w.close()
    for f in ("output-00001.json",):
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("algo", ["CQL", "CRR"])
def test_offline_mixin_matches_jax(algo, tmp_path):
    """OfflineAlgorithmMixin: the dataset's actions rescaled into (-1, 1)
    and clipped at 0.999 bit-equal, three minibatches of the same rows;
    CQL's ``_bc_weight`` 1 for ``bc_iters`` learn steps, then 0."""
    path = str(tmp_path / "d")
    _write_pendulum_set(path)
    mods = {"CQL": (JCQL, TCQL), "CRR": (JCRR, TCRR)}[algo]
    cfg = dict(env="Pendulum-v1", input_path=path, seed=0)
    ja = getattr(mods[0], f"{algo}Config")().update_from_dict(dict(cfg)).build()
    ta = getattr(mods[1], f"{algo}Config")().update_from_dict(
        dict(cfg, device="cpu")).build()
    np.testing.assert_array_equal(ta._data["raw_actions"],
                                  ja._data["raw_actions"])
    assert np.max(np.abs(ta._data["raw_actions"])) == np.float32(0.999)
    for _ in range(3):
        jb, tb = ja._offline_minibatch(16), ta._offline_minibatch(16)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    if algo == "CQL":
        ta.config["bc_iters"] = 2
        weights = [float(ta._bc_minibatch(4)["_bc_weight"]) for _ in range(4)]
        assert weights == [1.0, 1.0, 0.0, 0.0]
    ja.cleanup()
    ta.cleanup()


def test_offline_needs_input_path():
    for cls in (TCQL.CQLConfig, TCRR.CRRConfig, TBC.MARWILConfig):
        with pytest.raises(ValueError, match="input_path"):
            cls().environment("Pendulum-v1").resources(device="cpu").build()


# ---- whole algorithms ----


def _ddpg_algos(**over):
    cfg = dict(dict(env="Pendulum-v1", num_workers=0, num_envs_per_worker=1,
                    rollout_fragment_length=32, train_batch_size=64,
                    learning_starts=64, seed=0), **over)
    ja = JDDPG.DDPGConfig().update_from_dict(dict(cfg)).build()
    ta = TDDPG.DDPGConfig().update_from_dict(dict(cfg, device="cpu")).build()
    jp = ja.get_policy()
    jp.model = JDDPG._DDPGNets(1, False, H)
    jp.params, jp.target_params = _narrow_params(jp.model, act_dim=1)
    jp.pi_opt_state = jp.pi_optimizer.init(jp.params)
    jp.q_opt_state = jp.q_optimizer.init(jp.params)
    TM.load_offpolicy_from_flax(_narrow_port(ta.get_policy()),
                                jax.device_get(jp.params),
                                jax.device_get(jp.target_params))
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


def test_five_ddpg_steps_match_jax():
    """test_ddpg_pendulum_smoke's config (1 env, fragments of 32, batch
    64, 64 steps before learning) from shared params: five DDPG.step()s
    with numpy's exploration draws and the copied uniform replay: the
    same sampled batches (obs and actions within F32: the actions differ
    by ulps and the env integrates them), replay size, stats, params and
    target after each step; actions inside the Box."""
    ja, ta = _ddpg_algos()
    jseen, tseen = _record_samples(ja), _record_samples(ta)
    for step in range(5):
        jr, tr = ja.step(), ta.step()
        jb, tb = jseen[-1], tseen[-1]
        for k in ("obs", "new_obs", "actions", "raw_actions", "rewards"):
            _close(tb[k], jb[k], F32, f"step {step} {k}")
        for k in ("dones", "truncateds", "eps_id"):
            np.testing.assert_array_equal(tb[k], jb[k])
        for k in ("replay_size", "timesteps_total"):
            assert jr[k] == tr[k], (step, k)
        _close_stats({k: v for k, v in tr.items() if k.startswith("learner/")},
                     {k: v for k, v in jr.items() if k.startswith("learner/")})
        jpol, tpol = ja.get_policy(), ta.get_policy()
        _close_tree(tpol.get_weights(), jpol.params, f"params {step}")
        _close_tree(_state(tpol.target_model), jpol.target_params,
                    f"target {step}")
    assert tr["replay_size"] == 160 and "learner/actor_loss" in tr
    assert set(tr["timers"]) == {"sample_time_ms", "replay_time_ms",
                                 "learn_time_ms"}
    a = ta.compute_single_action(np.zeros(3, np.float32))
    assert a.shape == (1,) and np.all(np.abs(a) <= 2.0)
    ja.cleanup()
    ta.cleanup()


def test_sac_and_td3_steps_on_pendulum():
    """test_sac_pendulum_smoke's and test_td3_twin_q_and_delay's configs
    on the port: the buffer grows, the losses are finite, actions stay
    inside the Box bounds; TD3 learns from the second step (64 rows), one
    update a step, its actor loss on even learn steps only."""
    cfg = dict(env="Pendulum-v1", rollout_fragment_length=32,
               train_batch_size=64, learning_starts=64, seed=0,
               device="cpu")
    sac = TSAC.SACConfig().update_from_dict(dict(cfg)).build()
    for _ in range(4):
        r = sac.step()
    assert r["replay_size"] == 128 and np.isfinite(r["learner/critic_loss"])
    a = sac.compute_single_action(np.zeros(3, np.float32))
    assert (-2.0 <= a).all() and (a <= 2.0).all()
    sac.cleanup()
    td3 = TDDPG.TD3Config().update_from_dict(dict(cfg)).build()
    assert hasattr(td3.get_policy().model, "q2_net")
    seen = [("learner/actor_loss" in td3.step()) for _ in range(4)]
    assert seen == [False, False, True, False]
    td3.cleanup()


@pytest.mark.parametrize("name", ["SAC", "DDPG", "TD3", "MARWIL", "BC",
                                  "CQL", "CRR"])
def test_default_configs_match_jax(name):
    """Each config's defaults equal the JAX config's (the port adds only
    ``device``)."""
    mods = {"SAC": (JSAC, TSAC), "DDPG": (JDDPG, TDDPG),
            "TD3": (JDDPG, TDDPG), "MARWIL": (JBC, TBC), "BC": (JBC, TBC),
            "CQL": (JCQL, TCQL), "CRR": (JCRR, TCRR)}[name]
    jd, td = (getattr(m, f"{name}Config")().to_dict() for m in mods)
    assert td.pop("device") == "cuda"
    assert td == jd


def test_exports_match_jax():
    """``ray_tpu_torch.rllib.algorithms`` exports the JAX package's names
    of these algorithms; ``ray_tpu_torch.rllib`` too, with the JSON IO."""
    from ray_tpu.rllib import algorithms as JALG
    from ray_tpu_torch.rllib import algorithms as TALG
    names = ("SAC", "DDPG", "TD3", "BC", "MARWIL", "CQL", "CRR")
    for name in names + tuple(f"{n}Config" for n in names):
        assert name in JALG.__all__ and name in TALG.__all__, name
        assert getattr(TR, name) is getattr(TALG, name)
    assert TR.JsonReader is TOFF.JsonReader and TR.JsonWriter is TOFF.JsonWriter


# ---- the bench loops at the tests' size ----


@pytest.mark.parametrize("algo", ["SAC", "TD3"])
def test_bench_replay_loops_on_cpu(algo):
    """bench.sac_loop / ddpg_loop's CPU runs (256 x 256 nets, batch 32):
    keys, the buffer grown, finite losses, weights that moved, actions
    inside the bounds, no launches; the profile hook gets a learn
    phase."""
    phases = []
    prof = lambda learn: phases.append(learn())  # noqa: E731
    out = (bench.sac_loop(device="cpu", profile=prof) if algo == "SAC"
           else bench.ddpg_loop(algo, device="cpu", profile=prof))
    p = algo.lower()
    assert out[f"{p}_platform"] == "cpu" and out[f"{p}_hidden"] == 256
    assert out[f"{p}_fill_iters"] == 32 and out[f"{p}_iters_timed"] == 16
    assert out[f"{p}_replay_size"][1] > out[f"{p}_replay_size"][0] >= 32
    assert out[f"{p}_losses_finite"] and out[f"{p}_weights_moved"] > 0
    lo, hi = out[f"{p}_action_range"]
    assert -2.0 <= lo < hi <= 2.0
    assert out[f"{p}_launches"] == {} and out[f"{p}_env_steps_per_sec"] > 0
    assert set(out[f"{p}_split"]) == {"sample_time_ms", "replay_time_ms",
                                      "learn_time_ms"}
    assert phases == [None]


@pytest.mark.parametrize("algo", ["CQL", "CRR", "MARWIL", "BC"])
def test_bench_offline_loop_on_cpu(algo):
    """bench.offline_loop's CPU run: 800 Pendulum rows written by the
    port's JsonWriter and read back; CQL passes its 5 BC steps; finite
    losses, weights that moved, no launches."""
    phases = []
    out = bench.offline_loop(algo, device="cpu",
                             profile=lambda learn: phases.append(learn()))
    assert out["offline_rows"] == 800 and out["offline_algo"] == algo
    assert out["offline_losses_finite"] and out["offline_weights_moved"] > 0
    assert out["offline_launches"] == {}
    assert out["offline_learn_steps_per_sec"] > 0
    if algo == "CQL":
        assert out["offline_learn_steps_total"] > out["offline_bc_iters"]
    assert "learner/total_loss" in phases[0]
