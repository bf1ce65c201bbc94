"""The port's RLModule/Learner stack (``ray_tpu_torch.rllib.core``)
against the JAX package's, on the CPU.

RLModule's three forwards (shapes, and from shared params the JAX
module's values within 1e-5), the spec's determinism,
``PPOLearner.update_from_batch`` (stats and params) and the split
``compute_gradients`` / ``apply_gradients`` against JAX's on fixed
batches, multi-module routing, and the LearnerGroup's local mode (its
remote mode raises without a cluster; tests/test_torch_rllib_remote.py
runs it on one). Params cross with ``params_from_flax``.
"""

import numpy as np
import pytest
import torch

import jax

from ray_tpu.rllib import core as JCORE
from ray_tpu.rllib import env as JE
from ray_tpu_torch.rllib import core as TCORE
from ray_tpu_torch.rllib import env as TE
from ray_tpu_torch.rllib.models import params_from_flax

# f32: the two sides sum in other orders, a few ulps per op; held
# within F32 * (1 + max |JAX value|). A step of Adam moves each param
# by about lr whatever |g| is, so the two sides' gradient differences
# near g = 0 are amplified; the params after steps are held to the same
# bound all the same.
F32 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    scale = 1.0 + float(np.max(np.abs(want)))
    assert err <= F32 * scale, f"{what}: max err {err} > {F32} * {scale}"


def _close_tree(got_sd, want_tree, what=""):
    want = params_from_flax(want_tree)
    assert set(got_sd) == set(want)
    for k, w in want.items():
        _close(got_sd[k], w.numpy(), f"{what} {k}")


def _spec(seed=0, continuous=False):
    if continuous:
        return TCORE.RLModuleSpec(observation_space=TE.Box(-1, 1, (4,)),
                                  action_space=TE.Box(-2, 2, (2,)),
                                  seed=seed, device="cpu")
    return TCORE.RLModuleSpec(observation_space=TE.Box(-1, 1, (4,)),
                              action_space=TE.Discrete(2), seed=seed,
                              device="cpu")


def _jspec(seed=0):
    return JCORE.RLModuleSpec(observation_space=JE.Box(-1, 1, (4,)),
                              action_space=JE.Discrete(2), seed=seed)


def _ppo_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (n,)).astype(np.int32),
        "action_logp": rng.uniform(-1.2, -0.3, (n,)).astype(np.float32),
        "advantages": rng.standard_normal((n,)).astype(np.float32),
        "value_targets": rng.standard_normal((n,)).astype(np.float32),
    }


@pytest.mark.parametrize("continuous", [False, True])
def test_rl_module_three_forwards(continuous):
    """As tests/test_rllib_core.py's: the shapes of the three forwards;
    exploration draws more than one action over a batch; forward_train
    returns the dist inputs and values only."""
    mod = _spec(continuous=continuous).build()
    n_act = 2
    batch = {"obs": np.zeros((8, 4), np.float32)}
    inf = mod.forward_inference(batch)
    want_actions = (8,) if not continuous else (8, n_act)
    assert inf["actions"].shape == want_actions
    assert inf["action_dist_inputs"].shape == (8, 2 if not continuous
                                               else 2 * n_act)
    exp = mod.forward_exploration(batch)
    assert exp["actions"].shape == want_actions and "action_logp" in exp
    exp2 = mod.forward_exploration(
        {"obs": np.random.default_rng(0).standard_normal(
            (512, 4)).astype(np.float32)})
    assert len({tuple(np.atleast_1d(a)) for a in exp2["actions"]}) > 1
    tr = mod.forward_train(batch)
    assert set(tr) == {"action_dist_inputs", "vf_preds"}


def test_rl_module_forwards_match_jax():
    """From the JAX module's params: forward_inference (greedy actions
    equal) and forward_train within 1e-5; the exploration's logp is
    the logp of the actions it drew."""
    jmod, tmod = _jspec(3).build(), _spec(3).build()
    params_from_flax(jax.device_get(jmod.params), tmod.model)
    batch = {"obs": np.random.default_rng(1).standard_normal(
        (32, 4)).astype(np.float32)}
    ji, ti = jmod.forward_inference(batch), tmod.forward_inference(batch)
    np.testing.assert_array_equal(ji["actions"], ti["actions"])
    for k in ("action_dist_inputs", "vf_preds"):
        _close(ti[k], ji[k], k)
    jt, tt = jmod.forward_train(batch), tmod.forward_train(batch)
    for k in jt:
        _close(tt[k], jt[k], k)
    te = tmod.forward_exploration(batch)
    logp = tmod.logp(torch.from_numpy(te["action_dist_inputs"]),
                     torch.from_numpy(te["actions"]))
    _close(te["action_logp"], logp.numpy(), "logp")


def test_rl_module_spec_is_deterministic():
    a, b = _spec(seed=7).build(), _spec(seed=7).build()
    sa, sb = a.get_state(), b.get_state()
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    c = _spec(seed=8).build()
    assert not all(np.allclose(c.get_state()[k], sa[k]) for k in sa)


@pytest.mark.parametrize("grad_clip", [None, 0.3])
def test_ppo_learner_update_matches_jax(grad_clip):
    """PPOLearner (clip 0.2, vf coeff 0.5, lr 5e-4 by default) from the
    JAX learner's params: three update_from_batch steps, stats
    (``grad_norm`` before clipping) and params within 1e-5 of their
    scale; with grad_clip 0.3 the norm passes the clip."""
    cfg = {"entropy_coeff": 0.01}
    if grad_clip:
        cfg["grad_clip"] = grad_clip
    jl = JCORE.PPOLearner(module_spec=_jspec(), config=dict(cfg))
    tl = TCORE.PPOLearner(module_spec=_spec(), config=dict(cfg))
    mid = JCORE.DEFAULT_MODULE_ID
    params_from_flax(jax.device_get(jl.module[mid].params),
                     tl.module[mid].model)
    for seed in range(3):
        batch = _ppo_batch(seed=seed)
        js = jl.update_from_batch(batch)[mid]
        ts = tl.update_from_batch(batch)[mid]
        assert set(js) == set(ts) == {"total_loss", "policy_loss",
                                      "vf_loss", "entropy", "grad_norm"}
        for k in js:
            _close(ts[k], js[k], k)
        if grad_clip:
            assert js["grad_norm"] > grad_clip
        _close_tree(tl.module[mid].get_state(),
                    jax.device_get(jl.module[mid].params), f"step {seed}")


def test_ppo_learner_update_reduces_loss():
    learner = TCORE.PPOLearner(module_spec=_spec(), config={"lr": 5e-3})
    batch = _ppo_batch()
    losses = [learner.update_from_batch(batch)["default_policy"]
              ["total_loss"] for _ in range(31)]
    assert losses[-1] < losses[0]


def test_learner_compute_then_apply_gradients_matches_jax():
    """Learner.compute_gradients (host grads by module) against JAX's
    within 1e-5, then apply_gradients of them on both sides: params
    within 1e-5."""
    jl = JCORE.PPOLearner(module_spec=_jspec(), config={"grad_clip": 0.3})
    tl = TCORE.PPOLearner(module_spec=_spec(), config={"grad_clip": 0.3})
    mid = JCORE.DEFAULT_MODULE_ID
    params_from_flax(jax.device_get(jl.module[mid].params),
                     tl.module[mid].model)
    batch = _ppo_batch(seed=4)
    jg, tg = jl.compute_gradients(batch), tl.compute_gradients(batch)
    _close_tree(tg[mid], jg[mid], "grads")
    jl.apply_gradients(jg)
    tl.apply_gradients(tg)
    _close_tree(tl.module[mid].get_state(),
                jax.device_get(jl.module[mid].params), "params")


def test_multi_module_learner_updates_only_named_modules():
    learner = TCORE.PPOLearner(module_specs={"a": _spec(1), "b": _spec(2)},
                               config={"lr": 1e-3})
    b_before = learner.module["b"].get_state()
    a_before = learner.module["a"].get_state()
    out = learner.update_from_batch({"a": _ppo_batch()})
    assert set(out) == {"a"}
    b_after = learner.module["b"].get_state()
    assert all(np.array_equal(b_before[k], b_after[k]) for k in b_before)
    a_after = learner.module["a"].get_state()
    assert not all(np.array_equal(a_before[k], a_after[k])
                   for k in a_before)
    with pytest.raises(ValueError, match="multi-module"):
        learner.update_from_batch(_ppo_batch())


def test_learner_group_local_mode():
    """As tests/test_rllib_core.py's, and the optimizer's state travels
    with the module's: a group restored from another's state takes the
    same next step."""
    group = TCORE.LearnerGroup(
        TCORE.PPOLearner, num_learners=0,
        learner_kwargs={"module_spec": _spec(), "config": {"lr": 5e-3}})
    assert group.is_local
    out = group.update_from_batch(_ppo_batch())
    assert "default_policy" in out
    state = group.get_state()
    group2 = TCORE.LearnerGroup(
        TCORE.PPOLearner, num_learners=0,
        learner_kwargs={"module_spec": _spec(9), "config": {"lr": 5e-3}})
    group2.set_state(state)
    sa, sb = state["module"], group2.get_state()["module"]
    for mid in sa:
        assert all(np.array_equal(sa[mid][k], sb[mid][k]) for k in sa[mid])
    a = group.update_from_batch(_ppo_batch(seed=1))
    b = group2.update_from_batch(_ppo_batch(seed=1))
    assert a == b
    group.shutdown()


def test_learner_group_remote_learners_raise():
    """Without a cluster of the port's runtime, remote learners raise:
    no local learner stands in for them
    (tests/test_torch_rllib_remote.py runs them on a cluster)."""
    import ray_tpu_torch
    assert not ray_tpu_torch.is_initialized()
    with pytest.raises(RuntimeError, match=r"init\(\) must be called"):
        TCORE.LearnerGroup(TCORE.PPOLearner, num_learners=2,
                           learner_kwargs={"module_spec": _spec()})
