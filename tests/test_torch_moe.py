"""The port's MoE layer against the JAX package's, on the CPU.

``MoE`` on one device, on dp2 x ep4 (8 gloo ranks: the experts in ep
blocks, the all_to_all dispatch, the routing over the global batch) and
on ep2 x tp2 and ep2 x sp2 (4 gloo ranks: tp ranks holding the same
tokens, sp ranks holding positions of them) against JAX's ``MoE``
unsharded (and on dp2 x ep4 on the same mesh of 8 virtual CPU
devices): y, aux and the gradients of mean(y^2) + 0.01 aux, at
tests/test_moe.py's tolerances (rtol 1e-4, atol 1e-5), with a capacity
that drops tokens and one that does not; ``expert_sharding_rule``
against JAX's. Inputs and params are made from seeds and handed to
every side.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.parallel import mesh as JM
from ray_tpu.parallel.moe import MoE as JMoE
from ray_tpu.parallel.moe import expert_sharding_rule as j_rule
from ray_tpu_torch.parallel import dryrun as D
from ray_tpu_torch.parallel import mesh as TM
from ray_tpu_torch.parallel import moe as TMoE

SPAWN_TIMEOUT_S = 120.0
RTOL, ATOL = 1e-4, 1e-5        # tests/test_moe.py
S, DM, FF, E = 32, 16, 32, 4
CAPACITY = {"keeps_all": 2.0, "drops": 0.5}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _x():
    return np.random.default_rng(0).standard_normal((S, DM)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax(cf):
    """JAX's MoE: params, and y, aux and the loss's grads unsharded; y
    on the dp2 x ep4 mesh (experts P("ep"), tokens P("dp"))."""
    layer = JMoE(num_experts=E, d_ff=FF, capacity_factor=cf)
    x = jnp.asarray(_x())
    params = layer.init(jax.random.PRNGKey(1), x)["params"]

    def loss(p):
        y, aux = layer.apply({"params": p}, x)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)
    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]).reshape(2, 4), ("dp", "ep"))
    shard = {"router": jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())),
        params["router"]),
        **{k: jax.device_put(params[k], NamedSharding(mesh, P("ep")))
           for k in ("experts_w1", "experts_w2")}}
    y_sh, _ = jax.jit(lambda p, xx: layer.apply({"params": p}, xx))(
        shard, jax.device_put(x, NamedSharding(mesh, P("dp"))))
    return (jax.device_get({"params": params}), np.asarray(y), float(aux),
            jax.device_get(grads), np.asarray(y_sh))


def _want_grads(grads):
    return {"router.weight": np.asarray(grads["router"]["kernel"]).T,
            "router.bias": np.asarray(grads["router"]["bias"]),
            "experts_w1": np.asarray(grads["experts_w1"]),
            "experts_w2": np.asarray(grads["experts_w2"])}


@functools.lru_cache(maxsize=None)
def _ep_runs():
    calls = [("ray_tpu_torch.parallel.dryrun", "moe_sgd", dict(
        spec=dict(dp=2, ep=4), x=_x(), d_ff=FF, capacity_factor=cf,
        params=_jax(cf)[0])) for cf in CAPACITY.values()]
    runs = D.spawn(D.call_all, 8, (calls,), timeout_s=SPAWN_TIMEOUT_S)
    return dict(zip(CAPACITY, runs[0])), [r for r in runs]


def _hold(run, cf):
    params, y, aux, grads, y_sh = _jax(cf)
    np.testing.assert_allclose(run["y"], y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(run["y"], y_sh, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(run["aux"], aux, rtol=RTOL, atol=ATOL)
    for k, want in _want_grads(grads).items():
        np.testing.assert_allclose(run["grads"][k], want, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    return y


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_matches_jax_unsharded(capacity):
    """One device, f32, 32 tokens over 4 experts: y, aux and the
    gradients of mean(y^2) + 0.01 aux against JAX's. At capacity factor
    0.5 (4 slots an expert) tokens are dropped and their y is zero."""
    cf = CAPACITY[capacity]
    run = D.moe_sgd(None, _x(), d_ff=FF, capacity_factor=cf,
                    params=_jax(cf)[0])
    y = _hold(run, cf)
    dropped = ~np.any(y != 0, axis=-1)
    assert dropped.any() == (capacity == "drops")
    assert not np.any(run["y"][dropped])
    assert run["losses"][1] < run["losses"][0]


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_dp2_ep4_matches_jax(capacity):
    """dp2 x ep4 on 8 gloo ranks: each ep rank routes 4 of its dp rank's
    16 tokens, the slots counted over the global token order, the
    experts computed in ep blocks (one expert a rank) and exchanged by
    all_to_all. y, aux and the whole gradients against JAX's unsharded
    layer (y also against JAX on the same mesh), at rtol 1e-4, atol
    1e-5; every rank reports the same losses; each rank stores one
    expert's block."""
    cf = CAPACITY[capacity]
    by_cf, ranks = _ep_runs()
    run = by_cf[capacity]
    _hold(run, cf)
    one = D.moe_sgd(None, _x(), d_ff=FF, capacity_factor=cf,
                    params=_jax(cf)[0])
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-6)
    assert all(r[list(CAPACITY).index(capacity)]["losses"] == run["losses"]
               for r in ranks)
    assert run["blocks"]["experts_w1"] == (1, DM, FF)
    assert run["blocks"]["router.weight"] == (E, DM)


# (mesh, the global x's shape: [S, d] or [B, T, d] for sp to split T)
EP_TP_SP = {"ep2_tp2": (dict(ep=2, tp=2), (S, DM)),
            "ep2_sp2": (dict(ep=2, sp=2), (4, S // 4, DM))}


@functools.lru_cache(maxsize=None)
def _ep_tp_sp_runs():
    """Every (mesh, capacity) case of EP_TP_SP on one 4-rank spawn:
    {(mesh, capacity): rank 0's run}, and every rank's runs."""
    keys = [(m, c) for m in EP_TP_SP for c in CAPACITY]
    calls = [("ray_tpu_torch.parallel.dryrun", "moe_sgd", dict(
        spec=EP_TP_SP[m][0], x=_x().reshape(EP_TP_SP[m][1]), d_ff=FF,
        capacity_factor=CAPACITY[c], params=_jax(CAPACITY[c])[0]))
        for m, c in keys]
    runs = D.spawn(D.call_all, 4, (calls,), timeout_s=SPAWN_TIMEOUT_S)
    return dict(zip(keys, runs[0])), runs


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("mesh", list(EP_TP_SP))
def test_moe_tp_and_sp_match_jax(mesh, capacity):
    """ep2 x tp2 and ep2 x sp2 on 4 gloo ranks: sp ranks hold distinct
    positions of the rows (4 x 8 tokens, T split in two), so they count
    in the global slot order as (dp, fsdp) ranks do; tp ranks hold the
    same tokens. y (gathered back to the global shape), aux and the
    whole gradients against JAX's unsharded layer at rtol 1e-4, atol
    1e-5, with and without dropped tokens; the losses equal the
    one-device layer's within 1e-6 relative on every rank."""
    cf = CAPACITY[capacity]
    by_key, ranks = _ep_tp_sp_runs()
    run = dict(by_key[mesh, capacity])
    run["y"] = run["y"].reshape(S, DM)
    _hold(run, cf)
    one = D.moe_sgd(None, _x(), d_ff=FF, capacity_factor=cf,
                    params=_jax(cf)[0])
    i = list(by_key).index((mesh, capacity))
    for r in ranks:
        np.testing.assert_allclose(r[i]["losses"], one["losses"], rtol=1e-6)
    assert run["blocks"]["experts_w1"] == (E // 2, DM, FF)


@pytest.mark.parametrize("path, shape", [
    (("params", "moe", "experts_w1"), (4, 16, 32)),
    (("params", "moe", "experts_w2"), (4, 32, 16)),
    (("params", "moe", "router", "kernel"), (16, 4)),
    (("params", "moe", "experts_w1"), (6, 16, 32))])
def test_expert_sharding_rule_matches_jax(path, shape):
    """The rule's placements against JAX's NamedSharding on dp2 x ep4
    (None where it leaves the leaf to the default rules: the router, an
    expert count ep does not divide)."""
    spec = JM.MeshSpec(dp=2, ep=4)
    jmesh = spec.build(jax.devices()[:8])
    want = j_rule(jmesh, path, shape, spec)
    got = TMoE.expert_sharding_rule(None, path, shape, TM.MeshSpec(dp=2,
                                                                    ep=4))
    if want is None:
        assert got is None
    else:
        entries = tuple(want.spec) + (None,) * len(shape)
        assert got == TM._placements(entries[:len(shape)])
