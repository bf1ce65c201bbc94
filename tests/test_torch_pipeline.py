"""The port's pipeline schedule and pipelined trainer against the JAX
package's, on the CPU.

``pipeline_apply`` on 4 gloo ranks (pp = 4) against JAX's on 4 virtual
CPU devices, forward and gradients, at tests/test_pipeline.py's
tolerances (including M = 5 microbatches over 4 stages, which do not
divide); ``sequential_apply`` in one process; the pipelined trainer's
step on pp = 2 against JAX's ``make_pipelined_lm_trainer`` on
``MeshSpec(pp=2)`` (f32): ``eval_loss``, loss, grad_norm and params.
Ranks come from ``parallel.dryrun.spawn`` and import no JAX; inputs
are made from seeds and handed to every side.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import mesh as JM
from ray_tpu.parallel import pipeline as JP
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import dryrun as D
from ray_tpu_torch.parallel import pipeline as TP
from ray_tpu_torch.train import spmd as TS

SPAWN_TIMEOUT_S = 120.0
FWD_TOL = 2e-5                 # tests/test_pipeline.py
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
LR = 3e-4
DIM = 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def _setup(n_stages, n_micro, mb=4):
    rng = np.random.default_rng(n_micro)
    params = {"w1": rng.standard_normal((n_stages, DIM, DIM)) * 0.3,
              "b1": rng.standard_normal((n_stages, DIM)) * 0.1,
              "w2": rng.standard_normal((n_stages, DIM, DIM)) * 0.3}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((n_micro, mb, DIM)).astype(np.float32)
    return params, x


@functools.lru_cache(maxsize=None)
def _jax_pipeline(n_micro):
    """JAX's pipeline over pp = 4: outputs and jax.grad of mean(out^2)
    with respect to the stacked params and the microbatches."""
    params, x = _setup(4, n_micro)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("pp",))
    piped = JP.pipeline_apply(_jax_stage, mesh)

    def loss(p, xx):
        out = piped(p, xx)
        return jnp.mean(out ** 2), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(out), jax.device_get(grads)


MICRO = (8, 5)


@functools.lru_cache(maxsize=None)
def _pipeline_runs():
    """The 4-rank cases in one spawn: the schedule at each M, and the
    pipelined trainer on pp2 x sp2."""
    calls = []
    for m in MICRO:
        params, x = _setup(4, m)
        calls.append(("ray_tpu_torch.parallel.dryrun", "pipeline_case",
                      dict(stage_params=params, microbatches=x,
                           spec=dict(pp=4), remat=m == 8)))
    calls.append(("ray_tpu_torch.parallel.dryrun", "run_steps",
                  dict(_pp_sp_case(), spec=dict(pp=2, sp=2))))
    runs = D.spawn(D.call_all, 4, (calls,), timeout_s=SPAWN_TIMEOUT_S)
    out = {m: [r[i] for r in runs] for i, m in enumerate(MICRO)}
    out["pp2_sp2"] = [r[-1] for r in runs]
    return out


def _pp_sp_case():
    return dict(kind="pipelined", model=_cfgs()[1], batch=_lm_batch(),
                steps=2, seed=3)


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipeline_matches_jax(n_micro):
    """4 stages over 4 gloo ranks, M = 8 (remat) and M = 5 (no remat:
    the kept graphs), f32: the outputs on every rank within 2e-5 of
    JAX's; each rank's row of the param gradients, and the
    microbatches' gradient on every rank, within rtol 2e-4, atol 2e-5
    (the last stage's cotangent taken once, not times the pp size)."""
    want_out, (want_p, want_x) = _jax_pipeline(n_micro)
    runs = _pipeline_runs()[n_micro]
    for r in runs:
        np.testing.assert_allclose(r["out"], want_out, rtol=FWD_TOL,
                                   atol=FWD_TOL)
        np.testing.assert_allclose(r["dx"], want_x, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    for k, want in want_p.items():
        got = np.stack([r["grads"][k] for r in runs])
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


def test_sequential_apply_matches_jax():
    """The pp = 1 oracle in one process against JAX's, within 2e-5, on
    params that ``stack_stage_params`` stacked from one dict a stage."""
    params, x = _setup(3, 4)
    want = JP.sequential_apply(_jax_stage, jax.tree_util.tree_map(
        jnp.asarray, params), jnp.asarray(x))
    stacked = TP.stack_stage_params(
        lambda s: {k: torch.tensor(v[s]) for k, v in params.items()},
        range(3))
    for k, v in params.items():
        assert torch.equal(stacked[k], torch.tensor(v))
    got = TP.sequential_apply(D.mlp_stage, stacked, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def _cfgs():
    kw = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2,
              n_head=2, attention_backend="reference")
    return (JG.GPT2Config(dtype=jnp.float32, **kw),
            TG.GPT2Config(dtype=torch.float32, **kw))


def _lm_batch():
    tokens = np.random.default_rng(1).integers(0, 128, (4, 2, 16),
                                               dtype=np.int32)
    return {"input_ids": tokens, "labels": tokens}


@functools.lru_cache(maxsize=None)
def _jax_pipelined():
    """JAX's pipelined trainer on MeshSpec(pp=2): its params, its
    eval_loss on them, one step's metrics and params."""
    cj, _ = _cfgs()
    spec = JM.MeshSpec(pp=2)
    tr = JS.make_pipelined_lm_trainer(
        cj, mesh=spec.build(jax.devices()[:2]), spec=spec)
    state = tr.init(jax.random.PRNGKey(7))
    params = jax.device_get(state["params"])
    batch = JS.put_batch(tr, _lm_batch())
    ref = float(tr.eval_loss(state, batch))
    state, m = tr.step(state, batch)
    return params, ref, {k: float(v) for k, v in m.items()}, \
        jax.device_get(state["params"])


def _stacked(tree):
    """The JAX pipelined params -> the port's state_dict names, the
    stage params stacked over the stage axis (``gather_state``'s)."""
    rows = [TS.pipelined_params_from_flax({"params": tree}, s)
            for s in range(2)]
    return {k: (torch.stack([r[k] for r in rows]) if k.startswith("stages.")
                else v).numpy() for k, v in rows[0].items()}


def test_pipelined_trainer_matches_jax():
    """One f32 step of the pipelined trainer (2 layers over pp = 2, M = 4
    microbatches of 2 x 16 tokens) on 2 gloo ranks against JAX's on
    MeshSpec(pp=2), from the same params: ``eval_loss`` within 1e-6
    relative of JAX's; the step's loss and grad_norm within 1e-5; every
    param within 3e-5 (where the first step's |grad| is under 1e-6,
    within 2 lr); each rank holds its own stage's blocks."""
    _, ct = _cfgs()
    params, ref, want_m, want_p = _jax_pipelined()
    runs = D.spawn(D.run_steps, 2, (), timeout_s=SPAWN_TIMEOUT_S, kwargs=dict(
        kind="pipelined", model=ct, batch=_lm_batch(), steps=1,
        spec=dict(pp=2), params={"params": params}))
    (run,) = runs[0]
    np.testing.assert_allclose(run["eval_loss"], ref, rtol=1e-6)
    for k, v in want_m.items():
        np.testing.assert_allclose(run["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(run["metrics"]["loss"], run["eval_loss"],
                               rtol=1e-6)
    want = _stacked(want_p)
    assert set(run["model"]) == set(want)
    for name, w in want.items():
        exp_avg = run["opt"][name]["exp_avg"]
        mask = (np.abs(exp_avg) / 0.1 > 1e-6) | (exp_avg == 0)
        diff = np.abs(run["model"][name] - w)
        assert diff[~mask].max(initial=0) <= 2 * LR, name
        assert diff[mask].max(initial=0) <= 3e-5, name
    assert run["blocks"]["stages.h_0.attn.c_attn.weight"] == (96, 32)
    assert "stages.h_1.attn.c_attn.weight" not in run["blocks"]
    assert runs[1][0]["metrics"] == run["metrics"]


def test_pipelined_trainer_on_pp2_sp2_matches_one_device():
    """Two f32 steps of the pipelined trainer on pp2 x sp2 (4 gloo
    ranks: each stage's attention through the ring, positions and the
    loss's shift across the sp slices) against the same steps on one
    device from the same seeded params: loss and grad_norm within 1e-6
    relative each step, the params after them within 1e-6 (where the
    first step's |grad| is under 1e-6, within 2 lr a step); the same
    metrics on every rank."""
    ranks = _pipeline_runs()["pp2_sp2"]
    got, want = ranks[0], D.run_steps(**_pp_sp_case())
    assert all(r[-1]["metrics"] == got[-1]["metrics"] for r in ranks)
    for g, w in zip(got, want):
        for k, v in w["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], v, rtol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(g["eval_loss"], w["eval_loss"],
                                   rtol=1e-6)
    model, exp_avg = (_as_two_stages(t) for t in (
        want[-1]["model"], {n: st["exp_avg"] for n, st in
                            want[0]["opt"].items()}))
    assert set(model) == set(got[-1]["model"])
    for name, w in model.items():
        mask = (np.abs(exp_avg[name]) / 0.1 > 1e-6) | (exp_avg[name] == 0)
        diff = np.abs(got[-1]["model"][name] - w)
        assert diff[~mask].max(initial=0) <= 2 * 2 * LR, name
        assert diff[mask].max(initial=0) <= 1e-6, name


def _as_two_stages(tree):
    """A one-stage state (stage rows [1, ...] of blocks h_0, h_1) in the
    layout of two stages of one block (rows [2, ...] of h_0)."""
    out = {k: v for k, v in tree.items() if not k.startswith("stages.")}
    for k, v in tree.items():
        if k.startswith("stages.h_0."):
            rest = k[len("stages.h_0."):]
            out[k] = np.concatenate([v, tree["stages.h_1." + rest]])
    return out
