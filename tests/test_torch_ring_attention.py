"""The port's ring attention over sp against the JAX package's, on the CPU.

``ring_attention_sharded`` on 4 gloo ranks against JAX's on 4 virtual
CPU devices (forward and the gradients of sum(out * do)); the ring's
schedule simulated in one process (its block launches, the global lse
and delta in the backward); the GPT-2 trainer on sp = 2 and dp2 x sp2
against JAX's ``make_causal_lm_trainer`` on the same specs; the port's
Llama forward on sp = 2 against its one-device forward. Ranks come
from ``parallel.dryrun.spawn`` and import no JAX; inputs are made from
seeds with numpy and handed to every side. Each check states its
tolerance.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import llama as JL
from ray_tpu.ops.ring_attention import ring_attention_sharded
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import llama as TL
from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.ops import ring_attention as TR
from ray_tpu_torch.parallel import dryrun as D

SPAWN_TIMEOUT_S = 120.0
RING_TOL = 2e-5      # tests/test_parallel_ops.py's ring tolerance
LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkvdo(causal):
    rng = np.random.default_rng(3 + causal)
    return [rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_ring(causal):
    """JAX's ring over sp = 4: the output and jax.grad of sum(out * do)
    through its shard_map."""
    q, k, v, do = map(jnp.asarray, _qkvdo(causal))
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("sp",))

    def loss(q, k, v):
        out = ring_attention_sharded(q, k, v, mesh, causal=causal)
        return jnp.sum(out * do), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _gpt2_cfgs():
    cj = dataclasses.replace(JG.GPT2Config.tiny(), attention_backend="flash",
                             dtype=jnp.float32)
    ct = dataclasses.replace(TG.GPT2Config.tiny(), attention_backend="flash",
                             dtype=torch.float32)
    return cj, ct


def _lm_batch():
    tokens = np.random.default_rng(0).integers(0, 512, (4, 128),
                                               dtype=np.int32)
    labels = tokens.copy()
    labels[1, 60:70] = -100     # ignored labels across rank 0's edge
    return {"input_ids": tokens, "labels": labels}


@functools.lru_cache(maxsize=None)
def _jax_lm(spec_items):
    """The JAX trainer on ``MeshSpec(**spec)``: its initial params and
    one step's metrics and params."""
    cj, _ = _gpt2_cfgs()
    spec = JM.MeshSpec(**dict(spec_items))
    tr = JS.make_causal_lm_trainer(
        cj, mesh=spec.build(jax.devices()[:spec.num_devices]), spec=spec)
    state = tr.init(jax.random.PRNGKey(0))
    params = jax.device_get(state["params"])
    state, m = tr.step(state, JS.put_batch(tr, _lm_batch()))
    return params, {k: float(v) for k, v in m.items()}, jax.device_get(
        state["params"])


LM_SPECS = {"sp2": dict(sp=2), "dp2_sp2": dict(dp=2, sp=2)}


def _lm_case(name):
    _, ct = _gpt2_cfgs()
    params, _, _ = _jax_lm(tuple(LM_SPECS[name].items()))
    return dict(kind="causal_lm", model=TG.GPT2(ct), steps=1,
                batch=_lm_batch(), spec=LM_SPECS[name],
                params={"params": params})


def _llama_setup():
    cfg_t = dataclasses.replace(TL.LlamaConfig.tiny(), attention_backend="ring")
    cfg_j = dataclasses.replace(JL.LlamaConfig.tiny(),
                                attention_backend="reference")
    ids = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (2, 64),
                                            dtype=np.int32)
    params = jax.device_get(JL.LlamaModel(cfg_j).init(
        jax.random.PRNGKey(2), jnp.asarray(ids[:1, :8])))
    return cfg_t, cfg_j, params, ids


@functools.lru_cache(maxsize=None)
def _runs(world):
    """Every multi-rank case of ``world`` ranks in one spawn."""
    calls = {}
    if world == 4:
        for causal in (False, True):
            q, k, v, do = _qkvdo(causal)
            calls["ring", causal] = ("ray_tpu_torch.parallel.dryrun",
                                     "ring_case", dict(
                                         q=q, k=k, v=v, do=do, causal=causal,
                                         spec=dict(sp=4)))
        calls["lm", "dp2_sp2"] = ("ray_tpu_torch.parallel.dryrun",
                                  "run_steps", _lm_case("dp2_sp2"))
    else:
        calls["lm", "sp2"] = ("ray_tpu_torch.parallel.dryrun", "run_steps",
                              _lm_case("sp2"))
        cfg_t, _, params, ids = _llama_setup()
        calls["llama"] = ("ray_tpu_torch.parallel.dryrun",
                          "llama_ring_forward", dict(
                              cfg=cfg_t, params=params, ids=ids,
                              spec=dict(sp=2)))
    res = D.spawn(D.call_all, world, (list(calls.values()),),
                  timeout_s=SPAWN_TIMEOUT_S)
    return [dict(zip(calls, r)) for r in res]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(causal):
    """The ring on 4 gloo ranks (the streaming kernels' plain versions
    per block) against JAX's ring on 4 devices, f32, [2, 2, 64, 16]:
    the output on every rank and each rank's shards of dq, dk and dv
    within 2e-5."""
    want_out, want_grads = _jax_ring(causal)
    runs = [r["ring", causal] for r in _runs(4)]
    for r in runs:
        np.testing.assert_allclose(r["out"], want_out, atol=RING_TOL,
                                   rtol=RING_TOL)
    for name, want in zip(("dq", "dk", "dv"), want_grads):
        got = np.concatenate([r[name] for r in runs], axis=2)
        np.testing.assert_allclose(got, want, atol=RING_TOL, rtol=RING_TOL,
                                   err_msg=name)


def _counting(counts, lses):
    def wrap(name, fn):
        def run(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            if name in ("backward_dkv", "backward_dq"):
                lses.append((args[4], args[5]))
            return fn(*args, **kwargs)
        return run
    return TA.TrainingAttention(*[wrap(n, f) for n, f in zip(
        TA.TrainingAttention._fields, TA.TRAINING_PLAIN)])


def test_ring_schedule_launches_and_global_lse():
    """Four ranks' schedules simulated in one process (``simulate``: the
    transport replaced, nothing else), causal, f32: rank r runs r + 1
    blocks, so 10 launches of each streaming pass and one delta pass
    per rank; every backward block takes the rank's final lse and
    delta; the concatenated output and grads equal the one-device
    ``attention_reference`` within 2e-5."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.tensor(rng.standard_normal((1, 2, 128, 16)),
                                dtype=torch.float32) for _ in range(4))
    counts, lses = {}, []
    impl = _counting(counts, lses)
    n, sl = 4, 32
    qs = q * 16 ** -0.5
    fwd, dkv, dq = TA._streaming(impl, q, (16, 16))

    def part(t, r):
        return t[:, :, r * sl:(r + 1) * sl]
    res = TR.simulate([TR._forward_steps(
        fwd, part(qs, r), torch.stack([part(k, r), part(v, r)]), r, n, True)
        for r in range(n)])
    outs = [o.to(q.dtype) for o, _ in res]
    deltas = [impl.delta(o, part(do, r)) for r, o in enumerate(outs)]
    grads = TR.simulate([TR._backward_steps(
        (dkv, dq), part(qs, r), torch.stack([part(k, r), part(v, r)]),
        part(do, r), res[r][1], deltas[r], r, n, True) for r in range(n)])
    assert counts == {"forward": 10, "backward_dkv": 10, "backward_dq": 10,
                      "delta": 4}
    finals = {(id(lse), id(delta)) for (_, lse), delta in zip(res, deltas)}
    assert {(id(a), id(b)) for a, b in lses} <= finals
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = TA.attention_reference(qq, kk, vv, causal=True)
    ref.backward(do)
    torch.testing.assert_close(torch.cat(outs, 2), ref.detach(),
                               atol=RING_TOL, rtol=RING_TOL)
    for i, want in enumerate((qq.grad * 16 ** 0.5, kk.grad, vv.grad)):
        got = torch.cat([g[i] for g in grads], 2)
        torch.testing.assert_close(got, want, atol=RING_TOL, rtol=RING_TOL)


def test_ring_at_sp1_is_the_exact_flash_path():
    """``attention_backend="ring"`` without a mesh: one causal block of
    the streaming path, the same numbers as ``flash_attention(exact=True)``
    (bit for bit, f32), forward and gradients."""
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 3, 64, 32)),
                                dtype=torch.float32) for _ in range(4))
    outs = []
    for fn in (lambda *a: TR.ring_attention(*a, causal=True),
               lambda *a: TA.flash_attention(*a, causal=True, exact=True)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs)
        o.backward(do)
        outs.append([o.detach()] + [x.grad for x in xs])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _grad_mask(params_t, exp_avg):
    """{param: first-step |grad| > 1e-6}, from AdamW's first moment
    after one step (0.1 g); outside it AdamW's first step turns the
    last bits of a grad near eps into up to lr."""
    return {n: (np.abs(exp_avg[n]["exp_avg"]) / 0.1 > 1e-6)
            | (exp_avg[n]["exp_avg"] == 0) for n in params_t}


@pytest.mark.parametrize("mesh", list(LM_SPECS))
def test_gpt2_trainer_on_sp_matches_jax(mesh):
    """One f32 step of the tiny GPT-2 (flash backend: the ring at sp =
    2; 4 x 128 tokens, ignored labels across a slice's edge) on the
    mesh against JAX's trainer on the same spec from the same params:
    loss and grad_norm within 1e-5 relative, the params within 3e-5
    (where the first step's |grad| is under 1e-6, within 2 lr)."""
    _, want_m, want_p = _jax_lm(tuple(LM_SPECS[mesh].items()))
    run = _runs(4 if mesh == "dp2_sp2" else 2)[0]["lm", mesh][0]
    for k, v in want_m.items():
        np.testing.assert_allclose(run["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    want = {k: t.numpy() for k, t in TG.params_from_flax(
        {"params": want_p}).items()}
    mask = _grad_mask(want, run["opt"])
    for name, ref in want.items():
        diff = np.abs(run["model"][name] - ref)
        assert diff[~mask[name]].max(initial=0) <= 2 * LR, name
        assert diff[mask[name]].max(initial=0) <= 3e-5, name


def test_llama_ring_forward_matches_one_device():
    """The port's tiny Llama (8 heads over 2 kv heads: GQA, repeated
    before the ring) with ``attention_backend="ring"`` on sp = 2 (each
    rank rotates its slice by global positions) against the same params
    on one device with the plain attention: logits within 1e-5."""
    cfg_t, _, params, ids = _llama_setup()
    got = np.concatenate([r["llama"] for r in _runs(2)], axis=1)
    one = TL.LlamaModel(dataclasses.replace(cfg_t,
                                            attention_backend="reference"))
    TL.params_from_flax(params, one)
    with torch.no_grad():
        want = one(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
