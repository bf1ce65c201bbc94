"""The port's GPT-2 training step against the JAX package's, on the CPU.

``causal_lm_loss``, the flash-backend GPT-2, the clip + AdamW update,
three trainer steps from the same flax params, ``MeshSpec`` and the
port's ``entry()``. Inputs and params are made from seeds with numpy
or flax and handed to both sides. Each check states its tolerance.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import mesh as TM
from ray_tpu_torch.train import spmd as TS


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _flash_tiny(dtype="float32"):
    cj = dataclasses.replace(JG.GPT2Config.tiny(), attention_backend="flash",
                             dtype=getattr(jnp, dtype))
    ct = dataclasses.replace(TG.GPT2Config.tiny(), attention_backend="flash",
                             dtype=getattr(torch, dtype))
    return cj, ct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_lm_loss_matches_jax(dtype):
    """Loss and its gradient wrt the logits, with ignore_index labels.
    Loss within 1e-5 relative in both dtypes (the same bf16 roundings,
    f32 sums in another order); the bf16 gradient within one bf16 step
    of values below 1 (4e-3)."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 17, 61) * 3).astype(np.float32)
    labels = rng.randint(0, 61, (3, 17)).astype(np.int64)
    labels[0, 5:9] = -100
    labels[2, :] = -100
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    loss_j, g_j = jax.jit(jax.value_and_grad(JG.causal_lm_loss))(
        jnp.asarray(logits, jd), jnp.asarray(labels))
    lt = torch.tensor(logits).to(td).requires_grad_()
    loss_t = TG.causal_lm_loss(lt, torch.from_numpy(labels))
    loss_t.backward()
    assert loss_t.dtype == torch.float32 and lt.grad.dtype == td
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    tol = 1e-6 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(lt.grad.float().numpy(),
                               np.asarray(g_j, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gpt2_matches_flax(dtype):
    """Tiny widths, s = 128 (the port's flash backend takes the whole-kv
    path, its plain version here; flax on the CPU takes the exact
    reference): f32 logits within 1e-4; bf16 within 6e-2, as
    test_torch_gpt2 holds the bf16 reference backend."""
    cj, ct = _flash_tiny(dtype)
    mj = JG.GPT2(cj)
    params = jax.jit(mj.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))
    mt = TG.GPT2(ct)
    TG.params_from_flax(params, mt)
    assert mt.wte.weight.dtype == torch.float32        # f32 params
    ids = np.random.RandomState(1).randint(0, 512, (2, 128))
    with torch.no_grad():
        out = mt(torch.from_numpy(ids))
    ref = jax.jit(mj.apply)(params, jnp.asarray(ids, jnp.int32))
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_clip_and_adamw_match_optax(max_norm):
    """Five updates of three leaves with fresh grads each step: the
    port's clip_by_global_norm_ + adamw against optax's chain; params
    within 1e-6 and the pre-clip norm within 1e-6 relative."""
    rng = np.random.RandomState(2)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    leaves = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1))
    pj = [jnp.asarray(x) for x in leaves]
    sj = tx.init(pj)
    @jax.jit
    def update(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state, optax.global_norm(g)

    pt = [torch.tensor(x, requires_grad=True) for x in leaves]
    opt = TS.adamw(pt, 1e-2, 0.1)
    clipped = []
    for _ in range(5):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        gj = [jnp.asarray(g) for g in grads]
        pj, sj, norm_j = update(gj, sj, pj)
        for p, g in zip(pt, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = TS.global_norm([p.grad for p in pt])
        np.testing.assert_allclose(float(norm), float(norm_j), rtol=1e-6)
        clipped.append(float(norm) >= max_norm)
        TS.clip_by_global_norm_([p.grad for p in pt], max_norm, norm)
        opt.step()
    assert all(clipped) == (max_norm < 1)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)


def test_trainer_three_steps_match_jax():
    """Three steps from the same flax params on a repeated batch
    (tiny widths, s = 128, flash backend, f32): loss and grad_norm per
    step within 1e-5 relative; the params after the last step within
    3e-5, except the key bias: its true gradient is 0 (softmax ignores
    a shift common to a row), so Adam turns rounding noise into steps
    of up to ~lr each, and it is held to 2 lr a step."""
    cj, ct = _flash_tiny()
    mesh = JM.MeshSpec().build(jax.devices("cpu")[:1])
    trj = JS.make_causal_lm_trainer(cj, mesh=mesh, spec=JM.MeshSpec())
    sj = trj.init(jax.random.PRNGKey(0))
    params = jax.device_get(sj["params"])
    trt = TS.make_causal_lm_trainer(ct, device="cpu")
    st = trt.init(params={"params": params})
    tokens = np.random.default_rng(0).integers(0, cj.vocab_size, (2, 128),
                                               dtype=np.int32)
    bj = JS.put_batch(trj, {"input_ids": tokens, "labels": tokens})
    bt = TS.put_batch(trt, {"input_ids": tokens, "labels": tokens})
    for _ in range(3):
        sj, mj = trj.step(sj, bj)
        st, mt = trt.step(st, bt)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-5)
    assert st["step"] == 3
    want = TG.params_from_flax({"params": jax.device_get(sj["params"])})
    got = st["model"].state_dict()
    E = ct.n_embd
    for key, ref in want.items():
        diff = (got[key] - ref).abs()
        if key.endswith("attn.c_attn.bias"):
            assert float(diff[E:2 * E].max()) <= 3 * 2 * 3e-4
            diff = torch.cat([diff[:E], diff[2 * E:]])
        assert float(diff.max()) <= 3e-5, key


def test_dropout_step_draws_from_the_step_seeded_generator():
    """dropout > 0: a step's mask comes from a generator seeded by the
    step number, so two runs from the same init agree step for step,
    and the mask changes the loss."""
    _, ct = _flash_tiny()
    ct = dataclasses.replace(ct, dropout=0.1)
    tokens = np.random.default_rng(3).integers(0, 512, (2, 128))
    losses = []
    for _ in range(2):
        tr = TS.make_causal_lm_trainer(ct, device="cpu")
        st = tr.init(seed=1)
        b = TS.put_batch(tr, {"input_ids": tokens, "labels": tokens})
        losses.append([float(tr.step(st, b)[1]["loss"]) for _ in range(2)])
    assert losses[0] == losses[1]
    tr = TS.make_causal_lm_trainer(dataclasses.replace(ct, dropout=0.0),
                                   device="cpu")
    st = tr.init(seed=1)
    plain = float(tr.step(st, TS.put_batch(
        tr, {"input_ids": tokens, "labels": tokens}))[1]["loss"])
    assert plain != losses[0][0]


@pytest.mark.parametrize("spec", [
    dict(), dict(dp=2), dict(tp=2, sp=2), dict(dp=2, fsdp=2, tp=2)])
def test_meshspec_matches_jax(spec):
    j, t = JM.MeshSpec(**spec), TM.MeshSpec(**spec)
    assert TM.AXIS_ORDER == JM.AXIS_ORDER
    assert t.axis_sizes() == j.axis_sizes()
    assert t.num_devices == j.num_devices
    assert t.active_axes() == j.active_axes()
    assert t.describe() == j.describe()
    assert t.with_auto_dp(8) == TM.MeshSpec(**dataclasses.asdict(
        j.with_auto_dp(8)))
    assert TM.MeshSpec.from_dict(spec) == t
    n = t.num_devices
    if n > 1:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t.build(["cpu"] * n)


def test_meshspec_errors_match_jax():
    for fn in (lambda M: M.MeshSpec.from_dict({"dp": 2, "xx": 2}),
               lambda M: M.MeshSpec(tp=3).with_auto_dp(8)):
        with pytest.raises(ValueError) as ej:
            fn(JM)
        with pytest.raises(ValueError) as et:
            fn(TM)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as ej:
        JM.MeshSpec(dp=2).build(jax.devices("cpu")[:1])
    with pytest.raises(ValueError) as et:
        TM.MeshSpec(dp=2).build(["cpu"])
    assert str(et.value) == str(ej.value)
    assert TM.MeshSpec().build(["cpu"]).shape == (1,) * 6


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_default_spec_for_matches_jax(n):
    assert dataclasses.asdict(TS.default_spec_for(n)) == dataclasses.asdict(
        JS.default_spec_for(n))


def test_entry_shapes_on_cpu():
    """The (4, 512) GPT-2-small forward, shapes only (as the JAX test
    uses eval_shape): under FakeTensorMode no arithmetic runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ray_tpu_torch.entry import entry

    fn, (model, ids) = entry(device="cpu")
    assert tuple(ids.shape) == (4, 512)
    cfg = model.cfg
    assert (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.vocab_size,
            cfg.attention_backend) == (12, 768, 12, 50257, "flash")
    assert model.wte.weight.dtype == torch.float32
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(model, ids)
    assert tuple(out.shape) == (4, 512, 50257)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("what", ["trainer", "entry"])
def test_default_device_is_cuda(what):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    from ray_tpu_torch.entry import entry
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if what == "trainer":
            TS.make_causal_lm_trainer(TG.GPT2Config.tiny())
        else:
            entry()


def test_serving_stores_weights_in_compute_dtype():
    """Training keeps f32 params; the serving adapter stores Dense and
    Embed weights in cfg.dtype (LayerNorm stays f32), which gives the
    same logits as casting at every call."""
    from ray_tpu_torch.serve.llm.model_runner import TorchModelAdapter
    cfg = dataclasses.replace(TG.GPT2Config.tiny(), dtype=torch.bfloat16)
    ad = TorchModelAdapter("gpt2", config=cfg, seed=0, device="cpu")
    m = ad.model
    assert m.wte.weight.dtype == torch.bfloat16
    assert m.h_0.attn.c_attn.weight.dtype == torch.bfloat16
    assert m.ln_f.weight.dtype == torch.float32
    f32 = TG.GPT2(cfg).init_weights(torch.Generator().manual_seed(0))
    assert f32.h_0.mlp.c_fc.weight.dtype == torch.float32
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 512, (2, 16)))
    with torch.no_grad():
        assert torch.equal(m(ids), f32(ids))
