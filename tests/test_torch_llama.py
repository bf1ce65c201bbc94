"""The port's Llama against the JAX package's, on the CPU.

``rope_frequencies``, ``apply_rope``, ``RMSNorm``, ``params_from_flax``,
the full forward (logits, loss and grads through the flash backend at
s <= 2048, where it takes the whole-kv path, and at s > 2048, where it
takes the streaming path) and two steps of the example-06 loop
(``optax.adamw(3e-4)``), at ``tiny`` widths with grouped-query attention
(8 heads, 2 kv heads). Inputs and params are made from seeds with numpy
or flax and handed to both sides; each check states its tolerance.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as JL
from ray_tpu_torch.models import llama as TL


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _configs(max_seq_len=256, **kw):
    """The tiny config on both sides with the flash backend, f32."""
    cj = dataclasses.replace(JL.LlamaConfig.tiny(), attention_backend="flash",
                             max_seq_len=max_seq_len, **kw)
    ct = dataclasses.replace(TL.LlamaConfig.tiny(), attention_backend="flash",
                             max_seq_len=max_seq_len, **kw)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _params(**kw):
    """Params of the tiny model (``kw`` changes its config) in flax's
    tree, made once from a seed with numpy: each Dense kernel and the
    embedding normal with std fan_in^-0.5 (the embedding's: its width),
    the RMSNorm weights 1 + normal(0.1) so that a swapped norm shows.
    The tree's shape comes from ``jax.eval_shape`` of flax's init (no
    compile); the tests only read the params."""
    shapes = jax.eval_shape(JL.LlamaModel(_configs(**kw)[0]).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        x = rng.randn(*leaf.shape).astype(np.float32)
        if path[-1].key == "weight":
            return jnp.asarray(1 + 0.1 * x)
        fan_in = leaf.shape[0] if path[-1].key == "kernel" else leaf.shape[1]
        return jnp.asarray(x * fan_in ** -0.5)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models(max_seq_len=256, **kw):
    """Both models from the same params."""
    cj, ct = _configs(max_seq_len, **kw)
    params = _params(**kw)
    mt = TL.LlamaModel(ct)
    TL.params_from_flax(params, mt)
    return JL.LlamaModel(cj), params, mt


@functools.lru_cache(maxsize=None)
def _loss_and_grads(max_seq_len=256, **kw):
    """flax's loss and grads, jitted once per config: (loss, logits),
    grads = f(params, ids). The forward test at s <= 2048 and the loop
    share one compile (same config, same ids shape)."""
    mj = JL.LlamaModel(_configs(max_seq_len, **kw)[0])

    def loss(p, ids):
        logits = mj.apply(p, ids)
        return JL.causal_lm_loss(logits, ids), logits
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def test_rope_frequencies_equal_jax():
    """Both sides make the angles in f64 with numpy and store f32: equal
    bit for bit, up to Llama-2's 4096 positions."""
    ft = TL.rope_frequencies(128, 4096, 10000.0)
    fj = JL.rope_frequencies(128, 4096, 10000.0)
    assert ft.dtype == torch.float32 and tuple(ft.shape) == (4096, 64, 2)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_matches_jax(with_positions):
    """Rotate-half, with and without explicit positions: within 1e-6."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 8, 16).astype(np.float32)
    pos = rng.randint(0, 64, (2, 8)).astype(np.int32)
    ft = TL.rope_frequencies(16, 64, 10000.0)
    fj = JL.rope_frequencies(16, 64, 10000.0)
    out_t = TL.apply_rope(torch.from_numpy(x), ft,
                          torch.from_numpy(pos) if with_positions else None)
    out_j = JL.apply_rope(jnp.asarray(x), fj,
                          jnp.asarray(pos) if with_positions else None)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    """f32 accumulation, the input's dtype out: f32 within 1e-6, bf16
    within one bf16 step (2^-8 relative) of values of order 1."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 64) * 3).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out_j = JL.RMSNorm(1e-5).apply({"params": {"weight": jnp.asarray(w)}},
                                   jnp.asarray(x, jd))
    norm = TL.RMSNorm(64, 1e-5)
    norm.weight.data.copy_(torch.from_numpy(w))
    out_t = norm(torch.from_numpy(x).to(td))
    assert out_t.dtype == td and out_j.dtype == jd
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out_t.detach().float().numpy(),
                               np.asarray(out_j, np.float32), rtol=tol,
                               atol=tol)


def test_params_from_flax_round_trip():
    """Every flax leaf lands in the module under flax's path, Dense
    kernels transposed, all in f32; nothing is left over."""
    _, params, mt = _models()
    sd = mt.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        names = [k.key for k in path]
        key = ".".join(names[:-1]) + ".weight"
        want = np.asarray(leaf)
        if names[-1] == "kernel":
            want = want.T
        assert sd[key].dtype == torch.float32
        np.testing.assert_array_equal(sd[key].numpy(), want)


@pytest.mark.parametrize("seq,kw", [
    pytest.param(128, {}, id="128-2"),
    pytest.param(2304, dict(n_layers=1, n_heads=2, n_kv_heads=1),
                 id="2304-1")])
def test_forward_loss_and_grads_match_flax(seq, kw):
    """f32, flash backend, GQA, batch 2. s = 128 takes the port's
    whole-kv path, s = 2304 (> 2048: no knob) its streaming path (one
    layer of 2 heads over 1 kv head, d = 64, to keep the test cheap); on
    the CPU both are the kernels' plain versions, and flax's
    flash_attention is the exact softmax there. Logits within 1e-4, loss
    within 1e-5 relative, and each param's grad within 1e-4 of its
    tensor's largest entry (sums in another order through the layers and
    the head)."""
    max_seq_len = max(256, seq)
    _, params, mt = _models(max_seq_len, **kw)
    ids = np.random.RandomState(2).randint(0, 512, (2, seq))
    (loss_ref, logits_ref), g_j = _loss_and_grads(max_seq_len, **kw)(
        params, jnp.asarray(ids, jnp.int32))
    logits = mt(torch.from_numpy(ids))
    loss = TL.causal_lm_loss(logits, torch.from_numpy(ids))
    loss.backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    want = TL.params_from_flax(g_j)
    for name, p in mt.named_parameters():
        ref = want[name]
        assert float((p.grad - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max()), name


def test_example_loop_steps_match_optax():
    """Two steps of examples/06_llama_finetune.py's loop (2 x 128, a
    repeated batch): torch AdamW with optax.adamw(3e-4)'s defaults
    against optax. Loss per step within 1e-5 relative. Params after the
    last step within 3e-5 wherever every step's grad exceeded 1e-6 in
    size (Adam's steps move each entry by ~lr = 3e-4, so a wrong b2, eps
    or decay shows); where a grad came near eps = 1e-8, Adam turns its
    last-bit differences into steps of up to lr, so there each entry is
    held to 2 lr a step."""
    _, params, mt = _models()
    ids = jnp.asarray(np.random.RandomState(3).randint(0, 64, (2, 128)),
                      jnp.int32)
    loss_and_grads = _loss_and_grads(256)     # the s = 128 case's compile
    opt_j = optax.adamw(3e-4)
    state = opt_j.init(params)

    @jax.jit
    def update(params, state, grads):
        updates, state = opt_j.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    opt = TL.adamw(mt.parameters())
    batch = torch.from_numpy(np.asarray(ids))
    small = None
    for _ in range(2):
        (loss_j, _), g_j = loss_and_grads(params, ids)
        params, state = update(params, state, g_j)
        loss_t = TL.train_step(mt, opt, batch)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        tiny = {k: g.abs() <= 1e-6 for k, g in TL.params_from_flax(
            jax.device_get(g_j)).items()}
        small = tiny if small is None else {k: small[k] | tiny[k]
                                            for k in tiny}
    want = TL.params_from_flax(jax.device_get(params))
    for name, p in mt.named_parameters():
        diff = (p.detach() - want[name]).abs()
        assert float(diff[~small[name]].max()) <= 3e-5, name
        assert float(diff.max()) <= 2 * 2 * 3e-4, name


def test_init_weights_follows_flax_laws_and_ring_is_not_ported():
    """make_llama builds on the device asked for (the CPU here) and draws
    flax's laws from the seed; without CUDA its default device raises."""
    cfg = dataclasses.replace(TL.LlamaConfig.tiny(), dim=256, n_heads=8,
                              n_kv_heads=2)
    m = TL.make_llama(cfg, 0, device="cpu")
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert m.freqs.device.type == "cpu"
    again = TL.make_llama(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TL.make_llama(cfg, 0)
    w = m.layers_0.feed_forward.w1.weight.detach()    # [out, in], fan_in 256
    assert m.layers_0.attention.wq.bias is None
    assert float(w.abs().max()) <= 2 * (256 ** -0.5) / .87962566103423978
    assert abs(float(w.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert float(m.tok_embeddings.weight.detach().std()) == pytest.approx(
        256 ** -0.5, rel=0.1)
    assert float(m.norm.weight.min()) == 1.0
    assert m.output.weight.shape == (cfg.vocab_size, 256)
    ring = TL.LlamaModel(dataclasses.replace(cfg, attention_backend="ring"))
    assert ring.sp_mesh is None and all(
        b.attention.sp_mesh is None for b in ring.blocks())
