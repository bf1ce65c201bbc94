"""The port's ResNet and its training step against the JAX package's, on
the CPU.

SAME-padded convs and max-pool, batch norm (output and running stats),
the forward of narrow basic-block and bottleneck nets, SGD-Nesterov
with decay against optax, three trainer steps against the JAX trainer
on a one-device mesh, ``create_resnet``, the init law, ``put_batch`` and
the bench's CPU run. Inputs come from numpy seeds and params cross with
``params_from_flax``. Each check states its tolerance.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ray_tpu.models import resnet as JR
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import resnet as TR
from ray_tpu_torch.train import spmd as TS

# f32: the two sides sum in other orders (XLA's and oneDNN's convs,
# the batch statistics), a few ulps per op through a few layers
F32 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _nchw(x):
    """NHWC numpy -> the NCHW channels_last view the port's layers take."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3, 7])
@pytest.mark.parametrize("size", [9, 10])
def test_same_conv_matches_flax(size, kernel, stride):
    """nn.Conv(padding="SAME") at an odd and an even size: the port's
    pads (asymmetric where a strided kernel needs it) give flax's
    output, f32 within 1e-5."""
    rng = np.random.default_rng(size * 100 + kernel * 10 + stride)
    x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    conv = fnn.Conv(5, (kernel, kernel), (stride, stride), use_bias=False,
                    padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = conv.apply(params, jnp.asarray(x))
    tc = TR.Conv(3, 5, kernel, stride, dtype=torch.float32)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(np.array(
            params["params"]["kernel"])).permute(3, 2, 0, 1))
        got = tc(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert tuple(got.shape) == (2, 5) + tuple(want.shape[1:3])
    _close(got.permute(0, 2, 3, 1), want, F32)


@pytest.mark.parametrize("size", [7, 8, 112])
def test_same_max_pool_matches_flax(size):
    """nn.max_pool((3, 3), (2, 2), "SAME"): pads (0, 1) at even sizes,
    (1, 1) at odd ones, with -inf (all-negative input shows a zero
    pad). Exact."""
    rng = np.random.default_rng(size)
    x = -np.abs(rng.standard_normal((2, size, size, 4), dtype=np.float32))
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = TR.max_pool_same(_nchw(x), 3, 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype):
    """Two train-mode calls then one eval call of nn.BatchNorm(momentum
    0.9, eps 1e-5) on inputs of mean 3 and std 2, random scale and
    bias. Running mean and the BIASED running variance within 1e-5 in
    both dtypes (both sides take f32 stats of the same rounded input);
    outputs in f32 within 1e-5, in bf16 within one bf16 step (2^-8
    relative, 1e-2 absolute near 0): both round the same f32 value,
    computed in another order."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    xs = [(3 + 2 * rng.standard_normal((4, 5, 5, 6))).astype(np.float32)
          for _ in range(3)]
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jd)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], jd),
                        use_running_average=False)
    scale = rng.standard_normal(6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    tb = TR.BatchNorm(6, dtype=td)
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(scale))
        tb.bias.copy_(torch.from_numpy(bias))
    tol = F32 if dtype == "float32" else 1e-2
    for x in xs[:2]:
        want, mut = bn.apply(variables, jnp.asarray(x, jd),
                             use_running_average=False,
                             mutable=["batch_stats"])
        variables = {**variables, **mut}
        got = tb(_nchw(x).to(td))
        assert got.dtype == td
        assert got.is_contiguous(memory_format=torch.channels_last)
        _close(got.permute(0, 2, 3, 1), jnp.asarray(want, jnp.float32), tol)
        _close(tb.running_mean, variables["batch_stats"]["mean"], F32)
        _close(tb.running_var, variables["batch_stats"]["var"], F32)
    want = bn.apply(variables, jnp.asarray(xs[2], jd),
                    use_running_average=True)
    with torch.no_grad():
        got = tb.eval()(_nchw(xs[2]).to(td))
    _close(got.permute(0, 2, 3, 1), jnp.asarray(want, jnp.float32), tol)


def _narrow(block, small_images, dtype="float32", num_classes=10):
    """A narrow net on both sides: one block per stage, 8 filters."""
    jb = getattr(JR, block)
    tb = getattr(TR, block)
    mj = JR.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=jb,
                   num_classes=num_classes, num_filters=8,
                   dtype=getattr(jnp, dtype), small_images=small_images)
    mt = TR.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=tb,
                   num_classes=num_classes, num_filters=8,
                   dtype=getattr(torch, dtype), small_images=small_images)
    return mj, mt


def _flax_variables(mj, size, seed=0):
    """flax variables of ``mj`` from numpy (shapes by eval_shape, so no
    XLA compile): lecun-scaled normal kernels, and random scales,
    biases and running stats, so that no zero scale hides a branch and
    eval mode uses stats that are not 0 and 1."""
    shapes = jax.eval_shape(lambda: mj.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            x = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "var":
            x = rng.uniform(0.5, 2.0, a.shape)
        else:
            x = rng.standard_normal(a.shape) * 0.5 + (name == "scale")
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


# (block, small_images, image size, dtype): the stem at 36 gives odd
# sizes inside (18, 9, 5, 3); the CIFAR stem at 16 even ones
FORWARD_CASES = [
    ("ResNetBlock", False, 36, "float32"),
    ("ResNetBlock", True, 16, "float32"),
    ("BottleneckResNetBlock", False, 36, "float32"),
    ("BottleneckResNetBlock", True, 16, "float32"),
    ("BottleneckResNetBlock", False, 36, "bfloat16"),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", FORWARD_CASES,
                         ids=lambda c: f"{c[0]}-{'small' if c[1] else 'stem'}"
                                       f"-{c[2]}-{c[3]}")
def test_forward_matches_flax(case, train):
    """f32 logits (and, in train mode, the updated batch stats) within
    1e-4 (relative and absolute: ~20 layers of f32 rounding); bf16
    logits within 5e-2 of the same net in bf16 on the JAX side (each
    side rounds every activation to bf16, 2^-8 relative, through ~20
    layers, and the batch stats then differ by those roundings)."""
    block, small, size, dtype = case
    mj, mt = _narrow(block, small, dtype)
    variables = _flax_variables(mj, size)
    TR.params_from_flax(variables, mt)
    mt.train(train)
    x = np.random.default_rng(3).standard_normal((4, size, size, 3),
                                                 dtype=np.float32)
    with torch.no_grad():
        got = mt(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 10)
    if train:
        want, mut = jax.jit(lambda v, x: mj.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables,
                                                        jnp.asarray(x))
    else:
        want, mut = jax.jit(lambda v, x: mj.apply(v, x, train=False))(
            variables, jnp.asarray(x)), None
    tol = 1e-4 if dtype == "float32" else 5e-2
    _close(got, want, tol, "logits")
    if mut is not None and dtype == "float32":
        ref = TR.params_from_flax({"batch_stats": mut["batch_stats"]})
        sd = mt.state_dict()
        for k, v in ref.items():
            _close(sd[k], v, 1e-4, k)


def test_layout_stays_channels_last(monkeypatch):
    """Every conv and max-pool of a bf16 forward (ResNet-50's widths
    cut to one block per stage, 66 px, odd sizes inside) takes a
    channels_last input, so no conv pays a hidden layout copy; the
    backward runs through the same layout."""
    seen = []
    conv2d, max_pool2d = F.conv2d, F.max_pool2d

    def spy(fn):
        def wrapped(x, *args, **kwargs):
            seen.append(x.is_contiguous(memory_format=torch.channels_last))
            return fn(x, *args, **kwargs)
        return wrapped
    monkeypatch.setattr(F, "conv2d", spy(conv2d))
    monkeypatch.setattr(F, "max_pool2d", spy(max_pool2d))
    m = TR.ResNet(stage_sizes=[1, 1, 1, 1],
                  block_cls=TR.BottleneckResNetBlock, num_classes=10,
                  dtype=torch.bfloat16)
    m.init_weights(torch.Generator().manual_seed(0))
    m = m.to(memory_format=torch.channels_last)
    x = torch.randn(2, 66, 66, 3, generator=torch.Generator().manual_seed(1))
    m(x).sum().backward()
    assert len(seen) == 1 + 4 * 4 + 1 and all(seen)


@pytest.mark.parametrize("nesterov_wd", [(0.9, 1e-4), (0.5, 0.1)])
def test_sgd_nesterov_matches_optax(nesterov_wd):
    """Five updates of three leaves with fresh grads each step: the
    port's sgd_nesterov (torch SGD, weight_decay, nesterov) against
    optax.chain(add_decayed_weights, sgd(nesterov=True)); params
    within 1e-6."""
    momentum, wd = nesterov_wd
    rng = np.random.default_rng(2)
    shapes = [(4, 3, 3, 3), (4,), (7, 5)]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.add_decayed_weights(wd),
                     optax.sgd(0.1, momentum=momentum, nesterov=True))
    pj = [jnp.asarray(x) for x in leaves]
    sj = tx.init(pj)

    @jax.jit
    def update(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    pt = [torch.tensor(x, requires_grad=True) for x in leaves]
    opt = TS.sgd_nesterov(pt, 0.1, momentum, wd)
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        pj, sj = update([jnp.asarray(g) for g in grads], sj, pj)
        for p, g in zip(pt, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_trainer(block):
    """The JAX trainer of the narrow net at 32 px on a one-device mesh,
    its initial state on the host (its init compiles for seconds: the
    uint8 and f32 cases share it; each step donates the state it gets,
    so each case puts its own copy on the device) and the port's net."""
    mj, mt = _narrow(block, False)
    mesh = JM.MeshSpec().build(jax.devices("cpu")[:1])
    trj = JS.make_image_classifier_trainer(mj, mesh=mesh, spec=JM.MeshSpec(),
                                           input_shape=(1, 32, 32, 3))
    return trj, jax.device_get(trj.init(jax.random.PRNGKey(0))), mt


@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("block", ["ResNetBlock", "BottleneckResNetBlock"])
def test_trainer_three_steps_match_jax(block, image_dtype):
    """Three steps from the same flax variables on a repeated batch of 4
    images at 32 x 32 (f32 compute, 10 classes), JAX trainer on a
    one-device mesh: accuracy equal; the first step's loss within 1e-5
    relative, the next two within 2e-4; params and batch stats after
    the last step within 1e-4. At lr 0.1 the loss falls from ~2.9 to
    as low as 0.006 in three steps, and batch norm over 4 samples at 1
    x 1 px divides by small variances: the first step agrees to ~1e-6,
    and the updates grow that (to 6.8e-5 in the loss at worst)."""
    trj, init_state, mt = _jax_trainer(block)
    sj = jax.device_put(init_state, trj.state_sharding_tree)
    variables = {"params": init_state["params"],
                 "batch_stats": init_state["batch_stats"]}
    trt = TS.make_image_classifier_trainer(mt, input_shape=(1, 32, 32, 3),
                                           device="cpu")
    st = trt.init(params=variables)
    rng = np.random.default_rng(5)
    if image_dtype == "uint8":
        images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    else:
        images = rng.standard_normal((4, 32, 32, 3), dtype=np.float32)
    batch = {"image": images,
             "label": rng.integers(0, 10, (4,), dtype=np.int32)}
    bj = JS.put_batch(trj, batch)
    bt = TS.put_batch(trt, batch)
    assert bt["image"].dtype == getattr(torch, image_dtype)
    for i in range(3):
        sj, mj_ = trj.step(sj, bj)
        st, mt_ = trt.step(st, bt)
        np.testing.assert_allclose(float(mt_["loss"]), float(mj_["loss"]),
                                   rtol=1e-5 if i == 0 else 2e-4)
        assert float(mt_["accuracy"]) == float(mj_["accuracy"])
    assert st["step"] == 3
    want = TR.params_from_flax({"params": jax.device_get(sj["params"]),
                                "batch_stats": jax.device_get(
                                    sj["batch_stats"])})
    got = st["model"].state_dict()
    assert set(got) == set(want)
    for key, ref in want.items():
        _close(got[key], ref, 1e-4, key)


def test_create_resnet_names_and_errors():
    """The same table (stage sizes, block kind) and the same
    ValueError as the JAX package."""
    for name in ("resnet18", "resnet34", "resnet50", "resnet101",
                 "resnet152"):
        j = JR.create_resnet(name, 10, small_images=True)
        t = TR.create_resnet(name, 10, small_images=True)
        assert list(t.blocks()) and t.small_images
        assert t.n_blocks == sum(j.stage_sizes)
        assert t.block_name == j.block_cls.__name__
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    with pytest.raises(ValueError) as ej:
        JR.create_resnet("resnet7", 10)
    with pytest.raises(ValueError) as et:
        TR.create_resnet("resnet7", 10)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_init_law_and_shapes_match_flax(name):
    """At published widths (1,000 classes, 224 px): every param and
    batch stat has flax's shape under flax's name; the last norm of
    every block starts at scale 0, the others at 1, biases and running
    means at 0, running variances at 1; conv and Dense kernels are
    truncated normals of variance 1 / fan_in (the widest conv's std
    within 2%, all within [-2, 2] sigma)."""
    shapes = jax.eval_shape(lambda: JR.create_resnet(name, 1000).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = TR.params_from_flax(zeros)
    m = TR.create_resnet(name, 1000).init_weights(
        torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    last_norm = "BatchNorm_2" if name == "resnet50" else "BatchNorm_1"
    for k, v in sd.items():
        if k.endswith("running_var"):
            assert bool((v == 1).all())
        elif k.endswith(("running_mean", "bias")):
            assert not v.any(), k
        elif v.ndim == 1:                       # batch-norm scales
            assert bool((v == (0 if last_norm in k else 1)).all()), k
        else:
            std = (1.0 / v[0].numel()) ** 0.5
            bound = 2 * std / .87962566103423978
            assert float(v.abs().max()) <= bound * (1 + 1e-6), k
    w = sd["BottleneckResNetBlock_15.Conv_1.weight" if name == "resnet50"
           else "ResNetBlock_7.Conv_1.weight"]
    assert abs(float(w.std()) / (1.0 / w[0].numel()) ** 0.5 - 1) < 0.02


def test_put_batch_keeps_uint8():
    """uint8 images stay bytes, int32 labels become int64, f32 stays."""
    tr = TS.make_image_classifier_trainer(
        TR.create_resnet("resnet18", 10, dtype=torch.float32),
        device="cpu")
    b = TS.put_batch(tr, {"image": np.zeros((2, 4, 4, 3), np.uint8),
                          "label": np.zeros(2, np.int32),
                          "weights": np.zeros(2, np.float32)})
    assert (b["image"].dtype, b["label"].dtype, b["weights"].dtype) == (
        torch.uint8, torch.int64, torch.float32)
    with pytest.raises(ValueError, match="channels"):
        TS.make_image_classifier_trainer(
            TR.create_resnet("resnet18", 10), input_shape=(1, 32, 32, 1),
            device="cpu")


def test_bench_loops_on_cpu():
    """resnet_loop and gpt2_loop on the CPU (ResNet-50 at batch 8 x
    32 x 32 in f32; the tiny GPT-2): bench.py's keys, finite, with the
    FLOP source named and no mfu (no peak for a CPU)."""
    from ray_tpu_torch import bench
    res = bench.resnet_loop(device="cpu")
    for key in ("platform", "device_kind", "n_chips", "batch_per_chip",
                "step_time_ms", "compile_s", "img_per_sec",
                "img_per_sec_per_chip", "flops_per_step", "flops_source"):
        assert key in res, key
    assert res["platform"] == "cpu" and res["batch_per_chip"] == 8
    assert "mfu" not in res
    # ResNet-50 at 32 px: ~3 x 8 x 0.17 GFLOP of convs and the head
    assert 2e9 < res["flops_per_step"] < 6e9
    assert all(np.isfinite(res["losses"]))
    g = bench.gpt2_loop(device="cpu")
    for key in ("gpt2_batch_per_chip", "gpt2_seq_len", "gpt2_step_time_ms",
                "gpt2_compile_s", "gpt2_tokens_per_sec_per_chip"):
        assert key in g, key
    assert "gpt2_mfu" not in g and all(np.isfinite(g["gpt2_losses"]))
