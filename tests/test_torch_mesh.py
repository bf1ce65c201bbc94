"""The port's mesh, collectives and both trainers on dp, fsdp and tp
meshes, on the CPU with gloo ranks, against the port's one-device step
and the JAX package's trainers.

The JAX sides run in this process on the 8 virtual CPU devices that
conftest gives JAX. Each multi-rank case runs in ranks that the port
spawns (``parallel.dryrun.spawn``: a fork server, a file store, a
deadline), which import no JAX; the cases of one world size share one
spawn. Inputs are made from seeds with numpy and handed to every side.
Each check states its tolerance.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import resnet as JR
from ray_tpu.parallel import mesh as JM
from ray_tpu.train import spmd as JS
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import resnet as TR
from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.parallel import dryrun as D
from ray_tpu_torch.parallel import mesh as TM
from ray_tpu_torch.train import spmd as TS

STEPS = 3
LR = 3e-4            # the causal-LM trainer's default learning rate
# the mesh runs against the one-device run: loss and grad_norm within
# 1e-6 relative, params within 1e-6 (the same f32 arithmetic, summed in
# another order across ranks)
REL, PARAM_TOL = 1e-6, 1e-6
SPAWN_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _spec_of(placements_or_spec, ndim):
    """A JAX PartitionSpec -> the port's per-mesh-axis placements."""
    entries = tuple(placements_or_spec) + (None,) * ndim
    return TM._placements(entries[:ndim])


# ---------------------------------------------------------------------------
# (i) placements against the JAX PartitionSpecs, no spawn


def _tiny_trees():
    """The tiny GPT-2 and narrow ResNet on both sides, and the JAX
    variables' shapes (eval_shape: nothing compiles)."""
    gj, gt = JG.GPT2(JG.GPT2Config.tiny()), TG.GPT2(TG.GPT2Config.tiny())
    rj, rt = _narrow_resnets()
    gv = jax.eval_shape(lambda: gj.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    rv = jax.eval_shape(lambda: rj.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 32, 32, 3)),
                                        train=False))
    return {"gpt2": (gv, gt), "resnet": (rv, rt)}


@functools.lru_cache(maxsize=None)
def _trees():
    return _tiny_trees()


@pytest.mark.parametrize("fsdp", [1, 2, 4])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("model", ["gpt2", "resnet"])
def test_param_sharding_matches_jax(model, tp, fsdp):
    """For every leaf of the tiny flax tree (params and batch stats):
    ``param_sharding`` gives the placements that the JAX function's
    PartitionSpec names. Then the port model's own params, through
    ``state_shardings`` (torch dims) and back to flax dims by
    ``flax_layout``: the same placements on the same leaves."""
    variables, port_model = _trees()[model]
    jspec, tspec = JM.MeshSpec(tp=tp, fsdp=fsdp), TM.MeshSpec(tp=tp, fsdp=fsdp)
    jmesh = jspec.build(jax.devices()[:tp * fsdp])
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    want = {}
    for path, leaf in leaves:
        keys = tuple(p.key for p in path)
        shape = tuple(leaf.shape)
        js = JM.param_sharding(jmesh, keys, shape, jspec).spec
        want[keys] = _spec_of(js, len(shape))
        assert TM.param_sharding(None, keys, shape, tspec) == want[keys], keys
    assert any(p.is_shard() for pl in want.values() for p in pl) == (
        tp * fsdp > 1)
    layout = TS.flax_layout(port_model)
    got = TS.state_shardings(port_model, None, tspec)
    assert {path for path, _ in layout.values()} == set(want)
    for name, (path, perm) in layout.items():
        flax_dims = tuple(type(p)(perm.index(p.dim)) if p.is_shard() else p
                          for p in got[name])
        assert flax_dims == want[path], name


# ---------------------------------------------------------------------------
# the multi-rank runs, one spawn per world size


def _gpt2_cfgs():
    cj = dataclasses.replace(JG.GPT2Config.tiny(), attention_backend="flash",
                             dtype=jnp.float32)
    ct = dataclasses.replace(TG.GPT2Config.tiny(), attention_backend="flash",
                             dtype=torch.float32)
    return cj, ct


def _lm_batches():
    """4 x 128 seeded tokens; "uneven": labels that leave 2 of the 256
    counted tokens to rank 0's rows at dp2 and 254 to rank 1's."""
    tokens = np.random.default_rng(0).integers(0, 512, (4, 128),
                                               dtype=np.int32)
    uneven = tokens.copy()
    uneven[0, 3:] = -100
    uneven[1, :] = -100
    return ({"input_ids": tokens, "labels": tokens},
            {"input_ids": tokens, "labels": uneven})


@functools.lru_cache(maxsize=None)
def _jax_lm():
    """The JAX trainer on dp2 x tp2 (4 virtual devices): its initial
    params (every run starts from them) and its three steps."""
    cj, _ = _gpt2_cfgs()
    spec = JM.MeshSpec(dp=2, tp=2)
    tr = JS.make_causal_lm_trainer(cj, mesh=spec.build(jax.devices()[:4]),
                                   spec=spec)
    state = tr.init(jax.random.PRNGKey(0))
    params = jax.device_get(state["params"])
    batch = JS.put_batch(tr, _lm_batches()[0])
    metrics = []
    for _ in range(STEPS):
        state, m = tr.step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, metrics, jax.device_get(state["params"])


def _uneven_images():
    """8 images at 32 x 32 whose rows 4-7 are scaled by 5 and shifted by
    3: the (dp, fsdp) shards of the batch have very different
    statistics, so batch norm over each rank's rows alone would give
    another loss."""
    rng = np.random.default_rng(7)
    images = rng.standard_normal((8, 32, 32, 3), dtype=np.float32)
    images[4:] = images[4:] * 5 + 3
    return {"image": images,
            "label": rng.integers(0, 10, (8,), dtype=np.int32)}


def _narrow_resnets():
    kw = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, num_filters=8)
    return (JR.ResNet(block_cls=JR.BottleneckResNetBlock, dtype=jnp.float32,
                      **kw),
            TR.ResNet(block_cls=TR.BottleneckResNetBlock,
                      dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _jax_image():
    """The JAX image trainer on dp=2: its initial variables and three
    steps on the uneven batch."""
    mj, _ = _narrow_resnets()
    spec = JM.MeshSpec(dp=2)
    tr = JS.make_image_classifier_trainer(
        mj, mesh=spec.build(jax.devices()[:2]), spec=spec,
        input_shape=(1, 32, 32, 3))
    state = tr.init(jax.random.PRNGKey(0))
    variables = jax.device_get({"params": state["params"],
                                "batch_stats": state["batch_stats"]})
    batch = JS.put_batch(tr, _uneven_images())
    metrics = []
    for _ in range(STEPS):
        state, m = tr.step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.device_get({"params": state["params"],
                            "batch_stats": state["batch_stats"]})
    return variables, metrics, final


def _lm_case(spec, uneven=False):
    _, ct = _gpt2_cfgs()
    params, _, _ = _jax_lm()
    return dict(kind="causal_lm", model=TG.GPT2(ct), steps=STEPS,
                batch=_lm_batches()[uneven], spec=spec,
                params={"params": params})


def _image_case(spec):
    variables, _, _ = _jax_image()
    return dict(kind="image", model=_narrow_resnets()[1], steps=STEPS,
                batch=_uneven_images(), spec=spec, params=variables,
                input_shape=(1, 32, 32, 3))


LM_MESHES = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2), "tp2": dict(tp=2),
             "dp2_uneven_labels": dict(dp=2), "dp2_tp2": dict(dp=2, tp=2),
             "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2)}
IMAGE_MESHES = {"dp2": dict(dp=2), "dp2_fsdp2": dict(dp=2, fsdp=2),
                "tp2": dict(tp=2), "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2)}


def _cases():
    cases = {("lm", k): _lm_case(v, uneven=k.endswith("uneven_labels"))
             for k, v in LM_MESHES.items()}
    cases.update({("image", k): _image_case(v)
                  for k, v in IMAGE_MESHES.items()})
    return cases


@functools.lru_cache(maxsize=None)
def _mesh_runs(world: int):
    """Every case whose mesh has ``world`` ranks, in one spawn: {case
    key: rank 0's run}. Each rank returns the same gathered state."""
    cases = {k: c for k, c in _cases().items()
             if TM.MeshSpec(**c["spec"]).num_devices == world}
    runs = D.spawn(D.run_cases, world, (list(cases.values()),),
                   timeout_s=SPAWN_TIMEOUT_S)
    return dict(zip(cases, runs[0]))


def _mesh_run(key):
    return _mesh_runs(TM.MeshSpec(**_cases()[key]["spec"]).num_devices)[key]


@functools.lru_cache(maxsize=None)
def _oracle(key):
    """The same case on one device, in this process (no process group)."""
    case = dict(_cases()[key], spec=None)
    return D.run_steps(**case)


def _blocks_follow_placements(run, case):
    """Each rank's block of each param is the whole param cut along the
    dims ``state_shardings`` names, by the axes' sizes."""
    tr_model = case["model"]
    pl = TS.state_shardings(tr_model, None, TM.MeshSpec(**case["spec"]))
    for name, p in tr_model.named_parameters():
        want = list(p.shape)
        for axis, dim in TM.shard_dims(pl[name]).items():
            want[dim] //= case["spec"].get(axis, 1)
        assert run[0]["blocks"][name] == tuple(want), name


def _hold(got, want, rel, tol, grad_mask=None):
    """Per step the metrics within ``rel`` relative; after the last step
    every param within ``tol``. ``grad_mask`` (AdamW runs) = {name:
    entries whose first-step |grad| passes PARAM_MASK}: outside it a
    param is held to 2 lr a step instead. AdamW's first step moves a
    param by lr g / (|g| + eps), whose slope in g is lr eps / (|g| +
    eps)^2: where |g| is near eps = 1e-8 (the key bias, whose true
    gradient is 0 since softmax ignores a shift common to a row; a few
    embedding entries) the rounding of the sums moves it by up to lr.
    Returns the share of entries left out."""
    for g, w in zip(got, want):
        for k, v in w["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], v, rtol=rel,
                                       err_msg=k)
    out = n_all = 0
    for name, ref in want[-1]["model"].items():
        diff = np.abs(got[-1]["model"][name] - ref)
        if grad_mask is not None and name in grad_mask:
            held = grad_mask[name]
            assert diff[~held].max(initial=0) <= 2 * LR * len(want), name
            out, n_all = out + int((~held).sum()), n_all + held.size
            diff = diff[held]
        assert diff.max(initial=0) <= tol, (name, float(diff.max()))
    return out / max(n_all, 1)


PARAM_MASK = 1e-6


def _grad_mask(oracle):
    """{param: first-step |grad| > PARAM_MASK}, from AdamW's first
    moment after one step (0.1 g)."""
    return {n: (np.abs(st["exp_avg"]) / 0.1 > PARAM_MASK)
            | (st["exp_avg"] == 0) for n, st in oracle[0]["opt"].items()}


# ---------------------------------------------------------------------------
# (ii) the causal-LM trainer on dp, fsdp and tp meshes


@pytest.mark.parametrize("mesh", list(LM_MESHES))
def test_causal_lm_mesh_matches_one_device(mesh):
    """Three f32 steps of the tiny GPT-2 (n_head 4 = 2 tp, flash backend,
    4 x 128 tokens) on the mesh against the same steps on one device
    from the same params: loss and grad_norm within 1e-6 relative, the
    params within 1e-6 where the first step's |grad| passes 1e-6 (under
    1% of the entries are not: ``_hold``); each rank holds the blocks
    ``param_sharding`` picks. With "uneven" labels the
    global token mean differs from the mean of the two ranks' means."""
    key = ("lm", mesh)
    run, oracle = _mesh_run(key), _oracle(key)
    left_out = _hold(run, oracle, REL, PARAM_TOL, _grad_mask(oracle))
    assert left_out < 0.01
    _blocks_follow_placements(run, _cases()[key])
    if mesh.endswith("uneven_labels"):
        labels = _lm_batches()[1]["labels"][:, 1:]
        assert (labels[:2] != -100).sum() == 2
        assert (labels[2:] != -100).sum() == 254


def test_causal_lm_dp2_tp2_matches_jax():
    """The port on dp2 x tp2 against the JAX trainer on the same mesh
    from the same params, at test_torch_train's tolerances: loss and
    grad_norm within 1e-5 relative each step, params within 3e-5 (where
    the first step's |grad| is under 1e-6, by the lr rule)."""
    _, jax_metrics, jax_params = _jax_lm()
    run = _mesh_run(("lm", "dp2_tp2"))
    want = [{"metrics": m} for m in jax_metrics]
    want[-1]["model"] = {k: v.numpy() for k, v in TG.params_from_flax(
        {"params": jax_params}).items()}
    _hold(run, want, 1e-5, 3e-5, _grad_mask(_oracle(("lm", "dp2_tp2"))))


# ---------------------------------------------------------------------------
# (iv) the image trainer: global batch norm


@pytest.mark.parametrize("against", ["one_device", "jax_dp2"])
@pytest.mark.parametrize("mesh", list(IMAGE_MESHES))
def test_image_mesh_uses_global_batch_norm(mesh, against):
    """Three f32 steps of the narrow ResNet on the uneven batch on the
    mesh, against the port on one device or the JAX trainer on dp=2
    (whose batch norm under jit is global), at test_torch_resnet's
    tolerances: accuracy equal, the first loss within 1e-5 relative and
    the next two within 2e-4, params and batch stats within 1e-4. Under
    tp the convs' weights are stored in blocks (their output channels)
    and gathered for the step, which every tp rank computes whole."""
    _blocks_follow_placements(_mesh_run(("image", mesh)),
                              _cases()[("image", mesh)])
    key = ("image", mesh)
    run = _mesh_run(key)
    if against == "one_device":
        want = _oracle(key)
    else:
        _, metrics, final = _jax_image()
        want = [{"metrics": m} for m in metrics]
        want[-1]["model"] = {k: v.numpy() for k, v in
                             TR.params_from_flax(final).items()}
    for i, (g, w) in enumerate(zip(run, want)):
        np.testing.assert_allclose(g["metrics"]["loss"], w["metrics"]["loss"],
                                   rtol=1e-5 if i == 0 else 2e-4)
        assert g["metrics"]["accuracy"] == w["metrics"]["accuracy"]
    for name, ref in want[-1]["model"].items():
        np.testing.assert_allclose(run[-1]["model"][name], ref, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_uneven_batch_tells_local_from_global_batch_norm():
    """The check above can fail: on one device, the mean of the two
    halves' first-step losses (batch norm over each half) is off the
    whole batch's loss by far more than 1e-5 relative."""
    case = dict(_cases()[("image", "dp2")], spec=None, steps=1)
    whole = _oracle(("image", "dp2"))[0]["metrics"]["loss"]
    halves = []
    for rows in (slice(0, 4), slice(4, 8)):
        b = {k: v[rows] for k, v in case["batch"].items()}
        halves.append(D.run_steps(**dict(case, batch=b))[0]["metrics"]
                      ["loss"])
    assert abs(np.mean(halves) - whole) / whole > 1e-3


# ---------------------------------------------------------------------------
# the collectives facade, the bench's chip count, the dry run


@functools.lru_cache(maxsize=None)
def _exercised():
    return D.spawn(D.exercise_collectives, 4, (dict(dp=2, tp=2),),
                   timeout_s=SPAWN_TIMEOUT_S)


def test_collectives_on_a_dp2_tp2_mesh():
    """Each collective on 4 gloo ranks (dp-major coordinates) against
    its definition, from every rank's x = arange(4) + 10 rank."""
    res = _exercised()
    xs = {r["rank"]: np.arange(4.0) + 10 * r["rank"] for r in res}
    for r in res:
        rank = r["rank"]
        dp, tp = rank // 2, rank % 2
        assert tuple(r["coordinate"]) == (dp, 0, 0, 0, 0, tp)
        tp_ranks, dp_ranks = [2 * dp, 2 * dp + 1], [tp, 2 + tp]
        m = {q: np.stack([xs[q], xs[q] + 100]) for q in xs}
        np.testing.assert_array_equal(r["psum_tp"],
                                      sum(xs[q] for q in tp_ranks))
        np.testing.assert_array_equal(r["pmean_dp"],
                                      sum(xs[q] for q in dp_ranks) / 2)
        np.testing.assert_array_equal(r["pmax_dp"],
                                      np.maximum(*[xs[q] for q in dp_ranks]))
        np.testing.assert_array_equal(
            r["all_gather_tp"], np.concatenate([m[q] for q in tp_ranks], 1))
        np.testing.assert_array_equal(r["all_gather_tp_stacked"],
                                      np.stack([xs[q] for q in tp_ranks]))
        total = sum(m[q] for q in dp_ranks)
        np.testing.assert_array_equal(r["reduce_scatter_dp"],
                                      total[:, 2 * dp:2 * dp + 2])
        np.testing.assert_array_equal(r["ppermute_tp"],
                                      xs[tp_ranks[(tp - 1) % 2]])
        np.testing.assert_array_equal(
            r["all_to_all_dp"],
            np.concatenate([m[q][:, 2 * dp:2 * dp + 2] for q in dp_ranks], 0))
        assert r["axis_index_tp"] == tp
        # psum_forward: the sum, the gradient passed through (rank + 1);
        # psum_backward: the identity, the gradient summed over tp
        np.testing.assert_array_equal(r["psum_forward"], r["psum_tp"])
        np.testing.assert_array_equal(r["psum_forward_grad"],
                                      np.full(4, rank + 1.0))
        np.testing.assert_array_equal(r["psum_backward"], xs[rank])
        np.testing.assert_array_equal(
            r["psum_backward_grad"], np.full(4, sum(q + 1.0 for q in tp_ranks)))
        np.testing.assert_array_equal(r["allreduce_mean"],
                                      sum(xs.values()) / 4)
        assert r["group_world_size"] == 4
        assert r["counts"]["all_reduce"] >= 4 and r["counts"]["barrier"] == 1
        # a [4, 8] kernel on dp2 x tp2: tp takes the output (last) dim
        # (the JAX rule), so each rank holds its tp half of the columns
        kernel = np.arange(32.0).reshape(4, 8)
        np.testing.assert_array_equal(r["shard_params_local"],
                                      kernel[:, 4 * tp:4 * tp + 4])
        np.testing.assert_array_equal(r["shard_params_full"], kernel)
        assert tuple(r["single_axis_mesh_dp"]) == (4, 1, 1, 1, 1, 1)
    assert TS.default_spec_for(4) == TM.MeshSpec(dp=2, tp=2)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_data_sharding_and_replicated_match_jax(ndim):
    """The batch dim over (dp, fsdp), the rest replicated; and the
    all-replicated placements, as the JAX functions' PartitionSpecs."""
    spec = JM.MeshSpec(dp=2, fsdp=2, tp=2)
    jmesh = spec.build(jax.devices()[:8])
    assert TM.data_sharding(None, ndim) == _spec_of(
        JM.data_sharding(jmesh, ndim).spec, ndim)
    assert TM.replicated(None) == _spec_of(JM.replicated(jmesh).spec, ndim)
    tree = {"params": {"c_fc": {"kernel": np.zeros((8, 32))}}}
    assert TM.sharding_pytree(tree, None, TM.MeshSpec(tp=2, fsdp=2)) == {
        "params": {"c_fc": {"kernel": _spec_of(JM.sharding_pytree(
            tree, JM.MeshSpec(tp=2, fsdp=2).build(jax.devices()[:4]),
            JM.MeshSpec(tp=2, fsdp=2))["params"]["c_fc"]["kernel"].spec, 2)}}}


def test_bench_counts_chips_from_the_process_group():
    """gpt2_loop on 2 gloo ranks takes n_dev = 2 from the world size:
    the per-chip batch stays 2, the global batch is 4 rows on
    MeshSpec(dp=2), and its step runs collectives."""
    res = D.spawn(D.call, 2, ("ray_tpu_torch.bench", "gpt2_loop",
                              {"device": "cpu"}), timeout_s=SPAWN_TIMEOUT_S)
    for g in res:
        assert g["gpt2_n_chips"] == 2 and g["gpt2_batch_per_chip"] == 2
        assert g["gpt2_collective_calls"].get("all_reduce", 0) > 0
        assert all(np.isfinite(g["gpt2_losses"]))
    assert res[0]["gpt2_losses"] == res[1]["gpt2_losses"]


@pytest.mark.parametrize("n, phase", [(4, 1), (8, 1), (8, 2), (8, 3),
                                      (8, 4)])
def test_dryrun_multichip(n, phase):
    """Phase 1 on default_spec_for(n) (dp2 x tp2 at 4; dp2 x sp2 x tp2 at
    8, the ring): a finite bf16 loss, the same on every rank, and the
    f32 step's loss and grad_norm within 1e-6 of the one-device step's.
    Phase 2 on dp2 x pp2 x tp2: the pipelined step's loss within 1e-6
    of ``eval_loss`` on the same params (JAX's bound is 5e-2) and its
    loss and grad_norm of the one-device pipelined step's. Phase 3 on 8
    ranks: dp2 x fsdp2 x tp2 within 1e-6 of the one-device losses over
    two steps, the loss falls, and AdamW's exp_avg after one step on
    dp2 x fsdp4 within 1e-6 of the one-device step's (the JAX dry run's
    bound is 1e-4). Phase 4 on dp2 x ep4: the MoE step's two losses
    within 1e-6 of the unsharded step's (JAX's bound: 1e-4), the second
    lower, each rank holding one expert's block."""
    out = D.dryrun_multichip(n, phases=(phase,), timeout_s=SPAWN_TIMEOUT_S)
    if phase == 1:
        assert np.isfinite(out["phase1"]["loss"])
        assert max(out["phase1"]["rel"].values()) <= 1e-6
        assert (TS.default_spec_for(n).sp == 2) == (n == 8)
    elif phase == 2:
        assert max(out["phase2"]["rel"].values()) <= 1e-6
    elif phase == 3:
        assert out["phase3"]["exp_avg_max_abs_err"] < 1e-6
        assert max(out["phase3"]["loss_rel"]) <= 1e-6
    else:
        assert max(out["phase4"]["loss_rel"]) <= 1e-6
        assert out["phase4"]["losses"][1] < out["phase4"]["losses"][0]


# ---------------------------------------------------------------------------
# the streaming route for GPT-2 training (exact=True)


def _counting(impl, counts):
    def wrap(name, fn):
        def run(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run
    return TA.TrainingAttention(*[wrap(n, f) for n, f in
                                  zip(TA.TrainingAttention._fields, impl)])


def test_exact_trainer_takes_the_streaming_path(monkeypatch):
    """exact=True against the JAX trainer with RTPU_ATTN_EXACT=1: three
    steps of the tiny GPT-2 at s = 128 (a shape the whole-kv path would
    take), loss and grad_norm within 1e-5 relative, params within 3e-5
    (the key bias by the lr rule); every layer's attention went through
    the streaming forward, dkv and dq, and never the whole-kv pair."""
    monkeypatch.setenv("RTPU_ATTN_EXACT", "1")
    cj, ct = _gpt2_cfgs()
    jspec = JM.MeshSpec()
    trj = JS.make_causal_lm_trainer(cj, mesh=jspec.build(jax.devices()[:1]),
                                    spec=jspec)
    sj = trj.init(jax.random.PRNGKey(1))
    params = jax.device_get(sj["params"])
    counts = {}
    trt = TS.make_causal_lm_trainer(
        model=TG.GPT2(ct, impl=_counting(TA.TRAINING_PLAIN, counts)),
        exact=True, device="cpu")
    st = trt.init(params={"params": params})
    batch = _lm_batches()[0]
    bj, bt = JS.put_batch(trj, batch), TS.put_batch(trt, batch)
    for _ in range(STEPS):
        sj, mj = trj.step(sj, bj)
        st, mt = trt.step(st, bt)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)
    n = ct.n_layer * STEPS
    assert counts == {"forward": n, "backward_dkv": n, "backward_dq": n,
                      "delta": n}
    want = TG.params_from_flax({"params": jax.device_get(sj["params"])})
    got = st["model"].state_dict()
    E = ct.n_embd
    for k, ref in want.items():
        diff = (got[k] - ref).abs()
        if k.endswith("attn.c_attn.bias"):
            assert float(diff[E:2 * E].max()) <= 2 * LR * STEPS
            diff = torch.cat([diff[:E], diff[2 * E:]])
        assert float(diff.max()) <= 3e-5, k
