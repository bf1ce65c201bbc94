"""Multi-rank dry run of the training step: the port of
``__graft_entry__.dryrun_multichip`` phases 1 to 4.

    python -m ray_tpu_torch.parallel.dryrun 4     # phases 1 and 2, gloo
    python -m ray_tpu_torch.parallel.dryrun 8     # phases 1 to 4

The JAX package runs its dry run on n virtual CPU devices in one
process. The port runs one process per rank: ``spawn`` starts n ranks
of a new process group (gloo on the CPU), each runs a function of this
module, and their results come back in rank order.

Each phase is held against the port's own step on one device, whose
losses (and grad norms) the mesh's must match within ``LOSS_REL``:

  1. one step of a tiny GPT-2 on ``default_spec_for(n)`` (dp2 x tp2 at
     n = 4, dp2 x sp2 x tp2 at 8: the ring): in the model's default
     bf16 (a finite loss, the same on every rank) and in f32 (against
     the one-device step);
  2. (n a multiple of 4) the pipelined trainer on dp(n/4) x pp2 x tp2,
     M = 4 microbatches: its step's loss against ``eval_loss`` (the
     pp = 1 oracle on the same params) and against the one-device
     pipelined step (JAX's bound is 5e-2);
  3. (n a multiple of 8) two steps on dp x fsdp x tp (n/4, 2, 2), and
     the ZeRO check: on dp2 x fsdp4, AdamW's first moment after one
     step, gathered from its shards, within ``EXP_AVG_TOL`` of the
     one-device step's. The one-device oracle replaces the JAX run the
     JAX dry run compares with, whose dp x fsdp x tp backward XLA-CPU
     computes wrongly (``__graft_entry__.py:150-157``);
  4. (n a multiple of 8) a MoE layer (4 experts) on dp2 x ep4, one SGD
     step on mean(y^2) + 0.01 aux, the experts stored in ep blocks:
     both losses against the unsharded step (JAX's bound is 1e-4), and
     the second below the first.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

LOSS_REL = 1e-6       # each phase's losses against the oracle's
EXP_AVG_TOL = 1e-6    # the ZeRO check: max |exp_avg - oracle's|


def _rank_main(payload, rank, n, init_method, backend, timeout_s, results):
    """One rank: join the process group, run ``fn(*args, **kwargs)``
    (``payload`` = the pickled triple), report."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel.collectives import initialize_distributed
    try:
        fn, args, kwargs = pickle.loads(payload)
        torch.set_num_threads(1)
        # torch 2.13 renames all_gather_into_tensor / reduce_scatter_tensor
        # (the names torch 2.11 has) with a FutureWarning per call site
        warnings.filterwarnings("ignore", category=FutureWarning)
        initialize_distributed(init_method, n, rank, backend=backend,
                               local_device_ids=([rank] if backend == "nccl"
                                                 else None),
                               timeout_s=timeout_s)
        try:
            out = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


# what the ranks' functions import, loaded once by the fork server
_PRELOAD = ("torch.distributed.tensor", "torch.utils.checkpoint",
            "ray_tpu_torch.train.spmd", "ray_tpu_torch.parallel.pipeline",
            "ray_tpu_torch.parallel.moe", "ray_tpu_torch.models.llama",
            "ray_tpu_torch.models.resnet")


def spawn(fn: Callable, n: int, args: Sequence = (), *,
          backend: str = "gloo", timeout_s: float = 120.0,
          kwargs: Optional[Dict[str, Any]] = None) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on each of ``n`` ranks of a new
    process group and return their results in rank order. ``fn`` and
    its arguments are pickled (``fn`` by its import path). The group meets through a file
    store in a new temporary directory, so concurrent runs never share
    a port. Raises ``RuntimeError`` with a rank's traceback when it
    fails and ``TimeoutError`` when the ranks have not all reported
    after ``timeout_s`` (their collectives fail after the same time);
    either way every rank process is gone on return.

    Ranks start from a fork server that imported torch and the modules
    the ranks run (``_PRELOAD``) once per calling process: a fresh
    process, so none of the caller's threads is copied, and a rank
    starts in a fraction of a second."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", __name__, *_PRELOAD])
    store_dir = tempfile.mkdtemp(prefix="rtt_store_")
    init_method = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    # plain pickle both ways: multiprocessing's own passes each tensor's
    # storage as a file descriptor (a model's worth overflows the fork
    # server's limit), or as shared memory that dies with the rank
    payload = pickle.dumps((fn, tuple(args), dict(kwargs or {})))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(payload, r, n, init_method, backend,
                               timeout_s, results))
             for r in range(n)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 30.0
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks of {getattr(fn, '__name__', fn)}: "
                        f"{sorted(out)} reported within {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            if p.pid is None:       # never started
                continue
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(n)]


# ---------------------------------------------------------------------------
# What a rank runs


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def run_steps(kind: str, model, batch: Dict[str, np.ndarray], steps: int,
              spec: Optional[Dict[str, int]] = None, seed: int = 0,
              params=None, **trainer_kw) -> List[Dict[str, Any]]:
    """``steps`` trainer steps of ``kind`` ("causal_lm": ``model`` a
    GPT2; "pipelined": a GPT2Config; "image": a ResNet) on the CPU, on
    ``MeshSpec(**spec)`` over the process group if there is one (one
    device otherwise), from ``init(seed, params)``, on the global
    ``batch``. After each step: its metrics, the whole state
    (``gather_state``) as numpy and the shape of this rank's block of
    each param; for "pipelined" also ``eval_loss`` before the step.
    Every rank runs it."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import spmd

    spec = MeshSpec(**(spec or {}))
    if kind == "causal_lm":
        tr = spmd.make_causal_lm_trainer(model=model, spec=spec,
                                         device="cpu", **trainer_kw)
    elif kind == "pipelined":       # model: the GPT2Config
        tr = spmd.make_pipelined_lm_trainer(model, spec=spec, device="cpu",
                                            **trainer_kw)
    elif kind == "image":
        tr = spmd.make_image_classifier_trainer(model, spec=spec,
                                                device="cpu", **trainer_kw)
    else:
        raise ValueError(f"unknown trainer kind {kind!r}")
    state = tr.init(seed, params)
    b = spmd.put_batch(tr, batch)
    blocks = {n: tuple(t.shape)
              for n, t in state["mesh_state"].shards.items()}
    out = []
    for _ in range(steps):
        before = ({"eval_loss": float(tr.eval_loss(state, b))}
                  if tr.eval_loss is not None else {})
        state, metrics = tr.step(state, b)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "blocks": blocks, **before,
                    **_numpy(spmd.gather_state(state))})
    return out


def run_cases(cases: Sequence[Dict[str, Any]]) -> List[Any]:
    """``run_steps(**case)`` for each case in turn, each on a mesh of its
    own over the same ranks."""
    return [run_steps(**case) for case in cases]


def call(module: str, name: str, kwargs: Optional[Dict[str, Any]] = None):
    """``module.name(**kwargs)``: any function of the port on a rank."""
    import importlib
    return getattr(importlib.import_module(module), name)(**(kwargs or {}))


def call_all(calls: Sequence[tuple]) -> List[Any]:
    """``call(module, name, kwargs)`` for each triple in turn: several
    checks on one spawn's ranks."""
    return [call(*c) for c in calls]


def exercise_collectives(spec: Dict[str, int]) -> Dict[str, Any]:
    """Each collective of ``collectives`` once on ``MeshSpec(**spec)``
    over the process group, on tensors made from this rank's number:
    what each gave (numpy), the gradients through ``psum_forward`` and
    ``psum_backward``, a ``shard_params`` leaf (this rank's block and
    the whole), ``single_axis_mesh``'s shape and the call counts. A
    self-check of a process group and the facade, in the reference's
    API too."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import collectives as C
    from ray_tpu_torch.parallel.mesh import MeshSpec

    mesh = MeshSpec(**spec).build()
    C.reset_call_counts()
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.arange(4.0) + 10 * rank
    m = torch.stack([x, x + 100])                           # [2, 4]
    n_tp = mesh.size("tp")
    out = {
        "rank": rank, "coordinate": mesh.coordinate,
        "psum_tp": C.psum(x, "tp", mesh),
        "pmean_dp": C.pmean(x, "dp", mesh),
        "pmax_dp": C.pmax(x, "dp", mesh),
        "all_gather_tp": C.all_gather(m, "tp", mesh, gather_axis=1),
        "all_gather_tp_stacked": C.all_gather(x, "tp", mesh, tiled=False),
        "reduce_scatter_dp": C.reduce_scatter(m, "dp", mesh, scatter_axis=1),
        "ppermute_tp": C.ppermute(x, "tp", mesh,
                                  C.ring_neighbors("tp", n_tp)[0]),
        "all_to_all_dp": C.all_to_all(m, "dp", mesh, split_axis=1,
                                      concat_axis=0),
        "axis_index_tp": C.axis_index("tp", mesh),
    }
    for name, fn in (("psum_forward", C.psum_forward),
                     ("psum_backward", C.psum_backward)):
        leaf = x.clone().requires_grad_()
        y = fn(leaf, "tp", mesh)
        (y * (rank + 1)).sum().backward()
        out[name] = y.detach()
        out[name + "_grad"] = leaf.grad
    from ray_tpu_torch.parallel.mesh import shard_params, single_axis_mesh
    tree = {"params": {"h": {"mlp": {"kernel": torch.arange(32.0).reshape(
        4, 8)}}}}
    sharded = shard_params(tree, mesh, MeshSpec(**spec))
    leaf = sharded["params"]["h"]["mlp"]["kernel"]
    out["shard_params_local"] = leaf.to_local()
    out["shard_params_full"] = leaf.full_tensor()
    out["single_axis_mesh_dp"] = single_axis_mesh("dp").shape
    group = C.init_collective_group(world, rank, backend="gloo",
                                    group_name="exercise")
    out["allreduce_mean"] = C.allreduce(x, "exercise", op="mean")
    C.barrier("exercise")
    C.destroy_collective_group("exercise")
    out["group_world_size"] = group.world_size
    out["counts"] = C.call_counts()
    return _numpy(out)


def _tiny_gpt2(spec, **kw):
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
    cfg = GPT2Config(vocab_size=kw.pop("vocab_size", 256),
                     n_positions=kw.pop("n_positions", 64),
                     n_embd=kw.pop("n_embd", 64 * max(1, spec.tp)),
                     n_layer=2, n_head=kw.pop("n_head", max(4, spec.tp)),
                     attention_backend="reference", **kw)
    return GPT2(cfg)


def checkpoint_batch(vocab_size: int, shape=(4, 32)):
    """The two global batches of ``checkpoint_case`` (tokens as their
    own labels)."""
    rng = np.random.default_rng(11)
    return [{"input_ids": t, "labels": t}
            for t in (rng.integers(0, vocab_size, shape) for _ in range(2))]


def checkpoint_case(kind: str, root: str,
                    spec: Dict[str, int]) -> Dict[str, Any]:
    """Save and restore on ``MeshSpec(**spec)`` over the process group:
    ``GPT2Config.tiny()`` in f32 through the causal-LM trainer
    (``kind="causal_lm"``; batches [4, 32]) or the pipelined one
    (``"pipelined"``; [2, 2, 16]), from ``init(0)``: a step, an async
    save into ``CheckpointManager(root)`` (every rank its blocks, rank 0
    commits after a barrier: ``commit_gang_step``), a second step. For
    the pipelined trainer a fresh ``init(5)`` is then restored at the
    same mesh and takes the second step again (``resumed``). Returns
    the steps' metrics and, for the causal LM, the whole state at the
    save (``saved``, numpy)."""
    from ray_tpu_torch.checkpoint import CheckpointManager
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import spmd

    cfg = GPT2Config.tiny()
    mesh_spec = MeshSpec(**spec)
    if kind == "causal_lm":
        tr = spmd.make_causal_lm_trainer(cfg, spec=mesh_spec, device="cpu")
        shape = (4, 32)
    else:
        tr = spmd.make_pipelined_lm_trainer(cfg, spec=mesh_spec,
                                            device="cpu")
        shape = (2, 2, 16)
    batches = [spmd.put_batch(tr, b)
               for b in checkpoint_batch(cfg.vocab_size, shape)]

    def step(state, b):
        return {k: float(v) for k, v in tr.step(state, b)[1].items()}

    state = tr.init(0)
    metrics = [step(state, batches[0])]
    saved = _numpy(spmd.gather_state(state))
    mgr = CheckpointManager(root)
    ck = spmd.make_async_checkpointer(manager=mgr)
    ck.save(state["step"], state)
    spmd.commit_gang_step(ck, state["step"])
    metrics.append(step(state, batches[1]))
    ck.finalize()
    if kind == "causal_lm":
        return {"metrics": metrics, "saved": saved}
    restored = spmd.restore_spmd_state(tr.init(5), manager=mgr)
    return {"metrics": metrics, "resumed": [step(restored, batches[1])]}


def ring_case(q, k, v, do, causal: bool,
              spec: Dict[str, int]) -> Dict[str, np.ndarray]:
    """``ring_attention_sharded`` on the whole [b, h, s, d] inputs over
    ``MeshSpec(**spec)``'s sp (the kernels' CPU path: their plain
    versions), then the backward of sum(out * do): the whole output and
    this rank's shards of dq, dk and dv."""
    from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.mesh import MeshSpec
    mesh = MeshSpec(**spec).build()
    n, i = mesh.size("sp"), mesh.index("sp")
    q, k, v = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = ring_attention_sharded(q, k, v, mesh, causal=causal)
    (out * torch.as_tensor(do)).sum().backward()
    return _numpy({"out": out, **{f"d{name}": t.grad.chunk(n, 2)[i]
                                  for name, t in zip("qkv", (q, k, v))}})


def mlp_stage(params, x):
    """The stage the pipeline checks run: x + tanh(x w1 + b1) w2."""
    return x + torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def pipeline_case(stage_params, microbatches, spec: Dict[str, int],
                  remat: bool = True) -> Dict[str, Any]:
    """``pipeline_apply(mlp_stage)`` over ``MeshSpec(**spec)``'s pp on
    stacked ``stage_params`` (numpy), then the backward of mean(out^2):
    the outputs, this rank's row of each param's gradient and the
    microbatches' gradient."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    mesh = MeshSpec(**spec).build()
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in stage_params.items()}
    x = torch.tensor(microbatches, requires_grad=True)
    out = pipeline_apply(mlp_stage, mesh, remat=remat)(params, x)
    out.square().mean().backward()
    i = mesh.index("pp")
    return _numpy({"out": out, "dx": x.grad,
                   "grads": {k: p.grad[i] for k, p in params.items()}})


def llama_ring_forward(cfg: Any, params, ids,
                       spec: Dict[str, int]) -> np.ndarray:
    """The port's Llama forward on this rank's sp slice of ``ids`` (a
    ``LlamaModel`` of ``cfg`` from flax ``params``, ``set_mesh`` on
    ``MeshSpec(**spec)``): its logits."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshSpec
    mesh = MeshSpec(**spec).build()
    model = llama.LlamaModel(cfg)
    llama.params_from_flax(params, model)
    model.set_mesh(mesh)
    ids = torch.as_tensor(ids).chunk(mesh.size("sp"), 1)[mesh.index("sp")]
    with torch.no_grad():
        return model(ids.long()).numpy()


def moe_sgd(spec: Optional[Dict[str, int]], x, *, num_experts: int = 4,
            d_ff: int = 32, capacity_factor: float = 2.0, params=None,
            seed: int = 6, lr: float = 0.1,
            device: str = "cpu") -> Dict[str, Any]:
    """Phase 4's step on ``MeshSpec(**spec)`` (one device with None): a
    ``MoE`` layer from flax ``params`` or from ``init_weights(seed)``,
    its expert params stored in ep blocks (``expert_sharding_rule``),
    on this rank's part of the global tokens ``x`` ([S, d], or [B, T,
    d] whose T sp splits): the rows that split over (dp, fsdp) and the
    positions that split over sp; the loss mean(y^2) + 0.01 aux over the
    global batch, its gradients, one SGD step (``lr``), the loss again.
    Returns the losses, the global y and aux of the first forward, the
    whole gradients and each param's block shape. ``device``: where it
    runs without a process group."""
    from ray_tpu_torch.parallel import collectives as C
    from ray_tpu_torch.parallel import moe
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import spmd
    mspec = MeshSpec(**(spec or {}))
    mesh = mspec.build([device])
    x = np.asarray(x, np.float32)
    layer = moe.MoE(x.shape[-1], num_experts, d_ff,
                    capacity_factor=capacity_factor)
    if params is None:
        layer.init_weights(torch.Generator().manual_seed(seed))
    else:
        moe.moe_params_from_flax(params, layer)
    layer.to(mesh.device).set_mesh(mesh)
    ms = spmd._MeshState(layer, mesh, mspec, sum_axes=spmd.TOKEN_AXES,
                         override=moe.expert_sharding_rule)
    rows = torch.as_tensor(x)
    for dim, axis in ((0, spmd.BATCH_AXES), (1, "sp")):
        if mesh.size(axis) > 1:
            rows = rows.chunk(mesh.size(axis), dim)[mesh.index(axis)]
    rows = rows.to(mesh.device)

    def loss_part():
        y, aux = layer(rows)
        return y, aux, y.square().sum() / x.size + 0.01 * aux

    def total(t):
        return float(spmd._batch_sum(t.detach(), mesh, spmd.TOKEN_AXES))

    ms.gather()
    y, aux, l0 = loss_part()
    l0.backward()
    ms.reduce_grads()
    grads = {n: ms.full(n, b.grad) for n, b in ms.shards.items()}
    with torch.no_grad():
        for b in ms.shards.values():
            b -= lr * b.grad
    ms.gather()
    with torch.no_grad():
        l1 = loss_part()[2]
    y = y.detach()
    if y.ndim > 2:
        y = C.all_gather(y, "sp", mesh, gather_axis=1)
    return _numpy({"losses": (total(l0), total(l1)),
                   "y": C.all_gather(y, spmd.BATCH_AXES, mesh),
                   "aux": total(aux),
                   "grads": grads,
                   "blocks": {n: tuple(b.shape)
                              for n, b in ms.shards.items()}})


def _phase1_cases(n: int):
    """Phase 1's cases: one step on ``default_spec_for(n)`` (tiny shapes
    that divide by the mesh) in the model's default bf16 compute and in
    f32; the f32 one also without a mesh (the oracle)."""
    from ray_tpu_torch.train.spmd import default_spec_for
    spec = default_spec_for(n)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        model = _tiny_gpt2(spec, dtype=dtype)
        tokens = np.random.default_rng(0).integers(
            0, model.cfg.vocab_size, (2 * spec.dp * spec.fsdp, 16 * spec.sp),
            dtype=np.int32)
        cases.append(dict(kind="causal_lm", model=model, steps=1,
                          batch={"input_ids": tokens, "labels": tokens},
                          spec=dict(spec.axis_sizes())))
    return spec, cases, dict(cases[1], spec=None)


def _phase2_cases(n: int):
    """Phase 2: the pipelined trainer on dp(n/4) x pp2 x tp2 (tiny, f32,
    M = 4 microbatches of 2 dp rows each), and the same without a mesh."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    spec = dict(dp=n // 4, pp=2, tp=2)
    cfg = GPT2Config(vocab_size=128, n_positions=32, n_embd=64, n_layer=2,
                     n_head=2, attention_backend="reference",
                     dtype=torch.float32)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 2 * spec["dp"], 16), dtype=np.int32)
    case = dict(kind="pipelined", model=cfg, steps=1, seed=7,
                batch={"input_ids": tokens, "labels": tokens})
    return dict(case, spec=spec), case


def _phase3_cases(n: int):
    from ray_tpu_torch.parallel.mesh import MeshSpec
    fs = MeshSpec(dp=n // 4, fsdp=2, tp=2)
    model = _tiny_gpt2(fs, vocab_size=128, n_positions=32, n_embd=64,
                       n_head=4, dtype=torch.float32)
    tokens = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2 * fs.dp * fs.fsdp, 16), dtype=np.int32)
    case = dict(kind="causal_lm", model=model, steps=2, seed=3,
                batch={"input_ids": tokens, "labels": tokens})
    return [dict(case, spec=dict(dp=fs.dp, fsdp=2, tp=2)),
            dict(case, spec=dict(dp=2, fsdp=4))], case


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     phases: Sequence[int] = (1, 2, 3, 4),
                     timeout_s: float = 120.0) -> Dict[str, Any]:
    """Phases 1 to 4 on ``n_devices`` ranks (module docstring; phase 2
    where n is a multiple of 4, phases 3 and 4 where it is a multiple
    of 8); fails (``AssertionError``) where a check does not hold.
    Returns what it measured."""
    out: Dict[str, Any] = {}
    if 1 in phases:
        spec, cases, oracle_case = _phase1_cases(n_devices)
        runs = spawn(run_cases, n_devices, (cases,), backend=backend,
                     timeout_s=timeout_s)
        bf16 = [r[0][0]["metrics"] for r in runs]
        f32 = runs[0][1][0]["metrics"]
        oracle = run_steps(**oracle_case)[0]["metrics"]
        loss = bf16[0]["loss"]
        assert math.isfinite(loss), f"non-finite loss {loss}"
        assert all(m == bf16[0] for m in bf16), f"ranks disagree: {bf16}"
        rel = {k: _rel(f32[k], oracle[k]) for k in ("loss", "grad_norm")}
        assert max(rel.values()) <= LOSS_REL, \
            f"phase 1 parity broken: f32 {f32} vs one device {oracle}"
        out["phase1"] = {"spec": spec.describe(), "loss": loss,
                         "f32": f32, "oracle": oracle, "rel": rel}
        print(f"dryrun_multichip: n={n_devices} spec={spec.describe()} "
              f"loss={loss:.4f}; f32 loss={f32['loss']:.6f} (one device "
              f"{oracle['loss']:.6f}, rel {rel['loss']:.1e}) ok", flush=True)
    if 2 in phases and n_devices % 4 == 0:
        case, oracle_case = _phase2_cases(n_devices)
        (run,) = spawn(run_steps, n_devices, (), backend=backend,
                       timeout_s=timeout_s, kwargs=case)[0]
        (oracle,) = run_steps(**oracle_case)
        got = run["metrics"]
        rel = {"eval_loss": _rel(got["loss"], run["eval_loss"]),
               **{k: _rel(got[k], oracle["metrics"][k])
                  for k in ("loss", "grad_norm")}}
        assert math.isfinite(got["loss"]), f"non-finite pp loss {got}"
        assert max(rel.values()) <= LOSS_REL, \
            (f"pp parity broken: {got}, eval_loss {run['eval_loss']}, one "
             f"device {oracle['metrics']}")
        out["phase2"] = {"spec": f"dp{n_devices // 4} x pp2 x tp2",
                         "loss": got["loss"], "grad_norm": got["grad_norm"],
                         "eval_loss": run["eval_loss"],
                         "oracle": oracle["metrics"], "rel": rel}
        print(f"dryrun_multichip: pp phase dp{n_devices // 4} x pp2 x tp2 "
              f"loss={got['loss']:.6f} (eval_loss {run['eval_loss']:.6f}, "
              f"one device {oracle['metrics']['loss']:.6f}) ok", flush=True)
    if 3 in phases and n_devices % 8 == 0:
        cases, oracle_case = _phase3_cases(n_devices)
        fs, zero = spawn(run_cases, n_devices, (cases,), backend=backend,
                         timeout_s=timeout_s)[0]
        oracle = run_steps(**oracle_case)
        l_fs = [s["metrics"]["loss"] for s in fs]
        l_o = [s["metrics"]["loss"] for s in oracle]
        rel = [abs(a - b) / abs(b) for a, b in zip(l_fs, l_o)]
        assert all(math.isfinite(x) for x in l_fs), f"non-finite {l_fs}"
        assert max(rel) <= LOSS_REL, \
            f"fsdp parity broken: steps {l_fs} vs oracle {l_o}"
        assert l_fs[1] < l_fs[0], "fsdp adamw step did not reduce loss"
        mu_err = max(float(np.abs(zero[0]["opt"][k]["exp_avg"]
                                  - v["exp_avg"]).max())
                     for k, v in oracle[0]["opt"].items())
        assert mu_err <= EXP_AVG_TOL, \
            f"fsdp-sharded optimizer state diverges from oracle: {mu_err}"
        out["phase3"] = {"spec": f"dp{n_devices // 4} x fsdp2 x tp2",
                         "losses": l_fs, "oracle_losses": l_o,
                         "loss_rel": rel, "zero_spec": "dp2 x fsdp4",
                         "exp_avg_max_abs_err": mu_err}
        print(f"dryrun_multichip: fsdp phase dp{n_devices // 4} x fsdp2 x "
              f"tp2 losses=({l_fs[0]:.6f},{l_fs[1]:.6f}) oracle "
              f"({l_o[0]:.6f},{l_o[1]:.6f}); zero phase dp2 x fsdp4 "
              f"exp_avg_err={mu_err:.2e} ok", flush=True)
    if 4 in phases and n_devices % 8 == 0:
        x = np.random.default_rng(5).standard_normal((16, 16)).astype(
            np.float32)
        ep = spawn(moe_sgd, 8, (dict(dp=2, ep=4), x), backend=backend,
                   timeout_s=timeout_s)[0]
        oracle = moe_sgd(None, x)
        rel = [_rel(a, b) for a, b in zip(ep["losses"], oracle["losses"])]
        assert all(math.isfinite(v) for v in ep["losses"]), ep["losses"]
        assert max(rel) <= LOSS_REL, \
            f"ep parity broken: {ep['losses']} vs oracle {oracle['losses']}"
        assert ep["losses"][1] < ep["losses"][0], \
            "ep sgd step did not reduce loss"
        assert ep["blocks"]["experts_w1"][0] == 1, ep["blocks"]
        out["phase4"] = {"spec": "dp2 x ep4", "losses": ep["losses"],
                         "oracle_losses": oracle["losses"], "loss_rel": rel,
                         "blocks": ep["blocks"]}
        print(f"dryrun_multichip: ep phase dp2 x ep4 losses=("
              f"{ep['losses'][0]:.6f},{ep['losses'][1]:.6f}) oracle ("
              f"{oracle['losses'][0]:.6f},{oracle['losses'][1]:.6f}) ok",
              flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
