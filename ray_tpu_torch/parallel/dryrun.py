"""Multi-rank dry run of the training step: the port of
``__graft_entry__.dryrun_multichip`` phases 1 and 3.

    python -m ray_tpu_torch.parallel.dryrun 4     # phase 1, gloo
    python -m ray_tpu_torch.parallel.dryrun 8     # phase 3 (phase 1 at 8
                                                  # needs sp: A8)

The JAX package runs its dry run on n virtual CPU devices in one
process. The port runs one process per rank: ``spawn`` starts n ranks
of a new process group (gloo on the CPU), each runs a function of this
module, and their results come back in rank order.

Phase 1 takes one step of a tiny GPT-2 on ``default_spec_for(n)``;
at n = 8 that spec has sp = 2, which is not ported (ROADMAP.md Queue A
item 8) and raises. Phase 3 (n a multiple of 8): two steps on dp x fsdp
x tp (n/4, 2, 2) against the port's own step on one device, whose
losses must agree within ``LOSS_REL``; then the ZeRO check: on dp2 x
fsdp4, AdamW's first moment after one step, gathered from its shards,
within ``EXP_AVG_TOL`` of the one-device step's. The one-device oracle
replaces the JAX run the JAX dry run compares with, whose dp x fsdp x
tp backward XLA-CPU computes wrongly (``__graft_entry__.py:150-157``).
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

LOSS_REL = 1e-6       # phase 3: each step's loss against the oracle's
EXP_AVG_TOL = 1e-6    # the ZeRO check: max |exp_avg - oracle's|


def _rank_main(payload, rank, n, init_method, backend, timeout_s, results):
    """One rank: join the process group, run ``fn(*args)`` (``payload``
    = the pickled pair), report."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel.collectives import initialize_distributed
    try:
        fn, args = pickle.loads(payload)
        torch.set_num_threads(1)
        # torch 2.13 renames all_gather_into_tensor / reduce_scatter_tensor
        # (the names torch 2.11 has) with a FutureWarning per call site
        warnings.filterwarnings("ignore", category=FutureWarning)
        initialize_distributed(init_method, n, rank, backend=backend,
                               local_device_ids=([rank] if backend == "nccl"
                                                 else None),
                               timeout_s=timeout_s)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, n: int, args: Sequence = (), *,
          backend: str = "gloo", timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` on each of ``n`` ranks of a new process group
    and return their results in rank order. ``fn`` and ``args`` are
    pickled (``fn`` by its import path). The group meets through a file
    store in a new temporary directory, so concurrent runs never share
    a port. Raises ``RuntimeError`` with a rank's traceback when it
    fails and ``TimeoutError`` when the ranks have not all reported
    after ``timeout_s`` (their collectives fail after the same time);
    either way every rank process is gone on return.

    Ranks start from a fork server that imported torch and this package
    once per calling process: a fresh process, so none of the caller's
    threads is copied, and a rank starts in a fraction of a second."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", __name__])
    store_dir = tempfile.mkdtemp(prefix="rtt_store_")
    init_method = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    # plain pickle both ways: multiprocessing's own passes each tensor's
    # storage as a file descriptor (a model's worth overflows the fork
    # server's limit), or as shared memory that dies with the rank
    payload = pickle.dumps((fn, tuple(args)))
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
    GPT2; "image": a ResNet) on the CPU, on ``MeshSpec(**spec)`` over
    the process group if there is one (one device otherwise), from
    ``init(seed, params)``, on the global ``batch``. After each step:
    its metrics, the whole state (``gather_state``) as numpy and the
    shape of this rank's block of each param. Every rank runs it."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import spmd

    spec = MeshSpec(**(spec or {}))
    if kind == "causal_lm":
        tr = spmd.make_causal_lm_trainer(model=model, spec=spec,
                                         device="cpu", **trainer_kw)
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
        state, metrics = tr.step(state, b)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "blocks": blocks, **_numpy(spmd.gather_state(state))})
    return out


def run_cases(cases: Sequence[Dict[str, Any]]) -> List[Any]:
    """``run_steps(**case)`` for each case in turn, each on a mesh of its
    own over the same ranks."""
    return [run_steps(**case) for case in cases]


def call(module: str, name: str, kwargs: Optional[Dict[str, Any]] = None):
    """``module.name(**kwargs)``: any function of the port on a rank."""
    import importlib
    return getattr(importlib.import_module(module), name)(**(kwargs or {}))


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


def _phase1(n: int) -> float:
    """Phase 1 on one rank: one step on ``default_spec_for(n)`` (tiny
    shapes that divide by the mesh, the model's default bf16 compute)."""
    from ray_tpu_torch.train.spmd import default_spec_for
    spec = default_spec_for(n)
    model = _tiny_gpt2(spec)
    tokens = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2 * spec.dp * spec.fsdp, 16 * spec.sp),
        dtype=np.int32)
    (res,) = run_steps("causal_lm", model, {"input_ids": tokens,
                                            "labels": tokens}, 1,
                       spec=dict(spec.axis_sizes()))
    return res["metrics"]["loss"]


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


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     phases: Sequence[int] = (1, 3),
                     timeout_s: float = 120.0) -> Dict[str, Any]:
    """Phases 1 and 3 on ``n_devices`` ranks (phase 3 where n is a
    multiple of 8); fails (``AssertionError``) where a check does not
    hold. Returns what it measured."""
    from ray_tpu_torch.train.spmd import default_spec_for
    out: Dict[str, Any] = {}
    if 1 in phases:
        spec = default_spec_for(n_devices)
        spec.require_ported()
        losses = spawn(_phase1, n_devices, (n_devices,), backend=backend,
                       timeout_s=timeout_s)
        loss = losses[0]
        assert math.isfinite(loss), f"non-finite loss {loss}"
        assert len(set(losses)) == 1, f"ranks disagree: {losses}"
        out["phase1"] = {"spec": spec.describe(), "loss": loss}
        print(f"dryrun_multichip: n={n_devices} spec={spec.describe()} "
              f"loss={loss:.4f} ok", flush=True)
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
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dryrun_multichip(n, phases=(1, 3) if n % 8 else (3,))
