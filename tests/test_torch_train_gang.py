"""The port's train gang (``DataParallelTrainer``, ``BackendExecutor``,
``WorkerGroup``, ``air.session``) against the JAX package's, on the CPU.

One cluster of each package for the whole module (``init(num_cpus=4)``),
as ``tests/test_torch_runtime.py`` starts them. The programs of
``tests/test_train.py`` and ``tests/test_checkpoint_engine.py``'s gang
restart run on both and must give equal results: a single worker's
reports and ``metrics_history``, ``train_loop_config`` and the ranks at
2 workers, a checkpoint resume, a restart under
``FailureConfig(max_failures=1)``, a durable root committed through
the round barrier and resumed from ``latest_committed()`` across two
``fit()`` calls, and sharded saves through the session's
AsyncCheckpointer restored through its manager. Then: two workers
joined by the port's gloo group give the mean of rank + 1 that JAX's
two-process island gives; ``TorchTrainer`` with ``prepare_model`` (DDP)
ends both ranks at the weights of plain SGD on their mean gradient; a
preemption
notice sent to a train worker's process flips ``session.preempted()`` and
``preemption_deadline()`` inside its train_func thread, on both; a
2-worker gang runs one GPT-2-tiny step on ``MeshSpec(dp=2)``, each rank
fed its ``split(2)`` shard through ``iter_device_batches(device="cpu")``,
held to the JAX trainer's one-device step on the global batch.

Every train_func is a closure over the runtime package's name, so each
side imports only its own package in its workers.
"""

import concurrent.futures
import dataclasses
import functools
import importlib
import os
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

STORE_BYTES = 256 * 1024 * 1024
PACKAGES = ("ray_tpu", "ray_tpu_torch")
# the port's processes check every inbound RPC against its wire schema
# and start workers on demand, as conftest sets for the JAX package's
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
LR = 3e-4            # the causal-LM trainer's default learning rate


@pytest.fixture(scope="module")
def clusters():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    with mock.patch.dict(os.environ, PORT_ENV):
        ray_tpu.init(num_cpus=4, object_store_memory=STORE_BYTES)
        try:
            ray_tpu_torch.init(num_cpus=4, object_store_memory=STORE_BYTES)
            try:
                yield
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            torch.set_num_threads(old_threads)


def _mod(pkg, name=""):
    return importlib.import_module(pkg + name)


def _fit(pkg, train_fn, num_workers=1, **kw):
    train = _mod(pkg, ".train")
    cfg = _mod(pkg, ".air.config")
    trainer = train.DataParallelTrainer(
        train_fn, scaling_config=cfg.ScalingConfig(num_workers=num_workers),
        **kw)
    return trainer.fit()


def _both(program, *args):
    """``program(pkg, *args)`` on each runtime, the two at once (each
    driver call waits on its own cluster): {pkg: its result}."""
    with concurrent.futures.ThreadPoolExecutor(len(PACKAGES)) as pool:
        futures = {pkg: pool.submit(program, pkg, *args)
                   for pkg in PACKAGES}
        return {pkg: f.result() for pkg, f in futures.items()}


# ---- the programs of tests/test_train.py ----

def _single_worker_report(pkg):
    def train_fn(config):
        session = importlib.import_module(pkg + ".air.session")
        for i in range(3):
            session.report({"step": i, "loss": 1.0 / (i + 1)})

    r = _fit(pkg, train_fn)
    return r.error, r.metrics, r.metrics_history


def test_single_worker_report(clusters):
    got = _both(_single_worker_report)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    error, metrics, history = got["ray_tpu_torch"]
    assert error is None and metrics["step"] == 2 and len(history) == 3


@functools.lru_cache(maxsize=None)
def _two_workers():
    """One 2-worker gang on each runtime, reading ``train_loop_config``,
    the ranks, and the gang's reduction: the port's gloo group
    all-reduces rank + 1 where JAX's two-process island takes the mean
    of a global array whose rows hold rank + 1 (tests/test_train.py's
    island program). Two tests read it."""
    return _both(_two_worker_program)


def _two_worker_program(pkg):
    if pkg == "ray_tpu":
        def reduce_mean(session):
            import jax
            from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
            world, rank = session.get_world_size(), session.get_world_rank()
            n_local = len(jax.local_devices())
            mesh = Mesh(np.array(jax.devices()), ("dp",))
            local = np.full((n_local, 4), rank + 1, np.float32)
            arr = jax.make_array_from_process_local_data(
                NamedSharding(mesh, P("dp")), local, (n_local * world, 4))
            return {"mean": float(jax.jit(lambda x: x.mean())(arr)),
                    "group_size": jax.process_count()}
    else:
        def reduce_mean(session):
            import torch
            import torch.distributed as dist
            local = torch.full((4,), float(session.get_world_rank() + 1))
            dist.all_reduce(local)
            return {"mean": float(local.mean()) / session.get_world_size(),
                    "group_size": dist.get_world_size(),
                    "backend": dist.get_backend(),
                    "group_rank": dist.get_rank()}

    def train_fn(config):
        session = importlib.import_module(pkg + ".air.session")
        session.report({"rank": session.get_world_rank(),
                        "world": session.get_world_size(),
                        "local": session.get_local_rank(),
                        "node": session.get_node_rank(),
                        "mult": config["x"] * 2, **reduce_mean(session)})

    r = _fit(pkg, train_fn, num_workers=2, train_loop_config={"x": 21})
    return r.error, r.metrics, r.metrics_history


def test_train_loop_config_and_ranks(clusters):
    keys = ("rank", "world", "local", "node", "mult")
    got = {pkg: (error, {k: metrics[k] for k in keys},
                 [{k: m[k] for k in keys} for m in history])
           for pkg, (error, metrics, history) in _two_workers().items()}
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    error, metrics, _ = got["ray_tpu_torch"]
    assert error is None
    assert metrics == {"rank": 0, "world": 2, "local": 0, "node": 0,
                       "mult": 42}


def _checkpoint_resume(pkg):
    def train_fn(config):
        session = importlib.import_module(pkg + ".air.session")
        air = importlib.import_module(pkg + ".air")
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for i in range(start, start + 2):
            session.report({"step": i},
                           checkpoint=air.Checkpoint.from_dict({"step": i}))

    r1 = _fit(pkg, train_fn)
    r2 = _fit(pkg, train_fn, resume_from_checkpoint=r1.checkpoint)
    return (r1.metrics, r1.checkpoint.to_dict(), r2.metrics,
            r2.checkpoint.to_dict(), r2.metrics_history)


def test_checkpoint_resume(clusters):
    got = _both(_checkpoint_resume)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"][2] == {"step": 3}


def _failure_restart(pkg):
    def train_fn(config):
        session = importlib.import_module(pkg + ".air.session")
        air = importlib.import_module(pkg + ".air")
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for i in range(start, 4):
            session.report({"step": i},
                           checkpoint=air.Checkpoint.from_dict({"step": i}))
            if i == 1 and ckpt is None:
                raise RuntimeError("injected failure at step 1")

    cfg = _mod(pkg, ".air.config")
    r = _fit(pkg, train_fn, run_config=cfg.RunConfig(
        failure_config=cfg.FailureConfig(max_failures=1)))
    return r.error, r.metrics, r.metrics_history, r.checkpoint.to_dict()


def test_failure_restarts_from_checkpoint(clusters):
    got = _both(_failure_restart)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    error, metrics, history, _ = got["ray_tpu_torch"]
    assert error is None and metrics["step"] == 3
    # the restarted attempt resumed after step 1
    assert [m["step"] for m in history] == [2, 3]


def _durable_root(pkg, root):
    """tests/test_checkpoint_engine.py's gang restart: checkpoints go
    through session.report -> the manager's staging -> the driver's
    commit after each round; the worker dies leaving a half-staged step,
    the gang restarts from the last committed one, and a second fit()
    with the same run identity resumes from latest_committed()."""
    def train_fn(config):
        session = importlib.import_module(pkg + ".air.session")
        air = importlib.import_module(pkg + ".air")
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["i"] + 1 if ckpt else 0
        for i in range(start, 5):
            session.report({"i": i},
                           checkpoint=air.Checkpoint.from_dict({"i": i}))
            if i == 2 and start == 0:
                mgr = session.get_checkpoint_manager()
                tmp = mgr.begin_step(session.next_checkpoint_step())
                with open(os.path.join(tmp, "half.npy"), "wb") as f:
                    f.write(b"\x00" * 64)
                raise RuntimeError("preempted mid-save")

    cfg = _mod(pkg, ".air.config")
    ckpt_mod = _mod(pkg, ".checkpoint")
    name = "gang_restart_ckpt"
    root = os.path.join(root, pkg)
    r1 = _fit(pkg, train_fn, run_config=cfg.RunConfig(
        name=name, storage_path=root,
        failure_config=cfg.FailureConfig(max_failures=1)))
    mgr = ckpt_mod.CheckpointManager(os.path.join(root, name, "checkpoints"))
    latest = mgr.latest_committed()
    r2 = _fit(pkg, train_fn, run_config=cfg.RunConfig(name=name,
                                                        storage_path=root))
    return {"error": r1.error, "metrics": r1.metrics,
            "history": r1.metrics_history, "latest": latest,
            "committed": mgr.committed_steps(),
            "loaded": mgr.load(latest).to_dict(),
            "result_ckpt": r1.checkpoint.to_dict(),
            "result_dir": os.path.basename(r1.checkpoint._dir),
            "second_error": r2.error, "second_history": r2.metrics_history,
            "second_ckpt": r2.checkpoint.to_dict(),
            "files": sorted(os.listdir(os.path.join(root, name,
                                                    "checkpoints")))}


def test_durable_root_resumes_from_latest_committed(clusters, tmp_path):
    got = _both(_durable_root, str(tmp_path))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    port = got["ray_tpu_torch"]
    assert port["error"] is None and port["metrics"] == {"i": 4}
    assert port["loaded"] == port["result_ckpt"] == {"i": 4}
    # the fresh fit found its train_fn had nothing left to do
    assert port["second_error"] is None and port["second_history"] == []
    assert port["second_ckpt"] == {"i": 4}


def test_two_worker_allreduce_matches_jax_island(clusters):
    """Two port workers joined over gloo (TorchConfig's default without
    GPUs): the all-reduced mean of rank + 1 equals the mean JAX's
    two-process island computes over the same rows."""
    got = _two_workers()
    (perr, port, _), (jerr, jax_side, _) = (got["ray_tpu_torch"],
                                            got["ray_tpu"])
    assert perr is None and jerr is None, (perr, jerr)
    assert port["group_size"] == jax_side["group_size"] == 2
    assert port["mean"] == jax_side["mean"] == 1.5
    assert port["backend"] == "gloo" and port["group_rank"] == 0


def _async_through_session(pkg, root):
    """tests/test_checkpoint_engine.py's async program: the train_func
    saves sharded state through the session's AsyncCheckpointer (on the
    port also reached as ``spmd.make_async_checkpointer()`` without a
    manager) and the driver commits each step after the round barrier;
    once step 2 is committed, the train_func restores it through the
    session's manager (on the port by ``spmd.restore_spmd_state(target)``
    with no source)."""
    def train_fn(config):
        import time as _t
        import numpy as _np
        session = importlib.import_module(pkg + ".air.session")
        ckpter = session.get_async_checkpointer()
        if pkg == "ray_tpu_torch":
            from ray_tpu_torch.train import spmd
            assert spmd.make_async_checkpointer() is ckpter
        for i in range(3):
            state = {"w": _np.full(64, float(i), _np.float32)}
            pending = ckpter.save(session.next_checkpoint_step(), state)
            session.report({"i": i}, checkpoint=pending)
        ckpter.finalize()
        mgr = session.get_checkpoint_manager()
        t_end = _t.monotonic() + 60
        while mgr.latest_committed() != 2 and _t.monotonic() < t_end:
            _t.sleep(0.02)
        target = {"w": _np.zeros(64, _np.float32)}
        if pkg == "ray_tpu_torch":
            got = spmd.restore_spmd_state(target)
        else:
            # what JAX's spmd.restore_spmd_state does with no arguments
            # (its module imports JAX, which this worker need not load)
            got = mgr.restore_state(target)
        session.report({"w": _np.asarray(got["w"]).tolist(),
                        "next_step": session.next_checkpoint_step()})

    cfg = _mod(pkg, ".air.config")
    ckpt_mod = _mod(pkg, ".checkpoint")
    root = os.path.join(root, pkg)
    r = _fit(pkg, train_fn, run_config=cfg.RunConfig(
        name="async_session_ckpt", storage_path=root))
    mgr = ckpt_mod.CheckpointManager(
        os.path.join(root, "async_session_ckpt", "checkpoints"))
    return {"error": r.error, "history": r.metrics_history,
            "latest": mgr.latest_committed(),
            "result_dir": os.path.basename(r.checkpoint._dir)}


def test_async_checkpointer_through_session(clusters, tmp_path):
    got = _both(_async_through_session, str(tmp_path))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    port = got["ray_tpu_torch"]
    assert port["error"] is None and port["latest"] == 2
    assert port["result_dir"].endswith("00000002")
    assert port["history"][-1] == {"w": [2.0] * 64, "next_step": 3}


def _ddp_data(rank):
    torch.manual_seed(rank)  # different data per worker
    x = torch.randn(16, 4)
    return x, x.sum(dim=1, keepdim=True)


def test_torch_trainer_ddp(clusters):
    """tests/test_air_extras.py's TorchTrainer program on the port: 2
    workers, a DDP-wrapped linear layer (``prepare_model``) over the
    backend's gloo group, each rank on its own data, 3 SGD steps. Both
    ranks end with the same weights, equal within 1e-6 to the same
    steps taken here on the mean of the two ranks' gradients (what DDP's
    all-reduce gives; the JAX package's TorchTrainer is this same torch
    program, so the reference is plain torch)."""
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    def train_fn(config):
        import torch
        import torch.distributed as dist
        import torch.nn as nn
        from ray_tpu_torch import train
        torch.manual_seed(0)
        model = train.prepare_model(nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        rank = dist.get_rank()
        x, y = config["data"][rank]
        for _ in range(3):
            opt.zero_grad()
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
        w = torch.cat([p.detach().ravel() for p in model.parameters()])
        gathered = [torch.zeros_like(w) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, w)
        train.report({"loss": float(loss.detach()), "rank": rank,
                      "ddp": type(model).__name__,
                      "weights": [g.tolist() for g in gathered]})

    data = [_ddp_data(r) for r in range(2)]
    result = TorchTrainer(
        train_fn, train_loop_config={"data": data},
        scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.error is None, result.error
    got = result.metrics
    assert got["ddp"] == "DistributedDataParallel" and got["rank"] == 0
    assert got["weights"][0] == got["weights"][1]

    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for _ in range(3):
        grads = []
        for x, y in data:
            model.zero_grad()
            ((model(x) - y) ** 2).mean().backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
    want = torch.cat([p.detach().ravel() for p in model.parameters()])
    np.testing.assert_allclose(got["weights"][0], want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert got["loss"] < 10.0


# ---- a preemption notice reaches the train_func thread ----

def _preemption(pkg, tmp):
    addr_file = os.path.join(tmp, f"{pkg}.addr")

    def train_fn(config):
        import time as _t
        session = importlib.import_module(pkg + ".air.session")
        worker = importlib.import_module(pkg + "._private.worker")
        before = (session.preempted(), session.preemption_deadline())
        with open(addr_file + ".tmp", "w") as f:
            f.write(worker.global_worker().address)
        os.rename(addr_file + ".tmp", addr_file)
        t_end = _t.monotonic() + 60
        while not session.preempted() and _t.monotonic() < t_end:
            _t.sleep(0.02)
        session.report({"before": list(before),
                        "preempted": session.preempted(),
                        "deadline": session.preemption_deadline(),
                        "thread": __import__("threading")
                        .current_thread().name})

    deadline = 1.9e9 + (1.0 if pkg == "ray_tpu" else 2.0)

    def deliver():
        t_end = time.monotonic() + 60
        while not os.path.exists(addr_file) and time.monotonic() < t_end:
            time.sleep(0.02)
        with open(addr_file) as f:
            address = f.read()
        w = _mod(pkg, "._private.worker").global_worker()
        conn = w.io.run(w._peer(address))
        w.io.run(conn.notify("preemption_notice",
                             {"deadline_unix": deadline, "grace_s": 30.0}))

    sender = threading.Thread(target=deliver, daemon=True)
    sender.start()
    r = _fit(pkg, train_fn)
    sender.join(timeout=60)
    assert r.error is None, r.error
    return r.metrics, deadline


def test_preemption_notice_reaches_train_thread(clusters, tmp_path):
    """The notice goes over the wire to the TrainWorker's process (its
    core worker's handler), and the train_func, on its own thread,
    sees ``preempted()`` flip and the deadline sent."""
    for pkg, (metrics, deadline) in _both(_preemption,
                                          str(tmp_path)).items():
        assert metrics == {"before": [False, None], "preempted": True,
                           "deadline": deadline, "thread": "train_func"}, pkg


# ---- GPT-2 tiny on a 2-worker gang, fed by the Dataset ----

def _gpt2_cfgs():
    """GPT-2 tiny in f32 on both sides (plain attention)."""
    import jax.numpy as jnp
    from ray_tpu.models import gpt2 as JG
    from ray_tpu_torch.models import gpt2 as TG
    return (dataclasses.replace(JG.GPT2Config.tiny(), dtype=jnp.float32),
            dataclasses.replace(TG.GPT2Config.tiny(), dtype=torch.float32))


def _jax_trainer(cj):
    """The JAX trainer on one device and its initial state."""
    import jax
    from ray_tpu.parallel import mesh as JM
    from ray_tpu.train import spmd as JS
    mesh = JM.MeshSpec().build(jax.devices("cpu")[:1])
    tr = JS.make_causal_lm_trainer(cj, mesh=mesh, spec=JM.MeshSpec())
    return tr, tr.init(jax.random.PRNGKey(0))


def _jax_one_device_step(tr, state, tokens):
    """One JAX step on the global batch: its metrics and params after."""
    import jax
    from ray_tpu.train import spmd as JS
    state, m = tr.step(state, JS.put_batch(tr, {"input_ids": tokens,
                                                "labels": tokens}))
    return {k: float(v) for k, v in m.items()}, jax.device_get(
        state["params"])


def _gang_train_fn():
    """The train_func, a closure so that it travels by value."""

    def train_fn(config):
        """Each rank: the trainer on MeshSpec(dp=2) over the gang's group,
        its split(2) shard's one batch, one step; the same rank's part of
        the global batch through iter_device_batches(trainer=) must be the
        shard's rows."""
        import numpy as np
        import torch
        from ray_tpu_torch.air import session
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.parallel import dryrun
        from ray_tpu_torch.parallel.mesh import MeshSpec
        from ray_tpu_torch.train import spmd

        torch.set_num_threads(1)
        tr = spmd.make_causal_lm_trainer(model=gpt2.GPT2(config["cfg"]),
                                         spec=MeshSpec(dp=2), device="cpu")
        state = tr.init(params={"params": config["params"]})
        n_local = config["global_batch"] // session.get_world_size()
        batches = list(session.get_dataset_shard("train").iter_device_batches(
            batch_size=n_local, device="cpu",
            dtypes={"input_ids": np.int64, "labels": np.int64}))
        via_trainer = list(config["full"].iter_device_batches(
            batch_size=config["global_batch"], trainer=tr))
        same = (len(batches) == len(via_trainer) == 1
                and all(torch.equal(batches[0][k], via_trainer[0][k])
                        and batches[0][k].dtype == torch.int64
                        for k in ("input_ids", "labels")))
        state, m = tr.step(state, batches[0])
        out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "rows": batches[0]["input_ids"][:, 0].tolist(),
               "same_as_trainer_split": same}
        gathered = dryrun._numpy(spmd.gather_state(state))
        if session.get_world_rank() == 0:
            out["model"] = gathered["model"]
            out["exp_avg"] = {n: st["exp_avg"]
                              for n, st in gathered["opt"].items()}
        session.report(out)

    return train_fn


def test_gang_gpt2_step_matches_jax_one_device(clusters):
    """Loss and grad_norm within 1e-5 relative and the params within
    3e-5 of the JAX step (tests/test_torch_mesh.py's tolerances against
    JAX), except entries whose first-step |grad| is at most 1e-6 (by
    AdamW's first moment, 0.1 g), held to 2 lr: AdamW moves those by up
    to lr on the sums' rounding (the key bias, whose true gradient is
    0)."""
    import jax
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.models import gpt2 as TG
    from ray_tpu_torch import data
    from ray_tpu_torch.train import DataParallelTrainer

    cj, ct = _gpt2_cfgs()
    tokens = np.random.default_rng(0).integers(0, cj.vocab_size, (4, 128),
                                               dtype=np.int32)
    jtr, jstate = _jax_trainer(cj)
    params = jax.device_get(jstate["params"])
    ds = data.from_numpy({"input_ids": tokens, "labels": tokens})
    trainer = DataParallelTrainer(
        _gang_train_fn(),
        train_loop_config={"cfg": ct, "params": params, "global_batch": 4,
                           "full": ds},
        datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=2))
    # the gang trains while the JAX step compiles
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fit = pool.submit(trainer.fit)
        jax_metrics, jax_after = _jax_one_device_step(jtr, jstate, tokens)
        result = fit.result()
    assert result.error is None, result.error
    got = result.metrics
    assert got["rows"] == tokens[:2, 0].tolist()     # rank 0's shard
    assert got["same_as_trainer_split"] is True
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], jax_metrics[k], rtol=1e-5,
                                   err_msg=k)
    want = {k: v.numpy() for k, v in TG.params_from_flax(
        {"params": jax_after}).items()}
    assert set(got["model"]) == set(want)
    for name, ref in want.items():
        diff = np.abs(got["model"][name] - ref)
        g = got["exp_avg"][name] / 0.1
        held = (np.abs(g) > 1e-6) | (g == 0)
        assert diff[~held].max(initial=0) <= 2 * LR, name
        assert diff[held].max(initial=0) <= 3e-5, (name,
                                                   float(diff[held].max()))
