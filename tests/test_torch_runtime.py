"""The port's runtime against the JAX package's, on the CPU.

One cluster of each package for the whole module (``init(num_cpus=4)``,
four accelerators each: ``num_tpus=4`` on the JAX side, ``num_gpus=4``
faked on the port's). The same programs (put/get, tasks, chaining,
multiple returns, errors, ``wait``, actors, named actors,
``kill``, nested tasks, ``cluster_resources``) run on both and must give
equal results, exception class names included. So do the accelerator
schedules: placement-group bundles, a bundle a plain task cannot drain
and its return, an actor in a bundle, an actor queued behind another
until ``kill``, and tasks granted none; the port's GPU indices must be
the JAX runtime's TPU chips, and each worker's ``CUDA_VISIBLE_DEVICES``
(``TPU_VISIBLE_CHIPS`` on the JAX side) must list its grant. Port-only cases: torch
tensors cross the object store out of band and come back exact; a GPT-2
tiny trainer step in an actor is bit-equal to the same step in the
driver; every process the port spawns runs a ``ray_tpu_torch`` module;
the GCS's and the raylet's entry modules import no torch.
"""

import importlib
import os
import subprocess
import sys
from unittest import mock

import msgpack
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private import serialization

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_BYTES = 256 * 1024 * 1024


# the port's processes check every inbound RPC against its wire schema
# and start workers on demand, as conftest sets for the JAX package's
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}


@pytest.fixture(scope="module")
def clusters():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    # a module run before this one in the same process may have left a
    # cluster up
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    with mock.patch.dict(os.environ, PORT_ENV):
        ray_tpu.init(num_cpus=4, num_tpus=4, object_store_memory=STORE_BYTES)
        try:
            ray_tpu_torch.init(num_cpus=4, num_gpus=4,
                               object_store_memory=STORE_BYTES)
            try:
                yield {"jax": ray_tpu, "port": ray_tpu_torch}
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            torch.set_num_threads(old_threads)


# ---- what the tasks and actors run (pickled by value into workers) ----

def _double(x):
    return x * 2


def _three():
    return 1, 2, 3


def _boom(msg):
    raise ValueError(msg)


def _gated(path, x):
    import time
    while not os.path.exists(path):
        time.sleep(0.01)
    return x


def _fast(x):
    return x


def _nested(module, n):
    rt = importlib.import_module(module)
    return rt.get([rt.remote(_double).remote(i) for i in range(n)])


class _Counter:
    def __init__(self, start):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def fail(self):
        raise KeyError("no such key")


def _exc_names(e):
    return [c.__name__ for c in type(e).__mro__
            if c.__name__ not in ("object", "BaseException")]


# ---- the programs: each runs on one runtime module and returns a value
# that the two runtimes must give equally ----

def _put_get(rt):
    arrays = [np.arange(500_000, dtype=np.float64),
              np.arange(24, dtype=np.int32).reshape(2, 3, 4),
              np.zeros((0, 3), np.float32), np.array(True)]
    got = [rt.get(rt.put(a)) for a in arrays]
    return [(g.dtype.str, g.shape, g.tobytes()) for g in got] + [
        rt.get(rt.put({"a": [1, 2, 3], "b": "x"}))]


def _tasks_and_chaining(rt):
    f = rt.remote(_double)
    ref = f.remote(1)
    for _ in range(4):
        ref = f.remote(ref)
    big = rt.get(f.remote(np.ones(300_000, np.float32)))
    return rt.get(ref), big.shape, float(big.sum())


def _multiple_returns(rt):
    return rt.get(list(rt.remote(num_returns=3)(_three).remote()))


def _error(rt):
    try:
        rt.get(rt.remote(_boom).remote("bad input"))
    except Exception as e:   # the class is what is compared
        task_err = (_exc_names(e), isinstance(e, ValueError),
                    "bad input" in str(e))
    c = rt.remote(_Counter).remote(0)
    try:
        rt.get(c.fail.remote())
    except Exception as e:
        actor_err = (_exc_names(e), isinstance(e, KeyError))
    return task_err, actor_err


def _wait(rt, tmp_path):
    """``wait`` returns the ready refs in submission order, the slow
    ones (held until a file appears) after."""
    gate = str(tmp_path / f"gate-{rt.__name__}")
    # the held tasks go through the raylet (SPREAD is never leased), so
    # no fast task queues behind one on a leased worker
    slow = rt.remote(scheduling_strategy="SPREAD")(_gated)
    fast = rt.remote(_fast)
    refs = [slow.remote(gate, 0), fast.remote(1), slow.remote(gate, 2),
            fast.remote(3)]
    ready, rest = rt.wait(refs, num_returns=2, timeout=60)
    none_ready = rt.wait(rest, num_returns=1, timeout=0)
    open(gate, "w").close()
    return ([refs.index(r) for r in ready], rt.get(ready),
            [len(x) for x in none_ready], rt.get(rest, timeout=60))


def _actor_state(rt):
    c = rt.remote(_Counter).remote(10)
    out = [rt.get(c.incr.remote()) for _ in range(3)]
    refs = [c.incr.remote(by=i) for i in range(5)]
    return out, rt.get(refs)


def _named_actor(rt):
    rt.remote(_Counter).options(name="counter-a").remote(5)
    h = rt.get_actor("counter-a")
    first = rt.get(h.incr.remote())
    second = rt.get(rt.get_actor("counter-a").incr.remote())
    try:
        rt.get_actor("no-such-actor")
    except Exception as e:
        missing = type(e).__name__
    rt.kill(h)
    return first, second, missing


def _kill(rt):
    c = rt.remote(_Counter).remote(0)
    rt.get(c.incr.remote())
    rt.kill(c)
    try:
        rt.get(c.incr.remote(), timeout=60)
    except Exception as e:
        return _exc_names(e)


def _nested_tasks(rt):
    return rt.get(rt.remote(_nested).remote(rt.__name__, 5))


def _resources(rt):
    res = rt.cluster_resources()
    res = {("ACCEL" if k in ("TPU", "GPU") else k): v for k, v in res.items()}
    return sorted(res), res["CPU"], res["ACCEL"]


# ---- the accelerator schedules: the port's GPUs against JAX's TPUs ----

def _accel(rt):
    """The resource a runtime grants by index, and its option."""
    return ("TPU", "num_tpus") if rt is ray_tpu else ("GPU", "num_gpus")


def _report(module):
    """The calling task's or actor's grant, and whether its worker's
    visible-device variable lists exactly that grant."""
    rt = importlib.import_module(module)
    if module == "ray_tpu":
        ids, var = rt.get_tpu_ids(), "TPU_VISIBLE_CHIPS"
    else:
        ids, var = rt.get_gpu_ids(), "CUDA_VISIBLE_DEVICES"
    return list(ids), os.environ.get(var, "") == ",".join(map(str, ids))


class _Holder:
    def __init__(self, module):
        self.module = module

    def report(self):
        return _report(self.module)


def _pg(rt, per_bundle):
    acc, _ = _accel(rt)
    mod = importlib.import_module(rt.__name__ + ".util.placement_group")
    pg = mod.placement_group([{"CPU": 1, acc: n} for n in per_bundle])
    assert pg.ready(timeout=60)
    return pg, mod.remove_placement_group


def _on(rt, n, pg=None, index=0):
    """``rt.remote`` options for ``n`` accelerators, in bundle ``index``
    of ``pg`` when one is given."""
    opts = {_accel(rt)[1]: n}
    if pg is not None:
        ss = importlib.import_module(
            rt.__name__ + ".util.scheduling_strategies")
        opts.update(num_cpus=0.5,
                    scheduling_strategy=ss.PlacementGroupSchedulingStrategy(
                        pg, placement_group_bundle_index=index))
    return opts


def _two_bundles(rt):
    """Two 2-accelerator bundles get disjoint halves of the four."""
    pgs = [_pg(rt, [2]) for _ in range(2)]
    grants = [rt.get(rt.remote(**_on(rt, 2, pg))(_report).remote(
        rt.__name__), timeout=60) for pg, _ in pgs]
    for pg, remove in pgs:
        remove(pg)
    return grants


def _bundle_not_drained(rt):
    """A plain task cannot take a bundle's accelerators; removing the
    group returns them and the task runs."""
    pg, remove = _pg(rt, [4])
    outsider = rt.remote(num_cpus=0.5, **_on(rt, 1))(_report).remote(
        rt.__name__)
    ready, _ = rt.wait([outsider], num_returns=1, timeout=1.0)
    inside = rt.get(rt.remote(**_on(rt, 4, pg))(_report).remote(
        rt.__name__), timeout=60)
    remove(pg)
    return len(ready), inside, rt.get(outsider, timeout=60)


def _actor_in_bundle(rt):
    pg, remove = _pg(rt, [1, 3])
    actor = rt.remote(**_on(rt, 3, pg, index=1))(_Holder).remote(
        rt.__name__)
    grant = rt.get(actor.report.remote(), timeout=60)
    rt.kill(actor)
    remove(pg)
    return grant


def _queued_actor_after_kill(rt):
    """An actor holding all four keeps a second one queued (its first
    call unanswered, none available); ``kill`` of the first hands the
    second the same four."""
    acc, _ = _accel(rt)
    first = rt.remote(**_on(rt, 4))(_Holder).remote(rt.__name__)
    held = rt.get(first.report.remote(), timeout=60)
    second = rt.remote(**_on(rt, 4))(_Holder).remote(rt.__name__)
    pending = second.report.remote()
    ready, _ = rt.wait([pending], num_returns=1, timeout=1.0)
    free = rt.available_resources().get(acc, 0.0)
    rt.kill(first)
    after = rt.get(pending, timeout=60)
    rt.kill(second)
    return held, len(ready), free, after


def _none_granted(rt):
    """A task, an actor and a fractional demand take no index: the
    whole-device rule, ``int(demand)``."""
    plain = rt.get(rt.remote(_report).remote(rt.__name__), timeout=60)
    actor = rt.remote(_Holder).remote(rt.__name__)
    held = rt.get(actor.report.remote(), timeout=60)
    rt.kill(actor)
    half = rt.get(rt.remote(**_on(rt, 0.5))(_report).remote(rt.__name__),
                  timeout=60)
    return plain, held, half


PROGRAMS = [_put_get, _tasks_and_chaining, _multiple_returns, _error,
            _wait, _actor_state, _named_actor, _kill, _nested_tasks,
            _resources, _two_bundles, _bundle_not_drained, _actor_in_bundle,
            _queued_actor_after_kill, _none_granted]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__[1:])
def test_same_program_same_result(clusters, program, tmp_path):
    args = (tmp_path,) if program is _wait else ()
    ref = program(clusters["jax"], *args)
    got = program(clusters["port"], *args)
    assert got == ref
    if program is _kill:
        assert "ActorDiedError" in got
    if program is _two_bundles:
        assert sorted(got[0][0] + got[1][0]) == [0, 1, 2, 3]
    if program is _bundle_not_drained:
        assert got[0] == 0
    if program is _queued_actor_after_kill:
        assert got == (([0, 1, 2, 3], True), 0, 0.0, ([0, 1, 2, 3], True))
    if program is _none_granted:
        assert got == (([], True),) * 3


# ---- port only: torch tensors ----

def _tensors():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(64, 96, generator=g)
    return {"f32": base, "bf16": base.to(torch.bfloat16),
            "view": base.t()[::2, 1:],         # non-contiguous
            "i64": torch.arange(5000), "empty": torch.zeros(0, 4),
            "scalar": torch.tensor(3.5)}


@pytest.mark.parametrize("name", list(_tensors()))
def test_tensor_round_trip_exact(clusters, name):
    t = _tensors()[name]
    ref = ray_tpu_torch.put(t)
    back = ray_tpu_torch.get(ref)
    assert back.dtype == t.dtype and back.shape == t.shape
    assert back.device.type == "cpu"
    assert torch.equal(back, t)
    # through a worker and back: the task doubles it
    twice = ray_tpu_torch.get(ray_tpu_torch.remote(_double).remote(ref))
    assert torch.equal(twice, t * 2)
    # a reader's in-place write touches its own copy only
    back.zero_() if back.numel() else None
    assert torch.equal(ray_tpu_torch.get(ref), t)


def test_tensor_bytes_cross_out_of_band():
    """A tensor's bytes leave the pickle stream as one out-of-band
    buffer (no in-band ``torch.save`` storage); small ones stay in band."""
    t = _tensors()["bf16"]
    ser = serialization.serialize(t)
    header = msgpack.unpackb(ser.header, raw=False)
    assert [n for _, n in header["buffers"]] == [t.numel() * 2]
    assert header["pickle"] < 1024
    small = serialization.serialize(torch.ones(3))
    assert msgpack.unpackb(small.header, raw=False)["buffers"] == []
    p = torch.nn.Parameter(torch.ones(400, 2))
    back = serialization.deserialize(serialization.serialize(p).to_bytes())
    assert isinstance(back, torch.nn.Parameter) and back.requires_grad
    assert torch.equal(back, p)


def test_cuda_tensor_refused_without_gpu():
    """A CUDA tensor is rebuilt on the reader's GPU; a reader with none
    is told so, not handed a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("this process sees a GPU")
    raw = np.zeros(8, np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serialization._rebuild_tensor("float32", (2,), "cuda",
                                      memoryview(raw), False, False)


# ---- port only: a trainer step in an actor ----

class _TrainerActor:
    def __init__(self, seed):
        import torch
        torch.set_num_threads(2)
        from ray_tpu_torch.models.gpt2 import GPT2Config
        from ray_tpu_torch.train import spmd
        self.spmd = spmd
        self.tr = spmd.make_causal_lm_trainer(GPT2Config.tiny(),
                                              device="cpu")
        self.state = self.tr.init(seed=seed)

    def step(self, tokens):
        batch = self.spmd.put_batch(self.tr, {"input_ids": tokens,
                                              "labels": tokens})
        _, m = self.tr.step(self.state, batch)
        return ({k: float(v) for k, v in m.items()},
                self.spmd.gather_state(self.state)["model"])


def test_gpt2_step_in_actor_bit_equal(clusters):
    tokens = np.random.default_rng(5).integers(0, 512, (2, 64))
    actor = ray_tpu_torch.remote(_TrainerActor).remote(3)
    remote = ray_tpu_torch.get([actor.step.remote(tokens) for _ in range(2)])
    local = _TrainerActor(3)
    here = [local.step(tokens) for _ in range(2)]
    for (rm, rp), (hm, hp) in zip(remote, here):
        assert rm == hm
        assert rp.keys() == hp.keys()
        for k in hp:
            assert torch.equal(rp[k], hp[k]), k
    assert remote[1][0]["loss"] < remote[0][0]["loss"]


# ---- port only: processes ----

def _cmdline(pid):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().split(b"\0")


def _worker_pid():
    return os.getpid()


def test_spawned_processes_run_port_modules(clusters):
    procs = ray_tpu_torch._node_processes
    gcs = _cmdline(procs.gcs_proc.pid)
    raylet = _cmdline(procs.raylet_proc.pid)
    assert b"ray_tpu_torch._private.gcs_main" in gcs
    assert b"ray_tpu_torch._private.raylet_main" in raylet
    pids = set(ray_tpu_torch.get(
        [ray_tpu_torch.remote(_worker_pid).remote() for _ in range(4)]))
    for pid in pids:
        assert b"ray_tpu_torch._private.default_worker" in _cmdline(pid)
    # every child of the raylet is a port worker
    children = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            if ppid == procs.raylet_proc.pid:
                children.append(int(d))
    assert children
    for pid in children:
        assert b"ray_tpu_torch._private.default_worker" in _cmdline(pid)


def test_gcs_and_raylet_modules_import_no_torch():
    code = ("import sys; import ray_tpu_torch._private.gcs_main, "
            "ray_tpu_torch._private.raylet_main; "
            "print('torch' in sys.modules, 'jax' in sys.modules, "
            "'ray_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["False", "False", "False"]
