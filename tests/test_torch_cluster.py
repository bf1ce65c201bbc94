"""The port's multi-node test cluster and its test doubles against the
JAX package's, on the CPU; and the owner's release of a dead borrower's
refs.

One ``Cluster`` of each package for the module: a head and one added
node (a custom ``node2`` resource; the port's added node also has
``num_gpus=1``, a fake count on this box, and its head ``num_gpus=0``).
The same programs run on both: a task with the custom resource lands on
the added node, an object made there reads on the head with the same
bytes, and ``remove_node`` of a third node kills the actor on it. The
port's head store is 1 GiB for the dead-borrower checks (ROADMAP C6):
five ``BatchPredictor.predict`` calls over a 200 MB checkpoint, each of
whose pool actors borrows the checkpoint and is killed, leave the store
as they found it, and a plain actor killed while it borrows a ref lets
its owner free the object within ``FREE_S``. The JAX package keeps a
dead borrower forever, so there the object leaks (not asserted here).
The module's last test shuts the port cluster down and finds none of
its processes or store segments left.

Functions that workers run are defined inside the tests (cloudpickle
ships them by value) and reach only their own package. Every ``get``
has a time limit.
"""

import asyncio
import concurrent.futures
import gc
import importlib
import os
import time
from unittest import mock

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

PACKAGES = ("ray_tpu", "ray_tpu_torch")
PORT_STORE = 1 << 30               # the C6 repro's store
JAX_STORE = 128 * 1024 * 1024
TIMEOUT_S = 60
FREE_S = 5.0                       # a killed borrower's object is freed
OBJ_BYTES = 4 * 1024 * 1024        # over the inline limit: plasma, pulled
CKPT_BYTES = 200 * 1000 * 1000


def _within(fn, *args, timeout=TIMEOUT_S):
    """``fn(*args)`` on a helper thread: its result, or TimeoutError
    after ``timeout`` seconds (a hang fails the test, not the run)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args).result(timeout=timeout)
    finally:
        pool.shutdown(wait=False)


def _each(fn, args_of, timeout=TIMEOUT_S):
    """{pkg: fn(*args_of(pkg))}, both packages at once (each has its own
    driver)."""
    pool = concurrent.futures.ThreadPoolExecutor(len(PACKAGES))
    try:
        futs = {pkg: pool.submit(fn, *args_of(pkg)) for pkg in PACKAGES}
        return {pkg: f.result(timeout=timeout) for pkg, f in futs.items()}
    finally:
        pool.shutdown(wait=False)


def _cluster_cls(pkg):
    return importlib.import_module(pkg + "._private.cluster_utils").Cluster


@pytest.fixture(scope="module")
def clusters():
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    made = {}
    heads = {"ray_tpu": {"num_cpus": 2, "resources": {"head": 1},
                         "object_store_memory": JAX_STORE},
             "ray_tpu_torch": {"num_cpus": 2, "num_gpus": 0,
                               "resources": {"head": 1},
                               "object_store_memory": PORT_STORE}}
    added = {"ray_tpu": {"num_cpus": 2, "resources": {"node2": 1},
                         "object_store_memory": JAX_STORE},
             "ray_tpu_torch": {"num_cpus": 2, "num_gpus": 1,
                               "resources": {"node2": 1}}}

    def start(pkg):
        c = made[pkg] = _cluster_cls(pkg)(head_node_args=heads[pkg])
        node = c.add_node(**added[pkg])
        c.connect()
        c.wait_for_nodes()
        return c, node

    with mock.patch.dict(os.environ, {"RTT_PRESTART_WORKERS": "0",
                                      "RTPU_PRESTART_WORKERS": "0"}):
        try:
            yield _each(start, lambda pkg: (pkg,))
        finally:
            for c in made.values():
                c.shutdown()


def _placed_on_added_node(pkg):
    rt = importlib.import_module(pkg)

    @rt.remote(resources={"node2": 1})
    def where():
        return rt.get_runtime_context().get_node_id()

    return rt.get(where.remote(), timeout=TIMEOUT_S)


def test_custom_resource_task_lands_on_added_node(clusters):
    got = _each(_placed_on_added_node, lambda pkg: (pkg,))
    for pkg in PACKAGES:
        assert got[pkg] == clusters[pkg][1]["node_id"], pkg


def _made_on_added_node(pkg):
    rt = importlib.import_module(pkg)

    @rt.remote(resources={"node2": 1})
    def make(n, seed):
        import numpy
        return numpy.random.default_rng(seed).integers(
            0, 256, n, dtype=numpy.uint8)

    return rt.get(make.remote(OBJ_BYTES, 7), timeout=TIMEOUT_S)


def test_object_made_on_added_node_reads_on_head(clusters):
    want = np.random.default_rng(7).integers(0, 256, OBJ_BYTES,
                                             dtype=np.uint8)
    got = _each(_made_on_added_node, lambda pkg: (pkg,))
    assert got["ray_tpu"].tobytes() == want.tobytes()
    assert got["ray_tpu_torch"].tobytes() == got["ray_tpu"].tobytes()


def test_gpu_node_grants_index_zero(clusters):
    """The added node's ``num_gpus=1`` grants index 0; the head's
    ``num_gpus=0`` advertises none."""
    rt = ray_tpu_torch
    _, node = clusters["ray_tpu_torch"]

    @rt.remote(num_gpus=1)
    def grant():
        return (rt.get_runtime_context().get_node_id(), rt.get_gpu_ids(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    assert _within(lambda: rt.get(grant.remote(), timeout=TIMEOUT_S)) == \
        (node["node_id"], [0], "0")
    gpus = {n["node_id"]: n["resources"].get("GPU", 0.0)
            for n in rt.nodes() if n["alive"]}
    assert gpus[node["node_id"]] == 1.0 and sum(gpus.values()) == 1.0


def _remove_node_kills_actor(pkg, cluster):
    rt = importlib.import_module(pkg)
    exc = importlib.import_module(pkg + ".exceptions")
    doomed = cluster.add_node(num_cpus=1, resources={"doomed": 1})
    cluster.wait_for_nodes()

    @rt.remote(resources={"doomed": 1})
    class Where:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    a = Where.remote()
    on = rt.get(a.node.remote(), timeout=TIMEOUT_S)
    cluster.remove_node(doomed)
    try:
        rt.get(a.node.remote(), timeout=TIMEOUT_S)
    except exc.ActorDiedError as e:
        return on == doomed["node_id"], type(e).__name__
    return on == doomed["node_id"], "no error"


def test_remove_node_kills_its_actor(clusters):
    got = _each(_remove_node_kills_actor,
                lambda pkg: (pkg, clusters[pkg][0]))
    assert got["ray_tpu_torch"] == got["ray_tpu"] == (True, "ActorDiedError")


def test_num_tpus_raises(clusters):
    pc, _ = clusters["ray_tpu_torch"]
    with pytest.raises(ValueError, match="num_gpus"):
        pc.add_node(num_cpus=1, num_tpus=1)
    with pytest.raises(ValueError, match="num_gpus"):
        _cluster_cls("ray_tpu_torch")(head_node_args={"num_tpus": 4})
    # the JAX package maps it to its TPU resource
    assert _cluster_cls("ray_tpu")._res({"num_tpus": 4}) == {"TPU": 4.0}


def _mock_script(pkg):
    """The same script against a package's test doubles: every reply,
    record and error as a comparable value."""
    mocks = importlib.import_module(pkg + "._private.testing")
    ids = importlib.import_module(pkg + ".common.ids")
    out = []

    def fail(payload):
        raise RuntimeError(f"scripted failure {payload}")

    conn = mocks.MockConnection({"echo": lambda p: {"got": p},
                                 "fixed": {"v": 1}, "fail": fail})
    loop = asyncio.new_event_loop()
    try:
        out.append(loop.run_until_complete(conn.call("echo", {"x": 1})))
        out.append(loop.run_until_complete(conn.call("fixed")))
        out.append(loop.run_until_complete(conn.call("missing", [1, 2])))
        try:
            loop.run_until_complete(conn.call("fail", 3))
        except RuntimeError as e:
            out.append(str(e))
        loop.run_until_complete(conn.notify("note", {"n": 2}))
    finally:
        loop.close()
    conn.close()
    out += [conn.calls, conn.notifications, conn.calls_to("echo"),
            conn._closed]
    store = mocks.MockStore(capacity=64)
    a, b = (ids.ObjectID(bytes([i]) * ids.ObjectID.SIZE) for i in (1, 2))
    store.put_bytes(a, b"0123456789")
    buf = store.get_buffer(a)
    out += [bytes(buf), store.get_buffer(b), store.contains(a),
            store.delete(a)]
    store.release(a)
    out += [store.delete(a), store.contains(a)]
    view = store.create(b, 60)
    try:
        store.create(ids.ObjectID(bytes([3]) * ids.ObjectID.SIZE), 8)
    except Exception as e:  # noqa: BLE001 — the store-full error
        out.append(type(e).__name__)
    view[:4] = b"abcd"
    out += [store.get_buffer(b), store.pin(b)]
    store.seal(b)
    out += [store.pin(b), store.used_bytes(), store.stats()]
    bare = mocks.make_bare(mocks.MockStore, _capacity=7)
    out += [bare.capacity(), hasattr(bare, "_objects")]
    return out


def test_mocks_reply_and_record_as_jax(clusters):
    got = {pkg: _mock_script(pkg) for pkg in PACKAGES}
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu"][3] == "scripted failure 3"


# ---- dead borrowers (ROADMAP C6) ----

def _used(w):
    return w.plasma.used_bytes()


def _wait_until(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_killed_borrower_releases_its_ref(clusters):
    """A plain actor borrows a ref (nested in a list, so it arrives as a
    ref), the owner drops its own, then kills the actor: the owner
    frees the object within FREE_S."""
    from ray_tpu_torch._private import worker as wmod
    rt = ray_tpu_torch
    w = wmod.global_worker()

    @rt.remote(resources={"head": 1})
    class Holder:
        def hold(self, refs):
            self.refs = refs
            return True

    h = Holder.remote()
    ref = rt.put(np.zeros(20 << 20, np.uint8))
    oid = ref.id()
    assert rt.get(h.hold.remote([ref]), timeout=TIMEOUT_S)
    assert _wait_until(
        lambda: w.reference_counter.table[oid]["borrowers"], 10.0)
    del ref
    gc.collect()
    w.reference_counter.drain_deferred()
    assert oid in w.reference_counter.table      # the borrower holds it
    before = _used(w)
    t0 = time.monotonic()
    rt.kill(h)
    freed = _wait_until(lambda: oid not in w.reference_counter.table,
                        FREE_S)
    took = time.monotonic() - t0
    assert freed, f"not freed {took:.1f} s after the borrower's kill"
    assert _wait_until(lambda: _used(w) <= before - (20 << 20), FREE_S)


def test_batch_predict_pool_actors_leave_the_store_clean(clusters):
    """ROADMAP C6's repro: five ``predict`` calls over a 200 MB
    checkpoint in a 1 GiB store. Each call puts the checkpoint once; its
    pool actor borrows it and is killed when the dataset is done."""
    from ray_tpu_torch._private import worker as wmod
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.air import BatchPredictor, Checkpoint, Predictor
    w = wmod.global_worker()

    class Scale(Predictor):
        def __init__(self, k):
            self.k = k

        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            return cls(float(checkpoint.to_dict()["w"][:4].sum()) + 2.0)

        def predict(self, batch):
            return {"predictions": np.asarray(batch["x"]) * self.k}

    ckpt = Checkpoint.from_dict({"w": np.zeros(CKPT_BYTES, np.uint8)})
    xs = np.arange(8, dtype=np.float64)
    gc.collect()
    w.reference_counter.drain_deferred()
    base = _used(w)

    def one():
        ds = rdata.from_numpy({"x": xs}, parallelism=2)
        rows = BatchPredictor.from_checkpoint(ckpt, Scale).predict(
            ds, batch_size=4, num_workers=1).take_all()
        return [float(r["predictions"]) for r in rows]

    for i in range(5):
        assert _within(one) == list(xs * 2.0), i
        gc.collect()
        w.reference_counter.drain_deferred()
        assert _wait_until(lambda: _used(w) < base + CKPT_BYTES // 2,
                           FREE_S), \
            f"call {i}: {_used(w) - base} B still in the store"


def test_shutdown_leaves_no_process(clusters):
    """Last in the module: the port cluster's shutdown leaves none of its
    processes (GCS, raylets, workers: they carry the session in their
    environment) and none of its store segments."""
    pc, _ = clusters["ray_tpu_torch"]
    want = f"RTT_SESSION_DIR={pc.session_dir}".encode()
    segments = [pc.head.store_path] + [n["store_path"]
                                       for n in pc.worker_nodes]

    def ours():
        pids = []
        for d in os.listdir("/proc"):
            if not d.isdigit():
                continue
            try:
                with open(f"/proc/{d}/environ", "rb") as f:
                    if want not in f.read().split(b"\0"):
                        continue
                with open(f"/proc/{d}/stat") as f:
                    if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                        continue
            except OSError:
                continue
            pids.append(int(d))
        return pids

    assert len(ours()) >= 3                      # GCS and two raylets
    _within(pc.shutdown)
    assert ours() == []
    assert [p for p in segments if os.path.exists(p)] == []
