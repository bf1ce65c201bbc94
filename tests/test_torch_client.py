"""The port's ``ray://`` client drivers against the JAX package's, on
the CPU.

Two server processes, started together for the module: each holds a
cluster of its package (``init(num_cpus=4)``) and serves a
``ClientServer`` on a free port. This process connects to both at once
(each package keeps its own client connection) and runs the cases of
``tests/test_ray_client.py`` through both, comparing the results: put
and get, remote tasks (ref arguments, options, several returns), wait,
an actor's lifecycle (a handle passed to a task), a named actor, the
cluster's resources and a task's error; and the server's msgpack
surface for other languages (a function registered by name in
``util.cross_language``, called with plain values, the KV). Then a
separate process drives
the port's server through ``init("ray://...")`` and never loads torch.

Functions and classes are defined inside the tests (cloudpickle ships
them by value) and reach only their own package. Every ``get`` and
``wait`` has a time limit.
"""

import concurrent.futures
import importlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 30

SERVER = """
import os, signal, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("{prefix}_PRESTART_WORKERS", "0")
import {pkg} as rt
from {pkg}.util import cross_language
from {pkg}.util.client.server import ClientServer
rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
cross_language.register_function("math.add", lambda a, b: a + b)
srv = ClientServer(port=0, host="127.0.0.1")

def stop(*_):
    srv.stop()
    rt.shutdown()       # the cluster's GCS, raylet and workers
    os._exit(0)

signal.signal(signal.SIGTERM, stop)
print(f"PORT={{srv.port}}", flush=True)
while True:         # until the test stops this process
    time.sleep(1)
"""

CLIENT = """
import sys
import numpy as np
import ray_tpu_torch as rt
rt.init("ray://127.0.0.1:{port}")
a = np.arange(1 << 17, dtype=np.float64)
back = rt.get(rt.put(a), timeout=30)

@rt.remote
def add(x, y):
    return x + y

out = rt.get(add.remote(40, 2), timeout=30)
rt.shutdown()
print("RESULT", bool(np.array_equal(back, a)), out, "torch" in sys.modules)
"""


def _start(pkg):
    env = dict(os.environ)
    env.pop("RTPU_ADDRESS", None)
    env.pop("RTT_ADDRESS", None)
    prefix = "RTT" if pkg == "ray_tpu_torch" else "RTPU"
    return subprocess.Popen(
        [sys.executable, "-u", "-c", SERVER.format(pkg=pkg, prefix=prefix)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO, start_new_session=True)


def _port_of(proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("PORT="):
            return int(line.strip().split("=", 1)[1])
    return None


def _stop(proc):
    """The server and the cluster it started: its GCS and raylet run in
    sessions of their own, so the server shuts them down on SIGTERM;
    SIGKILL after 20 s."""
    proc.terminate()
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture(scope="module")
def servers():
    procs = {pkg: _start(pkg) for pkg in PACKAGES}
    try:
        ports = {pkg: _port_of(p) for pkg, p in procs.items()}
        assert None not in ports.values(), ports
        for pkg in PACKAGES:
            rt = importlib.import_module(pkg)
            if rt.is_initialized():
                rt.shutdown()
            rt.init(address=f"ray://127.0.0.1:{ports[pkg]}")
        yield ports
    finally:
        for pkg in PACKAGES:
            rt = importlib.import_module(pkg)
            if rt.is_initialized():
                rt.shutdown()
        for p in procs.values():
            _stop(p)


def _both(fn):
    """{pkg: fn(the package)}, both at once: each package keeps its own
    client connection."""
    pool = concurrent.futures.ThreadPoolExecutor(len(PACKAGES))
    try:
        futs = {pkg: pool.submit(fn, importlib.import_module(pkg))
                for pkg in PACKAGES}
        return {pkg: f.result(timeout=90) for pkg, f in futs.items()}
    finally:
        pool.shutdown(wait=False)


def _put_get(rt):
    client = importlib.import_module(rt.__name__ + ".util.client")
    arr = np.arange(1000, dtype=np.float32)
    ref = rt.put(arr)
    return isinstance(ref, client.ClientObjectRef), \
        rt.get(ref, timeout=T).tobytes() == arr.tobytes()


def test_client_put_get_roundtrip(servers):
    got = _both(_put_get)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == (True, True)


def _tasks(rt):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def pair(x):
        return x, x + 1

    ref = rt.put(10)
    return (rt.get(add.remote(2, 40), timeout=T),
            rt.get(add.remote(ref, 5), timeout=T),
            tuple(rt.get(pair.options(num_returns=2).remote(7), timeout=T)))


def test_client_remote_task(servers):
    got = _both(_tasks)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == (42, 15, (7, 8))


def _wait(rt):
    @rt.remote
    def slow(t):
        import time as _t
        _t.sleep(t)
        return t

    fast, slow_ref = slow.remote(0.01), slow.remote(3.0)
    ready, not_ready = rt.wait([fast, slow_ref], num_returns=1,
                               timeout=10.0)
    return ready == [fast], not_ready == [slow_ref]


def test_client_wait(servers):
    got = _both(_wait)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == (True, True)


def _actor_lifecycle(rt):
    client = importlib.import_module(rt.__name__ + ".util.client")

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.x = start

        def incr(self, n=1):
            self.x += n
            return self.x

    @rt.remote
    def poke(counter):
        return rt.get(counter.incr.remote(5), timeout=30)

    c = Counter.remote(100)
    out = [isinstance(c, client.ClientActorHandle),
           rt.get(c.incr.remote(), timeout=T),
           rt.get(c.incr.remote(9), timeout=T),
           rt.get(poke.remote(c), timeout=T)]
    rt.kill(c)
    try:
        rt.get(c.incr.remote(), timeout=T)
        out.append("alive")
    except Exception as e:  # noqa: BLE001 — the package's death error
        out.append(type(e).__name__)
    return out


def test_client_actor_lifecycle(servers):
    got = _both(_actor_lifecycle)
    assert got["ray_tpu"] == got["ray_tpu_torch"]
    assert got["ray_tpu_torch"][:4] == [True, 101, 110, 115]
    assert got["ray_tpu_torch"][4] != "alive"


def _named_actor(rt):
    @rt.remote
    class KV:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v
            return True

        def get(self, k):
            return self.d.get(k)

    KV.options(name="kv_client_test").remote()
    h = rt.get_actor("kv_client_test")
    out = [rt.get(h.set.remote("a", 1), timeout=T),
           rt.get(h.get.remote("a"), timeout=T)]
    try:
        rt.get_actor("no_such_actor")
        out.append("found")
    except ValueError:
        out.append("ValueError")
    rt.kill(h)
    return out


def test_client_named_actor(servers):
    got = _both(_named_actor)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == [True, 1, "ValueError"]


def _info_and_errors(rt):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    res = rt.cluster_resources()
    nodes = rt.nodes()
    try:
        rt.get(boom.remote(), timeout=T)
        err = "no error"
    except Exception as e:  # noqa: BLE001 — the task's error, shipped
        err = "kaboom" in str(e)
    return (res.get("CPU"), rt.is_initialized(),
            len([n for n in nodes if n["alive"]]), err)


def test_client_cluster_info_and_errors(servers):
    got = _both(_info_and_errors)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == (4.0, True, 1, True)


def _named_and_raw(rt):
    c = importlib.import_module(rt.__name__ + ".util.client.worker")._client
    xl = importlib.import_module(rt.__name__ + ".util.cross_language")
    refs = c._call("client_call_named", {"name": "math.add", "args": [1, 41]})
    got = c._call("client_get_raw", {"ids": refs, "timeout": T})
    ref = c._call("client_put_raw", {"value": {"k": [1, 2.5, "s"]}})
    back = c._call("client_get_raw", {"ids": [ref], "timeout": T})
    c._call("client_kv", {"op": "put", "key": "xl/k", "value": b"v"})
    try:
        xl.get_function("no.such")      # this process's own registry
        local = "found"
    except KeyError:
        local = "KeyError"
    return (c._call("client_list_named", {}), [g["value"] for g in got],
            back[0]["value"], c._call("client_kv", {"op": "get",
                                                    "key": "xl/k"}),
            local)


def test_client_named_functions_and_raw_values(servers):
    got = _both(_named_and_raw)
    assert got["ray_tpu"] == got["ray_tpu_torch"] == (
        ["math.add"], [42], {"k": [1, 2.5, "s"]}, b"v", "KeyError")


def test_client_process_never_imports_torch(servers):
    """A ``ray://`` driver of the port in a fresh process: put, get and
    a task, with torch never loaded there."""
    r = subprocess.run(
        [sys.executable, "-c",
         CLIENT.format(port=servers["ray_tpu_torch"])],
        capture_output=True, text=True, timeout=90, cwd=REPO,
        env={k: v for k, v in os.environ.items()
             if k not in ("RTT_ADDRESS", "RTPU_ADDRESS")})
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    assert r.returncode == 0 and lines, r.stdout[-2000:] + r.stderr[-2000:]
    assert lines[-1].split()[1:] == ["True", "42", "False"]
