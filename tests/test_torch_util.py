"""The port's ``util.ActorPool`` and ``util.Queue`` against the JAX
package's, on the CPU.

One cluster of each package for the module (``init(num_cpus=4)``). Each
program runs the same sequence of operations on both at once (two driver
threads) and the two must give the same results: the pool's ordered and
unordered maps, ``submit`` / ``get_next`` with a retried timeout, a
failed call that frees its actor, the guard against mixing the two
orders; the queue's FIFO order, ``Full`` and ``Empty`` with and without
waiting, sizes, a queue handed to tasks and an actor, blocked getters
served in turn (tests/test_util_dag_workflow.py's programs, plus the
edges). Actor classes and task functions are defined inside the
programs (cloudpickle ships them by value). Every ``get`` has a time
limit.
"""

import concurrent.futures
import importlib
import os
import threading
import time
from unittest import mock

import pytest

import ray_tpu
import ray_tpu_torch

STORE_BYTES = 128 * 1024 * 1024
PACKAGES = ("ray_tpu", "ray_tpu_torch")
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
TIMEOUT_S = 60


@pytest.fixture(scope="module")
def clusters():
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


def _both(program):
    """``program(rt, util, exceptions)`` on each runtime, the two at
    once, each within TIMEOUT_S: {pkg: its result}."""
    mods = {pkg: (importlib.import_module(pkg),
                  importlib.import_module(pkg + ".util"),
                  importlib.import_module(pkg + ".exceptions"))
            for pkg in PACKAGES}
    with concurrent.futures.ThreadPoolExecutor(len(PACKAGES)) as pool:
        futures = {pkg: pool.submit(program, *mods[pkg])
                   for pkg in PACKAGES}
        return {pkg: f.result(timeout=TIMEOUT_S)
                for pkg, f in futures.items()}


def _same(program):
    got = _both(program)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    return got["ray_tpu_torch"]


def test_util_exports_match_jax():
    import ray_tpu.util as J
    import ray_tpu_torch.util as T
    assert T.__all__ == J.__all__
    assert all(hasattr(T, name) for name in T.__all__)


def _worker_cls(rt):
    @rt.remote
    class Worker:
        def double(self, x):
            return x * 2

        def slow(self, x, s):
            time.sleep(s)
            return x

        def fail(self, x):
            raise ValueError(f"bad {x}")

    return Worker


def test_actor_pool_maps(clusters):
    def program(rt, util, exc):
        pool = util.ActorPool([_worker_cls(rt).remote() for _ in range(2)])
        ordered = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
        unordered = sorted(pool.map_unordered(
            lambda a, v: a.double.remote(v), range(4)))
        return ordered, unordered, pool.has_next(), pool.has_free()

    assert _same(program) == ([0, 2, 4, 6, 8, 10], [0, 2, 4, 6], False,
                              True)


def test_actor_pool_submit_and_edges(clusters):
    def program(rt, util, exc):
        pool = util.ActorPool([_worker_cls(rt).remote() for _ in range(2)])
        log = []
        for v in range(3):          # the third waits for a free actor
            pool.submit(lambda a, x: a.slow.remote(x, 0.5), v)
        log.append(("free", pool.has_free(), "next", pool.has_next()))
        try:
            pool.get_next(timeout=0.01)
        except exc.GetTimeoutError:
            log.append("timeout")   # the state is untouched: retry
        log.append([pool.get_next(timeout=TIMEOUT_S) for _ in range(3)])
        try:
            pool.get_next()
        except StopIteration:
            log.append("stop")
        pool.submit(lambda a, x: a.fail.remote(x), 7)
        try:
            pool.get_next(timeout=TIMEOUT_S)
        except Exception as e:      # the failure frees its actor
            log.append(("failed", "bad 7" in str(e), pool.has_free()))
        pool.submit(lambda a, x: a.double.remote(x), 2)
        pool.submit(lambda a, x: a.slow.remote(x, 0.5), 1)
        log.append(pool.get_next_unordered(timeout=TIMEOUT_S))
        try:                        # the next in order was taken
            pool.get_next()
        except ValueError:
            log.append("mixed orders")
        log.append(pool.get_next_unordered(timeout=TIMEOUT_S))
        return log

    assert _same(program) == [
        ("free", False, "next", True), "timeout", [0, 1, 2], "stop",
        ("failed", True, True), 4, "mixed orders", 1]


def test_queue_basic_and_edges(clusters):
    def program(rt, util, exc):
        q = util.Queue(maxsize=2)
        log = [q.empty(), q.qsize()]
        q.put(1)
        q.put("two")
        log += [q.full(), q.qsize()]
        for put in (lambda: q.put_nowait(3), lambda: q.put(3, timeout=0.3)):
            try:
                put()
            except util.Full:
                log.append("full")
        log += [q.get(), q.get_nowait()]
        for get in (q.get_nowait, lambda: q.get(timeout=0.3)):
            try:
                get()
            except util.Empty:
                log.append("empty")
        return log

    assert _same(program) == [True, 0, True, 2, "full", "full", 1, "two",
                              "empty", "empty"]


def test_queue_across_tasks_and_actors(clusters):
    def program(rt, util, exc):
        q = util.Queue()

        @rt.remote
        def producer(q, n):
            for i in range(n):
                q.put(i)
            return "done"

        @rt.remote
        class Consumer:
            def take(self, q, n):
                return [q.get(timeout=TIMEOUT_S) for _ in range(n)]

        done = rt.get(producer.remote(q, 5), timeout=TIMEOUT_S)
        first = [q.get(timeout=TIMEOUT_S) for _ in range(2)]
        rest = rt.get(Consumer.remote().take.remote(q, 3),
                      timeout=TIMEOUT_S)
        return done, first, rest, q.empty()

    assert _same(program) == ("done", [0, 1], [2, 3, 4], True)


def test_queue_blocked_getters_served(clusters):
    def program(rt, util, exc):
        q = util.Queue()
        results = []

        def consumer():
            results.append(q.get(timeout=TIMEOUT_S))

        threads = [threading.Thread(target=consumer) for _ in range(5)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        for i in range(5):
            q.put(i)
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        return any(t.is_alive() for t in threads), sorted(results)

    assert _same(program) == (False, [0, 1, 2, 3, 4])
