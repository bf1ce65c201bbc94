"""The port's ``util`` modules ``check_serialize``, ``multiprocessing``,
``iter``, ``dask`` and ``joblib`` against the JAX package's, on the CPU.

One cluster of each package for the module (``init(num_cpus=4)``). Each
program runs the same operations on both at once (two driver threads)
and the two must give the same results, which are also the results the
JAX oracles expect (tests/test_util_iter_dask.py,
tests/test_util_extras.py, tests/test_util_dag_workflow.py's pool):
the parallel iterator's transforms and gathers, the dict-graph
scheduler on a diamond, nested tasks and a cycle, ``Pool``'s maps and
async results, the serializability inspector's findings, and a
GridSearchCV through each package's joblib backend. Functions and
classes are defined inside the programs (cloudpickle ships them by
value). Every wait has a time limit.
"""

import concurrent.futures
import importlib
import operator
import os
import threading
from unittest import mock

import pytest

import ray_tpu
import ray_tpu_torch

STORE_BYTES = 128 * 1024 * 1024
PACKAGES = ("ray_tpu", "ray_tpu_torch")
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
TIMEOUT_S = 60
MODULES = ("check_serialize", "multiprocessing", "iter", "dask", "joblib")


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


def _module(pkg, name):
    return importlib.import_module(f"{pkg}.util.{name}")


def _both(program, name):
    """``program(module)`` with each package's ``util.<name>``, the two
    at once, each within TIMEOUT_S: {pkg: its result}."""
    mods = {pkg: _module(pkg, name) for pkg in PACKAGES}
    with concurrent.futures.ThreadPoolExecutor(len(PACKAGES)) as pool:
        futures = {pkg: pool.submit(program, mods[pkg]) for pkg in PACKAGES}
        return {pkg: f.result(timeout=TIMEOUT_S)
                for pkg, f in futures.items()}


def _same(program, name):
    got = _both(program, name)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    return got["ray_tpu_torch"]


def _public(mod, pkg):
    """The module's public names, less the package it imports."""
    return sorted(n for n in vars(mod) if not n.startswith("_")
                  and n != pkg)


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_jax(name):
    """Each copy defines what its JAX module defines, and names that
    module in its docstring."""
    jax_mod, port_mod = (_module(pkg, name) for pkg in PACKAGES)
    assert _public(port_mod, "ray_tpu_torch") == _public(jax_mod, "ray_tpu")
    assert f"ray_tpu/util/{name}.py" in port_mod.__doc__


def test_util_exports_unchanged():
    """The five modules are imported by name: ``util``'s exports stay
    JAX's."""
    import ray_tpu.util as J
    import ray_tpu_torch.util as T
    assert T.__all__ == J.__all__


# ---------------------------------------------------------------- iter


def test_parallel_iterator_for_each_gather_sync(clusters):
    def program(it):
        p = it.from_range(10, num_shards=3).for_each(lambda x: x * 2)
        try:
            return list(p.gather_sync())    # shard order: deterministic
        finally:
            p.stop()

    got = _same(program, "iter")
    assert sorted(got) == [0, 2, 4, 6, 8, 10, 12, 14, 16, 18]


def test_parallel_iterator_filter_batch_flatten(clusters):
    def program(it):
        p = (it.from_items(list(range(20)), num_shards=2)
             .filter(lambda x: x % 2 == 0).batch(3).flatten())
        try:
            return list(p.gather_sync()), p.num_shards
        finally:
            p.stop()

    got, shards = _same(program, "iter")
    assert sorted(got) == list(range(0, 20, 2)) and shards == 2


def test_parallel_iterator_gather_async_take_count(clusters):
    def program(it):
        p = it.from_range(100, num_shards=4).for_each(lambda x: x + 1)
        try:
            return (sorted(p.gather_async(fetch=8)), p.take(5), p.count())
        finally:
            p.stop()

    got, first, n = _same(program, "iter")
    assert got == list(range(1, 101)) and len(first) == 5 and n == 100


def test_parallel_iterator_from_iterators(clusters):
    def program(it):
        p = it.from_iterators([lambda: range(3), lambda: "ab"]).batch(2)
        try:
            return list(p.gather_sync(fetch=1))
        finally:
            p.stop()

    assert _same(program, "iter") == [[0, 1], ["a", "b"], [2]]


# ---------------------------------------------------------------- dask


def test_ray_dask_get_executes_graph(clusters):
    dsk = {"a": 10, "b": (operator.add, "a", 1),
           "c": (operator.mul, "a", 2), "d": (operator.add, "b", "c")}

    def program(dask):
        get = dask.ray_dask_get
        return get(dsk, "d"), get(dsk, ["b", "c"]), get(dsk, [["a", "d"]])

    assert _same(program, "dask") == (31, [11, 20], [[10, 31]])


def test_ray_dask_get_nested_tasks_and_lists(clusters):
    dsk = {"x": 4, "y": (sum, [(operator.mul, "x", 2), "x", 1])}
    assert _same(lambda dask: dask.ray_dask_get(dsk, "y"), "dask") == 13


def test_ray_dask_get_cycle_detection(clusters):
    def program(dask):
        try:
            dask.ray_dask_get({"a": (operator.neg, "b"),
                               "b": (operator.neg, "a")}, "a")
        except ValueError as e:
            return "cycle" in str(e)

    assert _same(program, "dask") is True


def test_enable_dask_on_ray_without_dask():
    """Neither machine has dask: both raise the same ImportError."""
    msgs = {}
    for pkg in PACKAGES:
        with mock.patch.dict("sys.modules", {"dask": None}):
            with pytest.raises(ImportError) as e:
                _module(pkg, "dask").enable_dask_on_ray()
        msgs[pkg] = str(e.value)
    assert msgs["ray_tpu_torch"] == msgs["ray_tpu"]


# ------------------------------------------------------- multiprocessing


def test_multiprocessing_pool(clusters):
    def program(mp):
        def sq(x):
            return x * x

        with mp.Pool(processes=2) as p:
            out = [p.map(sq, range(8)), p.map(sq, range(5), chunksize=2),
                   p.apply(sq, (3,)), p.apply_async(sq, (9,)).get(
                       timeout=TIMEOUT_S),
                   p.starmap(operator.add, [(1, 2), (3, 4)]),
                   list(p.imap(sq, [4, 5])),
                   sorted(p.imap_unordered(sq, [1, 2, 3]))]
            r = p.map_async(sq, [6, 7])
            r.wait(timeout=TIMEOUT_S)
            out += [r.ready(), r.successful(), r.get(timeout=TIMEOUT_S)]
        try:
            p.map(sq, [1])
        except ValueError as e:
            out.append(str(e))
        return out

    assert _same(program, "multiprocessing") == [
        [x * x for x in range(8)], [0, 1, 4, 9, 16], 9, 81, [3, 7],
        [16, 25], [1, 4, 9], True, True, [36, 49], "Pool is closed"]


def test_multiprocessing_failed_result(clusters):
    def program(mp):
        def boom(x):
            raise RuntimeError(f"boom {x}")

        p = mp.Pool(processes=2)
        r = p.apply_async(boom, (1,))
        r.wait(timeout=TIMEOUT_S)
        try:
            r.get(timeout=TIMEOUT_S)
        except Exception as e:
            raised = "boom 1" in str(e)
        return p._size, r.ready(), r.successful(), raised

    assert _same(program, "multiprocessing") == (2, True, False, True)


# ------------------------------------------------------- check_serialize


def test_inspect_serializability():
    """A lambda pickles; a closure over a lock is found down to the lock,
    and an object whose member holds a lock down to that member."""
    lock = threading.Lock()

    def bad():
        return lock

    class Holder:
        def __init__(self):
            self.fine = [1, 2]
            self.inner = {"lock": lock}

    got = {}
    for pkg in PACKAGES:
        inspect_serializability = _module(
            pkg, "check_serialize").inspect_serializability
        ok, failures = inspect_serializability(lambda: 42)
        assert ok and not failures
        rows = []
        for obj in (bad, Holder()):
            ok, failures = inspect_serializability(obj, name="obj")
            assert not ok and any(f.obj is lock for f in failures), failures
            rows.append([(f.name, type(f.parent).__name__, repr(f)
                          .startswith("FailureTuple(")) for f in failures])
        got[pkg] = rows
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu"][1] == [("lock", "dict", True)]


# ---------------------------------------------------------------- joblib


def test_joblib_backend_sklearn(clusters):
    """GridSearchCV fans out over each cluster's tasks through its joblib
    backend ("ray_tpu" and "ray_tpu_torch"): the same scores."""
    import joblib
    import numpy as np
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import GridSearchCV

    rng = np.random.default_rng(0)
    X = rng.standard_normal((120, 5))
    y = (X.sum(axis=1) > 0).astype(int)
    backend = {"ray_tpu": "ray_tpu", "ray_tpu_torch": "ray_tpu_torch"}

    def program(jl):
        jl.register_ray()
        pkg = jl.__name__.split(".")[0]
        with joblib.parallel_backend(backend[pkg], n_jobs=4):
            gs = GridSearchCV(LogisticRegression(max_iter=200),
                              {"C": [0.1, 1.0, 10.0]}, cv=3, n_jobs=4)
            gs.fit(X, y)
        return (gs.best_params_, round(float(gs.best_score_), 12),
                [round(float(s), 12)
                 for s in gs.cv_results_["mean_test_score"]])

    best, score, scores = _same(program, "joblib")
    assert score > 0.8 and best["C"] in (0.1, 1.0, 10.0) and len(scores) == 3
