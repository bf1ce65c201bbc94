"""The port's AIR preprocessors and batch inference against the JAX
package's, on the CPU.

One cluster of each package for the module (``init(num_cpus=4)``). The
13 preprocessors are fitted on the same rows on both and applied to
them; both sides run the same numpy, so the transformed columns are
equal (``np.array_equal``). ``Chain`` and ``Checkpoint.with_preprocessor``
round trips. ``BatchPredictor`` with ``JaxPredictor`` against
``TorchPredictor(device="cpu")``: the linear model of
``tests/test_air_extras.py`` with a preprocessor over an actor pool of
two (predictions within 1e-6), then a 2-layer narrow GPT-2 whose params
cross with ``params_from_flax`` (per-row mean NLL within
``tests/test_torch_gpt2.py``'s forward tolerance, rtol = atol = 1e-4).
``TorchPredictor(device="cuda")`` raises in a process the runtime
granted no GPU, and the predictor is built once per pool actor.

Functions that workers run are defined inside the tests (cloudpickle
ships them by value) and reach only their own package, so the port's
workers never import JAX. Every dataset run has a time limit.
"""

import concurrent.futures
import functools
import importlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

STORE_BYTES = 256 * 1024 * 1024
PACKAGES = ("ray_tpu", "ray_tpu_torch")
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
TIMEOUT_S = 60
LINEAR_TOL = 1e-6                  # the linear model's predictions
GPT2_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_gpt2.py's TOL


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


def _within(fn, *args, timeout=TIMEOUT_S):
    """``fn(*args)`` on a helper thread: its result, or TimeoutError
    after ``timeout`` seconds (a hang fails the test, not the run)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args).result(timeout=timeout)
    finally:
        pool.shutdown(wait=False)


def _each(fns, timeout=TIMEOUT_S):
    """{pkg: fns[pkg]()}, the packages at once (each has its own driver;
    most of the time is their pool actors' starts), each within
    ``timeout`` seconds."""
    pool = concurrent.futures.ThreadPoolExecutor(len(fns))
    try:
        futs = {pkg: pool.submit(fn) for pkg, fn in fns.items()}
        return {pkg: f.result(timeout=timeout) for pkg, f in futs.items()}
    finally:
        pool.shutdown(wait=False)


def _mod(pkg, name=""):
    return importlib.import_module(pkg + name)


def _rows():
    rng = np.random.default_rng(0)
    return [{"a": float(i) if i % 3 else float("nan"),
             "b": float(i - 5) * 1.5,
             "c": ["x", "y", "z"][i % 3],
             "f1": 3.0 * (i + 1), "f2": float(rng.normal()),
             "y": ["cat", "dog"][i % 2],
             "s": None if i % 5 == 0 else ["p", "q"][i % 2]}
            for i in range(30)]


def _cases():
    """name -> the preprocessor's constructor over a package's air
    module."""
    return {
        "StandardScaler": lambda air: air.StandardScaler(["b", "f2"]),
        "MinMaxScaler": lambda air: air.MinMaxScaler(["b", "f1"]),
        "LabelEncoder": lambda air: air.LabelEncoder("y"),
        "OrdinalEncoder": lambda air: air.OrdinalEncoder(["c", "y"]),
        "OneHotEncoder": lambda air: air.OneHotEncoder(["c"]),
        "SimpleImputer": lambda air: air.SimpleImputer(["a"]),
        "SimpleImputer_most_frequent": lambda air: air.SimpleImputer(
            ["s"], strategy="most_frequent"),
        "RobustScaler": lambda air: air.RobustScaler(["b", "f2"]),
        "MaxAbsScaler": lambda air: air.MaxAbsScaler(["b"]),
        "Normalizer": lambda air: air.Normalizer(["f1", "f2"]),
        "Concatenator": lambda air: air.Concatenator(["f1", "f2"],
                                                     output_column="x"),
        "BatchMapper": lambda air: air.BatchMapper(
            lambda b: {**b, "f1": np.asarray(b["f1"]) * 10.0}),
        "Chain": lambda air: air.Chain(
            air.SimpleImputer(["a"]), air.StandardScaler(["a", "b"]),
            air.Concatenator(["a", "b"], output_column="ab")),
    }


def _rows_for(name):
    rows = _rows()
    if name != "SimpleImputer_most_frequent":
        for r in rows:
            del r["s"]
    return rows


def _fit_apply(pkg, name):
    air = _mod(pkg, ".air")
    data = _mod(pkg, ".data")
    ds = data.from_items(_rows_for(name))
    pre = _cases()[name](air).fit(ds)
    rows = pre.transform(ds).take_all()
    batch = pre.transform_batch({k: np.asarray([r[k] for r in
                                                _rows_for(name)])
                                 for k in _rows_for(name)[0]})
    return rows, batch


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype, k
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), k


@pytest.mark.parametrize("name", sorted(_cases()))
def test_preprocessor_matches_jax(clusters, name):
    got = {pkg: _within(_fit_apply, pkg, name) for pkg in PACKAGES}
    (rows_t, batch_t), (rows_j, batch_j) = (got["ray_tpu_torch"],
                                            got["ray_tpu"])
    _assert_rows_equal(rows_t, rows_j)
    _assert_rows_equal([batch_t], [batch_j])


def test_preprocessor_base_and_unfitted_match_jax():
    for pkg in PACKAGES:
        air = _mod(pkg, ".air")
        with pytest.raises(NotImplementedError):
            air.Preprocessor().fit(None)
        with pytest.raises(RuntimeError, match="not fitted"):
            air.StandardScaler(["a"]).transform_batch({"a": np.ones(2)})
        with pytest.raises(ValueError, match="requires fill_value"):
            air.SimpleImputer(["a"], strategy="constant")


def test_chain_and_checkpoint_round_trip(clusters):
    from ray_tpu_torch.air import (BatchMapper, Chain, Checkpoint,
                                   Concatenator, MinMaxScaler,
                                   StandardScaler)
    ds = ray_tpu_torch.data.from_items(_rows_for("Chain"))
    pre = Chain(MinMaxScaler(["b"]), StandardScaler(["f1"]),
                Concatenator(["b", "f1"], output_column="x"))
    want = _within(lambda: pre.fit_transform(ds).take_all())
    ckpt = Checkpoint.from_dict({"params": {"w": np.ones(2, np.float32)}}
                                ).with_preprocessor(pre)
    for c in (ckpt, Checkpoint.from_directory(ckpt.to_directory())):
        back = c.get_preprocessor()
        assert isinstance(back, Chain) and back is not pre
        assert np.array_equal(c.to_dict()["params"]["w"],
                              np.ones(2, np.float32))
        _assert_rows_equal(_within(lambda: back.transform(ds).take_all()),
                           want)
    # a BatchMapper over a lambda rides the checkpoint, as in JAX's
    mapped = Checkpoint.from_dict({}).with_preprocessor(
        BatchMapper(lambda b: {"v": np.asarray(b["v"]) * 3}))
    assert np.array_equal(mapped.get_preprocessor().transform_batch(
        {"v": np.arange(3)})["v"], np.arange(3) * 3)
    # a checkpoint the JAX package's preprocessor rides reads back too
    jair = _mod("ray_tpu", ".air")
    jpre = jair.Chain(jair.MinMaxScaler(["b"])).fit(
        ray_tpu.data.from_items(_rows_for("Chain")))
    jck = jair.Checkpoint.from_dict({}).with_preprocessor(jpre)
    assert Checkpoint.from_dict(jck.to_dict()).get_preprocessor(
        ).preprocessors[0].stats_ == jpre.preprocessors[0].stats_


def _linear_predict(pkg):
    air = _mod(pkg, ".air")
    data = _mod(pkg, ".data")
    rng = np.random.default_rng(0)
    raw = [{"f1": float(v), "f2": float(v) * 3.0 + 1.0}
           for v in rng.normal(5.0, 2.0, 64)]
    ds = data.from_items(raw)
    pre = air.Chain(air.StandardScaler(columns=["f1", "f2"]),
                    air.Concatenator(columns=["f1", "f2"],
                                     output_column="x"))
    xs = np.stack([r["x"] for r in pre.fit_transform(ds).take_all()])
    w, *_ = np.linalg.lstsq(xs, xs[:, :1], rcond=None)
    ckpt = air.Checkpoint.from_dict(
        {"params": {"w": w.astype(np.float32)}}).with_preprocessor(pre)
    if pkg == "ray_tpu":
        def apply_fn(p, x):
            return x @ p["w"]
        kw = {}
        cls = air.JaxPredictor
    else:
        def apply_fn(p, x):
            return x @ p["w"]
        kw = {"device": "cpu"}
        cls = air.TorchPredictor
    bp = air.BatchPredictor.from_checkpoint(ckpt, cls, apply_fn=apply_fn,
                                            input_column="x", **kw)
    out = bp.predict(ds, batch_size=16, num_workers=2).take_all()
    return np.stack([np.asarray(r["predictions"]).ravel() for r in out])


def test_batch_predictor_linear_matches_jax(clusters):
    for pkg in PACKAGES:    # imported here: not by two threads at once
        _mod(pkg, ".air"), _mod(pkg, ".data")
    got = _each({pkg: functools.partial(_linear_predict, pkg)
                 for pkg in PACKAGES})
    assert got["ray_tpu_torch"].shape == (64, 1)
    np.testing.assert_allclose(got["ray_tpu_torch"], got["ray_tpu"],
                               rtol=0, atol=LINEAR_TOL)


def _gpt2_tokens():
    return np.random.default_rng(1).integers(0, 512, (8, 17)).astype(
        np.int32)


def test_batch_predictor_gpt2_matches_jax(clusters):
    import jax
    import jax.numpy as jnp

    from ray_tpu.air import BatchPredictor as JBP
    from ray_tpu.air import Checkpoint as JCk
    from ray_tpu.air import JaxPredictor
    from ray_tpu.models import gpt2 as JG
    from ray_tpu_torch.air import (BatchPredictor, Checkpoint,
                                   TorchPredictor)
    from ray_tpu_torch.models import gpt2 as TG

    # params drawn with numpy on eval_shape's shapes: flax's eager init
    # compiles op by op (seconds)
    mj = JG.GPT2(JG.GPT2Config.tiny())
    shapes = jax.eval_shape(mj.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(0)
    flax_params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        shapes)
    sd = {k: v.numpy() for k, v in TG.params_from_flax(flax_params).items()}
    tokens = _gpt2_tokens()

    def jax_nll(p, x):
        logits = mj.apply(p, x[:, :-1]).astype(jnp.float32)
        lse = jax.nn.logsumexp(logits, axis=-1)
        picked = jnp.take_along_axis(logits, x[:, 1:, None], -1)[..., 0]
        return (lse - picked).mean(-1)

    cache = {}

    def torch_nll(p, x):
        import torch.nn.functional as F
        model = cache.get(id(p))
        if model is None:
            with torch.device("meta"):
                model = TG.GPT2(TG.GPT2Config.tiny())
            model.load_state_dict(p, assign=True)
            model = cache[id(p)] = model.eval()
        logits = model(x[:, :-1].long()).float()
        return F.cross_entropy(logits.transpose(1, 2), x[:, 1:].long(),
                               reduction="none").mean(-1)

    def run_jax():
        bp = JBP.from_checkpoint(JCk.from_dict({"params": flax_params}),
                                 JaxPredictor, apply_fn=jax_nll,
                                 input_column="tokens")
        ds = ray_tpu.data.from_numpy({"tokens": tokens}, parallelism=2)
        return bp.predict(ds, batch_size=4, num_workers=1).take_all()

    def run_port():
        bp = BatchPredictor.from_checkpoint(
            Checkpoint.from_dict({"params": sd}), TorchPredictor,
            apply_fn=torch_nll, input_column="tokens", device="cpu")
        ds = ray_tpu_torch.data.from_numpy({"tokens": tokens},
                                           parallelism=2)
        return bp.predict(ds, batch_size=4, num_workers=1).take_all()

    done = _each({"ray_tpu": run_jax, "ray_tpu_torch": run_port})
    want = np.asarray([r["predictions"] for r in done["ray_tpu"]])
    rows = done["ray_tpu_torch"]
    got = np.asarray([r["predictions"] for r in rows])
    assert got.shape == (8,) and np.isfinite(got).all()
    assert all(np.array_equal(r["tokens"], t) for r, t in zip(rows, tokens))
    np.testing.assert_allclose(got, want, **GPT2_TOL)


def test_torch_predictor_builds_once_per_actor(clusters):
    from ray_tpu_torch.air import BatchPredictor, Checkpoint, TorchPredictor

    def apply_fn(p, x):
        return {"predictions": x * p["w"],
                "pid": torch.full(x.shape, os.getpid()),
                "params_id": torch.full(x.shape, id(p))}

    ckpt = Checkpoint.from_dict({"params": {"w": np.float32(2.0)}})
    bp = BatchPredictor.from_checkpoint(ckpt, TorchPredictor,
                                        apply_fn=apply_fn, device="cpu")
    ds = ray_tpu_torch.data.from_numpy(
        {"x": np.arange(32, dtype=np.float32)}, parallelism=8)
    rows = _within(lambda: bp.predict(ds, batch_size=2,
                                      num_workers=2).take_all())
    assert [float(r["predictions"]) for r in rows] == \
        [2.0 * i for i in range(32)]
    by_pid = {}
    for r in rows:
        by_pid.setdefault(int(r["pid"]), set()).add(int(r["params_id"]))
    assert len(by_pid) == 2 and all(len(v) == 1 for v in by_pid.values())


def test_torch_predictor_on_cuda_without_grant_raises(clusters):
    from ray_tpu_torch.air import BatchPredictor, Checkpoint, TorchPredictor

    ckpt = Checkpoint.from_dict({"params": {"w": np.float32(2.0)}})
    bp = BatchPredictor.from_checkpoint(ckpt, TorchPredictor,
                                        apply_fn=lambda p, x: x)
    ds = ray_tpu_torch.data.from_numpy({"x": np.arange(4.0)},
                                       parallelism=1)
    with pytest.raises(Exception, match="num_gpus_per_worker"):
        _within(lambda: bp.predict(ds, num_workers=1).take_all())

    @ray_tpu_torch.remote
    def build():
        try:
            TorchPredictor({"w": np.ones(1)}, lambda p, x: x)
        except RuntimeError as e:
            return os.environ.get("CUDA_VISIBLE_DEVICES"), str(e)
        return None

    visible, msg = ray_tpu_torch.get(build.remote(), timeout=TIMEOUT_S)
    assert visible == "" and "no GPU grant" in msg
    # without CUDA the driver's constructor raises too: nothing falls
    # back to the CPU
    with pytest.raises(RuntimeError):
        TorchPredictor({"w": np.ones(1)}, lambda p, x: x)


def test_sealed_actor_return_survives_a_lost_reply(clusters):
    """A Dataset actor pool kills its actors once ``wait`` says every
    block is ready, which it says as soon as the block is sealed in this
    node's plasma, before the call's reply arrives: a call failed after
    that (its reply lost with the actor) must resolve to the sealed
    value, not to the actor's death."""
    import threading
    from types import SimpleNamespace

    from ray_tpu_torch import actor as actor_mod
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.common.ids import ObjectID

    @ray_tpu_torch.remote
    class Producer:
        def block(self):
            return np.arange(64 * 1024, dtype=np.int64)  # past inline

    ref = Producer.remote().block.remote()
    want = ray_tpu_torch.get(ref, timeout=TIMEOUT_S)
    w = worker_mod.global_worker()
    assert w.plasma.contains(ref.id())
    w.memory_store.delete(ref.id())          # the reply never came
    state = SimpleNamespace(spec={"arg_refs": []}, return_ids=[ref.id()],
                            done=False, result_event=threading.Event())
    actor_mod._store_actor_error(
        w, state, exc.ActorDiedError("a" * 32, "kill() called"))
    assert state.done
    assert np.array_equal(ray_tpu_torch.get(ref, timeout=TIMEOUT_S), want)
    # a return the actor never sealed still fails with its death
    missing = ObjectID.from_random()
    state = SimpleNamespace(spec={"arg_refs": []}, return_ids=[missing],
                            done=False, result_event=threading.Event())
    actor_mod._store_actor_error(
        w, state, exc.ActorDiedError("a" * 32, "kill() called"))
    with pytest.raises(exc.ActorDiedError):
        w._deserialize_payload(missing, w.memory_store.get(missing))
