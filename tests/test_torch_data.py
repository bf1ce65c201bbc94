"""The port's ``ray_tpu_torch.data`` against the JAX package's
``ray_tpu.data``, on the CPU.

One cluster of each package for the whole module, as
``tests/test_torch_runtime.py`` starts them. The same items go through
both packages' Datasets, under the streaming executor and the bulk path
(``RTT_DATA_STREAMING`` / ``RTPU_DATA_STREAMING``), and must give
bit-equal outputs: ``from_items``, ``range``, ``from_numpy``,
``map_batches``, ``random_shuffle(seed=)``, ``split(n)``,
``streaming_split(n)``, and ``iter_batches`` with ``drop_last`` and
``pad_to_batch``. ``iter_device_batches(device="cpu")`` yields torch
tensors equal to the JAX package's device batches (dtypes cast as its
``dtypes=`` casts them), in ``iter_batches``' order; left at
``device="cuda"`` it raises without CUDA.
"""

import concurrent.futures
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
MODES = {"streaming": "1", "bulk": "0"}


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


@pytest.fixture(params=list(MODES))
def mode(request):
    flag = MODES[request.param]
    with mock.patch.dict(os.environ, {"RTPU_DATA_STREAMING": flag,
                                      "RTT_DATA_STREAMING": flag}):
        for pkg in PACKAGES:
            ex = importlib.import_module(
                pkg + ".data._internal.streaming_executor")
            assert ex.streaming_enabled() == (flag == "1")
        yield request.param


def _items(n=20):
    rng = np.random.default_rng(0)
    return [{"image": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
             "label": np.int32(rng.integers(0, 1000)),
             "w": np.float32(rng.standard_normal())} for _ in range(n)]


def _canon(x):
    """A value both packages' outputs reduce to for ``==``: arrays and
    numpy scalars as (dtype, shape, bytes), containers walked."""
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(x)
        return (a.dtype.str, a.shape, a.tobytes())
    return x


def _both(program):
    """``program(data_module)`` on each package, the two at once: the
    canonical forms, {pkg: result}."""
    def run(pkg):
        return _canon(program(importlib.import_module(pkg + ".data")))
    with concurrent.futures.ThreadPoolExecutor(len(PACKAGES)) as pool:
        futures = {pkg: pool.submit(run, pkg) for pkg in PACKAGES}
        return {pkg: f.result() for pkg, f in futures.items()}


def _batches(ds, **kw):
    return list(ds.iter_batches(batch_format="numpy", **kw))


def _doubler():
    """A map_batches fn, made in a closure so that it travels to the
    block tasks by value."""
    def double(batch):
        return {"image": batch["image"] // 2, "label": batch["label"] * 2,
                "w2": batch["w"] * batch["w"]}
    return double


PROGRAMS = {
    "from_items": lambda d: (
        d.from_items(_items(), parallelism=8).take_all(),
        _batches(d.from_items(_items(), parallelism=8), batch_size=6)),
    "range": lambda d: (d.range(37, parallelism=4).take_all(),
                        d.range(37, parallelism=4).count()),
    "from_numpy": lambda d: _batches(
        d.from_numpy({"x": np.arange(30, dtype=np.float32).reshape(10, 3),
                      "y": np.arange(10, dtype=np.int64)}), batch_size=4),
    "map_batches": lambda d: _batches(
        d.from_items(_items(), parallelism=4).map_batches(
            _doubler(), batch_size=3), batch_size=7),
    "random_shuffle": lambda d: (
        d.range(40, parallelism=5).random_shuffle(seed=7).take_all(),
        _batches(d.from_items(_items(), parallelism=4)
                 .random_shuffle(seed=3, num_blocks=2), batch_size=5)),
    "split": lambda d: [
        _batches(s, batch_size=4) for s in
        d.from_items(_items(), parallelism=8).map_batches(_doubler())
        .split(3)],
    "streaming_split": lambda d: [
        _batches(s, batch_size=4) for s in
        d.from_items(_items(), parallelism=8).map_batches(_doubler())
        .streaming_split(2)],
    "iter_batches_drop_last": lambda d: _batches(
        d.from_items(_items(), parallelism=3), batch_size=6,
        drop_last=True),
    "iter_batches_pad_to_batch": lambda d: _batches(
        d.from_items(_items(), parallelism=3).map_batches(_doubler()),
        batch_size=6, pad_to_batch=True),
}


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_dataset_outputs_match_jax(clusters, mode, program):
    got = _both(PROGRAMS[program])
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def test_known_values(clusters, mode):
    """A few of the programs' outputs stated outright, so the parity
    above cannot pass on two equal wrong answers."""
    d = ray_tpu_torch.data
    assert [int(r) for r in d.range(37, parallelism=4).take_all()] == list(
        range(37))
    rows = d.range(40, parallelism=5).random_shuffle(seed=7).take_all()
    assert sorted(int(r) for r in rows) == list(range(40))
    assert [int(r) for r in rows] != list(range(40))
    labels = [int(it["label"]) for it in _items()]
    dropped = _batches(d.from_items(_items(), parallelism=3), batch_size=6,
                       drop_last=True)
    assert [b["label"].tolist() for b in dropped] == [
        labels[i:i + 6] for i in (0, 6, 12)]
    padded = _batches(d.from_items(_items(), parallelism=3), batch_size=6,
                      pad_to_batch=True)
    assert padded[-1]["label"].tolist() == labels[18:] + labels[18:] * 2
    shards = d.from_items(_items(), parallelism=8).split(3)
    assert [s.count() for s in shards] == [6, 6, 6]


def _torch_loaded():
    def loaded(batch):
        import sys
        return {"torch": np.array(["torch" in sys.modules])}
    return loaded


def test_block_tasks_do_not_import_torch(clusters, mode):
    """The port's block tasks handle numpy blocks only: the CPU workers
    that run them never import torch (PR 18 measured 7-11 s for a GPU
    worker's import and CUDA init)."""
    ds = ray_tpu_torch.data.from_items(_items(), parallelism=4)
    flags = ds.map_batches(_torch_loaded()).take_all()
    assert [bool(r["torch"]) for r in flags] == [False] * 4


DTYPES = {"label": np.float32, "w": np.float16}


def _device_batches(pkg, **kw):
    ds = importlib.import_module(pkg + ".data").from_items(
        _items(), parallelism=4)
    if pkg == "ray_tpu":
        return [{k: np.asarray(v) for k, v in b.items()}
                for b in ds.iter_device_batches(**kw)]
    return list(ds.iter_device_batches(device="cpu", **kw))


@pytest.mark.parametrize("kw", [
    dict(batch_size=6),
    dict(batch_size=6, drop_last=True, pad_to_batch=False),
    dict(batch_size=8, pad_to_batch=False, dtypes=DTYPES)],
    ids=["padded", "drop_last", "dtypes"])
def test_iter_device_batches_match_jax(clusters, kw):
    """Torch tensors on the CPU, one per column, equal to the JAX
    package's device arrays (the same bytes, dtype names equal: uint8
    images stay bytes; ``dtypes`` casts int32 labels to float32 and
    float32 weights to float16) and to ``iter_batches``' numpy batches
    cast the same way, in order."""
    port = _device_batches("ray_tpu_torch", **kw)
    jax_side = _device_batches("ray_tpu", **kw)
    host = _batches(ray_tpu_torch.data.from_items(_items(), parallelism=4),
                    batch_size=kw["batch_size"],
                    drop_last=kw.get("drop_last", False),
                    pad_to_batch=kw.get("pad_to_batch", True))
    assert len(port) == len(jax_side) == len(host) > 1
    cast = kw.get("dtypes") or {}
    for got, want, ref in zip(port, jax_side, host):
        assert set(got) == set(want) == set(ref)
        for k, t in got.items():
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            a = t.numpy()
            assert a.dtype == want[k].dtype, (k, a.dtype, want[k].dtype)
            assert _canon(a) == _canon(want[k]), k
            assert _canon(a) == _canon(ref[k].astype(cast.get(k,
                                                              ref[k].dtype)))
    assert port[0]["image"].dtype == torch.uint8


def test_iter_device_batches_default_device_needs_cuda(clusters):
    ds = ray_tpu_torch.data.from_items(_items(4))
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(ds.iter_device_batches(batch_size=2))
