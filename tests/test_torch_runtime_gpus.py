"""GPU grants of the port's runtime, on the CPU with a fake count.

One port cluster, ``init(num_cpus=4, num_gpus=4)``, started inside an
inherited ``CUDA_VISIBLE_DEVICES="3,5,6,7"``, as a driver granted four
cards of a larger machine would be: no GPU is present, the raylet
schedules four indices and each stands for the inherited device at its
place, so a worker is never handed a card its parent was not granted.
Tasks, bundles and an actor report ``get_gpu_ids()`` and their
``CUDA_VISIBLE_DEVICES``, which must agree; a worker granted none sees
``""``. The schedules themselves are held against the JAX runtime's
(``num_tpus=4``) in ``tests/test_torch_runtime.py``. ``detect_gpus``'s
order is checked with the environment and the ``/dev`` listing patched,
as ``tests/test_tpu_detection.py`` does for the TPU.
"""

import os
import time
from unittest import mock

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import raylet as traylet
from ray_tpu_torch.common.config import SystemConfig
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy

INHERITED = [3, 5, 6, 7]


@pytest.fixture(scope="module")
def gpu4():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    # workers start on demand, as conftest sets for the JAX package; the
    # GCS and raylet take the environment when init starts them
    env = {"RTT_PRESTART_WORKERS": "0",
           "CUDA_VISIBLE_DEVICES": ",".join(map(str, INHERITED))}
    with mock.patch.dict(os.environ, env):
        ray_tpu_torch.init(num_cpus=4, num_gpus=4,
                           object_store_memory=64 * 1024 * 1024)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


def _report():
    import ray_tpu_torch as rt
    return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")


class _Holder:
    def report(self):
        return _report()


def _in_bundle(pg, index=0, num_gpus=1):
    return ray_tpu_torch.remote(
        num_cpus=0.5, num_gpus=num_gpus,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=index))(_report)


def _wait_gpus_free(want=float(len(INHERITED)), timeout=30.0):
    """Poll until the cluster's available GPU has read ``want`` for longer
    than the raylet's report period. A finished GPU task's grant is
    freed when the raylet handles its ``task_done``, which may come after
    the owner's ``get`` returns; the GCS's view (``available_resources``)
    follows the raylet's reports, pushed on a release and otherwise once
    a ``health_check_period_s`` (1 s), so a read of ``want`` alone may
    predate the grant. A run of ``want`` that spans a report shows the
    raylet's own count after the ``get``. Polled with a deadline, as
    tests/test_worker_lease.py waits for an idle lease."""
    from ray_tpu_torch.common.config import global_config
    span = global_config().health_check_period_s * 1.5
    deadline = time.time() + timeout
    since = None
    while time.time() < deadline:
        free = ray_tpu_torch.available_resources().get("GPU", 0.0)
        now = time.time()
        since = (since or now) if free == want else None
        if since is not None and now - since > span:
            return
        time.sleep(0.05)
    raise AssertionError(f"available GPU did not settle at {want}")


def _grant(ids_env):
    """A worker's grant, after checking that its CUDA_VISIBLE_DEVICES
    lists exactly its ``get_gpu_ids()``."""
    ids, env = ids_env
    assert env == ",".join(str(i) for i in ids)
    return list(ids)


def test_grants_name_inherited_devices(gpu4):
    """Ledger index i is inherited device i: a one-GPU task gets one of
    the inherited cards (never card 0), two 2-GPU bundles get {3, 5} and
    {6, 7}, and an actor in a bundle gets its bundle's cards."""
    one = _grant(ray_tpu_torch.get(
        ray_tpu_torch.remote(num_gpus=1)(_report).remote(), timeout=60))
    assert len(one) == 1 and one[0] in INHERITED
    _wait_gpus_free()
    pgs = [placement_group([{"CPU": 1, "GPU": 2}]) for _ in range(2)]
    halves = []
    for pg in pgs:
        assert pg.ready(timeout=30)
        halves.append(_grant(ray_tpu_torch.get(
            _in_bundle(pg, num_gpus=2).remote(), timeout=60)))
    for pg in pgs:
        remove_placement_group(pg)
    _wait_gpus_free()
    assert sorted(halves) == [[3, 5], [6, 7]]
    pg = placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 3}])
    assert pg.ready(timeout=30)
    actor = ray_tpu_torch.remote(
        num_gpus=3, scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=1))(_Holder).remote()
    three = _grant(ray_tpu_torch.get(actor.report.remote(), timeout=60))
    ray_tpu_torch.kill(actor)
    remove_placement_group(pg)
    assert len(three) == 3 and set(three) < set(INHERITED)


def test_no_gpu_sees_none_and_fraction_takes_no_index(gpu4):
    """A task or actor granted no GPU gets CUDA_VISIBLE_DEVICES="" (CUDA
    sees no device), inherited list or not. A fractional demand follows
    the whole-device rule that JAX applies to num_tpus: no index, and
    the node keeps 4."""
    plain = ray_tpu_torch.get(
        ray_tpu_torch.remote(_report).remote(), timeout=60)
    actor = ray_tpu_torch.remote(_Holder).remote()
    held = ray_tpu_torch.get(actor.report.remote(), timeout=60)
    ray_tpu_torch.kill(actor)
    half = ray_tpu_torch.get(
        ray_tpu_torch.remote(num_gpus=0.5)(_report).remote(), timeout=60)
    assert plain == held == half == ([], "")
    assert ray_tpu_torch.cluster_resources()["GPU"] == 4.0
    assert ray_tpu_torch.get_gpu_ids() == []


@pytest.mark.parametrize("case", [
    # (inherited CUDA_VISIBLE_DEVICES or None, count, devices or error)
    (None, 2, ["0", "1"]),
    ("3,5", 2, ["3", "5"]),
    ("3,5", 1, ["3"]),
    (" 7 , 2 ", 2, ["7", "2"]),
    ("GPU-aa11,GPU-bb22", 2, ["GPU-aa11", "GPU-bb22"]),
    ("", 0, []),
    ("3,5", 3, ValueError),
    ("", 1, ValueError),
], ids=["unset", "inherited", "fewer", "spaces", "uuid", "empty",
        "more-than-inherited", "none-inherited"])
def test_gpu_devices(case):
    inherited, count, want = case
    clean = {k: v for k, v in os.environ.items()
             if k != "CUDA_VISIBLE_DEVICES"}
    if inherited is not None:
        clean["CUDA_VISIBLE_DEVICES"] = inherited
    with mock.patch.dict(os.environ, clean, clear=True):
        if want is ValueError:
            with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
                traylet.gpu_devices(count)
        else:
            assert traylet.gpu_devices(count) == want


@pytest.mark.parametrize("opts", [{"num_tpus": 1},
                                  {"tpu_topology": "v5e-8"}])
def test_tpu_options_refused(opts):
    with pytest.raises(ValueError, match="num_gpus"):
        ray_tpu_torch.remote(**opts)(_report)
    with pytest.raises(ValueError, match="num_gpus"):
        ray_tpu_torch.remote(resources={"GPU": 1})(_report)


# ---- detect_gpus ----

def _cfg(gpus=-1):
    c = SystemConfig()
    c.gpus_per_host = gpus
    return c


def _devices(names, openable):
    """Patch the /dev listing and which of its files open."""
    real_open = os.open

    def fake_open(path, flags, *a):
        if path.startswith("/dev/nvidia"):
            if os.path.basename(path) in openable:
                return real_open(os.devnull, os.O_RDONLY)
            raise PermissionError(1, "Operation not permitted", path)
        return real_open(path, flags, *a)
    return (mock.patch.object(traylet.os, "listdir", lambda p: list(names)),
            mock.patch.object(traylet.os, "open", fake_open))


@pytest.mark.parametrize("case", [
    # (config, env, /dev files, files that open, expected)
    (2, {"RTT_NUM_GPUS": "7", "CUDA_VISIBLE_DEVICES": "0"}, ["nvidia0"],
     ["nvidia0"], 2),
    (-1, {"RTT_NUM_GPUS": "3", "CUDA_VISIBLE_DEVICES": "0"}, [], [], 3),
    (-1, {"CUDA_VISIBLE_DEVICES": "0,1,2"}, ["nvidia0"], ["nvidia0"], 3),
    (-1, {"CUDA_VISIBLE_DEVICES": ""}, ["nvidia0"], ["nvidia0"], 0),
    (-1, {}, ["nvidia0", "nvidia7", "nvidiactl", "nvidia-uvm"],
     ["nvidia0", "nvidia7"], 2),
    # the H100 machine: two device files, one card this process may open
    (-1, {}, ["nvidia0", "nvidia7", "nvidiactl"], ["nvidia7"], 1),
    (-1, {}, ["null", "zero"], [], 0),
], ids=["config", "env", "visible", "visible-empty", "dev", "dev-denied",
        "none"])
def test_detect_gpus_order(case):
    gpus, env, names, openable, want = case
    clean = {k: v for k, v in os.environ.items()
             if k not in ("RTT_NUM_GPUS", "CUDA_VISIBLE_DEVICES")}
    listing, opener = _devices(names, openable)
    with mock.patch.dict(os.environ, {**clean, **env}, clear=True), \
            listing, opener:
        assert traylet.detect_gpus(_cfg(gpus)) == want
