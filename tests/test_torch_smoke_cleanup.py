"""No process of a run outlives it.

``chip_smoke.py`` must stop every process it starts. Two layers hold
that: the port's raylet kills and reaps every worker it started when it
shuts down (also those it retired or killed earlier, which have left
its worker table), and the script's ``stop_leftovers`` kills whatever
process still carries the run's mark. A worker that ignores SIGTERM
stands for one that is slow to die (a CUDA context tearing down).
"""

import importlib.util
import os
import signal
import subprocess
import sys
import time
from unittest import mock

import pytest

import ray_tpu_torch

REPO_ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _running(pid: int) -> bool:
    """Alive and not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _sleeper(env):
    return subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(120)"], env=env,
        start_new_session=True)


def test_stop_leftovers_stops_marked_processes_only():
    cs = _chip_smoke()
    mark = f"test-{os.getpid()}-{time.time_ns()}"
    with mock.patch.dict(os.environ, {cs.RUN_MARK: mark}):
        marked = _sleeper(dict(os.environ))
        other = _sleeper({k: v for k, v in os.environ.items()
                          if k != cs.RUN_MARK})
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:   # until its environ is set
                with open(f"/proc/{marked.pid}/cmdline", "rb") as f:
                    if b"sleep" in f.read():
                        break
                time.sleep(0.05)
            found = cs.stop_leftovers()
            assert [pid for pid, _ in found] == [marked.pid]
            assert "sleep(120)" in found[0][1]
            assert not _running(marked.pid)    # killed and reaped
            assert _running(other.pid)
        finally:
            for p in (marked, other):
                p.kill()
                p.wait()


def _retired_worker_pid():
    """A GPU task's worker is retired when the task ends (SIGTERM): this
    one ignores it and, a second after the task, holds the GIL in native
    code (a regex that backtracks for hours), as a process stuck in a
    driver call would, so it cannot act on its raylet's death either."""
    import re
    import threading

    def stuck():
        time.sleep(1.0)
        re.match(r"(a+)+$", "a" * 64 + "b")

    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    threading.Thread(target=stuck, daemon=True).start()
    return os.getpid()


def test_shutdown_reaps_a_retired_worker_that_lingers():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    env = {"RTT_PRESTART_WORKERS": "0", "CUDA_VISIBLE_DEVICES": "3"}
    with mock.patch.dict(os.environ, env):
        ray_tpu_torch.init(num_cpus=2, num_gpus=1,
                           object_store_memory=64 * 1024 * 1024)
    pid = None
    try:
        pid = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(
            _retired_worker_pid).remote(), timeout=120)
        # the raylet has freed the GPU, so it has retired the worker
        deadline = time.monotonic() + 30
        while (ray_tpu_torch.available_resources().get("GPU") != 1.0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(2.0)
        assert _running(pid), "the worker did not outlive its retirement"
    finally:
        ray_tpu_torch.shutdown()
        left = pid is not None and _running(pid)
        if left:
            os.kill(pid, signal.SIGKILL)
    assert not left, "the retired worker outlived the cluster"
