"""Node bootstrap: starts/owns the head and per-node processes.

Reference analogue: python/ray/_private/node.py (start_gcs_server:895,
start_raylet:928, start_head_processes:1045) + services.py. A head node runs
{GCS, raylet}; non-head nodes run {raylet}. Each service is a subprocess with
its own event loop; readiness is signaled through small files in the session
directory.

Copied from the JAX package's ``ray_tpu/_private/node.py``: the GCS and
raylet run ``ray_tpu_torch``'s own modules, sessions live under
``<tempdir>/ray_tpu_torch``, and the TPU-tunnel env handling is gone.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.common.config import SystemConfig
from ray_tpu_torch.common.ids import NodeID


def new_session_dir() -> str:
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    os.makedirs(base, exist_ok=True)
    session = os.path.join(
        base, f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}_"
              f"{uuid.uuid4().hex[:6]}")
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    return session


def _wait_file(path: str, timeout: float = 30.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                data = f.read().strip()
            if data:
                return data
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {path}")


class NodeProcesses:
    """Handles to the subprocesses this driver started (for shutdown)."""

    def __init__(self):
        self.gcs_proc: Optional[subprocess.Popen] = None
        self.raylet_proc: Optional[subprocess.Popen] = None
        self.session_dir: str = ""
        self.gcs_address: str = ""
        self.raylet_address: str = ""
        self.node_id: str = ""
        self.store_path: str = ""

    def kill_all(self):
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is not None and proc.poll() is None:
                proc.terminate()
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is not None:
                try:
                    # the raylet reaps its workers first (up to 10 s)
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    proc.kill()
        # The raylet unlinks its shm segment in its SIGTERM handler; if it had
        # to be SIGKILLed the segment would leak into /dev/shm — unlink here
        # as a fallback (idempotent).
        if self.store_path:
            try:
                os.unlink(self.store_path)
            except OSError:
                pass


def sweep_stale_segments():
    """Remove plasmax segments in /dev/shm whose creating session is gone.

    A segment is stale when no live process has it mapped (checked via
    /proc/*/maps). Sessions killed with SIGKILL can leak segments; /dev/shm is
    a fixed-size tmpfs, so leaks eventually starve every later session.
    """
    import glob
    import time as _time
    now = _time.time()
    segs = []
    for seg in glob.glob("/dev/shm/rtt_plasmax_*"):
        try:
            # skip very fresh segments: a concurrently starting raylet sits
            # between O_CREAT and mmap, so it appears in the glob but in no
            # /proc/*/maps yet
            if now - os.path.getmtime(seg) > 30.0:
                segs.append(seg)
        except OSError:
            pass
    if not segs:
        return
    mapped = set()
    for maps in glob.glob("/proc/[0-9]*/maps"):
        try:
            with open(maps) as f:
                data = f.read()
        except OSError:
            continue
        for seg in segs:
            if seg in data:
                mapped.add(seg)
    for seg in segs:
        if seg not in mapped:
            try:
                os.unlink(seg)
            except OSError:
                pass


def start_gcs(session_dir: str, config: SystemConfig,
              port: int = 0) -> subprocess.Popen:
    env = dict(os.environ)
    env["RTT_SESSION_DIR"] = session_dir
    env["RTT_GCS_PORT"] = str(port)
    env["RTT_SYSTEM_CONFIG"] = config.to_json()
    log = open(os.path.join(session_dir, "logs", "gcs.log"), "ab")
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.gcs_main"],
        env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)


def start_raylet(session_dir: str, gcs_address: str, node_id: str,
                 resources: Dict[str, float], labels: Dict[str, str],
                 is_head: bool,
                 object_store_memory: Optional[int] = None,
                 env_overrides: Optional[Dict[str, str]] = None
                 ) -> subprocess.Popen:
    env = dict(os.environ)
    if env_overrides:
        # per-node env (simulated multi-"host" clusters: a distinct
        # RTT_NODE_IP per raylet + RTT_NET_FORCE_TCP makes two local
        # raylets talk to each other exclusively over TCP)
        env.update(env_overrides)
    env["RTT_SESSION_DIR"] = session_dir
    env["RTT_GCS_ADDRESS"] = gcs_address
    env["RTT_NODE_ID"] = node_id
    env["RTT_RESOURCES"] = json.dumps(resources)
    env["RTT_LABELS"] = json.dumps(labels)
    env["RTT_IS_HEAD"] = "1" if is_head else "0"
    if object_store_memory:
        env["RTT_OBJECT_STORE_BYTES"] = str(object_store_memory)
    log = open(os.path.join(session_dir, "logs", f"raylet_{node_id[:8]}.log"),
               "ab")
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.raylet_main"],
        env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)


def start_head(config: SystemConfig,
               resources: Optional[Dict[str, float]] = None,
               labels: Optional[Dict[str, str]] = None,
               object_store_memory: Optional[int] = None,
               session_dir: Optional[str] = None) -> NodeProcesses:
    np_ = NodeProcesses()
    sweep_stale_segments()
    np_.session_dir = session_dir or new_session_dir()
    np_.gcs_proc = start_gcs(np_.session_dir, config)
    gcs_port = _wait_file(os.path.join(np_.session_dir, "gcs_port"))
    np_.gcs_address = f"127.0.0.1:{gcs_port}"
    node_id = NodeID.from_random().hex()
    np_.node_id = node_id
    np_.raylet_proc = start_raylet(np_.session_dir, np_.gcs_address, node_id,
                                   resources or {}, labels or {},
                                   is_head=True,
                                   object_store_memory=object_store_memory)
    info = _wait_file(os.path.join(np_.session_dir,
                                   f"raylet_{node_id[:8]}.json"))
    info = json.loads(info)
    np_.raylet_address = info["unix_address"]
    np_.store_path = info["store_path"]
    return np_


def preempt_raylet(proc: subprocess.Popen) -> bool:
    """Deliver a preemption notice to a raylet process the way a spot
    or maintenance notice reaches the host: SIGUSR2. The raylet drains
    gracefully for its configured grace window (see
    raylet._preempt_drain), then exits — unlike ``kill_all``, which
    models an unannounced death. Returns False if the process is gone."""
    if proc is None or proc.poll() is not None:
        return False
    try:
        proc.send_signal(signal.SIGUSR2)
        return True
    except OSError:
        return False


def add_node(session_dir: str, gcs_address: str,
             resources: Optional[Dict[str, float]] = None,
             labels: Optional[Dict[str, str]] = None,
             object_store_memory: Optional[int] = None,
             env_overrides: Optional[Dict[str, str]] = None
             ) -> Dict[str, Any]:
    node_id = NodeID.from_random().hex()
    proc = start_raylet(session_dir, gcs_address, node_id, resources or {},
                        labels or {}, is_head=False,
                        object_store_memory=object_store_memory,
                        env_overrides=env_overrides)
    info = json.loads(_wait_file(
        os.path.join(session_dir, f"raylet_{node_id[:8]}.json")))
    info["proc"] = proc
    info["node_id"] = node_id
    return info
