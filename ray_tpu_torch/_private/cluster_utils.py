"""In-process multi-node test cluster.

Reference analogue: python/ray/cluster_utils.py (Cluster:99 / add_node:165) —
multiple raylets run as separate processes on one machine sharing one GCS;
this is how multi-node behavior (spillback, PGs, object transfer, node death)
is tested without a real cluster (SURVEY.md §4).

Copied from the JAX package's ``ray_tpu/_private/cluster_utils.py``.
Differences:

* ``num_gpus`` is a node's ``"GPU"`` count, granted by index as on any
  raylet: a node given ``num_gpus=1`` grants index 0 of the devices it
  inherits (``CUDA_VISIBLE_DEVICES``), one given ``num_gpus=0`` grants
  none. A node given no ``num_gpus`` detects the host's cards
  (``raylet.detect_gpus``), so two such raylets on one box both claim
  them, as Ray's ``cluster_utils`` does: pass ``num_gpus`` explicitly.
* ``num_tpus`` raises ``ValueError`` naming ``num_gpus``: the port's
  runtime has no TPU resource (Tune's ``"TPU"`` raises the same way).
* ``shutdown`` lets every raylet reap its workers (SIGTERM, up to 10 s)
  before it kills one, then waits for them all: it leaves no raylet,
  worker or store segment behind.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import node as node_mod
from ray_tpu_torch.common.config import SystemConfig

# a raylet reaps its workers for up to 10 s on SIGTERM
_REAP_S = 15.0


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict[str, Any]] = None,
                 connect: bool = False,
                 _system_config: Optional[Dict[str, Any]] = None):
        self.config = SystemConfig().apply_env_overrides()
        if _system_config:
            self.config.update(_system_config)
        head_res = self._res(head_node_args or {})   # raises before starting
        self.session_dir = node_mod.new_session_dir()
        self.head: Optional[node_mod.NodeProcesses] = None
        self.worker_nodes: List[Dict[str, Any]] = []
        self.gcs_address = ""
        if initialize_head:
            args = head_node_args or {}
            self.head = node_mod.start_head(
                self.config,
                resources=head_res,
                labels=args.get("labels"),
                object_store_memory=args.get("object_store_memory"),
                session_dir=self.session_dir)
            self.gcs_address = self.head.gcs_address
        if connect:
            self.connect()

    @staticmethod
    def _res(args: Dict[str, Any]) -> Dict[str, float]:
        if "num_tpus" in args:
            raise ValueError(
                "the ray_tpu_torch runtime has no TPU resource: give a "
                "node cards with num_gpus")
        res = dict(args.get("resources", {}))
        if "num_cpus" in args:
            res["CPU"] = float(args["num_cpus"])
        if "num_gpus" in args:
            res["GPU"] = float(args["num_gpus"])
        return res

    @property
    def address(self) -> str:
        return self.gcs_address

    def add_node(self, **args) -> Dict[str, Any]:
        info = node_mod.add_node(
            self.session_dir, self.gcs_address,
            resources=self._res(args),
            labels=args.get("labels"),
            object_store_memory=args.get("object_store_memory"),
            env_overrides=args.get("env_overrides"))
        self.worker_nodes.append(info)
        return info

    def add_nodes(self, count: int, **args) -> List[Dict[str, Any]]:
        """Spawn ``count`` identical raylets concurrently (scale tests:
        the 50-node simulated cluster comes up in one wave instead of
        paying a serial ready-wait per node)."""
        from ray_tpu_torch.common.ids import NodeID
        res = self._res(args)
        procs = []
        for _ in range(count):
            node_id = NodeID.from_random().hex()
            proc = node_mod.start_raylet(
                self.session_dir, self.gcs_address, node_id,
                res, args.get("labels") or {}, is_head=False,
                object_store_memory=args.get("object_store_memory"),
                env_overrides=args.get("env_overrides"))
            procs.append((node_id, proc))
        infos = []
        for node_id, proc in procs:
            info = json.loads(node_mod._wait_file(
                os.path.join(self.session_dir,
                             f"raylet_{node_id[:8]}.json"),
                timeout=120.0))
            info["proc"] = proc
            info["node_id"] = node_id
            self.worker_nodes.append(info)
            infos.append(info)
        return infos

    def preempt_node(self, info: Dict[str, Any],
                     grace_s: Optional[float] = None) -> Dict[str, Any]:
        """Deliver a preemption notice to a worker node. With a custom
        ``grace_s`` the notice rides the GCS ``preempt_node`` RPC;
        otherwise SIGUSR2 hits the raylet directly (the spot-VM path).
        The node drains (stops taking work, lets in-flight work finish,
        signals trainers to checkpoint) and then exits — it is NOT
        removed from ``worker_nodes`` here; the GCS marks it dead when
        the drain completes."""
        if grace_s is None:
            node_mod.preempt_raylet(info["proc"])
            return {"draining": True}
        from ray_tpu_torch._private import worker as wmod
        w = wmod.global_worker()
        return w.call_sync(w.gcs, "preempt_node", {
            "node_id": info["node_id"], "grace_s": grace_s})

    def remove_node(self, info: Dict[str, Any], allow_graceful: bool = False):
        """Take a node out. Graceful: the raylet reaps its workers and
        unlinks its segment. Not graceful: the raylet dies at once (a
        lost host); its workers notice it is gone and exit."""
        proc = info["proc"]
        if allow_graceful:
            proc.terminate()
        else:
            proc.kill()
        try:
            proc.wait(timeout=_REAP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        if not allow_graceful and info.get("store_path"):
            # SIGKILLed raylet can't unlink its own shm segment
            try:
                os.unlink(info["store_path"])
            except OSError:
                pass
        if info in self.worker_nodes:
            self.worker_nodes.remove(info)

    def connect(self, namespace: str = ""):
        import ray_tpu_torch
        os.environ["RTT_SESSION_DIR"] = self.session_dir
        ray_tpu_torch.init(address=self.gcs_address, namespace=namespace)

    def wait_for_nodes(self, timeout: float = 30.0):
        import ray_tpu_torch
        expected = 1 + len(self.worker_nodes) if self.head else \
            len(self.worker_nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
            if len(alive) >= expected:
                return
            time.sleep(0.1)
        raise TimeoutError("nodes did not come up")

    def shutdown(self):
        import ray_tpu_torch
        ray_tpu_torch.shutdown()
        if os.environ.get("RTT_SESSION_DIR") == self.session_dir:
            os.environ.pop("RTT_SESSION_DIR", None)
        # every raylet reaps its own workers on SIGTERM: signal them all
        # first, so the reaping runs in parallel, then wait
        procs = [info["proc"] for info in self.worker_nodes]
        if self.head is not None:
            procs += [self.head.raylet_proc]
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + _REAP_S
        for proc in procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        for info in self.worker_nodes:
            if info.get("store_path"):
                try:
                    os.unlink(info["store_path"])
                except OSError:
                    pass
        self.worker_nodes = []
        if self.head is not None:
            self.head.kill_all()
            self.head = None
