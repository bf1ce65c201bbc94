"""NodeProvider plugin interface + fake provider for tests.

Reference analogue: autoscaler/node_provider.py (ABC) and
autoscaler/_private/fake_multi_node/node_provider.py:237
(FakeMultiNodeProvider — full autoscaler logic with no cloud: worker
"nodes" are extra raylet processes on this machine sharing the head's
GCS, exactly like the Cluster test fixture).

Copied from the JAX package's ``ray_tpu/autoscaler/node_provider.py``.
Differences:

* A node type's ``resources`` may hold ``"GPU"``: the fake node's raylet
  grants that many cards by index, as ``Cluster.add_node(num_gpus=k)``
  does. A node type without ``"GPU"`` is given ``"GPU": 0``, so a fake
  node on a machine with cards never detects them on its own.
* ``terminate_node`` lets the raylet reap its workers (SIGTERM, then up
  to ``_REAP_S``, as ``Cluster.remove_node``) before it kills it, so a
  reaped GPU node leaves no worker behind.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

# a raylet reaps its workers for up to 10 s on SIGTERM
_REAP_S = 15.0


class NodeProvider:
    """Cloud-agnostic node lifecycle interface."""

    def __init__(self, provider_config: Dict[str, Any]):
        self.provider_config = provider_config

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str):
        raise NotImplementedError

    def node_resources(self, node_id: str) -> Dict[str, float]:
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Launches worker raylets in-process against the running head."""

    def __init__(self, provider_config: Dict[str, Any]):
        super().__init__(provider_config)
        from ray_tpu_torch._private import node as node_mod
        self._node_mod = node_mod
        self.session_dir = provider_config["session_dir"]
        self.gcs_address = provider_config["gcs_address"]
        self._nodes: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def create_node(self, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        created = []
        resources = {"GPU": 0.0,
                     **(node_config.get("resources") or {"CPU": 1})}
        for _ in range(count):
            info = self._node_mod.add_node(
                self.session_dir, self.gcs_address,
                resources=dict(resources),
                object_store_memory=node_config.get(
                    "object_store_memory"))
            info["resources"] = dict(resources)
            nid = info["node_id"]
            with self._lock:
                self._nodes[nid] = info
            created.append(nid)
        return created

    def terminate_node(self, node_id: str):
        with self._lock:
            info = self._nodes.pop(node_id, None)
        if info is None:
            return
        proc = info.get("proc")
        if proc is not None:
            try:
                proc.terminate()
                proc.wait(timeout=_REAP_S)
            except Exception:
                try:
                    proc.kill()
                    proc.wait(timeout=10)
                except Exception:
                    pass

    def node_resources(self, node_id: str) -> Dict[str, float]:
        with self._lock:
            info = self._nodes.get(node_id) or {}
        return dict(info.get("resources") or {})

    def node_pid(self, node_id: str) -> Optional[int]:
        """OS pid of the node's raylet process (launcher teardown uses
        this; the process layout stays private to the provider)."""
        with self._lock:
            info = self._nodes.get(node_id) or {}
        proc = info.get("proc")
        return proc.pid if proc is not None else None
