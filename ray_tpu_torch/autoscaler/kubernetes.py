"""Kubernetes node provider + RayCluster-style operator reconcile.

Reference analogue: the KubeRay operator (ray-operator's RayCluster
CRD: head group + worker groups with replicas, reconciled against pod
state) and autoscaler/_private/kuberay/node_provider.py (nodes are
pods; the autoscaler scales worker-group ``replicas``). The k8s API
client is injected (duck-typed ``list_pods`` / ``create_pod`` /
``delete_pod`` — a thin wrapper over the core-v1 surface) so the
provider and the reconcile loop run fully offline in tests; the real
``kubernetes`` SDK is gated on presence, like the other cloud SDKs.

The port's copy of the JAX package's
``ray_tpu/autoscaler/kubernetes.py`` (imports renamed to
``ray_tpu_torch``, env vars ``RTPU_*`` to ``RTT_*``).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

LABEL_CLUSTER = "ray-tpu-torch.io/cluster"
LABEL_GROUP = "ray-tpu-torch.io/group"


def _default_client(namespace: str):
    try:
        import kubernetes  # noqa: F401 — deployment-only
    except ImportError as e:
        raise RuntimeError(
            "Kubernetes provider requires the kubernetes SDK (not "
            "installed) or an injected k8s_client") from e
    raise RuntimeError(
        "wrap kubernetes.client.CoreV1Api in the list_pods/create_pod/"
        "delete_pod surface and inject it as k8s_client")


class KubernetesNodeProvider(NodeProvider):
    """Nodes are pods labeled with the cluster name + group."""

    def __init__(self, provider_config: Dict[str, Any], k8s_client=None):
        super().__init__(provider_config)
        self.namespace = provider_config.get("namespace", "default")
        self.cluster_name = provider_config.get("cluster_name", "rtt")
        self.k8s = k8s_client or _default_client(self.namespace)
        self._lock = threading.Lock()
        self._created_cfg: Dict[str, Dict[str, Any]] = {}

    def non_terminated_nodes(self) -> List[str]:
        names = []
        for pod in self.k8s.list_pods(self.namespace):
            labels = pod.get("labels") or {}
            if labels.get(LABEL_CLUSTER) != self.cluster_name:
                continue
            if pod.get("phase") in ("Succeeded", "Failed"):
                continue
            names.append(pod["name"])
        return names

    def create_node(self, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        created = []
        group = node_config.get("group", "worker")
        for _ in range(count):
            name = (f"{self.cluster_name}-{group}-"
                    f"{uuid.uuid4().hex[:8]}")
            pod = {
                "name": name,
                "labels": {LABEL_CLUSTER: self.cluster_name,
                           LABEL_GROUP: group},
                "image": node_config.get(
                    "image", "ray-tpu-torch:latest"),
                "resources": node_config.get("resources") or {},
                "command": node_config.get("command"),
                "env": node_config.get("env") or {},
            }
            self.k8s.create_pod(self.namespace, pod)
            created.append(name)
        with self._lock:
            for n in created:
                self._created_cfg[n] = dict(node_config)
        return created

    def terminate_node(self, node_id: str):
        self.k8s.delete_pod(self.namespace, node_id)
        with self._lock:
            self._created_cfg.pop(node_id, None)

    def node_resources(self, node_id: str) -> Dict[str, float]:
        cfg = self._created_cfg.get(node_id, {})
        res = dict(cfg.get("resources") or {})
        return {k: float(v) for k, v in res.items()} or {"CPU": 1.0}


class RayClusterOperator:
    """One reconcile pass of a RayCluster-style spec (the KubeRay
    controller role): ensure exactly one head pod and each worker
    group's ``replicas`` pods, deleting strays of removed groups.

    Spec shape (the RayCluster CRD essentials)::

        {"head": {"image": ..., "resources": {...}},
         "worker_groups": [
             {"name": "cpu", "replicas": 2, "image": ..., ...}]}
    """

    def __init__(self, provider: KubernetesNodeProvider):
        self.provider = provider

    def _pods_by_group(self) -> Dict[str, List[str]]:
        by_group: Dict[str, List[str]] = {}
        for pod in self.provider.k8s.list_pods(self.provider.namespace):
            labels = pod.get("labels") or {}
            if labels.get(LABEL_CLUSTER) != self.provider.cluster_name:
                continue
            if pod.get("phase") in ("Succeeded", "Failed"):
                continue
            by_group.setdefault(labels.get(LABEL_GROUP, ""),
                                []).append(pod["name"])
        return by_group

    def reconcile(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        """Drive pod state toward the spec; returns a summary of the
        actions taken (idempotent: a second pass is a no-op)."""
        actions = {"created": [], "deleted": []}
        by_group = self._pods_by_group()

        want: Dict[str, Dict[str, Any]] = {}
        head = dict(spec.get("head") or {})
        head.setdefault("replicas", 1)
        want["head"] = head
        for wg in spec.get("worker_groups") or []:
            want[wg.get("name", "worker")] = dict(wg)

        for group, cfg in want.items():
            have = by_group.get(group, [])
            target = int(cfg.get("replicas", 1))
            for _ in range(max(0, target - len(have))):
                (name,) = self.provider.create_node(
                    {**cfg, "group": group}, 1)
                actions["created"].append(name)
            for name in have[target:]:  # scale down
                self.provider.terminate_node(name)
                actions["deleted"].append(name)
        for group, pods in by_group.items():  # removed groups
            if group not in want:
                for name in pods:
                    self.provider.terminate_node(name)
                    actions["deleted"].append(name)
        return actions
