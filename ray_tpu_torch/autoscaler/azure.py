"""Azure VM node provider.

Reference analogue: autoscaler/_private/_azure/node_provider.py (the
azure-mgmt-compute SDK, VMs tagged by cluster name). Same injected-
transport discipline as the AWS/GCE providers: pass ``compute_client``
(duck-typed: ``list_vms`` / ``create_vm`` / ``delete_vm``, shaped like
a thin wrapper over azure.mgmt.compute) for offline use and tests; the
real SDK is imported lazily and gated on presence.

The port's copy of the JAX package's ``ray_tpu/autoscaler/azure.py``
(imports renamed to ``ray_tpu_torch``, env vars ``RTPU_*`` to
``RTT_*``).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

TAG_CLUSTER = "ray-tpu-torch-cluster-name"


def _default_client(subscription_id: str, resource_group: str):
    try:
        import azure.mgmt.compute  # noqa: F401 — deployment-only
    except ImportError as e:
        raise RuntimeError(
            "Azure provider requires azure-mgmt-compute (not installed) "
            "or an injected compute_client") from e
    raise RuntimeError(
        "wrap azure.mgmt.compute in the list_vms/create_vm/delete_vm "
        "surface and inject it as compute_client")


class AzureNodeProvider(NodeProvider):
    """Nodes are Azure VMs tagged with the cluster name."""

    def __init__(self, provider_config: Dict[str, Any],
                 compute_client=None):
        super().__init__(provider_config)
        self.subscription_id = provider_config.get("subscription_id", "")
        self.resource_group = provider_config.get("resource_group", "")
        self.location = provider_config.get("location", "westus2")
        self.cluster_name = provider_config.get("cluster_name", "rtt")
        self.compute = compute_client or _default_client(
            self.subscription_id, self.resource_group)
        self._lock = threading.Lock()
        self._created_cfg: Dict[str, Dict[str, Any]] = {}

    def non_terminated_nodes(self) -> List[str]:
        ids = []
        for vm in self.compute.list_vms(self.resource_group):
            tags = vm.get("tags") or {}
            if tags.get(TAG_CLUSTER) != self.cluster_name:
                continue
            if vm.get("provisioning_state") in ("Deleting", "Failed"):
                continue
            ids.append(vm["name"])
        return ids

    def create_node(self, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        created = []
        for _ in range(count):
            name = f"{self.cluster_name}-{uuid.uuid4().hex[:8]}"
            spec = {
                "name": name,
                "location": self.location,
                "vm_size": node_config.get("vm_size", "Standard_D2s_v3"),
                "image": node_config.get("image", {}),
                "tags": {TAG_CLUSTER: self.cluster_name,
                         "ray-tpu-torch-node-kind":
                             node_config.get("node_kind", "worker")},
            }
            for passthrough in ("admin_username", "ssh_public_key",
                                "subnet_id", "user_data"):
                if node_config.get(passthrough) is not None:
                    spec[passthrough] = node_config[passthrough]
            self.compute.create_vm(self.resource_group, spec)
            created.append(name)
        with self._lock:
            for n in created:
                self._created_cfg[n] = dict(node_config)
        return created

    def terminate_node(self, node_id: str):
        self.compute.delete_vm(self.resource_group, node_id)
        with self._lock:
            self._created_cfg.pop(node_id, None)

    def node_resources(self, node_id: str) -> Dict[str, float]:
        cfg = self._created_cfg.get(node_id, {})
        if cfg.get("resources"):
            return dict(cfg["resources"])
        vm_size = cfg.get("vm_size", "Standard_D2s_v3")
        # Standard_D<N>s_v3-style names carry the vCPU count in the
        # FIRST digit run ("D8s_v3" -> 8, not 83)
        import re
        m = re.search(r"\d+", vm_size.split("_", 1)[-1])
        return {"CPU": float(m.group(0)) if m else 2.0}

    def external_ip(self, node_id: str) -> Optional[str]:
        for vm in self.compute.list_vms(self.resource_group):
            if vm["name"] == node_id:
                return vm.get("public_ip") or vm.get("private_ip")
        return None
