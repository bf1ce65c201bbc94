"""GCE GPU-VM node provider (Compute Engine instances).

Reference analogue: autoscaler/_private/gcp/node_provider.py (GCPCompute
instances). Talks to the Compute Engine v1 API (projects.zones.instances)
— each "node" is one VM whose machine type carries its GPUs (the
accelerator-optimized A2/A3/A4 families: ``a3-highgpu-8g`` is one host
with 8 H100s), the granularity at which a multi-GPU host is placed.

The port's counterpart of the JAX package's
``ray_tpu/autoscaler/gcp_tpu.py`` (queued TPU-VM slices), kept in its
shape: the HTTP transport is injected (``api_client``) so the provider
logic is fully testable offline; the default client authenticates via
the GCE metadata server token (the standard in-cluster path); node ids
are prefixed with the cluster name; node configs are remembered for
``node_resources``.
"""

from __future__ import annotations

import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

# vCPUs of each GCE machine type with attached GPUs whose name ends in
# ``-<N>g`` (N = its GPU count), from Compute Engine's "GPU machine
# types" page (cloud.google.com/compute/docs/gpus) and its
# accelerator-optimized machine family page
# (cloud.google.com/compute/docs/accelerator-optimized-machines)
MACHINE_VCPUS: Dict[str, int] = {
    "a2-highgpu-1g": 12, "a2-highgpu-2g": 24, "a2-highgpu-4g": 48,
    "a2-highgpu-8g": 96, "a2-megagpu-16g": 96,
    "a2-ultragpu-1g": 12, "a2-ultragpu-2g": 24, "a2-ultragpu-4g": 48,
    "a2-ultragpu-8g": 96,
    "a3-highgpu-1g": 26, "a3-highgpu-2g": 52, "a3-highgpu-4g": 104,
    "a3-highgpu-8g": 208, "a3-megagpu-8g": 208, "a3-edgegpu-8g": 208,
    "a3-ultragpu-8g": 224,
    "a4-highgpu-8g": 224,
}

# the instance states that still hold (or are about to hold) a machine
_LIVE_STATES = ("PROVISIONING", "STAGING", "RUNNING", "REPAIRING")

_LABEL = "ray-tpu-torch-cluster"


def machine_resources(machine_type: str) -> Dict[str, float]:
    """``{"GPU": N, "CPU": vCPUs}`` of a machine type in the table;
    ``{"GPU": 0.0}`` for any other."""
    m = re.search(r"-(\d+)g$", machine_type or "")
    if m is None or machine_type not in MACHINE_VCPUS:
        return {"GPU": 0.0}
    return {"GPU": float(m.group(1)),
            "CPU": float(MACHINE_VCPUS[machine_type])}


class ComputeApiClient:
    """Minimal Compute Engine v1 REST transport (metadata-server auth)."""

    BASE = "https://compute.googleapis.com/compute/v1"

    def __init__(self, project: str, zone: str):
        self.project = project
        self.zone = zone
        self._token: Optional[str] = None
        self._token_expiry = 0.0

    def _auth_header(self) -> Dict[str, str]:
        import json
        import urllib.request
        if self._token is None or time.time() > self._token_expiry - 60:
            req = urllib.request.Request(
                "http://metadata.google.internal/computeMetadata/v1/"
                "instance/service-accounts/default/token",
                headers={"Metadata-Flavor": "Google"})
            data = json.loads(urllib.request.urlopen(
                req, timeout=10).read())
            self._token = data["access_token"]
            self._token_expiry = time.time() + data.get("expires_in", 300)
        return {"Authorization": f"Bearer {self._token}"}

    def _url(self, path: str) -> str:
        return (f"{self.BASE}/projects/{self.project}/zones/"
                f"{self.zone}/{path}")

    def request(self, method: str, path: str,
                body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        import json
        import urllib.request
        req = urllib.request.Request(
            self._url(path), method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **self._auth_header()})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())


class GCPGPUNodeProvider(NodeProvider):
    """Nodes are Compute Engine instances with GPUs; node ids are the
    instance names."""

    def __init__(self, provider_config: Dict[str, Any],
                 api_client=None):
        super().__init__(provider_config)
        self.project = provider_config.get("project_id", "")
        self.zone = provider_config.get("availability_zone",
                                        provider_config.get("zone", ""))
        self.cluster_name = provider_config.get("cluster_name", "rtt")
        self.api = api_client or ComputeApiClient(self.project, self.zone)
        self._lock = threading.Lock()
        # node id -> node_config used at creation (for node_resources)
        self._created_cfg: Dict[str, Dict[str, Any]] = {}

    # ---- NodeProvider API ----

    def non_terminated_nodes(self) -> List[str]:
        out = self.api.request(
            "GET", f"instances?filter=labels.{_LABEL}%3D{self.cluster_name}")
        ids = []
        for inst in out.get("items", []):
            name = inst.get("name", "")
            if not name.startswith(f"{self.cluster_name}-"):
                continue
            if inst.get("status", "") in _LIVE_STATES:
                ids.append(name)
        return ids

    def create_node(self, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        created = []
        machine = node_config.get("machineType", "a3-highgpu-8g")
        image = node_config.get(
            "sourceImage",
            "projects/deeplearning-platform-release/global/images/"
            "family/common-cu128-ubuntu-2204-nvidia-570")
        for _ in range(count):
            name = f"{self.cluster_name}-{uuid.uuid4().hex[:8]}"
            body = {
                "name": name,
                "machineType": f"zones/{self.zone}/machineTypes/{machine}",
                "labels": {_LABEL: self.cluster_name,
                           **(node_config.get("labels") or {})},
                "disks": [{
                    "boot": True, "autoDelete": True,
                    "initializeParams": {
                        "sourceImage": image,
                        "diskSizeGb": node_config.get("diskSizeGb", 200)},
                }],
                "networkInterfaces": node_config.get(
                    "networkInterfaces",
                    [{"network": "global/networks/default"}]),
                "metadata": {"items": [
                    {"key": k, "value": v} for k, v in
                    (node_config.get("metadata") or {}).items()]},
                # a VM with GPUs cannot live-migrate
                "scheduling": {"onHostMaintenance": "TERMINATE"},
            }
            if node_config.get("spot"):
                body["scheduling"].update(
                    {"provisioningModel": "SPOT",
                     "instanceTerminationAction": "DELETE"})
            if node_config.get("reservation"):
                body["reservationAffinity"] = {
                    "consumeReservationType": "SPECIFIC_RESERVATION",
                    "key": "compute.googleapis.com/reservation-name",
                    "values": [node_config["reservation"]]}
            self.api.request("POST", "instances", body)
            with self._lock:
                self._created_cfg[name] = dict(node_config)
            created.append(name)
        return created

    def terminate_node(self, node_id: str):
        try:
            self.api.request("DELETE", f"instances/{node_id}")
        finally:
            with self._lock:
                self._created_cfg.pop(node_id, None)

    def _machine_type(self, node_id: str) -> str:
        with self._lock:
            cfg = self._created_cfg.get(node_id)
        if cfg is not None:
            return cfg.get("machineType", "a3-highgpu-8g")
        # a fresh provider instance (monitor restart, `down` in a new
        # process) recovers the machine type from the API
        try:
            inst = self.api.request("GET", f"instances/{node_id}")
            return inst.get("machineType", "").rsplit("/", 1)[-1]
        except Exception:
            return ""

    def node_resources(self, node_id: str) -> Dict[str, float]:
        return machine_resources(self._machine_type(node_id))

    def node_state(self, node_id: str) -> str:
        out = self.api.request("GET", f"instances/{node_id}")
        return out.get("status", "UNKNOWN")
