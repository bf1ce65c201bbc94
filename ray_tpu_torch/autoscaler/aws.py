"""AWS EC2 node provider.

Reference analogue: autoscaler/_private/aws/node_provider.py (boto3
ec2 client: run_instances / describe_instances / terminate_instances,
cluster-name + node-kind tags). The client is injected the same way the
GCE provider injects its transport: pass ``ec2_client`` (anything with
the four boto3 methods used below) for offline use and tests; without
one, boto3 is imported lazily and the provider gates on its presence —
boto3 does not ship in this image, exactly like the reference gates on
its cloud SDKs.

The port's copy of the JAX package's ``ray_tpu/autoscaler/aws.py``
(imports renamed to ``ray_tpu_torch``, env vars ``RTPU_*`` to
``RTT_*``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

TAG_CLUSTER = "ray-tpu-torch-cluster-name"
TAG_KIND = "ray-tpu-torch-node-kind"


def _default_client(region: str):
    try:
        import boto3  # noqa: F401 — not in this image; deployment-only
    except ImportError as e:
        raise RuntimeError(
            "AWS provider requires boto3 (not installed) or an injected "
            "ec2_client") from e
    import boto3
    return boto3.client("ec2", region_name=region)


class AWSNodeProvider(NodeProvider):
    """Nodes are EC2 instances tagged with the cluster name."""

    def __init__(self, provider_config: Dict[str, Any], ec2_client=None):
        super().__init__(provider_config)
        self.region = provider_config.get("region", "us-west-2")
        self.cluster_name = provider_config.get("cluster_name", "rtt")
        self.ec2 = ec2_client or _default_client(self.region)
        self._lock = threading.Lock()
        self._created_cfg: Dict[str, Dict[str, Any]] = {}

    def _cluster_filter(self) -> List[Dict[str, Any]]:
        return [
            {"Name": f"tag:{TAG_CLUSTER}", "Values": [self.cluster_name]},
            {"Name": "instance-state-name",
             "Values": ["pending", "running"]},
        ]

    def non_terminated_nodes(self) -> List[str]:
        out = self.ec2.describe_instances(Filters=self._cluster_filter())
        ids = []
        for res in out.get("Reservations", []):
            for inst in res.get("Instances", []):
                ids.append(inst["InstanceId"])
        return ids

    def create_node(self, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        tags = [{"Key": TAG_CLUSTER, "Value": self.cluster_name},
                {"Key": TAG_KIND,
                 "Value": node_config.get("node_kind", "worker")}]
        params = {
            "ImageId": node_config.get("ImageId", ""),
            "InstanceType": node_config.get("InstanceType", "m5.large"),
            "MinCount": count, "MaxCount": count,
            "TagSpecifications": [{"ResourceType": "instance",
                                   "Tags": tags}],
        }
        for passthrough in ("KeyName", "SubnetId", "SecurityGroupIds",
                            "IamInstanceProfile", "UserData"):
            if node_config.get(passthrough) is not None:
                params[passthrough] = node_config[passthrough]
        out = self.ec2.run_instances(**params)
        ids = [i["InstanceId"] for i in out.get("Instances", [])]
        with self._lock:
            for i in ids:
                self._created_cfg[i] = dict(node_config)
        return ids

    def terminate_node(self, node_id: str):
        self.ec2.terminate_instances(InstanceIds=[node_id])
        with self._lock:
            self._created_cfg.pop(node_id, None)

    def node_resources(self, node_id: str) -> Dict[str, float]:
        cfg = self._created_cfg.get(node_id, {})
        if cfg.get("resources"):
            return dict(cfg["resources"])
        # conservative defaults by instance size suffix
        itype = cfg.get("InstanceType", "m5.large")
        size = itype.rsplit(".", 1)[-1]
        cpus = {"large": 2, "xlarge": 4, "2xlarge": 8, "4xlarge": 16,
                "8xlarge": 32, "12xlarge": 48, "16xlarge": 64,
                "24xlarge": 96}.get(size, 2)
        return {"CPU": float(cpus)}

    def external_ip(self, node_id: str) -> Optional[str]:
        out = self.ec2.describe_instances(InstanceIds=[node_id])
        for res in out.get("Reservations", []):
            for inst in res.get("Instances", []):
                return inst.get("PublicIpAddress") or \
                    inst.get("PrivateIpAddress")
        return None
