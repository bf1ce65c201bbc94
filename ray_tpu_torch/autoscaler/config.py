"""Cluster YAML config: schema, defaults, validation.

Reference analogue: autoscaler/_private/util.py (prepare_config,
validate_config against ray-schema.json) and the cluster.yaml format
(cluster_name, provider, available_node_types, head_node_type...).

Copied from the JAX package's ``ray_tpu/autoscaler/config.py``.
Difference: provider type ``gcp_gpu`` (Compute Engine VMs with attached
GPUs, ``autoscaler/gcp_gpu.py``) stands where JAX's ``gcp_tpu`` stands;
a config naming ``gcp_tpu`` raises ``ConfigError`` naming ``gcp_gpu``.
"""

from __future__ import annotations

from typing import Any, Dict

PROVIDER_TYPES = ("fake_multinode", "gcp_gpu", "aws", "azure",
                  "kubernetes", "external")

_DEFAULTS: Dict[str, Any] = {
    "max_workers": 8,
    "idle_timeout_minutes": 5.0,
    "provider": {},
    "available_node_types": {},
    "head_node_type": None,
}


class ConfigError(ValueError):
    pass


def load_config(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return prepare_config(raw)


def prepare_config(config: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(_DEFAULTS)
    out.update(config or {})
    validate_config(out)
    # per-node-type defaults
    for name, nt in out["available_node_types"].items():
        nt.setdefault("min_workers", 0)
        nt.setdefault("max_workers", out["max_workers"])
        nt.setdefault("node_config", {})
        nt.setdefault("resources", {})
    return out


def validate_config(config: Dict[str, Any]):
    if not config.get("cluster_name"):
        raise ConfigError("cluster_name is required")
    provider = config.get("provider") or {}
    ptype = provider.get("type")
    if ptype == "gcp_tpu":
        raise ConfigError(
            "the ray_tpu_torch autoscaler has no TPU provider: use "
            "provider.type gcp_gpu (Compute Engine VMs with GPUs)")
    if ptype not in PROVIDER_TYPES:
        raise ConfigError(
            f"provider.type must be one of {PROVIDER_TYPES}, "
            f"got {ptype!r}")
    if ptype == "gcp_gpu":
        for req in ("project_id", "availability_zone"):
            if not provider.get(req):
                raise ConfigError(f"provider.{req} is required for "
                                  "gcp_gpu")
    if ptype == "aws" and not provider.get("region"):
        raise ConfigError("provider.region is required for aws")
    if ptype == "azure":
        for req in ("subscription_id", "resource_group"):
            if not provider.get(req):
                raise ConfigError(f"provider.{req} is required for azure")
    node_types = config.get("available_node_types")
    if not isinstance(node_types, dict) or not node_types:
        raise ConfigError("available_node_types must be a non-empty dict")
    for name, nt in node_types.items():
        if not isinstance(nt, dict):
            raise ConfigError(f"node type {name!r} must be a dict")
        mn = nt.get("min_workers", 0)
        mx = nt.get("max_workers", config.get("max_workers", 8))
        if mn > mx:
            raise ConfigError(
                f"node type {name!r}: min_workers {mn} > max_workers {mx}")
    head = config.get("head_node_type")
    if head is not None and head not in node_types:
        raise ConfigError(
            f"head_node_type {head!r} not in available_node_types")


def make_provider(config: Dict[str, Any], **runtime):
    """Instantiate the provider named in the config (the registry the
    reference keeps in node_provider.py _NODE_PROVIDERS)."""
    provider = dict(config["provider"])
    ptype = provider.pop("type")
    provider["cluster_name"] = config["cluster_name"]
    provider.update(runtime)
    if ptype == "fake_multinode":
        from ray_tpu_torch.autoscaler.node_provider import (
            FakeMultiNodeProvider)
        return FakeMultiNodeProvider(provider)
    if ptype == "gcp_gpu":
        from ray_tpu_torch.autoscaler.gcp_gpu import GCPGPUNodeProvider
        return GCPGPUNodeProvider(provider,
                                  api_client=runtime.get("api_client"))
    if ptype == "aws":
        from ray_tpu_torch.autoscaler.aws import AWSNodeProvider
        return AWSNodeProvider(provider,
                               ec2_client=runtime.get("ec2_client"))
    if ptype == "azure":
        from ray_tpu_torch.autoscaler.azure import AzureNodeProvider
        return AzureNodeProvider(
            provider, compute_client=runtime.get("compute_client"))
    if ptype == "kubernetes":
        from ray_tpu_torch.autoscaler.kubernetes import KubernetesNodeProvider
        return KubernetesNodeProvider(
            provider, k8s_client=runtime.get("k8s_client"))
    if ptype == "external":
        # provider.module = "pkg.mod:ClassName"
        mod_path = provider.get("module")
        if not mod_path:
            raise ConfigError("external provider requires provider.module")
        import importlib
        mod_name, cls_name = mod_path.split(":")
        cls = getattr(importlib.import_module(mod_name), cls_name)
        return cls(provider)
    raise ConfigError(f"no provider implementation for {ptype!r}")
