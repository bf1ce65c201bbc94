"""Declarative Serve config schema + config-file deployment.

Copy of ``ray_tpu/serve/schema.py``. Reference analogue:
serve/schema.py (ServeApplicationSchema:258,
DeploymentSchema:124) and `serve deploy` (serve/scripts.py). Apps are
named by import path ("module:app" resolving to an Application or
Deployment); per-deployment overrides apply via .options before
serve.run.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field


class DeploymentSchema(BaseModel):
    name: str
    num_replicas: Optional[int] = None
    max_concurrent_queries: Optional[int] = None
    # bounded ingress waiting room + replica-selection policy
    # (docs/SERVE_DATAPLANE.md)
    max_queued_requests: Optional[int] = None
    routing_policy: Optional[str] = None
    user_config: Optional[Any] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    route_prefix: Optional[str] = None
    # drain window for a replica leaving service (docs/SERVE_HA.md)
    graceful_shutdown_timeout_s: Optional[float] = None


class ServeApplicationSchema(BaseModel):
    name: str = "default"
    import_path: str = Field(
        description="module[.sub]:attribute resolving to an Application "
                    "or Deployment")
    route_prefix: str = "/"
    deployments: List[DeploymentSchema] = Field(default_factory=list)
    args: Dict[str, Any] = Field(default_factory=dict)  # builder kwargs


class ServeDeploySchema(BaseModel):
    http_options: Dict[str, Any] = Field(default_factory=dict)
    applications: List[ServeApplicationSchema] = Field(
        default_factory=list)


def import_attr(import_path: str):
    if ":" in import_path:
        module_path, attr = import_path.split(":", 1)
    else:
        module_path, attr = import_path.rsplit(".", 1)
    module = importlib.import_module(module_path)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def build_app(schema: ServeApplicationSchema):
    """Resolve an application schema to a bound Application with
    per-deployment overrides applied."""
    from ray_tpu_torch.serve.api import Application, Deployment
    target = import_attr(schema.import_path)
    if callable(target) and not isinstance(
            target, (Application, Deployment)):
        # app builder function (reference: serve.run target builders)
        target = target(**schema.args)
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(
            f"{schema.import_path} resolved to {type(target).__name__}, "
            "expected an Application, Deployment, or builder")
    overrides = {d.name: d for d in schema.deployments}
    for node in target._collect():
        ov = overrides.get(node.deployment.name)
        if ov is None:
            continue
        cfg = {k: v for k, v in ov.model_dump().items()
               if k != "name" and v is not None}
        node.deployment.config.update(cfg)
    return target


def deploy_config(config: Dict[str, Any],
                  _blocking_timeout: float = 60.0) -> List[str]:
    """Deploy every application in a ServeDeploySchema dict (the payload
    of a config file / REST PUT). Returns the app names deployed."""
    from ray_tpu_torch.serve.api import run
    schema = ServeDeploySchema(**config)
    http_port = schema.http_options.get("port", 8000)
    deployed = []
    for app_schema in schema.applications:
        app = build_app(app_schema)
        run(app, name=app_schema.name,
            route_prefix=app_schema.route_prefix,
            http_port=http_port,
            _blocking_timeout=_blocking_timeout)
        deployed.append(app_schema.name)
    return deployed
