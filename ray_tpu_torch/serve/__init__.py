"""ray_tpu_torch.serve — online model serving on actors.

Copy of ``ray_tpu/serve/__init__.py``: the control plane (controller,
router, replica, HTTP proxy with SSE, LongPoll, autoscaling, batching)
over the port's runtime. Reference analogue: serve/. A replica that
runs on a GPU asks for it the way every actor does:
``ray_actor_options={"num_gpus": 1}``.
"""

from ray_tpu_torch.serve.api import (Application, Deployment, delete,
                                     delete_application, deployment,
                                     get_deployment_handle, list_applications,
                                     metrics, run, shutdown, start, status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.exceptions import (BatchSubmitTimeoutError,
                                            ReplicaOverloadedError)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.ingress import APIRouter, ingress
from ray_tpu_torch.serve._private.autoscaling import AutoscalingConfig

__all__ = [
    "deployment", "run", "start", "shutdown", "status", "metrics",
    "delete", "delete_application", "list_applications",
    "get_deployment_handle", "Deployment", "Application",
    "DeploymentHandle", "batch", "AutoscalingConfig",
    "APIRouter", "ingress",
    "ReplicaOverloadedError", "BatchSubmitTimeoutError",
    "llm",
]


def __getattr__(name):
    # serve.llm loads lazily: the LLM engine (docs/LLM_SERVING.md)
    # pulls in torch, which plain serve users shouldn't pay for
    if name == "llm":
        import importlib
        return importlib.import_module("ray_tpu_torch.serve.llm")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
