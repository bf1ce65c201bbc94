"""DeploymentHandle — composable client for a deployment.

Copy of ``ray_tpu/serve/handle.py``. Reference analogue:
serve/handle.py:78 (RayServeHandle). ``.remote()``
routes through the shared Router (backpressure-aware) and returns the
underlying ObjectRef; the in-flight slot is released when the ref
completes, so handle callers and the HTTP proxy share one flow-control
mechanism.

Controller HA: a handle pins the controller by ACTOR ID, and the GCS
restarts the controller under the same id (``max_restarts=-1``) — so a
handle serialized before a controller crash deserializes to a working
handle afterwards. ``.remote()`` itself never talks to the controller
once the router has a cached replica set for the deployment, so handle
traffic keeps flowing straight through a controller outage.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

_router_lock = threading.Lock()
_router = None


def _get_router(controller_handle):
    global _router
    with _router_lock:
        if _router is None:
            from ray_tpu_torch.serve._private.router import Router
            _router = Router(controller_handle)
        return _router


def _reset_router():
    global _router
    with _router_lock:
        if _router is not None:
            _router.stop()
        _router = None


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller_handle,
                 method_name: Optional[str] = None):
        self.deployment_name = deployment_name
        self._controller = controller_handle
        self._method_name = method_name

    def options(self, method_name: str) -> "DeploymentHandle":
        return DeploymentHandle(self.deployment_name, self._controller,
                                method_name)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment_name, self._controller,
                                name)

    def remote(self, *args, **kwargs):
        router = _get_router(self._controller)
        ref, release, _replica = router.assign_request(
            self.deployment_name, self._method_name or "__call__",
            args, kwargs)
        # completion callback (no value fetch, no waiter thread); if the
        # ref can't be tracked, release now rather than leak the slot
        if not ref.on_done(release):
            release()
        return ref

    def stream(self, payload=None, *, request_id=None,
               assign_timeout: float = 30.0):
        """Token streaming against an LLM deployment (serve/llm):
        returns a ``ReplicaStream`` — iterate it for incremental chunk
        dicts (``{"tokens", "text", "cursor", "done", ...}``); the
        first chunk arrives as soon as the first token is decoded, not
        when generation completes. Raises ``StreamBrokenError`` if the
        replica dies mid-stream (retry the whole request; partial
        output is never silently passed off as complete)."""
        router = _get_router(self._controller)
        return router.open_stream(self.deployment_name, payload,
                                  request_id=request_id,
                                  assign_timeout=assign_timeout)

    def __repr__(self):
        # stable across processes: the deployment version hash reprs
        # init args, and a memory-address repr would force a full
        # replica replacement on every (identical) redeploy
        return (f"DeploymentHandle({self.deployment_name!r}, "
                f"method={self._method_name!r})")

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self._controller,
                 self._method_name))
