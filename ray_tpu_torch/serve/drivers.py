"""Driver deployments: HTTP ingress multiplexing over a deployment graph.

Copy of ``ray_tpu/serve/drivers.py``. Reference analogue:
serve/drivers.py (DAGDriver:41) — one ingress
deployment that owns a {route: sub-graph} table and dispatches requests
by path, so a single serve.run deploys a whole multi-endpoint app.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.api import deployment


class _DAGDriverImpl:
    """Dispatches on the request path to bound sub-deployments.

    ``routes`` values are DeploymentHandles by the time the replica
    constructs (serve.run converts bound deployments inside dict args).
    """

    def __init__(self, routes: Dict[str, Any], http_adapter=None):
        self.routes = {("/" + k.strip("/")) if k != "/" else "/": v
                       for k, v in routes.items()}
        # payload transform applied before dispatch (reference:
        # DAGDriver's http_adapter; see serve/http_adapters.py)
        self.http_adapter = http_adapter

    def _match(self, path: str) -> Optional[str]:
        path = "/" + path.strip("/") if path != "/" else "/"
        best, best_len = None, -1
        for prefix in self.routes:
            if (path == prefix or prefix == "/"
                    or path.startswith(prefix + "/")):
                if len(prefix) > best_len:
                    best, best_len = prefix, len(prefix)
        return best

    def __call__(self, payload: Any = None, __serve_path__: str = "/"):
        prefix = self._match(__serve_path__)
        if prefix is None:
            raise KeyError(f"no DAG route matches {__serve_path__!r}")
        if self.http_adapter is not None and payload is not None:
            payload = self.http_adapter(payload)
        handle = self.routes[prefix]
        ref = (handle.remote(payload) if payload is not None
               else handle.remote())
        return ray_tpu_torch.get(ref, timeout=60.0)

    def get_routes(self) -> Dict[str, str]:
        return {k: repr(v) for k, v in self.routes.items()}


DAGDriver = deployment(_DAGDriverImpl, name="DAGDriver",
                       pass_http_path=True)
