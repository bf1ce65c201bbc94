"""Public Serve API: @serve.deployment, serve.run, handles, status.

Copy of ``ray_tpu/serve/api.py``. Reference analogue: serve/api.py
(deployment:251, run:455) and the
Application/bind graph from python/ray/dag. Deployments are pickled
callables shipped to the controller, which reconciles replica actors;
``bind`` composes deployments by injecting DeploymentHandles for bound
upstream deployments (the deployment-graph substrate).
"""

from __future__ import annotations

import time

import cloudpickle
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import (DeploymentHandle, _get_router,
                                        _reset_router)

_DEFAULT_HTTP_PORT = 8000


class Application:
    """A bound deployment DAG rooted at the ingress deployment."""

    def __init__(self, root: "BoundDeployment"):
        self.root = root

    def _collect(self) -> List["BoundDeployment"]:
        seen: Dict[str, BoundDeployment] = {}

        def visit(node: BoundDeployment):
            if node.deployment.name in seen:
                return
            seen[node.deployment.name] = node
            for a in _iter_bindable(list(node.init_args) +
                                    list(node.init_kwargs.values())):
                a = _unwrap(a)
                if isinstance(a, BoundDeployment):
                    visit(a)
        visit(self.root)
        return list(seen.values())


def _iter_bindable(values):
    """Yield candidate bound-deployment leaves, walking one container
    level (DAGDriver takes a {route: bound} dict)."""
    for v in values:
        if isinstance(v, dict):
            yield from v.values()
        elif isinstance(v, (list, tuple)):
            yield from v
        else:
            yield v


class BoundDeployment:
    def __init__(self, deployment: "Deployment", args, kwargs):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


def _unwrap(x):
    """Applications passed as init args are their root bound node."""
    return x.root if isinstance(x, Application) else x


class Deployment:
    def __init__(self, func_or_class: Union[Callable, type],
                 name: str, config: Dict[str, Any]):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def bind(self, *args, **kwargs) -> Application:
        return Application(BoundDeployment(self, args, kwargs))

    def options(self, **kwargs) -> "Deployment":
        cfg = dict(self.config)
        name = kwargs.pop("name", self.name)
        cfg.update(kwargs)
        return Deployment(self.func_or_class, name, cfg)


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               max_concurrent_queries: int = 100,
               max_queued_requests: Optional[int] = None,
               routing_policy: Optional[str] = None,
               user_config: Optional[Any] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               route_prefix: Optional[str] = None,
               pass_http_path: bool = False,
               graceful_shutdown_timeout_s: Optional[float] = None,
               llm_roles: Optional[Dict[str, int]] = None):
    """@serve.deployment — mark a class/function as a deployment.

    ``max_queued_requests`` bounds each replica's ingress waiting room
    on top of ``max_concurrent_queries`` execution slots (default: env
    ``RTT_SERVE_MAX_QUEUED``, else 2x max_concurrent_queries); a
    request past both limits is shed with a retriable
    ``ReplicaOverloadedError`` (HTTP 503 at the proxy).
    ``routing_policy`` pins this deployment's replica selection to
    ``"p2c"`` (power-of-two-choices over reported queue depths, the
    default) or ``"round_robin"``; unset defers to ``RTT_SERVE_ROUTING``.

    ``pass_http_path=True`` makes the HTTP proxy pass the request path
    below the route prefix as a ``__serve_path__`` kwarg — the contract
    driver deployments (drivers.DAGDriver) use to multiplex routes.

    ``graceful_shutdown_timeout_s`` bounds how long a replica leaving
    service (rolling update, downscale, delete, node drain) may keep
    finishing in-flight requests after it is removed from the route
    table, before the controller kills it (default: env
    ``RTT_SERVE_GRACEFUL_SHUTDOWN_S``, else 10 s).

    ``llm_roles`` (LLM deployments) splits the replicas into prefill
    and decode pools, e.g. ``{"prefill": 1, "decode": 2}``: the
    controller assigns a role per ready replica in the route table and
    the router runs new prompts through a prefill replica before
    streaming from a decode replica, shipping the prompt's KV pages
    between them (docs/LLM_SERVING.md). Unset = every replica unified."""

    def wrap(func_or_class):
        return Deployment(
            func_or_class,
            name or func_or_class.__name__,
            {
                "num_replicas": num_replicas,
                "max_concurrent_queries": max_concurrent_queries,
                "max_queued_requests": max_queued_requests,
                "routing_policy": routing_policy,
                "user_config": user_config,
                "autoscaling_config": autoscaling_config,
                "ray_actor_options": ray_actor_options,
                "route_prefix": route_prefix,
                "graceful_shutdown_timeout_s": graceful_shutdown_timeout_s,
                "llm_roles": llm_roles,
                # @serve.ingress classes (serve/ingress.py) opt into the
                # proxy's path+method passing via class attributes
                "pass_http_path": pass_http_path or bool(getattr(
                    func_or_class, "__serve_pass_http_path__", False)),
                "pass_http_method": bool(getattr(
                    func_or_class, "__serve_pass_http_method__", False)),
            })

    return wrap if _func_or_class is None else wrap(_func_or_class)


def start(http_port: Optional[int] = _DEFAULT_HTTP_PORT,
          http_host: str = "127.0.0.1"):
    """Start (or connect to) the Serve controller; http_port=None means
    no HTTP ingress. An explicit port starts the proxy even when the
    controller already exists.

    The controller runs with ``max_restarts=-1``: when its worker dies,
    the GCS restarts it and the fresh incarnation recovers target state
    from the journal and re-adopts the live replicas (docs/SERVE_HA.md).
    ``start`` therefore tolerates a controller that exists but is
    mid-restart — it waits for the restarted incarnation instead of
    racing a doomed second create against the taken name."""
    from ray_tpu_torch._private import usage as _usage
    _usage.record_library_usage("serve")
    controller = _connect_controller(create=True, http_port=http_port)
    if http_port is not None:
        try:
            proxy = ray_tpu_torch.get_actor("SERVE_PROXY")
            ray_tpu_torch.get(proxy.ping.remote(), timeout=10.0)
        except Exception:
            from ray_tpu_torch.serve.http_proxy import HTTPProxyActor
            proxy_cls = ray_tpu_torch.remote(
                name="SERVE_PROXY", lifetime="detached",
                max_restarts=-1,
                max_concurrency=64)(HTTPProxyActor)
            proxy = proxy_cls.remote(CONTROLLER_NAME, http_host,
                                     http_port)
            ray_tpu_torch.get(proxy.ping.remote(), timeout=30.0)
    return controller


def _connect_controller(create: bool, http_port: Optional[int] = None,
                        timeout: float = 30.0):
    """Resolve a live controller handle, creating one if asked and none
    exists. A controller in RESTARTING is waited on, not replaced."""
    deadline = time.time() + timeout
    last_err: Optional[Exception] = None
    while True:
        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            ray_tpu_torch.get(controller.ping.remote(), timeout=10.0)
            return controller
        except Exception as e:
            last_err = e
        if create:
            try:
                controller_cls = ray_tpu_torch.remote(
                    name=CONTROLLER_NAME, lifetime="detached",
                    max_restarts=-1,
                    max_concurrency=32)(ServeController)
                controller = controller_cls.remote(http_port)
                ray_tpu_torch.get(controller.ping.remote(), timeout=30.0)
                return controller
            except Exception as e:
                # lost a create race or the name is held by a
                # RESTARTING incarnation — fall through and re-resolve
                last_err = e
        if time.time() >= deadline:
            raise RuntimeError(
                f"Serve controller unavailable after {timeout}s: "
                f"{type(last_err).__name__}: {last_err}")
        time.sleep(0.5)


def run(app: Union[Application, Deployment], *,
        name: str = "default",
        route_prefix: str = "/",
        http_port: Optional[int] = _DEFAULT_HTTP_PORT,
        _blocking_timeout: float = 60.0) -> DeploymentHandle:
    """Deploy an application; returns a handle to the ingress deployment
    (reference: serve.run serve/api.py:455). ``http_port=None`` runs
    handle-only (no HTTP ingress). ``name`` scopes the app: a redeploy
    replaces only deployments of the same app, so multiple applications
    coexist (reference: multi-app serve.run(name=...))."""
    if isinstance(app, Deployment):
        app = app.bind()
    controller = start(http_port=http_port)
    nodes = app._collect()
    root_name = app.root.deployment.name

    def _to_handle(v):
        u = _unwrap(v)
        if isinstance(u, BoundDeployment):
            return DeploymentHandle(u.deployment.name, controller)
        if isinstance(v, dict):
            return {k: _to_handle(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(_to_handle(x) for x in v)
        return v

    specs = []
    for node in nodes:
        dep = node.deployment
        # bound upstream deployments become handles at init time
        init_args = tuple(_to_handle(a) for a in node.init_args)
        init_kwargs = {k: _to_handle(v)
                       for k, v in node.init_kwargs.items()}
        cfg = dict(dep.config)
        cfg["name"] = dep.name
        cfg["app_name"] = name
        cfg["serialized_callable"] = cloudpickle.dumps(dep.func_or_class)
        cfg["init_args"] = init_args
        cfg["init_kwargs"] = init_kwargs
        if dep.name == root_name and not cfg.get("route_prefix"):
            cfg["route_prefix"] = route_prefix
        specs.append(cfg)
    reply = ray_tpu_torch.get(controller.deploy_application.remote(specs),
                              timeout=60.0)
    if isinstance(reply, dict) and reply.get("error"):
        raise RuntimeError(reply["error"])
    _wait_healthy(controller, [s["name"] for s in specs],
                  timeout=_blocking_timeout)
    if http_port is not None:
        # route barrier: the proxy must be on the post-deploy table
        # before run() returns, or an immediate request can match the
        # previous app's routes (and its torn-down replicas)
        try:
            proxy = ray_tpu_torch.get_actor("SERVE_PROXY")
            ray_tpu_torch.get(proxy.sync_routes.remote(), timeout=30.0)
        except ValueError:
            pass
    return DeploymentHandle(root_name, controller)


def _controller_death_cause(controller) -> Optional[str]:
    """Non-None iff the GCS says the controller actor is DEAD (not
    merely restarting) — the caller should say so instead of timing
    out with a generic 'not healthy' message."""
    try:
        from ray_tpu_torch._private.worker import global_worker
        w = global_worker()
        info = w.call_sync(w.gcs, "get_actor",
                           {"actor_id": controller._id_hex}, timeout=10)
        if info.get("state") == "DEAD":
            return info.get("death_cause") or "unknown cause"
    except Exception:
        pass
    return None


def _wait_healthy(controller, names: List[str], timeout: float):
    deadline = time.time() + timeout
    statuses: Dict[str, Any] = {}
    while time.time() < deadline:
        try:
            statuses = ray_tpu_torch.get(
                controller.get_deployment_statuses.remote(), timeout=30.0)
        except Exception as e:
            cause = _controller_death_cause(controller)
            if cause is not None:
                raise RuntimeError(
                    f"Serve controller has died and will not restart "
                    f"({cause}); deployments {names} cannot converge — "
                    f"run serve.start() / serve.run() to start a new "
                    f"controller") from e
            # transient (controller restarting): retry until deadline
            time.sleep(0.5)
            continue
        if all(statuses.get(n, {}).get("status") == "HEALTHY"
               for n in names):
            return
        time.sleep(0.2)
    cause = _controller_death_cause(controller)
    if cause is not None:
        raise RuntimeError(
            f"Serve controller has died and will not restart ({cause}); "
            f"deployments {names} cannot converge")
    raise TimeoutError(f"deployments {names} not healthy in {timeout}s: "
                       f"{statuses}")


def get_deployment_handle(name: str) -> DeploymentHandle:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return DeploymentHandle(name, controller)


def status() -> Dict[str, Any]:
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return ray_tpu_torch.get(
            controller.get_deployment_statuses.remote(), timeout=30.0)
    except Exception:
        return {}


def metrics() -> Dict[str, Any]:
    """Live per-deployment data-plane metrics (queue depth, shed
    total/rate, p99) from the controller's replica_load telemetry —
    what the dashboard serve panel and /metrics render. Empty dict
    when serve isn't running."""
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return ray_tpu_torch.get(
            controller.get_serve_metrics.remote(), timeout=30.0)
    except Exception:
        return {}


def delete(names: Union[str, List[str]]):
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    if isinstance(names, str):
        names = [names]
    ray_tpu_torch.get(controller.delete_deployments.remote(names),
                      timeout=30.0)


def delete_application(app_name: str):
    """Tear down one named application (reference: serve.delete)."""
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete_application.remote(app_name),
                      timeout=60.0)


def list_applications() -> Dict[str, List[str]]:
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return ray_tpu_torch.get(controller.list_applications.remote(),
                                 timeout=30.0)
    except Exception:
        return {}


def shutdown():
    """Tear down all deployments, the proxy, and the controller."""
    _reset_router()
    try:
        proxy = ray_tpu_torch.get_actor("SERVE_PROXY")
        try:
            ray_tpu_torch.get(proxy.shutdown.remote(), timeout=10.0)
        except Exception:
            pass
        ray_tpu_torch.kill(proxy)
    except Exception:
        pass
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        try:
            ray_tpu_torch.get(controller.shutdown.remote(), timeout=30.0)
        except Exception:
            pass
        time.sleep(0.5)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    # the controller clears its journal on a clean shutdown; if it was
    # already dead, scrub from here so a later serve.start() doesn't
    # resurrect deployments the user just tore down
    try:
        from ray_tpu_torch.serve._private import journal
        journal.clear()
    except Exception:
        pass
