"""FastAPI-style HTTP ingress for Serve deployments.

Reference analogue: serve/api.py ``@serve.ingress(app)`` — a FastAPI
app mounted on a deployment class so one replica serves the app's whole
route table, with path/query/body params bound to endpoint arguments.

Copy of ``ray_tpu/serve/ingress.py``: no web-framework dependency.
``APIRouter`` is a dependency-free router whose route objects expose the same
``path``/``methods``/``endpoint`` surface FastAPI's ``app.routes``
does — so ``ingress()`` accepts either an ``APIRouter`` or a real
FastAPI/Starlette app (duck-typed, endpoints invoked directly) when
one is installed. Dispatch rides the existing proxy contract:
``pass_http_path`` delivers the sub-path and ``pass_http_method`` the
HTTP verb; no second HTTP stack inside replicas.
"""

from __future__ import annotations

import inspect
import re
from typing import Any, Callable, Dict, List, Optional, Tuple


class _Route:
    """Same attribute shape as fastapi.routing.APIRoute."""

    def __init__(self, path: str, methods: List[str], endpoint: Callable):
        self.path = path
        self.methods = set(m.upper() for m in methods)
        self.endpoint = endpoint
        # /items/{item_id} -> ^/items/(?P<item_id>[^/]+)$
        self._regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path) + "$")

    def match(self, path: str) -> Optional[Dict[str, str]]:
        m = self._regex.match(path)
        return m.groupdict() if m else None


class APIRouter:
    """Minimal FastAPI-surface router: ``@app.get("/x/{y}")`` etc.
    Decorating methods inside a class body registers the unbound
    function; ``ingress()`` binds ``self`` at dispatch time (exactly
    the reference's usage pattern)."""

    def __init__(self):
        self.routes: List[_Route] = []

    def _register(self, path: str, methods: List[str]):
        def deco(fn):
            self.routes.append(_Route(path, methods, fn))
            return fn
        return deco

    def get(self, path: str):
        return self._register(path, ["GET"])

    def post(self, path: str):
        return self._register(path, ["POST"])

    def put(self, path: str):
        return self._register(path, ["PUT"])

    def delete(self, path: str):
        return self._register(path, ["DELETE"])

    def route(self, path: str, methods: List[str]):
        return self._register(path, methods)


def _coerce(value: str, annotation: Any) -> Any:
    """Best-effort path/query param coercion from the annotation
    (FastAPI does this via pydantic; int/float/bool cover the common
    cases here)."""
    if annotation in (int, float):
        try:
            return annotation(value)
        except ValueError:
            return value
    if annotation is bool:
        return value.lower() in ("1", "true", "yes")
    return value


def _dispatch(instance, routes, path: str, method: str, payload: Any):
    matched_path = False
    for route in routes:
        params = route.match(path)
        if params is None:
            continue
        matched_path = True
        if method.upper() not in route.methods:
            continue
        fn = route.endpoint
        sig = inspect.signature(fn)
        kwargs: Dict[str, Any] = {}
        args: Tuple = ()
        names = list(sig.parameters)
        if names and names[0] == "self":
            args = (instance,)
            names = names[1:]
        for name in names:
            p = sig.parameters[name]
            if name in params:
                kwargs[name] = _coerce(params[name], p.annotation)
        # query-string payloads arrive as a dict: spread matching keys
        if isinstance(payload, dict):
            for name in names:
                if name not in kwargs and name in payload:
                    kwargs[name] = payload[name]
        # remaining un-filled required param takes the whole body (the
        # FastAPI "body parameter" role) — dict bodies included: a JSON
        # object whose keys didn't fill params by name is still the
        # body (query-style dicts fill everything and leave no leftover)
        leftovers = [n for n in names if n not in kwargs
                     and sig.parameters[n].default is inspect.Parameter.empty]
        if leftovers and payload is not None:
            kwargs[leftovers[0]] = payload
        return fn(*args, **kwargs)
    if matched_path:
        raise LookupError(f"405: method {method} not allowed for {path}")
    raise LookupError(f"404: no ingress route matches {path!r}")


def ingress(app):
    """``@serve.ingress(app)`` — mount an ``APIRouter`` (or FastAPI
    app) on a deployment class. The returned class answers the proxy's
    ``__call__(payload, __serve_path__, __serve_method__)`` contract by
    routing into the app's endpoints with ``self`` bound."""
    def deco(cls):
        # routes are read HERE, not when ingress(app) evaluates:
        # decorator expressions run before the class body, so the
        # @app.get registrations inside the body haven't happened yet
        # at that point. Real FastAPI apps nest non-API routes (docs,
        # openapi); keep only ones with the endpoint surface,
        # normalized into _Route (FastAPI's APIRoute carries the same
        # path/methods/endpoint triple).
        routes = [r if isinstance(r, _Route)
                  else _Route(r.path,
                              list(getattr(r, "methods", ["GET"])),
                              r.endpoint)
                  for r in getattr(app, "routes", ())
                  if hasattr(r, "endpoint") and hasattr(r, "path")]
        class Ingress(cls):
            __serve_pass_http_path__ = True
            __serve_pass_http_method__ = True

            def __call__(self, payload: Any = None,
                         __serve_path__: str = "/",
                         __serve_method__: str = "GET"):
                try:
                    return _dispatch(self, routes, __serve_path__,
                                     __serve_method__, payload)
                except LookupError as e:
                    # routing misses travel as a structured result (the
                    # proxy maps it to the HTTP status) — NOT as an
                    # exception string the proxy would have to sniff
                    msg = str(e)
                    return {"__serve_http_status__":
                            int(msg[:3]) if msg[:3].isdigit() else 500,
                            "error": msg}

        Ingress.__name__ = cls.__name__
        Ingress.__qualname__ = cls.__qualname__
        Ingress.__doc__ = cls.__doc__
        return Ingress

    return deco
