"""HTTP ingress — proxy actor routing HTTP requests to replicas.

Copy of ``ray_tpu/serve/http_proxy.py``. Reference analogue:
serve/_private/http_proxy.py:387 (HTTPProxyActor,
HTTPProxy.__call__:312 over uvicorn/ASGI). Here: a stdlib
ThreadingHTTPServer inside an actor; each request thread routes through
the shared backpressure-aware Router (load-aware selection + overload
retry on other replicas), so HTTP and handle traffic obey the same
``max_concurrent_queries`` flow control. A saturated deployment sheds:
when every replica is at capacity (router assign times out after
``RTT_SERVE_PROXY_ASSIGN_TIMEOUT_S``) or the overload retries exhaust,
the proxy answers a retriable 503 instead of queueing unboundedly.

Controller HA: the proxy serves every request from its CACHED route
table + replica sets — a controller outage never stops the data plane.
Synchronous refreshes degrade to the cache on failure, and the route
long-poll reconnects with backoff once the restarted controller is
back (see serve/_private/long_poll.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse


class HTTPProxyActor:
    def __init__(self, controller_name: str, host: str = "127.0.0.1",
                 port: int = 8000):
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.long_poll import LongPollClient
        from ray_tpu_torch.serve._private.router import Router
        self._controller = ray_tpu_torch.get_actor(controller_name)
        self._router = Router(self._controller)
        self._routes: Dict[str, str] = {}   # route_prefix -> deployment
        # routes update via long-poll, NOT a controller RPC per request
        self._route_poller = LongPollClient(
            self._controller, "route_table", self._on_route_update)
        self.host, self.port = host, port
        self._server: Optional[ThreadingHTTPServer] = None
        self._refresh_routes()
        self._start_server()

    def _on_route_update(self, table):
        self._pass_path = {name: bool(info.get("pass_http_path"))
                           for name, info in (table or {}).items()}
        self._pass_method = {name: bool(info.get("pass_http_method"))
                             for name, info in (table or {}).items()}
        routes = {}
        for name, info in (table or {}).items():
            prefix = info.get("route_prefix")
            if prefix:
                routes[prefix.rstrip("/") or "/"] = name
        self._routes = routes

    def _refresh_routes(self):
        """Synchronous route pull, resilient to a controller outage:
        the proxy MUST keep answering from its cached routes while the
        controller restarts (the long-poll re-delivers on recovery)."""
        import ray_tpu_torch
        try:
            _, table = ray_tpu_torch.get(
                self._controller.get_route_table.remote(), timeout=10.0)
        except Exception:
            return  # keep serving the cached table
        if table is not None:
            self._on_route_update(table)

    def _match(self, path: str):
        """Longest-prefix route match → (deployment name, matched prefix)
        or None."""
        path = path.rstrip("/") or "/"
        best, best_len, best_prefix = None, -1, "/"
        for prefix, name in self._routes.items():
            if (path == prefix or path.startswith(
                    prefix if prefix.endswith("/") else prefix + "/")
                    or prefix == "/"):
                if len(prefix) > best_len:
                    best, best_len, best_prefix = name, len(prefix), prefix
        if best is None:
            return None
        return best, best_prefix

    def _start_server(self):
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _handle(self, body: Optional[bytes]):
                import ray_tpu_torch
                # client-supplied request id: propagated proxy → router
                # → replica (reserved __rtpu_request_id__ kwarg) and
                # echoed on EVERY response, so a client can join its
                # observation with the replica's request ledger
                self._request_id = self.headers.get("X-Request-Id")
                parsed = urlparse(self.path)
                matched = proxy._match(parsed.path)
                if matched is None:
                    # maybe deployed after our last long-poll tick
                    proxy._refresh_routes()
                    matched = proxy._match(parsed.path)
                if matched is None:
                    self._respond(404, {"error":
                                        f"no route for {parsed.path}"})
                    return
                name, route_prefix = matched
                if body is not None and body:
                    try:
                        payload = json.loads(body)
                    except Exception:
                        payload = body.decode("utf-8", "replace")
                else:
                    q = parse_qs(parsed.query)
                    payload = {k: v[0] if len(v) == 1 else v
                               for k, v in q.items()} if q else None
                from ray_tpu_torch import exceptions as rexc
                from ray_tpu_torch.serve._private.router import \
                    is_overload_error
                last_err: Optional[Exception] = None
                # only idempotent requests are retried — a POST may have
                # run side effects on the replica before it died
                attempts = 4 if self.command == "GET" else 1
                try:
                    assign_timeout = float(os.environ.get(
                        "RTT_SERVE_PROXY_ASSIGN_TIMEOUT_S", 5.0))
                except ValueError:
                    assign_timeout = 5.0
                # proxy root span: everything below (route match,
                # router assign, replica, retries) nests under it, so
                # a trace's critical path attributes the full
                # proxy-observed latency; trace id = X-Request-Id when
                # the client sent one (echoed as X-Trace-Id either way)
                from ray_tpu_torch._private import tracing
                proxy_span = None
                if tracing.enabled():
                    proxy_span = tracing.Span(
                        self._request_id or tracing.new_trace_id(),
                        f"serve.proxy:{name}", kind="serve.proxy",
                        phase="transfer",
                        attrs={"path": parsed.path,
                               "method": self.command,
                               "request_id": self._request_id})
                    self._proxy_span = proxy_span  # closed in _respond
                # token streaming (serve/llm): a JSON body with
                # "stream": true — or an Accept: text/event-stream
                # header — switches this request to SSE; tokens are
                # written the moment the engine decodes them
                wants_sse = ("text/event-stream"
                             in (self.headers.get("Accept") or ""))
                if (isinstance(payload, dict) and payload.get("stream")) \
                        or (wants_sse and isinstance(payload,
                                                     (dict, type(None)))):
                    self._handle_stream(name, payload or {})
                    return
                for attempt in range(attempts):
                    try:
                        kwargs = {}
                        if getattr(proxy, "_pass_path", {}).get(name):
                            # driver deployments (DAGDriver) multiplex on
                            # the request path BELOW their route prefix
                            sub = parsed.path
                            if route_prefix != "/" and \
                                    sub.startswith(route_prefix):
                                sub = sub[len(route_prefix):] or "/"
                            kwargs["__serve_path__"] = sub
                            if getattr(proxy, "_pass_method",
                                       {}).get(name):
                                kwargs["__serve_method__"] = self.command
                        result = proxy._router.execute_request(
                            name, "__call__",
                            (payload,) if payload is not None else (),
                            kwargs, get_timeout=60.0,
                            assign_timeout=assign_timeout,
                            request_id=self._request_id,
                            trace_parent=(proxy_span.child_ctx()
                                          if proxy_span else None))
                        if isinstance(result, dict) and \
                                "__serve_http_status__" in result:
                            # structured routing miss from an ingress
                            # deployment (serve/ingress.py)
                            self._respond(
                                result["__serve_http_status__"],
                                {"error": result.get("error")})
                            return
                        self._respond(200, result)
                        return
                    except rexc.GetTimeoutError as e:
                        # the replica accepted the request but didn't
                        # answer in time — not an overload signal
                        self._respond(504, {"error": repr(e)})
                        return
                    except TimeoutError as e:
                        # router assign timed out: every replica is at
                        # max_concurrent_queries — shed with a
                        # retriable 503 instead of queueing unboundedly
                        self._respond(503, {
                            "error": f"deployment {name!r} saturated: "
                                     f"{e}",
                            "retryable": True})
                        return
                    except (rexc.ActorDiedError,
                            rexc.ActorUnavailableError) as e:
                        # routed to a replica that died (e.g. torn down by
                        # a redeploy the long-poll hasn't delivered yet):
                        # resync membership and retry
                        last_err = e
                        time.sleep(0.3 * (attempt + 1))
                        proxy._router.force_refresh()
                        proxy._refresh_routes()
                        fresh = proxy._match(parsed.path)
                        if fresh is None:
                            break
                        name, route_prefix = fresh
                    except Exception as e:
                        if is_overload_error(e):
                            # every retry landed on a full replica —
                            # bounded queues shed, the client retries
                            self._respond(503, {
                                "error": f"deployment {name!r} "
                                         f"overloaded: {e}".split(
                                             "\n")[0],
                                "retryable": True})
                            return
                        self._respond(500, {"error": repr(e)})
                        return
                if attempts == 1:
                    # non-idempotent request, NOT retried here and must
                    # not be advertised retryable — the replica may have
                    # run side effects before dying. Resync for the next
                    # request.
                    proxy._router.force_refresh()
                    proxy._refresh_routes()
                    self._respond(500, {"error": repr(last_err)})
                else:
                    # idempotent and safe to retry later (a redeploy was
                    # likely still settling)
                    self._respond(503, {"error": repr(last_err),
                                        "retryable": True})

            def _handle_stream(self, name: str, payload: dict):
                """SSE token streaming: open a stream through the
                shared router (same admission/overload behavior as
                unary), then write one ``data:`` event per token chunk
                as it lands — the client reads the first token while
                the tail is still decoding. A mid-stream replica death
                surfaces as an explicit error event, never a silently
                truncated 200."""
                import json as _json

                from ray_tpu_torch.serve.exceptions import StreamBrokenError
                try:
                    assign_timeout = float(os.environ.get(
                        "RTT_SERVE_PROXY_ASSIGN_TIMEOUT_S", 5.0))
                except ValueError:
                    assign_timeout = 5.0
                sp = getattr(self, "_proxy_span", None)
                try:
                    stream = proxy._router.open_stream(
                        name, payload, request_id=self._request_id,
                        assign_timeout=assign_timeout,
                        trace_parent=(sp.child_ctx() if sp else None))
                except TimeoutError as e:
                    self._respond(503, {"error": f"deployment {name!r} "
                                                 f"saturated: {e}",
                                        "retryable": True})
                    return
                except Exception as e:
                    if is_overload_error(e):
                        self._respond(503, {
                            "error": str(e).split("\n")[0],
                            "retryable": True})
                    else:
                        self._respond(500, {"error": repr(e)})
                    return

                def fold_usage(chunk):
                    return {k: v for k, v in chunk.items()
                            if k in ("tokens", "text", "cursor", "done",
                                     "n_tokens", "finish_reason",
                                     "ttft_s")}

                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                # no Content-Length: the body ends when the connection
                # closes (HTTP/1.1 §3.3.3) — stdlib-client friendly
                self.send_header("Connection", "close")
                if self._request_id:
                    self.send_header("X-Request-Id", self._request_id)
                if sp is not None:
                    self.send_header("X-Trace-Id", sp.trace_id)
                self.end_headers()
                status = "ok"
                try:
                    for chunk in stream:
                        self.wfile.write(
                            b"data: "
                            + _json.dumps(fold_usage(chunk)).encode()
                            + b"\n\n")
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except StreamBrokenError as e:
                    status = "error"
                    try:
                        self.wfile.write(
                            b"data: " + _json.dumps(
                                {"error": str(e), "done": True,
                                 "tokens_so_far": e.tokens_so_far}
                            ).encode() + b"\n\n")
                        self.wfile.flush()
                    except OSError:
                        pass
                except OSError:
                    # client went away: abandon generation server-side
                    status = "error"
                    stream.cancel()
                finally:
                    self.close_connection = True
                    if sp is not None:
                        self._proxy_span = None
                        sp.finish(status)

            def _respond(self, code: int, result: Any):
                sp = getattr(self, "_proxy_span", None)
                if sp is not None:
                    self._proxy_span = None
                    sp.finish("ok" if code < 400
                              else "shed" if code == 503 else "error")
                try:
                    data = json.dumps(result).encode()
                    ctype = "application/json"
                except (TypeError, ValueError):
                    data = str(result).encode()
                    ctype = "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                if getattr(self, "_request_id", None):
                    self.send_header("X-Request-Id", self._request_id)
                if sp is not None:
                    # the join key for the trace's spans even when the
                    # client sent no X-Request-Id
                    self.send_header("X-Trace-Id", sp.trace_id)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._handle(None)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self._handle(self.rfile.read(n) if n else b"")

        for attempt in range(32):
            try:
                self._server = ThreadingHTTPServer(
                    (self.host, self.port + attempt), Handler)
                self.port = self.port + attempt
                break
            except OSError:
                continue
        if self._server is None:
            raise RuntimeError("no free port for HTTP proxy")
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def sync_routes(self) -> bool:
        """Synchronously pull the current route table + replica sets —
        the deploy barrier serve.run uses so a request right after it
        returns cannot see pre-deploy routing."""
        self._refresh_routes()
        self._router.force_refresh()
        return True

    def get_port(self) -> int:
        return self.port

    def ping(self):
        return "pong"

    def shutdown(self):
        if self._server:
            self._server.shutdown()
        self._route_poller.stop()
        self._router.stop()
        return "ok"
