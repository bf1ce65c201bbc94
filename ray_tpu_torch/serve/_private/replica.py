"""Replica actor — hosts one copy of a deployment's user callable.

Copy of ``ray_tpu/serve/_private/replica.py``. Reference analogue:
serve/_private/replica.py:250 (RayServeReplica,
handle_request:494). Concurrency comes from the actor's thread pool;
user-code concurrency is gated by an execution semaphore of
``max_concurrent_queries`` slots, with a bounded waiting room of
``max_queued_requests`` on top. A request arriving past both limits is
shed immediately with a retriable ``ReplicaOverloadedError`` instead of
queueing unboundedly (the router retries it on another replica; the
HTTP proxy maps exhaustion to 503).

The replica also tracks its own load telemetry — queue depth
(executing + waiting) and an EWMA of service time — which the
controller collects into the ``replica_load`` long-poll key for
load-aware routing and autoscaling, and which piggybacks on proxy
responses via ``handle_request_with_load``.

Graceful drain: ``prepare_drain`` flips the replica into draining mode
— it finishes what it has but sheds every NEW arrival with a retriable
``ReplicaOverloadedError`` (routers holding a route table published
before the drain retry on a serving replica). The controller kills a
draining replica only once ``queue_len`` hits zero or the deployment's
``graceful_shutdown_timeout_s`` expires.

Chaos site: ``serve.replica.request`` fires per accepted request
(method = the deployment name), so a seeded schedule can SIGKILL one
replica at an exact request count (``RTT_CHAOS`` op ``kill``).

Request ids: a caller may tag a request with the reserved
``__rtpu_request_id__`` kwarg (the HTTP proxy maps the ``X-Request-Id``
header onto it). The replica strips it before user code runs, records
(id, outcome, latency) in a bounded per-replica request ledger, and
echoes it in the proxy's response envelope — the join key the game-day
reconciliation pass (``ray_tpu_torch/gameday/reconcile.py``) uses to match
client-observed outcomes against server records. On graceful shutdown
the ledger is flushed to the GCS KV so replicas retired by a rolling
update keep their half of the join.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._private import chaos, tracing
from ray_tpu_torch.serve.exceptions import ReplicaOverloadedError

# EWMA smoothing for per-request service time: heavy enough to damp
# bimodal request mixes, light enough to track a warmup->steady change
# within ~10 requests.
_EWMA_ALPHA = 0.3

# reserved kwarg carrying a client-supplied request id; stripped before
# the user callable sees kwargs
REQUEST_ID_KWARG = "__rtpu_request_id__"

# reserved kwarg carrying the router's span context ({"trace_id",
# "span_id"}); stripped before user code, parents this replica's
# queue/execute spans (docs/TRACING.md)
TRACE_CTX_KWARG = "__rtpu_trace_ctx__"


def _default_max_queued(max_concurrent_queries: int) -> int:
    env = os.environ.get("RTT_SERVE_MAX_QUEUED")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return 2 * max_concurrent_queries


def _request_log_max() -> int:
    try:
        return max(0, int(os.environ.get("RTT_SERVE_REQUEST_LOG_MAX",
                                         65536)))
    except ValueError:
        return 65536


class ReplicaActor:
    """Generic wrapper the controller instantiates as an actor."""

    def __init__(self, deployment_name: str, serialized_callable: bytes,
                 init_args: tuple, init_kwargs: dict,
                 user_config: Optional[Any] = None,
                 version: str = "",
                 max_concurrent_queries: int = 100,
                 max_queued_requests: Optional[int] = None,
                 replica_name: Optional[str] = None):
        import cloudpickle
        self.deployment_name = deployment_name
        self.version = version
        self.replica_name = replica_name or f"{deployment_name}#{os.getpid()}"
        fn_or_cls = cloudpickle.loads(serialized_callable)
        if isinstance(fn_or_cls, type):
            self.callable = fn_or_cls(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self.callable = fn_or_cls
            self._is_function = True
        self._max_concurrent = max(1, int(max_concurrent_queries))
        if max_queued_requests is None:
            max_queued_requests = _default_max_queued(self._max_concurrent)
        self._max_queued = max(0, int(max_queued_requests))
        # user code runs under this semaphore; threads past it wait in
        # the bounded "queued" room counted by admission control below
        self._exec_sem = threading.Semaphore(self._max_concurrent)
        self._draining = False
        self._ongoing = 0
        self._queued = 0
        self._ongoing_lock = threading.Lock()
        self._total_requests = 0
        self._total_errors = 0
        self._total_shed = 0
        self._latency_sum = 0.0
        self._ewma_s = 0.0
        self._have_ewma = False
        # bounded latency reservoir for tail quantiles (p99 in the
        # dashboard serve panel): last 512 service times, O(1) record
        from collections import deque
        self._lat_ring = deque(maxlen=512)
        # per-request ledger: (request_id, outcome, latency_s) for every
        # admitted/shed request — the server half of the game-day
        # reconciliation join. Bounded; overflow is flagged, not silent.
        self._request_log = deque(maxlen=_request_log_max() or 1)
        self._request_log_dropped = 0
        if user_config is not None:
            self.reconfigure(user_config)
        # bucket-prewarm hook: a callable may define __serve_prewarm__
        # (typically calling a @serve.batch method's .prewarm) so every
        # pad bucket compiles at startup instead of on the first unlucky
        # request. Failures must not kill the replica.
        if not self._is_function and hasattr(self.callable,
                                             "__serve_prewarm__"):
            try:
                self.callable.__serve_prewarm__()
            except Exception:
                import traceback
                traceback.print_exc()

    # ---- request path ----

    def handle_request(self, method_name: str, args: tuple,
                       kwargs: dict) -> Any:
        return self._execute(method_name, args, kwargs)

    def handle_request_with_load(self, method_name: str, args: tuple,
                                 kwargs: dict) -> Dict[str, Any]:
        """Proxy path: the result envelope piggybacks this replica's
        current load so the proxy's router sees queue depth at response
        latency, not at the next long-poll tick — and echoes the
        request id so the caller can correlate response to request."""
        rid = kwargs.get(REQUEST_ID_KWARG) if kwargs else None
        result = self._execute(method_name, args, kwargs)
        envelope = {"__serve_result__": result,
                    "__serve_load__": self.get_load()}
        if rid is not None:
            envelope["__serve_request_id__"] = rid
        return envelope

    def _record_request_locked(self, rid: Optional[str], outcome: str,
                               dt: float):
        """Append one ledger entry (caller holds ``_ongoing_lock``)."""
        if len(self._request_log) == self._request_log.maxlen:
            self._request_log_dropped += 1
        self._request_log.append((rid, outcome, round(dt, 6)))

    def _execute(self, method_name: str, args: tuple, kwargs: dict) -> Any:
        t0 = time.monotonic()
        t0_wall = time.time()
        rid = kwargs.pop(REQUEST_ID_KWARG, None) if kwargs else None
        tctx = kwargs.pop(TRACE_CTX_KWARG, None) if kwargs else None
        if chaos._ENGINE is not None:
            # chaos injection point: "kill" at the N-th request this
            # replica accepted (method filter = deployment name)
            chaos.hit("serve.replica.request", self.deployment_name)
        # stream-poll methods a stateful callable lists as drain-exempt
        # (serve/llm: __llm_next__) stay answerable while draining — an
        # in-flight stream must read its remaining tokens before the
        # controller's idle-kill (KV-aware drain, docs/LLM_SERVING.md)
        drain_exempt = (not self._is_function
                        and method_name in getattr(
                            self.callable, "__serve_drain_exempt__", ()))
        with self._ongoing_lock:
            in_flight = self._ongoing + self._queued
            limit = self._max_concurrent + self._max_queued
            if (self._draining and not drain_exempt) \
                    or in_flight >= limit:
                # a draining replica finishes what it has but takes no
                # new work; a full replica sheds — both retriable, so
                # the router re-routes to a replica still in the
                # published table
                self._total_shed += 1
                self._record_request_locked(rid, "shed", 0.0)
                if tctx:
                    tracing.record_span(
                        tctx["trace_id"], tracing.new_span_id(),
                        f"replica.shed:{self.replica_name}",
                        parent_span_id=tctx.get("span_id"),
                        kind="serve.replica", phase="queue",
                        start_ts=t0_wall, end_ts=time.time(),
                        status="shed")
                raise ReplicaOverloadedError(self.deployment_name,
                                             in_flight, limit)
            self._queued += 1
            self._total_requests += 1
        self._exec_sem.acquire()
        with self._ongoing_lock:
            self._queued -= 1
            self._ongoing += 1
        # replica-side spans: the bounded-ingress wait ("queue") then
        # user code ("execute"); the execute span is installed as the
        # worker's current trace ctx so tasks/actor calls the user code
        # makes nest under this request in the trace tree
        exec_span = None
        prev_trace = worker = None
        if tctx and tctx.get("trace_id"):
            t_q = time.time()
            if t_q - t0_wall > 1e-4:  # don't record empty queue waits
                tracing.record_span(
                    tctx["trace_id"], tracing.new_span_id(),
                    f"replica.queue:{self.replica_name}",
                    parent_span_id=tctx.get("span_id"),
                    kind="serve.replica", phase="queue",
                    start_ts=t0_wall, end_ts=t_q)
            exec_span = tracing.span_if(
                tctx["trace_id"], f"replica.execute:{self.replica_name}",
                parent_span_id=tctx.get("span_id"),
                kind="serve.replica", phase="execute",
                attrs={"deployment": self.deployment_name,
                       "method": method_name or "__call__"})
            if exec_span is not None:
                from ray_tpu_torch._private import worker as worker_mod
                worker = worker_mod._global_worker
                if worker is not None:
                    prev_trace = getattr(worker.task_context, "trace",
                                         None)
                    worker.task_context.trace = exec_span.trace_ctx()
        # the disagg prefill hop is an INTERNAL sub-request: the same
        # request id completes again on the decode replica, so ledger
        # it under its own outcome or the per-request reconciliation
        # join would read the pair as a duplicate completion
        outcome = ("prefill" if method_name == "__llm_prefill__"
                   else "ok")
        try:
            if self._is_function:
                target = self.callable
            else:
                target = getattr(self.callable, method_name or "__call__")
            if rid is not None and not self._is_function and getattr(
                    self.callable, "__serve_wants_request_id__", False):
                # stateful callables (serve/llm) opt back into seeing
                # the request id (per-request token ledger, spans)
                kwargs = dict(kwargs, **{REQUEST_ID_KWARG: rid})
            return target(*args, **kwargs)
        except Exception:
            outcome = "error"
            with self._ongoing_lock:
                self._total_errors += 1
            raise
        finally:
            if worker is not None:
                worker.task_context.trace = prev_trace
            if exec_span is not None:
                exec_span.finish(
                    "error" if outcome == "error" else "ok")
            self._exec_sem.release()
            dt = time.monotonic() - t0
            with self._ongoing_lock:
                self._ongoing -= 1
                self._latency_sum += dt
                if self._have_ewma:
                    self._ewma_s += _EWMA_ALPHA * (dt - self._ewma_s)
                else:
                    self._ewma_s, self._have_ewma = dt, True
                self._lat_ring.append(dt)
                self._record_request_locked(rid, outcome, dt)

    # ---- control plane ----

    def reconfigure(self, user_config: Any):
        """Apply a new user_config without restarting the replica
        (reference: replica.py reconfigure path)."""
        if not self._is_function and hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)

    def get_load(self) -> Dict[str, Any]:
        """Cheap telemetry snapshot: what the router's power-of-two-
        choices scoring consumes (piggybacked + long-poll refreshed),
        and what the controller's drain poll watches reach zero.

        A stateful callable (serve/llm) merges its own load via the
        ``__serve_load__`` hook: its in-flight sequences add to
        ``queue_len`` — so the drain poll waits for decodes to finish
        and p2c sees decode pressure — and its ``llm`` metrics ride
        the controller telemetry into the autoscaler + /metrics."""
        with self._ongoing_lock:
            out = {
                "queue_len": self._ongoing + self._queued,
                "ewma_s": self._ewma_s,
                "shed": self._total_shed,
                "draining": self._draining,
                "total_requests": self._total_requests,
                "total_errors": self._total_errors,
                "p99_s": self._quantile(0.99),
                "ts": time.time(),
            }
        if not self._is_function and hasattr(self.callable,
                                             "__serve_load__"):
            try:
                extra = self.callable.__serve_load__() or {}
                out["queue_len"] += int(extra.get("queue_len_extra", 0))
                if extra.get("llm") is not None:
                    out["llm"] = extra["llm"]
            except Exception:
                pass
        return out

    def _quantile(self, q: float) -> float:
        """Tail quantile over the bounded reservoir (caller holds the
        lock or tolerates a racy read — the ring is append-only)."""
        if not self._lat_ring:
            return 0.0
        vals = sorted(self._lat_ring)
        idx = min(len(vals) - 1, int(q * len(vals)))
        return vals[idx]

    def get_llm_state(self) -> Optional[Dict[str, Any]]:
        """LLM engine metrics + token ledger (serve/llm), read OUTSIDE
        the request path — collection must not move the request
        counters the game-day reconciliation compares."""
        if not self._is_function and hasattr(self.callable,
                                             "__llm_metrics__"):
            try:
                return self.callable.__llm_metrics__()
            except Exception:
                return None
        return None

    def get_replica_metadata(self) -> Dict[str, Any]:
        """Identity for controller re-adoption (orphan sweep after a
        controller restart): which deployment + code version this
        replica is running."""
        return {"deployment": self.deployment_name,
                "version": self.version}

    def get_request_log(self) -> Dict[str, Any]:
        """This replica's request ledger: every admitted/shed request
        as (request_id, outcome, latency_s), ``outcome`` in
        ok|error|shed|prefill (``prefill`` = the disagg two-hop's
        internal first hop — admitted work, not a client-visible
        completion). ``truncated`` means the bounded log overflowed
        (raise ``RTT_SERVE_REQUEST_LOG_MAX``) — per-request joins are
        then unreliable and reconciliation says so."""
        with self._ongoing_lock:
            return {"deployment": self.deployment_name,
                    "replica": self.replica_name,
                    "records": list(self._request_log),
                    "truncated": self._request_log_dropped > 0}

    def prepare_drain(self) -> str:
        """Graceful-drain step 2 (step 1 removed us from the route
        table): stop accepting new requests; in-flight ones finish.
        Stateful callables get the ``__serve_prepare_drain__`` hook so
        their own admission (the LLM engine's) closes too, while their
        in-flight work (decoding sequences) runs to completion."""
        with self._ongoing_lock:
            self._draining = True
        if not self._is_function and hasattr(self.callable,
                                             "__serve_prepare_drain__"):
            try:
                self.callable.__serve_prepare_drain__()
            except Exception:
                import traceback
                traceback.print_exc()
        return "ok"

    def get_metrics(self) -> Dict[str, Any]:
        with self._ongoing_lock:
            return {
                "num_ongoing_requests": self._ongoing,
                "num_queued_requests": self._queued,
                "queue_len": self._ongoing + self._queued,
                "total_requests": self._total_requests,
                "total_errors": self._total_errors,
                "total_shed": self._total_shed,
                "latency_sum_s": self._latency_sum,
                "ewma_service_time_s": self._ewma_s,
                "p50_s": self._quantile(0.50),
                "p99_s": self._quantile(0.99),
                "max_concurrent_queries": self._max_concurrent,
                "max_queued_requests": self._max_queued,
            }

    def check_health(self) -> str:
        """Controller health probe; user callables may define their own
        ``check_health`` raising on failure."""
        if not self._is_function and hasattr(self.callable,
                                             "check_health"):
            self.callable.check_health()
        return "ok"

    def prepare_for_shutdown(self):
        # stateful callables flush their own state first (serve/llm:
        # the per-request token ledger a rolling update must not lose)
        if not self._is_function and hasattr(
                self.callable, "__serve_prepare_shutdown__"):
            try:
                self.callable.__serve_prepare_shutdown__(
                    self.replica_name)
            except Exception:
                pass
        # stop @serve.batch flusher threads: admission is closed and
        # in-flight requests finished, so the queues are drained
        if not self._is_function:
            d = getattr(self.callable, "__dict__", None) or {}
            for attr, v in list(d.items()):
                if attr.startswith("__serve_batcher_"):
                    try:
                        v.stop(timeout_s=1.0)
                    except Exception:
                        pass
        # drain this process's task-event ring synchronously: the
        # controller kills us right after this RPC returns, and the
        # FINISHED events of our last requests (≤0.5 s of batching)
        # must reach the GCS for the state engine to agree with the
        # client ledger (gameday reconciliation check C6)
        try:
            from ray_tpu_torch._private import task_events as tev
            tev.flush_all(timeout=2.0)
        except Exception:
            pass
        # same for the trace-span ring: a replica retired by a rolling
        # update must not take the tail of its request spans with it
        # (the gameday trace-completeness check joins against them)
        try:
            tracing.flush_all(timeout=2.0)
        except Exception:
            pass
        # flush the request ledger before dying: a replica retired by a
        # rolling update / downscale must not take the server half of
        # the game-day reconciliation join with it (best-effort — a KV
        # outage degrades observability, never shutdown)
        try:
            with self._ongoing_lock:
                records = list(self._request_log)
                truncated = self._request_log_dropped > 0
            if records:
                from ray_tpu_torch.gameday import store
                store.flush_replica_ledger(
                    self.replica_name, self.deployment_name,
                    records, truncated=truncated)
        except Exception:
            pass
        if not self._is_function and hasattr(self.callable, "__del__"):
            try:
                self.callable.__del__()
            except Exception:
                pass
        return "ok"
