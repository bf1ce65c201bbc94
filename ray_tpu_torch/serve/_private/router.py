"""Client-side request router with load-aware replica selection.

Copy of ``ray_tpu/serve/_private/router.py``. Reference analogue:
serve/_private/router.py:261 (Router,
assign_request:298) + the PowerOfTwoChoicesReplicaScheduler. Each
handle/proxy owns a Router that long-polls the controller for the live
replica membership AND per-replica load telemetry (queue depth + EWMA
service time, published on the ``replica_load`` key and piggybacked on
proxy responses), then picks replicas with power-of-two-choices over
reported queue lengths. When telemetry is stale the score falls back to
this router's own in-flight counts; ``RTT_SERVE_ROUTING=round_robin``
(or a per-deployment ``routing_policy``) restores blind round-robin.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions as rexc
from ray_tpu_torch._private import tracing
from ray_tpu_torch.actor import get_actor_by_id
from ray_tpu_torch.serve._private.long_poll import LongPollClient
from ray_tpu_torch.serve.exceptions import ReplicaOverloadedError

logger = logging.getLogger("ray_tpu_torch.serve.router")

# transport/control-plane failures a routing refresh may legitimately
# hit; anything else (TypeError, KeyError, ...) is a bug and must raise
_REFRESH_ERRORS = (rexc.RayTpuError, TimeoutError, ConnectionError,
                   OSError)


def _load_staleness_s() -> float:
    try:
        return float(os.environ.get("RTT_SERVE_LOAD_STALENESS_S", 5.0))
    except ValueError:
        return 5.0


def _default_policy() -> str:
    return os.environ.get("RTT_SERVE_ROUTING", "p2c").strip().lower()


def _call_under_span(span: Optional["tracing.Span"], fn):
    """Run ``fn`` (an actor-call submit) with ``span`` installed as the
    caller's current trace ctx: the call's task-event record then joins
    the serve trace (visible under RTT_ACTOR_TASK_EVENTS=1) instead of
    the caller process's root trace."""
    if span is None:
        return fn()
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod._global_worker
    if w is None:
        return fn()
    prev = getattr(w.task_context, "trace", None)
    w.task_context.trace = span.trace_ctx()
    try:
        return fn()
    finally:
        w.task_context.trace = prev


def is_overload_error(err: BaseException) -> bool:
    """True when an exception raised at ``get()`` means the replica shed
    the request (retriable on another replica)."""
    if isinstance(err, ReplicaOverloadedError):
        return True
    cause = getattr(err, "cause", None)
    if isinstance(cause, ReplicaOverloadedError):
        return True
    # defensive: the cause survives the object plane only if picklable;
    # fall back to the type name in the captured traceback
    return (isinstance(err, rexc.TaskError)
            and "ReplicaOverloadedError" in str(err))


class ReplicaSet:
    """Tracks live replicas of one deployment: per-replica local
    in-flight counts plus replica-reported load telemetry."""

    def __init__(self, deployment_name: str, max_concurrent_queries: int):
        self.deployment_name = deployment_name
        self.max_concurrent_queries = max_concurrent_queries
        self.routing_policy: Optional[str] = None  # None → env default
        self._replicas: List[Any] = []       # actor handles
        self._in_flight: Dict[str, int] = {}  # actor id hex -> count
        # actor id hex -> "prefill"|"decode" (controller-assigned, only
        # for disaggregated LLM deployments; empty otherwise)
        self._roles: Dict[str, str] = {}
        # actor id hex -> {"queue_len", "ewma_s", "ts"} as reported by
        # the replica (long-poll refresh or response piggyback)
        self._reports: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._rr = 0
        self._rng = random.Random()

    def update_replicas(self, replicas: List[Any],
                        max_concurrent_queries: Optional[int] = None,
                        routing_policy: Optional[str] = None,
                        replica_roles: Optional[Dict[str, str]] = None):
        with self._cv:
            self._replicas = list(replicas)
            if max_concurrent_queries:
                self.max_concurrent_queries = max_concurrent_queries
            if routing_policy is not None:
                self.routing_policy = routing_policy
            live = {r._id_hex for r in self._replicas}
            self._roles = {k: v for k, v in (replica_roles or {}).items()
                           if k in live}
            self._in_flight = {k: v for k, v in self._in_flight.items()
                               if k in live}
            self._reports = {k: v for k, v in self._reports.items()
                             if k in live}
            self._cv.notify_all()

    def member_ids(self) -> Set[str]:
        with self._cv:
            return {r._id_hex for r in self._replicas}

    def role_members(self, role: str) -> Set[str]:
        with self._cv:
            return {k for k, v in self._roles.items() if v == role}

    def disaggregated(self) -> bool:
        """True when the controller published a role split with at
        least one live prefill AND one live decode replica — the
        router's cue to run the two-hop admission."""
        with self._cv:
            roles = set(self._roles.values())
        return "prefill" in roles and "decode" in roles

    def record_report(self, replica_id: str, queue_len: float,
                      ewma_s: float = 0.0, ts: Optional[float] = None):
        """Fold in a replica-reported load sample (long-poll snapshot or
        response piggyback); newer timestamps win."""
        ts = time.time() if ts is None else ts
        with self._cv:
            cur = self._reports.get(replica_id)
            if cur is None or ts >= cur["ts"]:
                self._reports[replica_id] = {"queue_len": float(queue_len),
                                             "ewma_s": float(ewma_s or 0.0),
                                             "ts": ts}

    # ---- selection ----

    def _score(self, key: str, now: float) -> Tuple[float, float]:
        """(queue score, EWMA tiebreak). Fresh replica-reported queue
        depth is the primary signal — it sees load from EVERY router —
        plus our own in-flight (requests the report can't know about
        yet). Stale telemetry degrades to local counts only."""
        local = self._in_flight.get(key, 0)
        rep = self._reports.get(key)
        if rep is not None and now - rep["ts"] <= _load_staleness_s():
            return (rep["queue_len"] + local, rep["ewma_s"])
        return (float(local), 0.0)

    def _pick(self, candidates: List[Any]) -> Any:
        policy = self.routing_policy or _default_policy()
        if policy == "round_robin" or len(candidates) == 1:
            # preserve arrival order relative to the full replica list
            n = len(self._replicas)
            cand_ids = {c._id_hex for c in candidates}
            for off in range(n):
                r = self._replicas[(self._rr + off) % n]
                if r._id_hex in cand_ids:
                    self._rr = (self._rr + off + 1) % n
                    return r
            return candidates[0]
        # power of two choices: sample two distinct replicas, take the
        # one with the lower queue score (EWMA service time tiebreaks)
        now = time.time()
        a, b = self._rng.sample(candidates, 2)
        sa, sb = self._score(a._id_hex, now), self._score(b._id_hex, now)
        return a if sa <= sb else b

    def assign(self, timeout: float = 30.0,
               exclude: Optional[Set[str]] = None):
        """Pick a replica with < max_concurrent_queries of OUR in-flight
        requests; blocks when all are saturated (backpressure)."""
        deadline = time.time() + timeout
        exclude = exclude or set()
        with self._cv:
            while True:
                candidates = [
                    r for r in self._replicas
                    if r._id_hex not in exclude
                    and (self._in_flight.get(r._id_hex, 0)
                         < self.max_concurrent_queries)]
                if candidates:
                    r = self._pick(candidates)
                    key = r._id_hex
                    self._in_flight[key] = self._in_flight.get(key, 0) + 1
                    return r
                remaining = deadline - time.time()
                if remaining <= 0:
                    # build the message from CURRENT state under the
                    # lock — update_replicas may have raced the wait
                    # loop, and a stale count here sends the operator
                    # chasing the wrong replica set
                    n = len(self._replicas)
                    n_excluded = sum(1 for r in self._replicas
                                     if r._id_hex in exclude)
                    in_flight = sum(self._in_flight.get(r._id_hex, 0)
                                    for r in self._replicas)
                    raise TimeoutError(
                        f"no replica available for "
                        f"{self.deployment_name!r} within {timeout}s "
                        f"({n} replicas, {n_excluded} excluded, "
                        f"{in_flight} total in-flight, cap "
                        f"{self.max_concurrent_queries}/replica)")
                self._cv.wait(timeout=min(remaining, 1.0))

    def release(self, replica, service_time_s: Optional[float] = None):
        with self._cv:
            key = replica._id_hex
            if key in self._in_flight:
                self._in_flight[key] -= 1
                if self._in_flight[key] <= 0:
                    self._in_flight.pop(key)
            self._cv.notify()


class Router:
    """Routes requests for many deployments; membership and load
    telemetry refreshed via long-poll."""

    def __init__(self, controller_handle):
        self._controller = controller_handle
        self._sets: Dict[str, ReplicaSet] = {}
        self._lock = threading.Lock()
        self._poller = LongPollClient(
            controller_handle, "route_table", self._on_update)
        self._load_poller = LongPollClient(
            controller_handle, "replica_load", self._on_load_update)
        # seed synchronously so the first request doesn't race the poller
        try:
            _, snapshot = ray_tpu_torch.get(
                controller_handle.get_route_table.remote())
            if snapshot:
                self._on_update(snapshot)
        except _REFRESH_ERRORS as e:
            logger.warning(
                "router: initial route-table seed from controller failed "
                "(%s: %s); falling back to the long-poll — the first "
                "request may see a brief 'unknown deployment' window",
                type(e).__name__, e)

    def _on_update(self, snapshot: Optional[Dict[str, Any]]):
        if not snapshot:
            return
        with self._lock:
            for name, info in snapshot.items():
                replicas = []
                for h in info["replicas"]:
                    try:
                        replicas.append(get_actor_by_id(h))
                    except (ValueError, *_REFRESH_ERRORS) as e:
                        # replica died between table publish and our
                        # resolve; the controller's health check will
                        # push a corrected table
                        logger.warning(
                            "router: replica %s of %r unresolvable "
                            "(%s: %s); skipping until the next table "
                            "update", h[:8], name, type(e).__name__, e)
                s = self._sets.get(name)
                if s is None:
                    s = ReplicaSet(name, info["max_concurrent_queries"])
                    self._sets[name] = s
                s.update_replicas(replicas,
                                  info["max_concurrent_queries"],
                                  info.get("routing_policy"),
                                  info.get("replica_roles"))
            for gone in set(self._sets) - set(snapshot):
                self._sets.pop(gone)

    def _on_load_update(self, snapshot: Optional[Dict[str, Any]]):
        """``replica_load`` long-poll: {deployment: {replica_id:
        {queue_len, ewma_s, ts}}} collected by the controller."""
        if not snapshot:
            return
        with self._lock:
            sets = dict(self._sets)
        for name, per_replica in snapshot.items():
            s = sets.get(name)
            if s is None:
                continue
            for replica_id, load in (per_replica or {}).items():
                try:
                    s.record_report(replica_id, load["queue_len"],
                                    load.get("ewma_s", 0.0),
                                    load.get("ts"))
                except (KeyError, TypeError):
                    continue

    def replica_set(self, deployment_name: str) -> ReplicaSet:
        with self._lock:
            s = self._sets.get(deployment_name)
        if s is None:
            # force one refresh for deployments created after seeding —
            # resilient to a controller outage: a KNOWN deployment keeps
            # routing from the cached set; only a genuinely unseen one
            # needs the controller up to resolve
            try:
                _, snapshot = ray_tpu_torch.get(
                    self._controller.get_route_table.remote(),
                    timeout=10.0)
                self._on_update(snapshot)
            except _REFRESH_ERRORS as e:
                raise KeyError(
                    f"unknown deployment {deployment_name!r} and the "
                    f"controller is unreachable to resolve it "
                    f"({type(e).__name__}: {e})") from e
            with self._lock:
                s = self._sets.get(deployment_name)
        if s is None:
            raise KeyError(f"unknown deployment {deployment_name!r}")
        return s

    def force_refresh(self):
        """Synchronous pull of the current route table (bypasses the
        long-poll latency) — used after a deploy barrier or when a
        request hits a dead replica."""
        try:
            _, snapshot = ray_tpu_torch.get(
                self._controller.get_route_table.remote(), timeout=10.0)
            self._on_update(snapshot)
        except _REFRESH_ERRORS as e:
            logger.warning(
                "router: route-table refresh failed for deployments %s "
                "(%s: %s); keeping the previous table until the "
                "long-poll catches up", sorted(self._sets),
                type(e).__name__, e)

    def assign_request(self, deployment_name: str, method_name: str,
                       args: tuple, kwargs: dict,
                       timeout: float = 30.0,
                       exclude: Optional[Set[str]] = None,
                       trace_parent: Optional[Dict[str, str]] = None):
        """Pick a replica, fire the call; returns (ObjectRef, done_cb,
        replica handle).

        Tracing: each call opens a ``serve.request`` root span (trace
        id = the ``__rtpu_request_id__`` kwarg when tagged, so the SLO
        report links a slow request straight to its trace) with a
        ``router.assign`` child covering replica selection — the wait
        for a free slot IS the router-side queueing the analyzer must
        see. The root closes in the done callback, i.e. at the same
        instant the caller observes completion. ``trace_parent`` nests
        this request under an enclosing span (the HTTP proxy's)."""
        rs = self.replica_set(deployment_name)
        root = None
        sampled = False
        if tracing.enabled():
            from ray_tpu_torch.serve._private.replica import (REQUEST_ID_KWARG,
                                                              TRACE_CTX_KWARG)
            rid = (kwargs or {}).get(REQUEST_ID_KWARG)
            root = tracing.Span(
                (trace_parent or {}).get("trace_id") or rid
                or tracing.new_trace_id(),
                f"serve.request:{deployment_name}",
                parent_span_id=(trace_parent or {}).get("span_id"),
                kind="serve.request", phase="transfer",
                attrs={"deployment": deployment_name,
                       "request_id": rid})
            # head-sampling decides HERE whether the request is traced
            # end to end: only sampled requests pay for context
            # propagation and child spans; an unsampled root costs two
            # clock reads and is still tail-kept when slow
            sampled = tracing.sampled(root.trace_id)
            if sampled:
                kwargs = dict(kwargs) if kwargs else {}
                kwargs[TRACE_CTX_KWARG] = root.child_ctx()
        t_assign = time.time()
        try:
            replica = rs.assign(timeout=timeout, exclude=exclude)
        except BaseException:
            if root is not None:
                root.finish("error")
            raise
        if sampled and time.time() - t_assign > 1e-4:
            # the wait for a free replica slot is router-side queueing;
            # a no-wait assign is noise and not worth a span
            tracing.record_span(
                root.trace_id, tracing.new_span_id(), "router.assign",
                parent_span_id=root.span_id, kind="serve.router",
                phase="schedule", start_ts=t_assign,
                end_ts=time.time())
        ref = _call_under_span(
            root if sampled else None,
            lambda: replica.handle_request.remote(
                method_name, args, kwargs))
        if root is None:
            return ref, lambda: rs.release(replica), replica

        def done():
            rs.release(replica)
            root.finish()
        return ref, done, replica

    def execute_request(self, deployment_name: str, method_name: str,
                        args: tuple, kwargs: dict, *,
                        get_timeout: float = 60.0,
                        assign_timeout: float = 30.0,
                        overload_retries: Optional[int] = None,
                        request_id: Optional[str] = None,
                        trace_parent: Optional[Dict[str, str]] = None
                        ) -> Any:
        """Synchronous request with overload retry — the proxy hot path.

        Uses the replica's envelope method so each response piggybacks
        current load into this router's telemetry. A shed request
        (``ReplicaOverloadedError``) is retried on a different replica
        up to ``overload_retries`` times (env
        ``RTT_SERVE_OVERLOAD_RETRIES``, default 3); exhaustion
        re-raises the overload error for the caller to map (the HTTP
        proxy returns 503).

        ``request_id`` tags the request end to end: it rides the
        reserved ``__rtpu_request_id__`` kwarg into the replica (which
        strips it, ledgers it, and echoes it in the envelope), and
        every overload retry reuses the SAME id — retries are one
        logical request, and the per-request join in
        ``gameday/reconcile.py`` counts them that way (N shed records
        + at most one completion for one id)."""
        if request_id is not None:
            from ray_tpu_torch.serve._private.replica import REQUEST_ID_KWARG
            kwargs = {**(kwargs or {}), REQUEST_ID_KWARG: request_id}
        root = None
        sampled = False
        if tracing.enabled():
            from ray_tpu_torch.serve._private.replica import TRACE_CTX_KWARG
            root = tracing.Span(
                (trace_parent or {}).get("trace_id") or request_id
                or tracing.new_trace_id(),
                f"serve.request:{deployment_name}",
                parent_span_id=(trace_parent or {}).get("span_id"),
                kind="serve.request", phase="transfer",
                attrs={"deployment": deployment_name,
                       "request_id": request_id})
            sampled = tracing.sampled(root.trace_id)
            if sampled:
                kwargs = {**(kwargs or {}),
                          TRACE_CTX_KWARG: root.child_ctx()}
        try:
            out = self._execute_attempts(
                deployment_name, method_name, args, kwargs,
                get_timeout=get_timeout, assign_timeout=assign_timeout,
                overload_retries=overload_retries,
                root=root if sampled else None)
        except BaseException:
            if root is not None:
                root.finish("error")
            raise
        if root is not None:
            root.finish()
        return out

    def _execute_attempts(self, deployment_name: str, method_name: str,
                          args: tuple, kwargs: dict, *,
                          get_timeout: float, assign_timeout: float,
                          overload_retries: Optional[int],
                          root: Optional["tracing.Span"] = None) -> Any:
        if overload_retries is None:
            try:
                overload_retries = int(os.environ.get(
                    "RTT_SERVE_OVERLOAD_RETRIES", 3))
            except ValueError:
                overload_retries = 3
        rs = self.replica_set(deployment_name)
        exclude: Set[str] = set()
        last_err: Optional[BaseException] = None
        for _ in range(max(1, overload_retries + 1)):
            t_assign = time.time()
            replica = rs.assign(timeout=assign_timeout,
                                exclude=exclude)
            if root is not None and time.time() - t_assign > 1e-4:
                tracing.record_span(
                    root.trace_id, tracing.new_span_id(),
                    "router.assign", parent_span_id=root.span_id,
                    kind="serve.router", phase="schedule",
                    start_ts=t_assign, end_ts=time.time())
            ref = _call_under_span(
                root, lambda: replica.handle_request_with_load.remote(
                    method_name, args, kwargs))
            try:
                out = ray_tpu_torch.get(ref, timeout=get_timeout)
            except Exception as e:
                if is_overload_error(e):
                    # shed: the replica is full — don't pick it again
                    # for this request, try the others
                    exclude.add(replica._id_hex)
                    rs.record_report(replica._id_hex,
                                     queue_len=float("inf"))
                    last_err = e
                    continue
                raise
            finally:
                rs.release(replica)
            if isinstance(out, dict) and "__serve_result__" in out:
                load = out.get("__serve_load__")
                if isinstance(load, dict):
                    rs.record_report(replica._id_hex,
                                     load.get("queue_len", 0),
                                     load.get("ewma_s", 0.0),
                                     load.get("ts"))
                return out["__serve_result__"]
            return out
        raise last_err

    # ------------------------------------------------------- streaming

    def open_stream(self, deployment_name: str, payload: Any, *,
                    request_id: Optional[str] = None,
                    assign_timeout: float = 30.0,
                    open_timeout: float = 30.0,
                    overload_retries: Optional[int] = None,
                    trace_parent: Optional[Dict[str, str]] = None
                    ) -> "ReplicaStream":
        """Start a token stream (serve/llm): pick a replica with the
        same load-aware admission as a unary request, call its
        ``__llm_open__``, and return a ``ReplicaStream`` pinned to that
        replica (sequence state is replica-local — every subsequent
        poll MUST go to the same one). A shed open retries on other
        replicas exactly like ``execute_request``; the router in-flight
        slot is held only for the open call — once the engine admitted
        the sequence, ITS admission (waiting queue + KV pool) is the
        backpressure, and polls are cheap cursor reads.

        Tracing: the ``serve.request`` root span stays open until the
        stream finishes, so the trace covers the full generation, not
        just the admission RPC."""
        if overload_retries is None:
            try:
                overload_retries = int(os.environ.get(
                    "RTT_SERVE_OVERLOAD_RETRIES", 3))
            except ValueError:
                overload_retries = 3
        kwargs: Dict[str, Any] = {}
        if request_id is not None:
            from ray_tpu_torch.serve._private.replica import REQUEST_ID_KWARG
            kwargs[REQUEST_ID_KWARG] = request_id
        root = None
        sampled = False
        if tracing.enabled():
            from ray_tpu_torch.serve._private.replica import TRACE_CTX_KWARG
            root = tracing.Span(
                (trace_parent or {}).get("trace_id") or request_id
                or tracing.new_trace_id(),
                f"serve.request:{deployment_name}",
                parent_span_id=(trace_parent or {}).get("span_id"),
                kind="serve.request", phase="transfer",
                attrs={"deployment": deployment_name,
                       "request_id": request_id, "streaming": True})
            sampled = tracing.sampled(root.trace_id)
            if sampled:
                kwargs[TRACE_CTX_KWARG] = root.child_ctx()
        rs = self.replica_set(deployment_name)
        try:
            if rs.disaggregated():
                stream = self._open_disagg(
                    deployment_name, rs, payload, kwargs,
                    root if sampled else None,
                    assign_timeout=assign_timeout,
                    open_timeout=open_timeout,
                    overload_retries=overload_retries)
                if stream is not None:
                    stream._root = root
                    return stream
                logger.warning(
                    "llm disagg: two-hop admission unavailable for %r; "
                    "falling back to unified __llm_open__",
                    deployment_name)
            return self._open_unified(
                deployment_name, rs, payload, kwargs,
                root, sampled, assign_timeout=assign_timeout,
                open_timeout=open_timeout,
                overload_retries=overload_retries)
        except BaseException:
            if root is not None:
                root.finish("error")
            raise

    def _open_unified(self, deployment_name, rs, payload, kwargs,
                      root, sampled, *, assign_timeout, open_timeout,
                      overload_retries) -> "ReplicaStream":
        exclude: Set[str] = set()
        last_err: Optional[BaseException] = None
        for _ in range(max(1, overload_retries + 1)):
            replica = rs.assign(timeout=assign_timeout,
                                exclude=exclude)
            ref = _call_under_span(
                root if sampled else None,
                lambda: replica.handle_request_with_load.remote(
                    "__llm_open__", (payload,), kwargs))
            try:
                out = ray_tpu_torch.get(ref, timeout=open_timeout)
            except Exception as e:
                if is_overload_error(e):
                    exclude.add(replica._id_hex)
                    rs.record_report(replica._id_hex,
                                     queue_len=float("inf"))
                    last_err = e
                    continue
                raise
            finally:
                rs.release(replica)
            if isinstance(out, dict) and "__serve_result__" in out:
                load = out.get("__serve_load__")
                if isinstance(load, dict):
                    rs.record_report(replica._id_hex,
                                     load.get("queue_len", 0),
                                     load.get("ewma_s", 0.0),
                                     load.get("ts"))
                out = out["__serve_result__"]
            return ReplicaStream(deployment_name, replica,
                                 out["stream_id"], root)
        raise last_err

    def _hop(self, rs, payload, kwargs, root, role: str,
             method: str, *, assign_timeout, open_timeout,
             overload_retries) -> Optional[Tuple[Any, Any]]:
        """One admission hop against the ``role`` sub-fleet: assign a
        replica of that role, call ``method``, unwrap the load
        envelope. Returns (replica, result) or None when the hop can't
        complete retriably (role empty / all shed / assign timeout) —
        the caller falls back. Non-overload errors raise."""
        members = rs.role_members(role)
        if not members:
            return None
        exclude = rs.member_ids() - members
        for _ in range(max(1, overload_retries + 1)):
            try:
                replica = rs.assign(timeout=assign_timeout,
                                    exclude=exclude)
            except TimeoutError:
                return None   # role sub-fleet saturated: fall back
            ref = _call_under_span(
                root, lambda: replica.handle_request_with_load.remote(
                    method, (payload,), kwargs))
            try:
                out = ray_tpu_torch.get(ref, timeout=open_timeout)
            except Exception as e:
                if is_overload_error(e):
                    exclude.add(replica._id_hex)
                    rs.record_report(replica._id_hex,
                                     queue_len=float("inf"))
                    continue
                raise
            finally:
                rs.release(replica)
            if isinstance(out, dict) and "__serve_result__" in out:
                load = out.get("__serve_load__")
                if isinstance(load, dict):
                    rs.record_report(replica._id_hex,
                                     load.get("queue_len", 0),
                                     load.get("ewma_s", 0.0),
                                     load.get("ts"))
                out = out["__serve_result__"]
            return replica, out
        return None

    def _open_disagg(self, deployment_name, rs, payload, kwargs,
                     root, *, assign_timeout, open_timeout,
                     overload_retries) -> Optional["ReplicaStream"]:
        """Two-hop disaggregated admission: ``__llm_prefill__`` on a
        prefill-role replica (prompt + first token + KV snapshot into a
        plasmax ring slot), then ``__llm_adopt__`` on a decode-role
        replica (rebind the shipped pages; re-prefill on a torn frame)
        — the stream pins to the DECODE replica. Any structural
        failure returns None and the caller falls back to the unified
        single-hop open, which is always correct."""
        try:
            got = self._hop(rs, payload, kwargs, root, "prefill",
                            "__llm_prefill__",
                            assign_timeout=assign_timeout,
                            open_timeout=open_timeout,
                            overload_retries=overload_retries)
            if got is None:
                return None
            _prefill_replica, handoff = got
            got = self._hop(rs, handoff, kwargs, root, "decode",
                            "__llm_adopt__",
                            assign_timeout=assign_timeout,
                            open_timeout=open_timeout,
                            overload_retries=overload_retries)
            if got is None:
                return None
            decode_replica, out = got
            return ReplicaStream(deployment_name, decode_replica,
                                 out["stream_id"], None)
        except Exception as e:
            # correctness is owned by the unified fallback; the two-hop
            # path only ever improves latency, so any error degrades
            logger.warning(
                "llm disagg: two-hop admission failed for %r "
                "(%s: %s); falling back to unified open",
                deployment_name, type(e).__name__, e)
            return None

    def stop(self):
        self._poller.stop()
        self._load_poller.stop()


class ReplicaStream:
    """A token stream pinned to one replica (serve/llm sequences are
    replica-local state). Iterating yields chunk dicts
    ``{"tokens", "text"?, "cursor", "done", ...}``; the final chunk has
    ``done=True`` and a ``finish_reason``. A replica death mid-stream
    raises ``StreamBrokenError`` carrying the progress so far — the
    caller retries the WHOLE request or fails cleanly; a stream is
    never silently truncated."""

    def __init__(self, deployment_name: str, replica, stream_id: str,
                 root_span=None):
        self.deployment_name = deployment_name
        self.replica = replica
        self.stream_id = stream_id
        self.cursor = 0
        self.done = False
        self.finish_reason: Optional[str] = None
        self._root = root_span

    def _finish_span(self, status: str = "ok"):
        if self._root is not None:
            self._root.finish(status)
            self._root = None

    def next_chunk(self, max_wait_s: float = 10.0,
                   get_timeout: float = 30.0) -> Dict[str, Any]:
        """One cursor poll; returns the next chunk (possibly empty on
        an idle wait timeout — call again)."""
        if self.done:
            return {"tokens": [], "cursor": self.cursor, "done": True,
                    "finish_reason": self.finish_reason}
        try:
            chunk = ray_tpu_torch.get(
                self.replica.handle_request.remote(
                    "__llm_next__", (self.stream_id, self.cursor,
                                     max_wait_s), {}),
                timeout=get_timeout)
        except BaseException as e:
            self._finish_span("error")
            if isinstance(e, (rexc.ActorDiedError,
                              rexc.ActorUnavailableError, KeyError,
                              rexc.TaskError)):
                from ray_tpu_torch.serve.exceptions import StreamBrokenError
                raise StreamBrokenError(
                    self.deployment_name, self.cursor,
                    f"{type(e).__name__}: {e}".split("\n")[0]) from e
            raise
        self.cursor = chunk.get("cursor", self.cursor)
        if chunk.get("done"):
            self.done = True
            self.finish_reason = chunk.get("finish_reason")
            if chunk.get("error"):
                self._finish_span("error")
                from ray_tpu_torch.serve.exceptions import StreamBrokenError
                raise StreamBrokenError(self.deployment_name,
                                        self.cursor, chunk["error"])
            self._finish_span("ok")
        return chunk

    def __iter__(self):
        while not self.done:
            chunk = self.next_chunk()
            if chunk.get("tokens") or chunk.get("done"):
                yield chunk

    def cancel(self):
        self._finish_span("error")
        try:
            self.replica.handle_request.remote(
                "__llm_cancel__", (self.stream_id,), {})
        except Exception:
            pass
        self.done = True
