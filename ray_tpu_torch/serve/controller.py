"""ServeController — the Serve control plane actor.

Copy of ``ray_tpu/serve/controller.py``. Reference analogue:
serve/controller.py:61 (run_control_loop:239,
deploy_app:415) + _private/deployment_state.py (DeploymentState:958,
scaling :1281, rolling updates keyed by version hash). One actor holds
target state, reconciles replica actors toward it in a background
thread, health-checks them, autoscales from queue metrics, and publishes
the route table over long-poll.

Control-plane HA (reference: the controller's KVStore checkpoints +
detached-replica recovery in deployment_state.py):

* **Durable state.** Every mutation of target state (deploy/delete,
  autoscale decisions, replica membership changes) is journaled to the
  GCS KV table (`serve/_private/journal.py`). The controller runs with
  ``max_restarts=-1``; a restarted controller rebuilds ``_deployments``
  from the journal, re-adopts the live detached ``SERVE_REPLICA::*``
  actors by name (replicas are NOT restarted), republishes the route
  table, and resumes reconciliation. Routers and the HTTP proxy keep
  serving from their cached route tables during the outage and
  reconnect their long-polls with backoff.
* **Health-gated rolling updates.** Replicas on a stale version are
  replaced start-before-stop in bounded surge waves
  (``RTT_SERVE_MAX_SURGE`` extra replicas at a time): each wave's new
  replicas must pass health checks before an old replica is drained.
  A new version that never becomes healthy leaves the old version
  serving.
* **Graceful drain.** A replica leaving service (rolling update,
  downscale, deployment delete, draining node) is first removed from
  the published route table and told to shed new arrivals
  (``prepare_drain``), then killed only once its in-flight count hits
  zero or ``graceful_shutdown_timeout_s`` expires.
* **Node preemption.** Replicas on a node the GCS marks draining are
  condemned: replacements start elsewhere first (the scheduler already
  excludes draining nodes), then the condemned replicas drain inside
  the node's grace window.

Differences from the JAX controller, both for replicas that hold a GPU
grant (``ray_actor_options={"num_gpus": 1}``): a replica that has not
passed its first probe is still constructing (``import torch``, CUDA
init, the model's build: 8-20 s on an H100 machine), so its probe
misses do not count against it — only a probe that finds the actor
dead removes it; and a replica removed as unhealthy is killed, so its
GPU grant frees for the replacement.

Chaos sites (``_private/chaos.py``): ``serve.controller.tick`` fires
once per control-loop iteration (op ``kill`` SIGKILLs the controller
worker — the GCS restarts it); ``serve.replica.request`` lives in the
replica (see ``_private/replica.py``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("ray_tpu_torch.serve.controller")

CONTROLLER_NAME = "SERVE_CONTROLLER"
REPLICA_NAME_PREFIX = "SERVE_REPLICA::"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _max_surge() -> int:
    """Extra replicas a rolling update may run beyond target while a
    wave's new replicas come up (reference: maxSurge in k8s rollouts)."""
    return max(1, _env_int("RTT_SERVE_MAX_SURGE", 1))


def _health_failure_threshold() -> int:
    return max(1, _env_int("RTT_SERVE_HEALTH_FAILURES", 3))


def _health_timeout_s() -> float:
    return _env_float("RTT_SERVE_HEALTH_TIMEOUT_S", 10.0)


def _aggregate_llm(per_replica: Dict[str, Any],
                   roles: Optional[Dict[str, str]] = None
                   ) -> Optional[Dict[str, Any]]:
    """Fold the per-replica ``llm`` load rows (serve/llm engine
    telemetry riding ``ReplicaActor.get_load``) into one deployment-
    level signal set: summed throughput/sequence counts, MEAN KV
    occupancy (each replica owns an equal pool). None when no replica
    reports LLM metrics (stateless deployments stay on queue depth).

    ``roles`` (disaggregated deployments: replica id hex -> role) adds
    a ``per_role`` breakdown so the autoscaler can see prefill and
    decode pressure separately (docs/LLM_SERVING.md)."""
    keyed = [(k, v["llm"]) for k, v in per_replica.items()
             if isinstance(v, dict) and isinstance(v.get("llm"), dict)]
    rows = [r for _, r in keyed]
    if not rows:
        return None
    n = len(rows)
    out = {
        "tokens_per_s": sum(r.get("tokens_per_s", 0.0) for r in rows),
        "cache_hit_tokens_per_s": sum(
            r.get("cache_hit_tokens_per_s", 0.0) for r in rows),
        "cache_hit_tokens_total": sum(
            r.get("cache_hit_tokens_total", 0) for r in rows),
        "kv_occupancy": sum(r.get("kv_occupancy", 0.0)
                            for r in rows) / n,
        "running": sum(r.get("running", 0) for r in rows),
        "waiting": sum(r.get("waiting", 0) for r in rows),
        "generated_tokens_total": sum(
            r.get("generated_tokens_total", 0) for r in rows),
        "finished_total": sum(r.get("finished_total", 0)
                              for r in rows),
        "kv_blocks_used": sum(r.get("kv_blocks_used", 0)
                              for r in rows),
        "kv_blocks_total": sum(r.get("kv_blocks_total", 0)
                               for r in rows),
        "ttft_p99_s": max((r.get("ttft_p99_s", 0.0) for r in rows),
                          default=0.0),
        "replicas_reporting": n,
    }
    if roles:
        per_role: Dict[str, Dict[str, Any]] = {}
        for hex_id, r in keyed:
            role = roles.get(hex_id, "unified")
            agg = per_role.setdefault(role, {
                "tokens_per_s": 0.0, "running": 0, "waiting": 0,
                "kv_occupancy": 0.0, "replicas": 0})
            agg["tokens_per_s"] += r.get("tokens_per_s", 0.0)
            agg["running"] += r.get("running", 0)
            agg["waiting"] += r.get("waiting", 0)
            agg["kv_occupancy"] += r.get("kv_occupancy", 0.0)
            agg["replicas"] += 1
        for agg in per_role.values():
            if agg["replicas"]:
                agg["kv_occupancy"] /= agg["replicas"]
        out["per_role"] = per_role
    return out


class _DeploymentInfo:
    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.version = hashlib.sha1(
            repr(sorted((k, repr(v)) for k, v in config.items()
                        if k != "num_replicas")).encode()).hexdigest()[:12]
        self.target_replicas = config.get("num_replicas", 1)
        # actor handle -> version string
        self.replicas: Dict[Any, str] = {}
        # handles confirmed ready (first successful check_health) —
        # HEALTHY counts these, not mere creations, so serve.run cannot
        # return while replicas are still constructing
        self.ready: set = set()
        # replica id hex -> detached actor name (journaled so a
        # restarted controller can re-adopt by name)
        self.replica_names: Dict[str, str] = {}
        # handle -> {"deadline": unix, "reason": str}: out of the
        # published route table, killed once idle or at deadline
        self.draining: Dict[Any, Dict[str, Any]] = {}
        # replicas on a draining node — replaced start-before-stop like
        # stale versions, then drained inside the node's grace window
        self.condemned: set = set()
        # replica id hex -> consecutive failed health probes
        self.health_fails: Dict[str, int] = {}
        self.autoscaler = None
        autoscale = config.get("autoscaling_config")
        if autoscale:
            from ray_tpu_torch.serve._private.autoscaling import (
                AutoscalingConfig, AutoscalingPolicy)
            cfg = (autoscale if isinstance(autoscale, AutoscalingConfig)
                   else AutoscalingConfig(**autoscale))
            self.target_replicas = cfg.min_replicas
            self.autoscaler = AutoscalingPolicy(cfg)

    def graceful_timeout_s(self) -> float:
        v = self.config.get("graceful_shutdown_timeout_s")
        if v is None:
            return _env_float("RTT_SERVE_GRACEFUL_SHUTDOWN_S", 10.0)
        return float(v)

    def carry_over(self, prev: "_DeploymentInfo"):
        """Redeploy: adopt the predecessor's live state (same dict
        objects — in-flight drain polls hold references to them)."""
        self.replicas = prev.replicas
        self.ready = prev.ready
        self.replica_names = prev.replica_names
        self.draining = prev.draining
        self.condemned = prev.condemned
        self.health_fails = prev.health_fails


class ServeController:
    """Runs as a named detached actor (``max_restarts=-1``) with a
    high-concurrency thread pool (long-poll listeners block in
    ``listen_for_change``)."""

    def __init__(self, http_port: Optional[int] = None):
        from ray_tpu_torch.serve._private.long_poll import LongPollHost
        self._deployments: Dict[str, _DeploymentInfo] = {}
        self._lock = threading.RLock()
        self._long_poll = LongPollHost()
        self._replica_seq = 0
        self._journaled_seq = -1
        self._shutdown = threading.Event()
        self._http_port = http_port
        self._last_error: Optional[str] = None   # control-loop level
        self._last_errors: Dict[str, str] = {}   # per-deployment
        self._last_load_table: Dict[str, Any] = {}
        # shed-rate window: deployment -> (ts, total_shed) at the
        # previous metrics read (get_serve_metrics computes sheds/s)
        self._shed_prev: Dict[str, Any] = {}
        self._last_published_table: Optional[Dict[str, Any]] = None
        self._replica_nodes: Dict[str, str] = {}  # replica hex -> node id
        self._draining_nodes: Dict[str, float] = {}  # node id -> deadline
        self._recovered = False
        self._adopted = 0
        self._recover_from_journal()
        self._reconcile_thread = threading.Thread(
            target=self._control_loop, daemon=True)
        self._reconcile_thread.start()

    # ---- journal + recovery ----

    def _journal_meta(self):
        if self._replica_seq == self._journaled_seq:
            return
        from ray_tpu_torch.serve._private import journal
        try:
            journal.put_meta({"replica_seq": self._replica_seq,
                              "namespace": self._namespace()})
            self._journaled_seq = self._replica_seq
        except Exception:
            logger.warning("serve journal: meta write failed",
                           exc_info=True)

    def _journal_deployment(self, name: str):
        """Write one deployment's target state + replica membership.
        Caller holds the lock. Best-effort: a journal outage must not
        take down serving."""
        from ray_tpu_torch.serve._private import journal
        info = self._deployments.get(name)
        try:
            if info is None:
                journal.delete_deployment(name)
                return
            journal.put_deployment(name, {
                "config": info.config,
                "version": info.version,
                "target_replicas": info.target_replicas,
                "replicas": [
                    {"name": info.replica_names.get(h._id_hex, ""),
                     "id": h._id_hex,
                     "version": v,
                     "draining": h in info.draining}
                    for h, v in info.replicas.items()],
            })
        except Exception:
            logger.warning("serve journal: write failed for %r", name,
                           exc_info=True)

    def _namespace(self) -> str:
        try:
            from ray_tpu_torch._private.worker import global_worker
            return global_worker().namespace
        except Exception:
            return ""

    def _recover_from_journal(self):
        """Rebuild ``_deployments`` from the GCS journal and re-adopt
        the live detached replica actors by name — the data plane keeps
        its processes (and its in-flight requests) across a controller
        restart."""
        from ray_tpu_torch.serve._private import journal
        try:
            meta, deps = journal.load_all()
        except Exception:
            logger.warning("serve journal: recovery read failed; "
                           "starting with empty state", exc_info=True)
            return
        if meta:
            self._replica_seq = max(self._replica_seq,
                                    int(meta.get("replica_seq", 0)))
        if not deps:
            return
        ns = (meta or {}).get("namespace", self._namespace())
        now = time.time()
        for name, rec in deps.items():
            try:
                info = _DeploymentInfo(rec["config"])
                info.target_replicas = int(
                    rec.get("target_replicas", info.target_replicas))
                for rep in rec.get("replicas", []):
                    h = self._readopt_replica(rep, ns)
                    if h is None:
                        continue
                    info.replicas[h] = rep.get("version", info.version)
                    info.replica_names[h._id_hex] = rep["name"]
                    self._bump_seq_past(rep["name"])
                    if rep.get("draining"):
                        # resume the interrupted drain with a fresh
                        # grace window
                        info.draining[h] = {
                            "deadline": now + info.graceful_timeout_s(),
                            "reason": "drain resumed after controller "
                                      "restart"}
                        try:
                            h.prepare_drain.remote()
                        except Exception:
                            logger.debug(
                                "serve: prepare_drain to resumed-"
                                "draining replica %s failed (dead? "
                                "health check removes it)",
                                rep["name"], exc_info=True)
                    else:
                        # it was serving a moment ago; health checks
                        # will demote it if that changed
                        info.ready.add(h)
                    self._adopted += 1
                self._deployments[name] = info
            except Exception:
                logger.warning("serve journal: skipping unrecoverable "
                               "deployment %r", name, exc_info=True)
        self._adopt_orphans(ns)
        self._recovered = True
        self._publish_route_table(force=True)
        logger.info("serve controller recovered from journal: "
                    "%d deployments, %d replicas re-adopted",
                    len(self._deployments), self._adopted)

    def _readopt_replica(self, rep: Dict[str, Any], namespace: str):
        """Name -> live ActorHandle, or None if the replica is gone
        (the reconcile loop will start a replacement)."""
        name = rep.get("name")
        if not name:
            return None
        try:
            from ray_tpu_torch._private.worker import global_worker
            from ray_tpu_torch.actor import ActorHandle
            from ray_tpu_torch.common.ids import ActorID
            w = global_worker()
            info = w.call_sync(w.gcs, "get_named_actor",
                               {"name": name, "namespace": namespace},
                               timeout=10)
            if info.get("error") or info.get("state") != "ALIVE":
                return None
            h = ActorHandle(ActorID.from_hex(info["actor_id"]),
                            info.get("class_name", ""))
            if info.get("worker_address"):
                h._worker_address = info["worker_address"]
            if info.get("node_id"):
                self._replica_nodes[h._id_hex] = info["node_id"]
            return h
        except Exception:
            logger.warning("serve journal: re-adopt of %r failed", name,
                           exc_info=True)
            return None

    def _bump_seq_past(self, replica_name: str):
        """Never reuse a live replica's name: advance the sequence past
        any adopted ``...#<seq>`` suffix (covers a journal meta write
        lost right before the crash)."""
        _, _, seq = replica_name.rpartition("#")
        try:
            self._replica_seq = max(self._replica_seq, int(seq))
        except ValueError:
            pass

    def _adopt_orphans(self, namespace: str):
        """A crash between replica creation and the journal write leaks
        a live detached replica the journal doesn't know. Sweep the
        actor directory for ``SERVE_REPLICA::*`` names we don't track:
        adopt the ones whose deployment still exists, kill the rest."""
        import ray_tpu_torch
        try:
            from ray_tpu_torch._private.worker import global_worker
            w = global_worker()
            named = w.call_sync(w.gcs, "list_named_actors",
                                {"namespace": namespace}, timeout=10)
        except Exception:
            return
        tracked = set()
        for info in self._deployments.values():
            tracked.update(info.replica_names.values())
        for entry in named or []:
            name = entry.get("name", "")
            if not name.startswith(REPLICA_NAME_PREFIX) or name in tracked:
                continue
            dep_name = name[len(REPLICA_NAME_PREFIX):].rpartition("#")[0]
            h = self._readopt_replica({"name": name}, namespace)
            if h is None:
                continue
            self._bump_seq_past(name)
            info = self._deployments.get(dep_name)
            version = None
            try:
                meta = ray_tpu_torch.get(h.get_replica_metadata.remote(),
                                         timeout=10.0)
                version = meta.get("version")
            except Exception:
                logger.debug("serve: no metadata from readopted "
                             "replica %r; assuming current version",
                             name, exc_info=True)
            if info is None:
                logger.warning("serve: killing orphan replica %r "
                               "(deployment gone)", name)
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    logger.debug("serve: kill of orphan replica %r "
                                 "failed (already gone?)", name,
                                 exc_info=True)
                continue
            info.replicas[h] = version or info.version
            info.replica_names[h._id_hex] = name
            self._adopted += 1

    # ---- API called by serve.run / handles ----

    def deploy_application(self, deployments: List[Dict[str, Any]]):
        """Set target state; reconciliation happens asynchronously. Only
        deployments of the SAME app are replaced — apps coexist
        (reference: multi-application serve)."""
        app_name = (deployments[0].get("app_name", "default")
                    if deployments else "default")
        with self._lock:
            new_names = {d["name"] for d in deployments}
            for d in deployments:
                existing = self._deployments.get(d["name"])
                if existing is not None and not \
                        existing.config.get("_deleted") and \
                        existing.config.get("app_name",
                                            "default") != app_name:
                    # a silent takeover would run app B's code under app
                    # A's routes; deployment names are cluster-unique
                    return {"error":
                            f"deployment {d['name']!r} already exists in "
                            f"app {existing.config.get('app_name')!r} — "
                            "deployment names must be unique across apps"}
                info = _DeploymentInfo(d)
                if existing is not None:
                    info.carry_over(existing)
                self._deployments[d["name"]] = info
                self._journal_deployment(d["name"])
            same_app = {n for n, i in self._deployments.items()
                        if i.config.get("app_name", "default") == app_name}
            for stale in same_app - new_names:
                self._deployments[stale].target_replicas = 0
                self._deployments[stale].config["_deleted"] = True
                self._journal_deployment(stale)
        self._reconcile_once()
        return "ok"

    def delete_deployments(self, names: List[str]):
        with self._lock:
            for n in names:
                if n in self._deployments:
                    self._deployments[n].target_replicas = 0
                    self._deployments[n].config["_deleted"] = True
                    self._journal_deployment(n)
        return "ok"

    def delete_application(self, app_name: str):
        """Tear down every deployment of one app (reference:
        serve.delete(app_name))."""
        with self._lock:
            for n, info in self._deployments.items():
                if info.config.get("app_name", "default") == app_name:
                    info.target_replicas = 0
                    info.config["_deleted"] = True
                    self._journal_deployment(n)
        self._reconcile_once()
        return "ok"

    def list_applications(self) -> Dict[str, List[str]]:
        with self._lock:
            out: Dict[str, List[str]] = {}
            for n, info in self._deployments.items():
                if info.config.get("_deleted"):
                    continue
                out.setdefault(
                    info.config.get("app_name", "default"), []).append(n)
            return out

    def listen_for_change(self, key: str, last_version: int):
        return self._long_poll.listen(key, last_version)

    def get_route_table(self):
        return self._long_poll.get("route_table")

    def get_deployment_statuses(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out = {}
            for name, info in self._deployments.items():
                if info.config.get("_deleted"):
                    continue
                live = sum(1 for h, v in info.replicas.items()
                           if v == info.version and h in info.ready
                           and h not in info.draining)
                stale = sum(1 for h, v in info.replicas.items()
                            if h not in info.draining
                            and (v != info.version or h in info.condemned))
                out[name] = {
                    "name": name,
                    "app": info.config.get("app_name", "default"),
                    # HEALTHY = the TARGET version is fully serving: a
                    # mid-rollout deployment (old version still in the
                    # table) reports UPDATING even though traffic flows
                    "status": ("HEALTHY"
                               if live >= info.target_replicas
                               and stale == 0
                               else "UPDATING"),
                    "target_replicas": info.target_replicas,
                    "live_replicas": live,
                    "stale_replicas": stale,
                    "draining_replicas": len(info.draining),
                    "version": info.version,
                }
                # scoped: only the deployment whose reconcile/health
                # pass errored carries the message
                if name in self._last_errors:
                    out[name]["last_controller_error"] = \
                        self._last_errors[name]
            return out

    def get_serve_metrics(self) -> Dict[str, Any]:
        """Live per-deployment data-plane metrics for the dashboard /
        Prometheus: queue depth (sum over replicas), shed totals +
        shed rate since the previous read, p99/EWMA service time —
        all from the ``replica_load`` telemetry the controller already
        collects every metrics tick (no extra replica RPCs here)."""
        statuses = self.get_deployment_statuses()
        now = time.time()
        out: Dict[str, Any] = {}
        for name, st in statuses.items():
            loads = (self._last_load_table or {}).get(name, {})
            queue_len = sum(v.get("queue_len", 0) for v in loads.values())
            shed_total = sum(v.get("shed", 0) for v in loads.values())
            requests_total = sum(v.get("total_requests", 0)
                                 for v in loads.values())
            errors_total = sum(v.get("total_errors", 0)
                               for v in loads.values())
            p99 = max((v.get("p99_s", 0.0) for v in loads.values()),
                      default=0.0)
            ewma = max((v.get("ewma_s", 0.0) for v in loads.values()),
                       default=0.0)
            prev = self._shed_prev.get(name)
            shed_rate = 0.0
            if prev and now > prev[0]:
                shed_rate = max(0.0, (shed_total - prev[1])
                                / (now - prev[0]))
            self._shed_prev[name] = (now, shed_total)
            out[name] = {
                "app": st.get("app"),
                "status": st.get("status"),
                "replicas": st.get("live_replicas"),
                "target_replicas": st.get("target_replicas"),
                "queue_len": queue_len,
                "shed_total": shed_total,
                "shed_rate_per_s": round(shed_rate, 3),
                "requests_total": requests_total,
                "errors_total": errors_total,
                "p99_s": round(p99, 6),
                "ewma_s": round(ewma, 6),
            }
            llm = _aggregate_llm(loads)
            if llm is not None:
                out[name]["llm"] = llm
        return out

    def get_controller_info(self) -> Dict[str, Any]:
        """Introspection for tests/bench/ops: restart identity, journal
        recovery outcome, and loop-level (non-deployment) errors."""
        return {
            "pid": os.getpid(),
            "recovered": self._recovered,
            "adopted_replicas": self._adopted,
            "replica_seq": self._replica_seq,
            "last_error": self._last_error,
        }

    def get_http_port(self):
        return self._http_port

    def shutdown(self):
        """Explicit teardown (serve.shutdown): fast-stop every replica —
        graceful drain is for keeping traffic alive, and there is no
        traffic to keep alive after an intentional full teardown."""
        from ray_tpu_torch.serve._private import journal
        self._shutdown.set()
        with self._lock:
            handles = []
            for info in self._deployments.values():
                info.target_replicas = 0
                handles.extend(info.replicas)
                info.replicas = {}
                info.draining = {}
                info.ready = set()
            self._deployments = {}
        for h in handles:
            self._stop_replica(h)
        try:
            journal.clear()
        except Exception:
            logger.warning("serve journal: clear on shutdown failed",
                           exc_info=True)
        self._publish_route_table(force=True)
        return "ok"

    def ping(self):
        return "pong"

    # ---- reconciliation ----

    def _control_loop(self):
        from ray_tpu_torch._private import chaos
        while not self._shutdown.is_set():
            try:
                if chaos._ENGINE is not None:
                    # op "kill" = SIGKILL this worker; the GCS actor
                    # state machine restarts the controller, which
                    # recovers from the journal
                    chaos.hit("serve.controller.tick")
                self._refresh_node_view()
                self._reconcile_once()
                self._metrics_tick()
                self._health_check()
                self._last_error = None
            except Exception:
                # keep reconciling, but surface the failure
                self._last_error = traceback.format_exc(limit=8)
            self._shutdown.wait(1.0)

    def _refresh_node_view(self):
        """Draining-node set from the GCS node table: replicas living
        there must be replaced before the grace window closes."""
        try:
            from ray_tpu_torch._private.worker import global_worker
            w = global_worker()
            nodes = w.call_sync(w.gcs, "get_nodes", {}, timeout=5)
        except Exception:
            return  # keep the previous view
        self._draining_nodes = {
            n["node_id"]: float(n.get("drain_deadline_unix") or 0.0)
            for n in nodes
            if n.get("alive") and n.get("draining")}

    def _start_replica(self, name: str, info: _DeploymentInfo):
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.replica import ReplicaActor
        cfg = info.config
        self._replica_seq += 1
        mcq = cfg.get("max_concurrent_queries", 100)
        max_queued = cfg.get("max_queued_requests")
        if max_queued is None:
            from ray_tpu_torch.serve._private.replica import \
                _default_max_queued
            max_queued = _default_max_queued(mcq)
        replica_name = f"{REPLICA_NAME_PREFIX}{name}#{self._replica_seq}"
        opts = dict(
            name=replica_name,
            # The actor thread pool must hold executing requests (mcq) +
            # the bounded waiting room (max_queued: threads parked on the
            # replica's execution semaphore) + headroom so a saturated
            # replica still answers check_health/get_load control probes
            # — admission control sheds anything beyond that.
            max_concurrency=mcq + max_queued + 4,
            lifetime="detached",
        )
        if cfg.get("ray_actor_options"):
            opts.update(cfg["ray_actor_options"])
        actor_cls = ray_tpu_torch.remote(**opts)(ReplicaActor)
        h = actor_cls.remote(
            name, cfg["serialized_callable"],
            tuple(cfg.get("init_args") or ()),
            dict(cfg.get("init_kwargs") or {}),
            user_config=cfg.get("user_config"),
            version=info.version,
            max_concurrent_queries=mcq,
            max_queued_requests=max_queued,
            replica_name=replica_name)
        info.replicas[h] = info.version
        info.replica_names[h._id_hex] = replica_name
        return h

    def _stop_replica(self, handle):
        import ray_tpu_torch
        try:
            # wait (bounded) for the graceful hook BEFORE killing, else
            # the kill races ahead of the fire-and-forget RPC
            ray_tpu_torch.get(handle.prepare_for_shutdown.remote(),
                              timeout=5.0)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            pass

    def _forget_replica(self, info: _DeploymentInfo, h):
        """Drop every trace of a replica from one deployment's state.
        Caller holds the lock."""
        info.replicas.pop(h, None)
        info.ready.discard(h)
        info.draining.pop(h, None)
        info.condemned.discard(h)
        info.health_fails.pop(h._id_hex, None)
        info.replica_names.pop(h._id_hex, None)
        self._replica_nodes.pop(h._id_hex, None)

    def _least_loaded(self, name: str, handles) -> List[Any]:
        """Sort by last-reported queue depth ascending (the downscale /
        drain victim order) — never evict the busiest replica when a
        quieter one frees the same capacity."""
        loads = self._last_load_table.get(name, {})

        def key(h):
            rep = loads.get(h._id_hex) or {}
            return (float(rep.get("queue_len", 0.0)), h._id_hex)

        return sorted(handles, key=key)

    def _lookup_replica_node(self, h) -> Optional[str]:
        nid = self._replica_nodes.get(h._id_hex)
        if nid is not None:
            return nid
        try:
            from ray_tpu_torch._private.worker import global_worker
            w = global_worker()
            info = w.call_sync(w.gcs, "get_actor",
                               {"actor_id": h._id_hex}, timeout=5)
            nid = info.get("node_id")
            if nid:
                self._replica_nodes[h._id_hex] = nid
            return nid
        except Exception:
            return None

    def _begin_drain(self, name: str, info: _DeploymentInfo, h,
                     reason: str):
        """Take a replica out of service WITHOUT dropping its work:
        remove it from the published table (caller republishes), tell
        it to shed new arrivals retriably, and schedule the kill for
        when it is idle (bounded by graceful_shutdown_timeout_s)."""
        now = time.time()
        deadline = now + info.graceful_timeout_s()
        if h in info.condemned:
            # finish before the node's own grace window slams shut
            node_dl = self._draining_nodes.get(
                self._replica_nodes.get(h._id_hex) or "", 0.0)
            if node_dl:
                deadline = min(deadline, max(now, node_dl - 1.0))
        # "notified" stays False for one propagation window: the route
        # table WITHOUT this replica must reach routers before the
        # replica starts shedding stragglers (else requests assigned in
        # the window surface errors instead of landing elsewhere)
        info.draining[h] = {"deadline": deadline, "begun": now,
                            "notified": False, "reason": reason}
        info.ready.discard(h)
        logger.info("serve: draining replica %s of %r (%s)",
                    info.replica_names.get(h._id_hex,
                                           h._id_hex[:8]), name, reason)

    def _reconcile_deployment(self, name: str, info: _DeploymentInfo
                              ) -> bool:
        """One deployment's convergence step. Caller holds the lock.
        Returns True when membership (and thus the route table or the
        journal) changed."""
        changed = False
        # 0) condemn replicas on draining nodes — they need start-
        # before-stop replacement exactly like a stale version
        if self._draining_nodes:
            for h in list(info.replicas):
                if h in info.draining or h in info.condemned:
                    continue
                nid = self._lookup_replica_node(h)
                if nid and nid in self._draining_nodes:
                    info.condemned.add(h)
                    changed = True
        cur = [h for h, v in info.replicas.items()
               if v == info.version and h not in info.draining
               and h not in info.condemned]
        stale = [h for h in info.replicas
                 if h not in info.draining and h not in cur]
        target = max(0, info.target_replicas)
        surge = _max_surge()
        # 1) start-before-stop: bring the current version up first.
        # Initial deploys (no stale) scale straight to target; rolling
        # updates are bounded to `surge` extra replicas per wave.
        while len(cur) < target and len(cur) + len(stale) < target + surge:
            cur.append(self._start_replica(name, info))
            changed = True
        # 2) the health gate: drain stale replicas only one-for-one
        # against new replicas that PASSED health checks — a broken new
        # version never takes the old one down
        ready_cur = sum(1 for h in cur if h in info.ready)
        n_drain = min(len(stale), max(0, ready_cur + len(stale) - target))
        if n_drain:
            for h in self._least_loaded(name, stale)[:n_drain]:
                self._begin_drain(name, info, h, "rolling update")
                changed = True
        # 3) downscale: drain the least-loaded current-version replicas
        if len(cur) > target:
            for h in self._least_loaded(name, cur)[:len(cur) - target]:
                self._begin_drain(name, info, h, "downscale")
                changed = True
        return changed

    def _reconcile_once(self):
        changed = False
        drain_polls: List[Tuple[str, _DeploymentInfo, Any,
                                Dict[str, Any]]] = []
        with self._lock:
            for name, info in list(self._deployments.items()):
                try:
                    if self._reconcile_deployment(name, info):
                        changed = True
                        self._journal_deployment(name)
                    self._last_errors.pop(name, None)
                except Exception:
                    self._last_errors[name] = traceback.format_exc(limit=8)
                for h, st in info.draining.items():
                    drain_polls.append((name, info, h, st))
            self._journal_meta()
        # poll draining replicas outside the lock (an RPC per draining
        # replica; a wedged one must not block deploys/statuses)
        if self._poll_draining(drain_polls):
            changed = True
        if changed:
            self._publish_route_table()

    def _poll_draining(self, polls) -> bool:
        """Kill each draining replica once its in-flight count reaches
        zero or its grace deadline passes."""
        import ray_tpu_torch
        if not polls:
            return False
        changed = False
        now = time.time()
        for name, info, h, st in polls:
            # give the replica-less route table one propagation window
            # (long-poll push is ~ms; 1 s covers a reconnecting client)
            # before shedding/killing
            if now - st.get("begun", now) < min(
                    1.0, max(0.0, st["deadline"] - st.get("begun", now))):
                continue
            if not st.get("notified"):
                st["notified"] = True
                try:
                    h.prepare_drain.remote()
                except Exception:
                    logger.debug("serve: prepare_drain to draining "
                                 "replica %s failed (dead? drain "
                                 "completes on the deadline)", name,
                                 exc_info=True)
            idle = False
            if now < st["deadline"]:
                try:
                    load = ray_tpu_torch.get(h.get_load.remote(), timeout=2.0)
                    idle = load.get("queue_len", 0) <= 0
                except Exception:
                    idle = True  # dead/unreachable: nothing left to drain
            if not idle and now < st["deadline"]:
                continue
            self._stop_replica(h)
            with self._lock:
                self._forget_replica(info, h)
                live = self._deployments.get(name)
                if live is not None:
                    if live is not info:
                        self._forget_replica(live, h)
                    if live.config.get("_deleted") and not live.replicas:
                        del self._deployments[name]
                    self._journal_deployment(name)
            changed = True
        return changed

    @staticmethod
    def _llm_roles_map(info, replica_hexes) -> Optional[Dict[str, str]]:
        """Assign prefill/decode roles over a disaggregated LLM
        deployment's live replicas (``llm_roles`` in the config,
        e.g. ``{"prefill": 1, "decode": 2}``).  Assignment is by
        replica AGE (detached actor names carry a monotonically
        increasing #seq): the oldest ``n_prefill`` replicas prefill,
        the rest decode.  Age-stable ordering means a rolling update
        replaces roles one replica at a time instead of reshuffling
        the whole fleet on every wave."""
        roles_cfg = info.config.get("llm_roles")
        if not roles_cfg or not replica_hexes:
            return None
        ordered = sorted(replica_hexes,
                         key=lambda hx: info.replica_names.get(hx, hx))
        n_prefill = max(0, int(roles_cfg.get("prefill", 0)))
        out = {}
        for i, hx in enumerate(ordered):
            out[hx] = "prefill" if i < n_prefill else "decode"
        return out

    def _publish_route_table(self, force: bool = False):
        with self._lock:
            table = {}
            for name, info in self._deployments.items():
                if info.config.get("_deleted"):
                    continue
                replicas = [h._id_hex
                            for h in info.replicas
                            if h in info.ready
                            and h not in info.draining]
                table[name] = {
                    # only health-confirmed replicas carry traffic: a
                    # just-started (possibly broken) replica enters the
                    # table when its first probe passes, and a draining
                    # replica is already out — removal from the table
                    # is step 1 of the drain
                    "replicas": replicas,
                    "max_concurrent_queries":
                        info.config.get("max_concurrent_queries", 100),
                    "max_queued_requests":
                        info.config.get("max_queued_requests"),
                    "routing_policy": info.config.get("routing_policy"),
                    "route_prefix": info.config.get("route_prefix"),
                    "pass_http_path":
                        bool(info.config.get("pass_http_path")),
                    "pass_http_method":
                        bool(info.config.get("pass_http_method")),
                }
                roles = self._llm_roles_map(info, replicas)
                if roles is not None:
                    table[name]["replica_roles"] = roles
            if not force and table == self._last_published_table:
                return
            self._last_published_table = table
        self._long_poll.notify_changed("route_table", table)

    def _health_check(self):
        """Probe EVERY replica concurrently (one wedged probe no longer
        delays the others by its full timeout), and remove a replica
        only after ``RTT_SERVE_HEALTH_FAILURES`` consecutive failures —
        except a definitively dead actor, which is removed at once. A
        replica still constructing (never ready) is removed only dead;
        a removed replica is killed (its GPU grant frees)."""
        import ray_tpu_torch
        from ray_tpu_torch import exceptions as rexc
        with self._lock:
            probes = [(name, info, h)
                      for name, info in self._deployments.items()
                      for h in list(info.replicas)
                      if h not in info.draining]
        if not probes:
            return
        refs = [h.check_health.remote() for _, _, h in probes]
        done, _pending = ray_tpu_torch.wait(
            refs, num_returns=len(refs), timeout=_health_timeout_s())
        done_ids = {id(r) for r in done}
        threshold = _health_failure_threshold()
        removals = []
        newly_ready = False
        with self._lock:
            for (name, info, h), ref in zip(probes, refs):
                ok = dead = False
                if id(ref) in done_ids:
                    try:
                        ray_tpu_torch.get(ref, timeout=5.0)
                        ok = True
                    except (rexc.ActorDiedError,
                            rexc.ActorUnavailableError):
                        dead = True
                    except Exception:
                        # user check_health raised / probe error:
                        # neither ok nor dead — counts as a miss below
                        logger.debug("serve: health probe on a %r "
                                     "replica errored", name,
                                     exc_info=True)
                if h not in info.replicas:
                    continue  # removed by a concurrent path meanwhile
                if ok:
                    info.health_fails.pop(h._id_hex, None)
                    if h not in info.ready:
                        info.ready.add(h)
                        newly_ready = True
                    continue
                if not dead and h not in info.ready:
                    continue  # still constructing: a miss is its build
                fails = info.health_fails.get(h._id_hex, 0) + 1
                info.health_fails[h._id_hex] = fails
                if dead or fails >= threshold:
                    removals.append((name, info, h))
            for name, info, h in removals:
                logger.warning(
                    "serve: removing unhealthy replica %s of %r",
                    info.replica_names.get(h._id_hex, h._id_hex[:8]),
                    name)
                self._forget_replica(info, h)
                self._journal_deployment(name)
        for _name, _info, h in removals:
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                pass  # already dead
        if newly_ready:
            # a replica passing its FIRST probe enters the route table
            # (and may unlock the next rolling-update wave)
            self._publish_route_table()
        if removals:
            # routers must stop picking the dead replicas NOW — the next
            # reconcile replaces them, but the table with them removed
            # has to go out immediately
            self._publish_route_table()
            self._reconcile_once()

    def _metrics_tick(self):
        """Collect per-replica load (queue depth incl. the bounded
        waiting room + EWMA service time), publish it on the
        ``replica_load`` long-poll key for load-aware routing, and feed
        the same queue metrics to the autoscaler."""
        import ray_tpu_torch
        now = time.time()
        with self._lock:
            items = [(name, info,
                      [h for h in info.replicas if h not in info.draining])
                     for name, info in self._deployments.items()
                     if not info.config.get("_deleted")]
        load_table: Dict[str, Dict[str, Any]] = {}
        for name, info, handles in items:
            per_replica = {}
            total_queue = 0.0
            for h in handles:
                try:
                    load = ray_tpu_torch.get(h.get_load.remote(), timeout=5.0)
                    per_replica[h._id_hex] = load
                    total_queue += load.get("queue_len", 0)
                # dead/slow replica: the health check owns removal;
                # routers just won't get a fresh report for it
                except Exception:
                    pass
            if per_replica:
                load_table[name] = per_replica
            if info.autoscaler is not None:
                # queue_len (ongoing + queued) — a replica with a full
                # waiting room now registers as load even when its
                # execution slots cap num_ongoing. LLM replicas also
                # report engine telemetry (tokens/s, KV occupancy)
                # that the policy may scale on (docs/LLM_SERVING.md).
                decision = info.autoscaler.get_decision(
                    len(handles), total_queue, now,
                    signals=_aggregate_llm(
                        per_replica,
                        roles=self._llm_roles_map(
                            info, list(per_replica))))
                if decision != info.target_replicas:
                    with self._lock:
                        info.target_replicas = decision
                        self._journal_deployment(name)
        if load_table or self._last_load_table:
            self._last_load_table = load_table
            self._long_poll.notify_changed("replica_load", load_table)
