"""GCS — the head-node control plane.

Role-equivalent to the reference's gcs_server (reference:
src/ray/gcs/gcs_server/gcs_server.cc wiring gcs_node_manager,
gcs_actor_manager + gcs_actor_scheduler, gcs_job_manager,
gcs_placement_group_manager/_scheduler, gcs_kv_manager, pubsub_handler,
gcs_health_check_manager). One asyncio process holds:

  - node table + resource view (raylets report periodically — the analogue of
    the ray_syncer resource gossip, common/ray_syncer/ray_syncer.h)
  - cluster scheduler: hybrid pack/spread node selection for spillback and
    actor placement, TPU-slice aware
  - actor directory + state machine (DEPENDENCIES_UNREADY → PENDING_CREATION →
    ALIVE ⇄ RESTARTING → DEAD, reference: src/ray/design_docs/actor_states.rst);
    pending actors of one demand are placed in the order they arrived (the
    port's addition to the JAX package's GCS: ``_older_actor_waiting``)
  - placement groups with 2-phase commit against raylets (reference:
    gcs_placement_group_scheduler.cc Prepare/Commit/CancelResourceReserve)
  - KV store (function blobs, runtime-env URIs, cluster metadata, rendezvous)
  - pubsub channels (actor state, node events, logs, errors)
  - object directory (object -> node locations, for inter-node transfer)
  - job table
  - health: an active disconnect/heartbeat monitor; node death is broadcast

State is held in plain dicts; a `StoreClient` abstraction (in-memory default,
file-backed snapshot optional) mirrors the reference's pluggable gcs storage
(gcs/store_client/) so GCS fault tolerance can be added without changing
managers.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import task_events as tev
from ray_tpu_torch._private.gcs_store import StoreClient, make_store
from ray_tpu_torch.common.config import SystemConfig

logger = logging.getLogger(__name__)


# ------------------------------------------------------------------
# List pagination + server-side filtering (shared by every list_*
# handler; reference: the dashboard state_aggregator's ListApiOptions
# — limit / server-side filters / a continuation token so no RPC ever
# carries the full table of a large cluster in one response).

def _match_row(row: Dict[str, Any], filters: Optional[Dict[str, Any]]
               ) -> bool:
    """Equality filter pushdown; a list/tuple value means membership."""
    if not filters:
        return True
    for k, v in filters.items():
        have = row.get(k)
        if isinstance(v, (list, tuple)):
            if have not in v:
                return False
        elif have != v:
            return False
    return True


_LIST_LIMIT_DEFAULT = 1000
_LIST_LIMIT_MAX = 10_000


def paginate(rows, payload: Dict[str, Any], id_key: str):
    """Apply filters, then (when the client asked for the paged shape)
    sort by the stable ``id_key`` and cut a cursor page.

    Legacy callers (no ``paged`` flag) get the old bare-list reply, so
    every pre-pagination peer keeps working; paged callers get
    ``{"items", "next_token", "total"}`` where ``next_token`` is the
    last id of the page — pass it back to resume strictly after it
    (ids are unique + the sort is stable, so pages never overlap and
    their union is the full filtered set even as rows churn).
    """
    payload = payload or {}
    filters = payload.get("filters")
    rows = [r for r in rows if _match_row(r, filters)]
    if not payload.get("paged"):
        return rows
    rows.sort(key=lambda r: str(r.get(id_key, "")))
    total = len(rows)
    token = payload.get("continuation_token")
    if token:
        rows = [r for r in rows if str(r.get(id_key, "")) > str(token)]
    limit = int(payload.get("limit") or _LIST_LIMIT_DEFAULT)
    limit = max(1, min(limit, _LIST_LIMIT_MAX))
    page = rows[:limit]
    next_token = str(page[-1].get(id_key, "")) \
        if len(rows) > limit and page else None
    return {"items": page, "next_token": next_token, "total": total}


class TaskEventTable:
    """Bounded, indexed task table fed by the task-event pipeline
    (reference: gcs_task_manager.cc GcsTaskManager — same contract:
    RAY_task_events_max_num_task_in_gcs cap, oldest-finished evicted
    first, a visible drop counter instead of silent loss).

    Never O(all-tasks-ever): memory is ``cap`` records; everything
    beyond it increments ``dropped`` and disappears.
    """

    def __init__(self, cap: Optional[int] = None):
        if cap is None:
            cap = int(os.environ.get("RTT_TASK_TABLE_MAX", 32768))
        self.cap = max(1, int(cap))
        self.records: Dict[str, Dict[str, Any]] = {}
        from collections import deque
        self._terminal_order: "deque[str]" = deque()
        self.dropped = 0          # records evicted past the cap
        self.events_dropped = 0   # process-ring overflow (reported in)
        self.state_counts: Dict[str, int] = {}
        self.total_seen = 0       # records ever created
        # trace_id -> {task_id}: lets get_trace synthesize task-phase
        # spans without scanning the whole table (bounded by the same
        # cap — entries die with their records)
        self.trace_index: Dict[str, set] = {}

    def _count(self, state: Optional[str], delta: int):
        if state:
            self.state_counts[state] = \
                self.state_counts.get(state, 0) + delta

    def apply(self, ev: Dict[str, Any]):
        tid = ev.get("task_id")
        state = ev.get("state")
        if not tid or state not in tev.STATE_RANK:
            return
        rec = self.records.get(tid)
        if rec is None:
            rec = {"task_id": tid, "state": state, "attempt": 0,
                   "created_ts": ev.get("ts")}
            self.records[tid] = rec
            self.total_seen += 1
            self._count(state, +1)
            self._evict()
        # fields merge regardless of ordering (a late PENDING event
        # still fills in name/job_id it uniquely knows)
        for k in ("name", "job_id", "node_id", "worker_pid",
                  "trace_ctx", "dispatch_ts", "deser_s", "ship_s"):
            if ev.get(k) is not None:
                rec[k] = ev[k]
        tc = rec.get("trace_ctx")
        if tc and tc.get("trace_id"):
            self.trace_index.setdefault(tc["trace_id"], set()).add(tid)
        attempt = int(ev.get("attempt") or 0)
        old_rank = tev.STATE_RANK.get(rec["state"], -1)
        new_rank = tev.STATE_RANK[state]
        if attempt > rec["attempt"]:
            # a retry restarts the lifecycle: state may regress (and
            # the previous attempt's phase timestamps no longer
            # describe this lifecycle)
            rec["attempt"] = attempt
            rec.pop("state_ts", None)
            rec.pop("dispatch_ts", None)
            advance = True
        elif attempt < rec["attempt"]:
            # stale attempt (flush ticks race across processes): its
            # terminal state must not override the newer attempt
            advance = False
        else:
            advance = new_rank >= old_rank
        if advance and rec["state"] != state:
            self._count(rec["state"], -1)
            self._count(state, +1)
            rec["state"] = state
        if attempt == rec["attempt"] and ev.get("ts") is not None:
            # per-state wall clock: what get_trace synthesizes the
            # task's queue/schedule/dispatch/execute spans from.
            # Recorded REGARDLESS of advance — flush ticks from
            # different processes race, so a worker's FINISHED often
            # lands before the raylet's queue stamp; each state's ts is
            # a fact of this attempt, not a merge-ordering outcome
            # (first event per state wins: the raylet re-emits its
            # state at dispatch time to carry dispatch_ts).
            rec.setdefault("state_ts", {}).setdefault(state, ev["ts"])
        if advance:
            if state == tev.RUNNING:
                rec["start_ts"] = ev.get("ts")
            elif state in tev.TERMINAL_STATES:
                rec["end_ts"] = ev.get("ts")
                if rec.get("start_ts") and ev.get("ts"):
                    rec["duration_s"] = round(
                        ev["ts"] - rec["start_ts"], 6)
                if ev.get("error") is not None:
                    rec["error"] = str(ev["error"])[:500]
                self._terminal_order.append(tid)

    def _evict(self):
        while len(self.records) > self.cap:
            victim = None
            # oldest-terminal first: live tasks are what an operator is
            # debugging; history is what we can afford to forget
            while self._terminal_order:
                cand = self._terminal_order.popleft()
                rec = self.records.get(cand)
                if rec is not None and \
                        rec["state"] in tev.TERMINAL_STATES:
                    victim = cand
                    break
            if victim is None:
                victim = next(iter(self.records))
            rec = self.records.pop(victim, None)
            if rec is not None:
                self._count(rec["state"], -1)
                self.dropped += 1
                tc = rec.get("trace_ctx") or {}
                tids = self.trace_index.get(tc.get("trace_id"))
                if tids is not None:
                    tids.discard(victim)
                    if not tids:
                        self.trace_index.pop(tc["trace_id"], None)

    def summary(self) -> Dict[str, Any]:
        return {"total": len(self.records),
                "total_seen": self.total_seen,
                "by_state": dict(self.state_counts),
                "dropped": self.dropped,
                "events_dropped": self.events_dropped,
                "cap": self.cap}


class TraceTable:
    """Bounded, indexed span store fed by the ``trace_spans`` pipeline
    (the TaskEventTable contract applied to traces: a hard span cap,
    oldest-updated trace evicted first, a visible drop counter instead
    of silent loss or OOM).

    Spans group by trace_id; insertion order of the ``traces`` dict is
    maintained as LRU-by-last-update so eviction is O(1) amortized.
    """

    def __init__(self, cap: Optional[int] = None,
                 per_trace_cap: Optional[int] = None):
        if cap is None:
            cap = int(os.environ.get("RTT_TRACE_TABLE_MAX", 65536))
        if per_trace_cap is None:
            per_trace_cap = int(os.environ.get(
                "RTT_TRACE_MAX_SPANS", 512))
        self.cap = max(1, int(cap))
        self.per_trace_cap = max(1, int(per_trace_cap))
        # trace_id -> {"spans": [...], "updated_ts", "start_ts",
        # "end_ts", "root_name", "error"}  (dict preserves insertion
        # order; re-insert on update = LRU)
        self.traces: Dict[str, Dict[str, Any]] = {}
        self.total_spans = 0
        self.dropped_spans = 0      # evicted/over-cap spans
        self.spans_dropped_rings = 0  # process-ring overflow (reported)
        self.total_seen = 0

    def apply(self, span: Dict[str, Any]):
        tid = span.get("trace_id")
        if not tid or span.get("span_id") is None:
            return
        self.total_seen += 1
        ent = self.traces.pop(tid, None)
        if ent is None:
            ent = {"spans": [], "start_ts": span.get("start_ts"),
                   "end_ts": span.get("end_ts"), "root_name": None,
                   "error": False}
        self.traces[tid] = ent  # re-insert: newest at the end
        ent["updated_ts"] = time.time()
        if len(ent["spans"]) >= self.per_trace_cap:
            self.dropped_spans += 1
            return
        ent["spans"].append(span)
        self.total_spans += 1
        ts0, ts1 = span.get("start_ts"), span.get("end_ts")
        if ts0 is not None and (ent["start_ts"] is None
                                or ts0 < ent["start_ts"]):
            ent["start_ts"] = ts0
        if ts1 is not None and (ent["end_ts"] is None
                                or ts1 > ent["end_ts"]):
            ent["end_ts"] = ts1
        if span.get("status") == "error":
            ent["error"] = True
        if span.get("parent_span_id") in (None, "", "root"):
            ent["root_name"] = span.get("name")
        self._evict()

    def _evict(self):
        while self.total_spans > self.cap and len(self.traces) > 1:
            victim_id = next(iter(self.traces))  # oldest-updated
            victim = self.traces.pop(victim_id)
            self.total_spans -= len(victim["spans"])
            self.dropped_spans += len(victim["spans"])

    def get(self, trace_id: str) -> List[Dict[str, Any]]:
        ent = self.traces.get(trace_id)
        return list(ent["spans"]) if ent else []

    def summary_rows(self) -> List[Dict[str, Any]]:
        rows = []
        for tid, ent in self.traces.items():
            t0, t1 = ent.get("start_ts"), ent.get("end_ts")
            rows.append({
                "trace_id": tid,
                "root": ent.get("root_name"),
                "spans": len(ent["spans"]),
                "start_ts": t0,
                "duration_s": (round(t1 - t0, 6)
                               if t0 is not None and t1 is not None
                               else None),
                "status": "error" if ent.get("error") else "ok",
            })
        return rows

    def summary(self) -> Dict[str, Any]:
        return {"traces": len(self.traces),
                "spans": self.total_spans,
                "total_seen": self.total_seen,
                "dropped_spans": self.dropped_spans,
                "spans_dropped_rings": self.spans_dropped_rings,
                "cap": self.cap}


# Actor states (reference: design_docs/actor_states.rst)
DEPS_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class NodeInfo:
    def __init__(self, node_id: str, payload: Dict[str, Any],
                 conn: protocol.Connection):
        self.node_id = node_id
        self.raylet_address: str = payload["raylet_address"]
        # 1.8: netx transfer endpoint ('' = node serves asyncio-only)
        self.netx_address: str = payload.get("netx_address", "")
        self.object_store_path: str = payload["object_store_path"]
        self.hostname: str = payload.get("hostname", "")
        self.total_resources: Dict[str, float] = dict(payload["resources"])
        self.available_resources: Dict[str, float] = dict(payload["resources"])
        self.labels: Dict[str, str] = dict(payload.get("labels", {}))
        self.conn = conn
        self.alive = True
        # draining: preemption notice received; still alive (in-flight
        # work finishing) but the scheduler must not place onto it
        self.draining = False
        self.drain_deadline_unix = 0.0
        self.last_seen = time.monotonic()
        self.is_head = bool(payload.get("is_head"))
        # versioned sync state (reference: ray_syncer.h — per-node
        # versioned snapshots; stale versions dropped, epoch guards
        # against a restarted raylet's counter reset)
        self.sync_epoch: float = float(payload.get("sync_epoch", 0.0))
        self.sync_version: int = int(payload.get("sync_version", 0))
        self.view_stamp: int = 0  # cluster-view version this entry last changed at


class GcsServer:
    def __init__(self, config: SystemConfig,
                 store_path: Optional[str] = None):
        self.config = config
        # Persistence (reference: gcs/store_client/ + gcs_init_data.cc):
        # live state stays in dicts (hot path), every mutation writes through
        # to the store, and start() replays the store so a restarted GCS
        # rebuilds actors/PGs/jobs/KV. In-memory backend when no path given.
        self.store: StoreClient = make_store(store_path)
        self.nodes: Dict[str, NodeInfo] = {}
        self._view_version = 0  # cluster-view sync version (ray_syncer)
        self.kv: Dict[str, bytes] = {}
        self.actors: Dict[str, Dict[str, Any]] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}  # (ns, name) -> id
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.placement_groups: Dict[str, Dict[str, Any]] = {}
        self.object_locations: Dict[bytes, Set[str]] = {}
        self.object_owners: Dict[bytes, str] = {}  # object hex -> worker addr
        self.subscribers: Dict[str, Set[protocol.Connection]] = {}
        # bounded structured-event ring (reference: RAY_EVENT framework;
        # browsable via the state API / dashboard /api/events)
        from collections import deque
        self.events: "deque" = deque(maxlen=1000)
        # bounded task table fed by the task-event pipeline (reference:
        # gcs_task_manager.cc); cap via RTT_TASK_TABLE_MAX
        self.task_table = TaskEventTable()
        # bounded span store fed by the trace-span pipeline (cap via
        # RTT_TRACE_TABLE_MAX); get_trace merges it with task-phase
        # spans synthesized from the task table's per-state timestamps
        self.trace_table = TraceTable()
        # scheduler's pessimistic view of its own in-flight placements:
        # node_id -> [(expiry, demand)] (see _utilization)
        self._ephemeral_allocs: Dict[str, List[Tuple[float, Dict[str,
                                                                 float]]]] = {}
        self._spread_rr = -1
        # actors waiting for a node, by arrival: equal demands are placed
        # in this order (_older_actor_waiting)
        self._actor_tickets: Dict[str, int] = {}
        self._actors_waiting: Set[str] = set()   # no node found yet
        self._next_actor_ticket = 0
        self.next_job_index = 1
        self._server = protocol.Server(self._handlers())
        self._actor_creation_waiters: Dict[str, List[asyncio.Future]] = {}
        self._shutdown = asyncio.Event()

    # ------------------------------------------------------------------ wiring

    def _handlers(self):
        h = {
            "_on_connect": self._on_connect,
            "_on_disconnect": self._on_disconnect,
            "register_node": self.register_node,
            "resource_report": self.resource_report,
            "node_liveness": self.node_liveness,
            "get_nodes": self.get_nodes,
            "profile_stacks": self.profile_stacks,
            "profile_flamegraph": self.profile_flamegraph,
            "get_node_stats": self.get_node_stats,
            "drain_node": self.drain_node,
            "node_draining": self.node_draining,
            "node_drained": self.node_drained,
            "preempt_node": self.preempt_node,
            "kv_put": self.kv_put,
            "kv_get": self.kv_get,
            "kv_get_prefix": self.kv_get_prefix,
            "kv_del": self.kv_del,
            "kv_keys": self.kv_keys,
            "kv_exists": self.kv_exists,
            "next_job_id": self.next_job_id,
            "add_job": self.add_job,
            "get_jobs": self.get_jobs,
            "register_actor": self.register_actor,
            "create_actor": self.create_actor,
            "get_actor": self.get_actor,
            "get_named_actor": self.get_named_actor,
            "list_named_actors": self.list_named_actors,
            "actor_state_update": self.actor_state_update,
            "kill_actor": self.kill_actor,
            "wait_actor_alive": self.wait_actor_alive,
            "list_actors": self.list_actors,
            "add_event": self.add_event,
            "list_events": self.list_events,
            "task_events": self.task_events,
            "trace_spans": self.trace_spans,
            "get_trace": self.get_trace,
            "list_traces": self.list_traces,
            "list_tasks": self.list_tasks,
            "list_objects": self.list_objects,
            "summarize": self.summarize,
            "summarize_tasks": self.summarize_tasks,
            "configure_state": self.configure_state,
            "schedule": self.schedule,
            "create_placement_group": self.create_placement_group,
            "remove_placement_group": self.remove_placement_group,
            "get_placement_group": self.get_placement_group,
            "list_placement_groups": self.list_placement_groups,
            "subscribe": self.subscribe,
            "unsubscribe": self.unsubscribe,
            "publish": self.publish,
            "add_object_location": self.add_object_location,
            "remove_object_location": self.remove_object_location,
            "get_object_locations": self.get_object_locations,
            "cluster_resources": self.cluster_resources,
            "available_resources": self.available_resources,
            "ping": self.ping,
        }
        return h

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._load_persisted()
        self.port = await self._server.start_tcp(host, port)
        protocol.spawn(self._health_loop())
        self._resume_interrupted()
        logger.info("GCS listening on %s:%s", host, self.port)
        return self.port

    # ------------------------------------------------------------ persistence

    def _load_persisted(self):
        """Rebuild manager state from the store (reference:
        gcs_init_data.cc LoadJobTableData/LoadActorTableData/...)."""
        restart_actors: List[str] = []
        restart_pgs: List[str] = []
        for table, key, value in self.store.load_all():
            if table == "kv":
                self.kv[key] = value
            elif table == "jobs":
                self.jobs[key] = value
            elif table == "actors":
                self.actors[key] = value
                if value.get("state") in (PENDING_CREATION, RESTARTING,
                                          DEPS_UNREADY):
                    restart_actors.append(key)
            elif table == "named_actors":
                ns, _, name = key.partition("\x00")
                self.named_actors[(ns, name)] = value
            elif table == "pgs":
                self.placement_groups[key] = value
                if value.get("state") == "PENDING":
                    restart_pgs.append(key)
            elif table == "meta":
                if key == "next_job_index":
                    self.next_job_index = int(value)
        if self.actors or self.placement_groups or self.kv:
            logger.info(
                "GCS state rebuilt from store: %d actors, %d PGs, %d jobs, "
                "%d kv keys", len(self.actors), len(self.placement_groups),
                len(self.jobs), len(self.kv))
        self._pending_restart_actors = restart_actors
        self._pending_restart_pgs = restart_pgs

    def _resume_interrupted(self):
        """Re-kick scheduling work that was in flight when the GCS died.
        Called once the server is accepting raylet re-registrations."""
        for aid in getattr(self, "_pending_restart_actors", []):
            protocol.spawn(self._schedule_actor(aid))
        for pg_id in getattr(self, "_pending_restart_pgs", []):
            protocol.spawn(self._retry_pg(pg_id))
        self._pending_restart_actors = []
        self._pending_restart_pgs = []
        if self.actors or self.placement_groups:
            protocol.spawn(
                self._reconcile_after_restart())

    async def _reconcile_after_restart(self):
        """Nodes that died while the GCS was down never re-register, so
        persisted ALIVE actors / CREATED PGs pointing at them would hang
        forever. After a re-registration grace period, fail those actors
        over (restart policy applies) and re-place those PGs."""
        await asyncio.sleep(self.config.health_check_timeout_s)
        live = {nid for nid, n in self.nodes.items() if n.alive}
        for aid, info in list(self.actors.items()):
            if info["state"] in (ALIVE, RESTARTING, PENDING_CREATION) and \
                    info.get("node_id") and info["node_id"] not in live:
                await self._handle_actor_failure(
                    aid, "node lost during GCS downtime")
        for pg_id, pg in list(self.placement_groups.items()):
            if pg.get("state") == "CREATED" and pg.get("assignment") and \
                    any(nid not in live for nid in pg["assignment"]):
                pg["state"] = "PENDING"
                pg["assignment"] = None
                self._persist_pg(pg_id)
                protocol.spawn(self._retry_pg(pg_id))

    def _persist_actor(self, aid: str):
        info = self.actors.get(aid)
        if info is not None:
            self.store.put("actors", aid, info)

    def _persist_pg(self, pg_id: str):
        pg = self.placement_groups.get(pg_id)
        if pg is not None:
            self.store.put("pgs", pg_id, pg)

    async def _on_connect(self, conn):
        pass

    async def _on_disconnect(self, conn):
        # raylet connection drop == node death (active health check analogue,
        # reference: gcs_health_check_manager.cc). A raylet that re-dialed
        # (ReconnectingConnection) re-registers with a NEW conn before the
        # old one's EOF is processed — only the node's current conn counts.
        node_id = conn.meta.get("node_id")
        if node_id and node_id in self.nodes and self.nodes[node_id].alive \
                and self.nodes[node_id].conn is conn:
            await self._mark_node_dead(node_id, "raylet disconnected")
        for channel in list(self.subscribers):
            subs = self.subscribers[channel]
            subs.discard(conn)
            if not subs:
                self.subscribers.pop(channel, None)

    # ------------------------------------------------------------- events

    def _event(self, severity: str, label: str, message: str, **fields):
        from ray_tpu_torch.util import events as ev
        event = ev.report(severity, label, message, **fields)
        event["source"] = "gcs"
        self.events.append(event)

    async def add_event(self, payload, conn):
        self.events.append(payload)
        return {}

    async def list_events(self, payload, conn):
        payload = payload or {}
        limit = payload.get("limit", 200)
        sev = payload.get("severity")
        out = [e for e in self.events
               if sev is None or e.get("severity") == sev]
        out = [e for e in out if _match_row(e, payload.get("filters"))]
        return out[-limit:] if limit and limit > 0 else []

    # ------------------------------------------------------ task state

    async def task_events(self, payload, conn):
        """Batched task lifecycle events from workers/raylets — folded
        into the bounded task table (never stored raw)."""
        payload = payload or {}
        self.task_table.events_dropped += int(payload.get("dropped") or 0)
        for ev in payload.get("events") or ():
            try:
                self.task_table.apply(ev)
            except Exception:
                logger.debug("bad task event dropped: %r", ev,
                             exc_info=True)
        return {}

    async def trace_spans(self, payload, conn):
        """Batched spans from the per-process tracing buffers — folded
        into the bounded trace table (never stored raw)."""
        payload = payload or {}
        self.trace_table.spans_dropped_rings += \
            int(payload.get("dropped") or 0)
        for span in payload.get("spans") or ():
            try:
                self.trace_table.apply(span)
            except Exception:
                logger.debug("bad span dropped: %r", span, exc_info=True)
        return {}

    async def get_trace(self, payload, conn):
        """One trace's full span set: explicit spans (serve, dag hops,
        object pulls) merged with task-lifecycle spans synthesized from
        the state engine's task records — assembled HERE, where both
        tables live, in one RPC."""
        from ray_tpu_torch._private import tracing
        trace_id = (payload or {}).get("trace_id") or ""
        spans = self.trace_table.get(trace_id)
        for task_id in sorted(
                self.task_table.trace_index.get(trace_id) or ()):
            rec = self.task_table.records.get(task_id)
            if rec is not None:
                spans.extend(tracing.synthesize_task_spans(rec))
        return {"trace_id": trace_id, "spans": spans,
                **{k: v for k, v in self.trace_table.summary().items()
                   if k in ("dropped_spans", "spans_dropped_rings")}}

    async def list_traces(self, payload, conn):
        """Cursor-paginated trace summaries: explicit-span traces plus
        task-only traces (a task tree whose trace never recorded an
        explicit span is still browsable)."""
        rows = self.trace_table.summary_rows()
        seen = {r["trace_id"] for r in rows}
        for tid, task_ids in self.task_table.trace_index.items():
            if tid in seen:
                continue
            recs = [self.task_table.records[t] for t in task_ids
                    if t in self.task_table.records]
            if not recs:
                continue
            starts = [r.get("created_ts") for r in recs
                      if r.get("created_ts") is not None]
            ends = [r.get("end_ts") for r in recs
                    if r.get("end_ts") is not None]
            rows.append({
                "trace_id": tid,
                "root": min(recs, key=lambda r: r.get("created_ts")
                            or 0).get("name"),
                "spans": len(recs),
                "start_ts": min(starts) if starts else None,
                "duration_s": (round(max(ends) - min(starts), 6)
                               if starts and ends else None),
                "status": ("error" if any(r.get("state") == "FAILED"
                                          for r in recs) else "ok"),
            })
        reply = paginate(rows, payload, "trace_id")
        if isinstance(reply, dict):
            reply["dropped"] = self.trace_table.dropped_spans
        return reply

    async def list_tasks(self, payload, conn):
        rows = [dict(r) for r in self.task_table.records.values()]
        reply = paginate(rows, payload, "task_id")
        if isinstance(reply, dict):
            reply["dropped"] = self.task_table.dropped
            reply["events_dropped"] = self.task_table.events_dropped
        return reply

    async def list_objects(self, payload, conn):
        """Cluster object listing: aggregates the PER-RAYLET plasma
        indexes (each raylet reports its own bounded page) instead of
        the GCS centralizing every object record — the head holds only
        the location directory, and one listing RPC never materializes
        more than ~limit rows per node."""
        payload = payload or {}
        limit = int(payload.get("limit") or _LIST_LIMIT_DEFAULT)
        limit = max(1, min(limit, _LIST_LIMIT_MAX))
        req = {"limit": limit,
               "continuation_token": payload.get("continuation_token")}
        fan = await self._fanout_to_raylets(
            "list_objects", req, node_id=payload.get("node_id"))
        merged: Dict[str, Dict[str, Any]] = {}
        truncated = False
        for node_reply in fan["nodes"]:
            if node_reply.get("error"):
                continue
            truncated = truncated or bool(node_reply.get("truncated"))
            for row in node_reply.get("objects") or ():
                oid = row["object_id"]
                have = merged.get(oid)
                if have is None:
                    have = merged[oid] = dict(row)
                    have["locations"] = []
                else:
                    # keep the richer copy's size/pinned/spilled bits
                    for k in ("size_bytes", "pinned", "spilled"):
                        if row.get(k):
                            have[k] = row[k]
                have["locations"].append(row.get("node_id"))
        for oid, rec in merged.items():
            rec["owner"] = self.object_owners.get(oid)
        rows = list(merged.values())
        reply = paginate(rows, payload, "object_id")
        if isinstance(reply, dict) and truncated and \
                not reply.get("next_token") and reply["items"]:
            # a raylet clipped its page at the limit: there IS more
            # even though the merged cut didn't overflow
            reply["next_token"] = reply["items"][-1]["object_id"]
        return reply

    async def summarize(self, payload, conn):
        """Cluster summary in ONE rpc — counts computed where the
        tables live instead of shipping full node/actor tables to the
        client just to len() them."""
        actors_by_state: Dict[str, int] = {}
        for info in self.actors.values():
            s = info.get("state") or "?"
            actors_by_state[s] = actors_by_state.get(s, 0) + 1
        return {
            "nodes_total": len(self.nodes),
            "nodes_alive": sum(1 for n in self.nodes.values() if n.alive),
            "nodes_draining": sum(1 for n in self.nodes.values()
                                  if n.alive and n.draining),
            "actors_total": len(self.actors),
            "actors_alive": actors_by_state.get(ALIVE, 0),
            "actors_by_state": actors_by_state,
            "jobs_total": len(self.jobs),
            "placement_groups_total": len(self.placement_groups),
            "objects_tracked": len(self.object_locations),
            "cluster_resources": await self.cluster_resources({}, conn),
            "available_resources": await self.available_resources({},
                                                                  conn),
            "tasks": self.task_table.summary(),
            "traces": self.trace_table.summary(),
        }

    async def summarize_tasks(self, payload, conn):
        """`ray-tpu summary tasks`: per-function aggregation over the
        bounded table (reference: `ray summary tasks`)."""
        by_func: Dict[str, Dict[str, Any]] = {}
        for rec in self.task_table.records.values():
            name = rec.get("name") or "(unknown)"
            agg = by_func.get(name)
            if agg is None:
                agg = by_func[name] = {"name": name, "count": 0,
                                       "by_state": {},
                                       "duration_sum_s": 0.0,
                                       "finished": 0}
            agg["count"] += 1
            st = rec["state"]
            agg["by_state"][st] = agg["by_state"].get(st, 0) + 1
            if rec.get("duration_s") is not None:
                agg["duration_sum_s"] += rec["duration_s"]
                agg["finished"] += 1
        for agg in by_func.values():
            if agg["finished"]:
                agg["mean_duration_s"] = round(
                    agg["duration_sum_s"] / agg["finished"], 6)
        return {"summary": sorted(by_func.values(),
                                  key=lambda a: -a["count"]),
                **self.task_table.summary()}

    async def configure_state(self, payload, conn):
        """Operator/test knob: resize the task table cap live (shrink
        evicts immediately, drop counter visible)."""
        cap = (payload or {}).get("task_table_max")
        if cap is not None:
            self.task_table.cap = max(1, int(cap))
            self.task_table._evict()
        tcap = (payload or {}).get("trace_table_max")
        if tcap is not None:
            self.trace_table.cap = max(1, int(tcap))
            self.trace_table._evict()
        return {"task_table_max": self.task_table.cap,
                "trace_table_max": self.trace_table.cap}

    async def _health_loop(self):
        period = self.config.health_check_period_s
        while not self._shutdown.is_set():
            await asyncio.sleep(period)
            now = time.monotonic()
            for node in list(self.nodes.values()):
                if node.alive and now - node.last_seen > \
                        self.config.health_check_timeout_s:
                    await self._mark_node_dead(node.node_id, "heartbeat timeout")

    async def _mark_node_dead(self, node_id: str, reason: str):
        node = self.nodes.get(node_id)
        if node is None:
            return
        node.alive = False
        self._bump_view(node)
        logger.warning("node %s dead: %s", node_id[:8], reason)
        self._event("ERROR", "NODE_DEAD",
                    f"node {node_id[:8]} died: {reason}",
                    node_id=node_id, reason=reason)
        await self._publish("node_events",
                            {"event": "dead", "node_id": node_id,
                             "reason": reason})
        # fail actors on that node; restart where policy allows
        for aid, info in list(self.actors.items()):
            if info.get("node_id") == node_id and info["state"] in (
                    ALIVE, PENDING_CREATION, RESTARTING):
                await self._handle_actor_failure(
                    aid, f"node {node_id[:8]} died: {reason}")
        # drop object locations + the scheduler's in-flight accounting
        for oid, locs in list(self.object_locations.items()):
            locs.discard(node_id)
        self._ephemeral_allocs.pop(node_id, None)

    # ------------------------------------------------------------------- nodes

    def _bump_view(self, node: "NodeInfo"):
        """Advance the cluster-view version and stamp the changed entry
        (the delta unit of the bidirectional sync stream)."""
        self._view_version += 1
        node.view_stamp = self._view_version

    def _view_delta(self, since: int) -> Dict[str, Any]:
        """Entries that changed after ``since`` — piggybacked on report
        replies so every raylet converges on the cluster view without a
        second RPC (reference: ray_syncer bidirectional stream)."""
        delta = [{
            "node_id": n.node_id,
            "alive": n.alive,
            "draining": n.draining,
            "raylet_address": n.raylet_address,
            "available": n.available_resources,
            "total": n.total_resources,
        } for n in self.nodes.values() if n.view_stamp > since]
        return {"view_version": self._view_version, "delta": delta}

    async def register_node(self, payload, conn):
        node_id = payload["node_id"]
        info = NodeInfo(node_id, payload, conn)
        self.nodes[node_id] = info
        self._bump_view(info)
        conn.meta["node_id"] = node_id
        # (re-)registration carries the node's primary object copies so a
        # restarted GCS rebuilds its object directory
        for hex_id in payload.get("objects", ()):  # volatile directory state
            self.object_locations.setdefault(hex_id, set()).add(node_id)
        self._event("INFO", "NODE_ADDED",
                    f"node {node_id[:8]} registered",
                    node_id=node_id, resources=info.total_resources,
                    hostname=info.hostname)
        await self._publish("node_events", {"event": "alive",
                                            "node_id": node_id,
                                            "resources": info.total_resources})
        return {"config": self.config.to_json()}

    async def node_liveness(self, payload, conn):
        """Thread-side heartbeat (see raylet._start_liveness_thread):
        refreshes last_seen while the raylet's EVENT LOOP may be busy
        with bulk work — a loaded node is not a dead node.  A loop
        wedged past loop_stall_death_s stops counting as alive: the
        beat attests the process, the lag bounds the loop."""
        node = self.nodes.get(payload["node_id"])
        if node is None:
            return {}
        lag = float(payload.get("loop_lag_s", 0.0))
        if node.alive and lag < self.config.loop_stall_death_s:
            node.last_seen = time.monotonic()
        return {}

    async def resource_report(self, payload, conn):
        node = self.nodes.get(payload["node_id"])
        if node is None:
            return {}
        # versioned stream: drop stale/reordered reports (same epoch,
        # older version); a NEW epoch (restarted raylet, counter reset)
        # always supersedes (reference: ray_syncer.h version filtering)
        epoch = float(payload.get("sync_epoch", 0.0))
        version = int(payload.get("sync_version", 0))
        if epoch == node.sync_epoch and version <= node.sync_version \
                and version:
            node.last_seen = time.monotonic()
            return self._view_delta(int(payload.get("known_view", 0)))
        node.sync_epoch, node.sync_version = epoch, version
        node.available_resources = payload["available"]
        node.total_resources = payload.get("total", node.total_resources)
        node.last_seen = time.monotonic()
        self._bump_view(node)
        # a fresh report supersedes older ephemeral allocations (the task
        # is either reflected in it or already finished) — keeping them
        # would double-count against the node
        allocs = self._ephemeral_allocs.get(payload["node_id"])
        if allocs:
            cutoff = time.monotonic() - 0.25
            allocs[:] = [(t, d) for t, d in allocs if t > cutoff]
        return self._view_delta(int(payload.get("known_view", 0)))

    async def get_nodes(self, payload, conn):
        rows = [{
            "node_id": n.node_id,
            "alive": n.alive,
            "draining": n.draining,
            "drain_deadline_unix": n.drain_deadline_unix,
            "raylet_address": n.raylet_address,
            "netx_address": n.netx_address,
            "object_store_path": n.object_store_path,
            "resources": n.total_resources,
            "available": n.available_resources,
            "labels": n.labels,
            "is_head": n.is_head,
        } for n in self.nodes.values()]
        return paginate(rows, payload, "node_id")

    async def _fanout_to_raylets(self, method: str, payload: Dict[str, Any],
                                 node_id: Optional[str] = None,
                                 timeout: float = 10.0) -> Dict[str, Any]:
        """Concurrent RPC to every (or one) alive raylet; per-node
        errors are folded into the result list rather than failing the
        whole fan-out."""
        targets = [n for n in list(self.nodes.values())
                   if n.alive and (not node_id or n.node_id == node_id)]

        async def one(n):
            try:
                return await asyncio.wait_for(
                    n.conn.call(method, payload), timeout=timeout)
            except Exception as e:
                return {"node_id": n.node_id,
                        "error": f"{type(e).__name__}: {e}"}

        return {"nodes": list(await asyncio.gather(
            *[one(n) for n in targets]))}

    async def profile_stacks(self, payload, conn):
        """Fan a live-stack snapshot request out to raylets (reference:
        the dashboard reporter's profile endpoints); node_id narrows to
        one node, worker_id to one worker."""
        return await self._fanout_to_raylets(
            "dump_worker_stacks",
            {"worker_id": payload.get("worker_id")},
            node_id=payload.get("node_id"))

    async def profile_flamegraph(self, payload, conn):
        """Timed sampling profiles (folded stacks) of workers across
        the cluster (reference: profile_manager.py py-spy flamegraphs).
        node_id/worker_id narrow the fan-out."""
        duration = min(float(payload.get("duration_s") or 2.0), 30.0)
        req = {"duration_s": duration}
        for k in ("worker_id", "interval_s"):
            if payload.get(k) is not None:
                req[k] = payload[k]
        return await self._fanout_to_raylets(
            "profile_workers", req,
            node_id=payload.get("node_id"),
            timeout=duration + 15.0)

    async def get_node_stats(self, payload, conn):
        """Fan a node-stats snapshot out to raylet agents (reference:
        dashboard head scraping per-node agents, dashboard/agent.py);
        node_id narrows to one node."""
        return await self._fanout_to_raylets(
            "node_stats", {}, node_id=payload.get("node_id"))

    async def drain_node(self, payload, conn):
        await self._mark_node_dead(payload["node_id"], "drained")
        return {}

    async def node_draining(self, payload, conn):
        """A raylet received a preemption notice: mark it draining in
        the node table so the scheduler (spillback, actors, PGs) stops
        placing onto it, and broadcast for anyone watching node state."""
        node = self.nodes.get(payload["node_id"])
        if node is None:
            return {}
        node.draining = True
        node.drain_deadline_unix = float(
            payload.get("deadline_unix") or 0.0)
        self._bump_view(node)
        self._event("WARNING", "NODE_DRAINING",
                    f"node {node.node_id[:8]} draining: "
                    f"{payload.get('reason') or 'preemption notice'}",
                    node_id=node.node_id,
                    grace_s=payload.get("grace_s"),
                    deadline_unix=node.drain_deadline_unix)
        await self._publish("node_events", {
            "event": "draining", "node_id": node.node_id,
            "grace_s": payload.get("grace_s"),
            "deadline_unix": node.drain_deadline_unix})
        return {}

    async def node_drained(self, payload, conn):
        """Graceful end of a drain: the raylet is about to exit — mark
        the node dead NOW (fast failover) instead of waiting out the
        heartbeat timeout."""
        await self._mark_node_dead(
            payload["node_id"],
            f"preempted ({payload.get('reason') or 'drained'})")
        return {}

    async def preempt_node(self, payload, conn):
        """Deliver a preemption notice to a raylet (the test/operator
        entry; real TPU spot notices arrive as SIGUSR2 on the host)."""
        node = self.nodes.get(payload["node_id"])
        if node is None or not node.alive:
            return {"error": "unknown or dead node"}
        try:
            return await node.conn.call("preempt", {
                "grace_s": payload.get("grace_s"),
                "reason": payload.get("reason")}, timeout=10)
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    async def cluster_resources(self, payload, conn):
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.total_resources.items():
                out[k] = out.get(k, 0) + v
        return out

    async def available_resources(self, payload, conn):
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.available_resources.items():
                out[k] = out.get(k, 0) + v
        return out

    # --------------------------------------------------------------------- kv

    async def kv_put(self, payload, conn):
        key = payload["key"]
        overwrite = payload.get("overwrite", True)
        if not overwrite and key in self.kv:
            return {"added": False}
        self.kv[key] = payload["value"]
        self.store.put("kv", key, payload["value"])
        return {"added": True}

    async def kv_get(self, payload, conn):
        return {"value": self.kv.get(payload["key"])}

    async def kv_del(self, payload, conn):
        prefix = payload.get("prefix", False)
        key = payload["key"]
        if prefix:
            n = 0
            for k in [k for k in self.kv if k.startswith(key)]:
                del self.kv[k]
                self.store.delete("kv", k)
                n += 1
            return {"deleted": n}
        deleted = self.kv.pop(key, None) is not None
        if deleted:
            self.store.delete("kv", key)
        return {"deleted": int(deleted)}

    async def kv_keys(self, payload, conn):
        prefix = payload.get("prefix", "")
        return {"keys": [k for k in self.kv if k.startswith(prefix)]}

    async def kv_get_prefix(self, payload, conn):
        """Bulk fetch of every key under a prefix in ONE round-trip — the
        recovery read path (e.g. a restarted serve controller loading its
        whole journal) must not pay a kv_get per key."""
        prefix = payload.get("prefix", "")
        return {"items": [[k, v] for k, v in self.kv.items()
                          if k.startswith(prefix)]}

    async def kv_exists(self, payload, conn):
        return {"exists": payload["key"] in self.kv}

    # -------------------------------------------------------------------- jobs

    async def next_job_id(self, payload, conn):
        idx = self.next_job_index
        self.next_job_index += 1
        self.store.put("meta", "next_job_index", self.next_job_index)
        return {"job_index": idx}

    async def add_job(self, payload, conn):
        self.jobs[payload["job_id"]] = {
            "job_id": payload["job_id"],
            "driver_pid": payload.get("driver_pid"),
            "start_time": time.time(),
            "namespace": payload.get("namespace", ""),
            "metadata": payload.get("metadata", {}),
            "status": "RUNNING",
        }
        self.store.put("jobs", payload["job_id"],
                       self.jobs[payload["job_id"]])
        return {}

    async def get_jobs(self, payload, conn):
        return paginate(list(self.jobs.values()), payload, "job_id")

    # ----------------------------------------------------------------- pubsub

    async def subscribe(self, payload, conn):
        for channel in payload["channels"]:
            self.subscribers.setdefault(channel, set()).add(conn)
        return {}

    async def unsubscribe(self, payload, conn):
        """Drop channel subscriptions (and empty channel sets — the
        per-object channels below would otherwise accumulate one entry
        per ever-waited-on object)."""
        for channel in payload["channels"]:
            subs = self.subscribers.get(channel)
            if subs is not None:
                subs.discard(conn)
                if not subs:
                    self.subscribers.pop(channel, None)
        return {}

    async def publish(self, payload, conn):
        await self._publish(payload["channel"], payload["message"])
        return {}

    async def _publish(self, channel: str, message):
        dead = []
        for sub in self.subscribers.get(channel, ()):  # push-based pubsub
            try:
                await sub.notify("pubsub", {"channel": channel,
                                            "message": message})
            except Exception:
                dead.append(sub)
        for d in dead:
            self.subscribers.get(channel, set()).discard(d)

    # ---------------------------------------------------------------- actors

    async def register_actor(self, payload, conn):
        """Persist registration before scheduling (reference semantics:
        RegisterActor persists before dependency resolution so the actor
        survives owner-failure windows; actor_states.rst)."""
        aid = payload["actor_id"]
        if aid in self.actors:
            # idempotent under ReconnectingConnection retry: the first
            # attempt registered before the GCS died mid-reply
            return {"actor_id": aid, "existing": False}
        name = payload.get("name")
        ns = payload.get("namespace", "")
        if name:
            key = (ns, name)
            if key in self.named_actors and self.named_actors[key] != aid:
                existing = self.named_actors[key]
                # a mapping whose actor record is missing (crash between
                # the two persists) counts as DEAD — the name is free
                if self.actors.get(existing,
                                   {"state": DEAD}).get("state") != DEAD:
                    if payload.get("get_if_exists"):
                        return {"actor_id": existing, "existing": True}
                    return {"error": f"actor name {name!r} taken in "
                                     f"namespace {ns!r}"}
        self.actors[aid] = {
            "actor_id": aid,
            "name": name,
            "namespace": ns,
            "state": DEPS_UNREADY,
            "class_name": payload.get("class_name", ""),
            "owner_address": payload.get("owner_address"),
            "detached": payload.get("detached", False),
            "resources": payload.get("resources", {}),
            "max_restarts": payload.get("max_restarts", 0),
            "num_restarts": 0,
            "node_id": None,
            "worker_address": None,
            "create_spec": payload.get("create_spec"),
            "scheduling": payload.get("scheduling", {}),
            "death_cause": None,
        }
        # actor record first, THEN the name mapping: a crash between the two
        # fsync points must not leave a name pointing at a missing actor
        self._persist_actor(aid)
        if name:
            self.named_actors[(ns, name)] = aid
            self.store.put("named_actors", f"{ns}\x00{name}", aid)
        return {"actor_id": aid, "existing": False}

    async def create_actor(self, payload, conn):
        """Dependency-resolved: schedule and start the actor process-side.

        Reference: GcsActorScheduler::Schedule (gcs_actor_scheduler.cc:49) —
        GCS picks a node, leases a worker from that raylet, pushes creation.
        """
        aid = payload["actor_id"]
        info = self.actors.get(aid)
        if info is None:
            return {"error": "unknown actor"}
        if info["state"] != DEPS_UNREADY:
            # retried create (GCS restart mid-reply): scheduling is already
            # in flight or done — kicking it again would lease a 2nd worker
            return {}
        info["create_spec"] = payload.get("create_spec", info.get("create_spec"))
        self._persist_actor(aid)
        protocol.spawn(self._schedule_actor(aid))
        return {}

    async def _schedule_actor(self, aid: str):
        info = self.actors.get(aid)
        if info is None or info["state"] == DEAD:
            return
        info["state"] = PENDING_CREATION
        demand = info.get("resources", {})
        sched = info.get("scheduling", {})
        self._next_actor_ticket += 1
        self._actor_tickets[aid] = self._next_actor_ticket
        try:
            await self._place_actor(aid, info, demand, sched)
        finally:
            self._actor_tickets.pop(aid, None)
            self._actors_waiting.discard(aid)

    def _older_actor_waiting(self, aid: str, demand, sched) -> bool:
        """Another actor with this demand and strategy has waited longer
        for capacity: it takes the capacity first, so equal pending
        actors (trials queued behind one GPU) start in the order they
        were created, as the reference's per-class queue starts them.
        One that found a node and is being created holds nobody back:
        actors that fit start together. The JAX runtime's GCS lets each
        waiting actor poll on its own, and the first poll after a
        release wins."""
        mine = self._actor_tickets[aid]
        for other, ticket in self._actor_tickets.items():
            if ticket >= mine or other not in self._actors_waiting:
                continue
            o = self.actors.get(other)
            if o is not None and o["state"] == PENDING_CREATION and \
                    o.get("resources", {}) == demand and \
                    o.get("scheduling", {}) == sched:
                return True
        return False

    async def _place_actor(self, aid: str, info: Dict[str, Any],
                           demand: Dict[str, float], sched: Dict[str, Any]):
        deadline = time.monotonic() + self.config.worker_lease_timeout_s * 10
        while time.monotonic() < deadline:
            if info["state"] == DEAD:
                return      # killed while it waited: never create it
            node_id = self._pick_node(demand, sched)
            if node_id is None or \
                    self._older_actor_waiting(aid, demand, sched):
                self._actors_waiting.add(aid)
                await asyncio.sleep(0.2)  # wait for resources/nodes
                continue
            self._actors_waiting.discard(aid)
            node = self.nodes[node_id]
            try:
                reply = await node.conn.call("create_actor_worker", {
                    "actor_id": aid,
                    "create_spec": info["create_spec"],
                    "resources": demand,
                }, timeout=self.config.worker_start_timeout_s)
            except Exception as e:
                logger.warning("actor %s creation on %s failed: %s",
                               aid[:8], node_id[:8], e)
                self._actors_waiting.add(aid)
                await asyncio.sleep(0.2)
                continue
            if reply.get("error"):
                err = reply["error"]
                if reply.get("retryable", True):
                    # the node had no room after all (the view is as old
                    # as its last report): waiting still, in its place
                    self._actors_waiting.add(aid)
                    await asyncio.sleep(0.2)
                    continue
                await self._mark_actor_dead(aid, err)
                return
            info["node_id"] = node_id
            info["worker_address"] = reply["worker_address"]
            # 1.8: the worker's direct-lane endpoints ride the actor
            # record (get_actor / wait_actor_alive) so any caller in
            # the fleet can push actor_call down the native lane
            info["direct_address"] = reply.get("direct_address", "")
            info["direct_tcp_address"] = reply.get(
                "direct_tcp_address", "")
            info["state"] = ALIVE
            self._persist_actor(aid)
            await self._publish("actor_events",
                                {"actor_id": aid, "state": ALIVE,
                                 "worker_address": reply["worker_address"]})
            for fut in self._actor_creation_waiters.pop(aid, []):
                if not fut.done():
                    fut.set_result(info)
            return
        await self._mark_actor_dead(aid, "actor creation timed out (resources "
                                         "never became available)")

    async def _handle_actor_failure(self, aid: str, reason: str):
        info = self.actors.get(aid)
        if info is None:
            return
        max_restarts = info.get("max_restarts", 0)
        if max_restarts == -1 or info["num_restarts"] < max_restarts:
            info["num_restarts"] += 1
            info["state"] = RESTARTING
            self._event("WARNING", "ACTOR_RESTARTING",
                        f"actor {aid[:8]} ({info.get('class_name')}) "
                        f"restarting: {reason}",
                        actor_id=aid, restarts=info["num_restarts"])
            self._persist_actor(aid)
            await self._publish("actor_events",
                                {"actor_id": aid, "state": RESTARTING})
            protocol.spawn(self._schedule_actor(aid))
        else:
            await self._mark_actor_dead(aid, reason)

    async def _mark_actor_dead(self, aid: str, reason: str):
        info = self.actors.get(aid)
        if info is None:
            return
        info["state"] = DEAD
        info["death_cause"] = reason
        self._event("ERROR", "ACTOR_DEAD",
                    f"actor {aid[:8]} ({info.get('class_name')}) died: "
                    f"{reason}", actor_id=aid, reason=reason)
        self._persist_actor(aid)
        await self._publish("actor_events",
                            {"actor_id": aid, "state": DEAD, "reason": reason})
        for fut in self._actor_creation_waiters.pop(aid, []):
            if not fut.done():
                fut.set_result(info)

    async def actor_state_update(self, payload, conn):
        aid = payload["actor_id"]
        state = payload["state"]
        if state == DEAD:
            info = self.actors.get(aid)
            if info is None:
                return {}
            if payload.get("restart", False) and not payload.get("intended"):
                await self._handle_actor_failure(aid, payload.get("reason", ""))
            else:
                await self._mark_actor_dead(aid, payload.get("reason", ""))
        return {}

    async def kill_actor(self, payload, conn):
        aid = payload["actor_id"]
        info = self.actors.get(aid)
        if info is None or info["state"] == DEAD:
            return {}
        node = self.nodes.get(info.get("node_id") or "")
        info["max_restarts"] = 0 if payload.get("no_restart", True) else \
            info["max_restarts"]
        self._persist_actor(aid)
        if node is not None and info.get("worker_address"):
            try:
                await node.conn.call("kill_actor_worker", {
                    "actor_id": aid,
                    "worker_address": info["worker_address"],
                })
            except Exception:
                pass
        await self._mark_actor_dead(aid, "ray_tpu_torch.kill() called")
        return {}

    async def get_actor(self, payload, conn):
        info = self.actors.get(payload["actor_id"])
        if info is None:
            return {"error": "unknown actor"}
        return {k: v for k, v in info.items() if k != "create_spec"}

    async def get_named_actor(self, payload, conn):
        key = (payload.get("namespace", ""), payload["name"])
        aid = self.named_actors.get(key)
        if aid is None:
            return {"error": f"no actor named {payload['name']!r}"}
        return await self.get_actor({"actor_id": aid}, conn)

    async def list_named_actors(self, payload, conn):
        ns = payload.get("namespace")
        out = []
        for (actor_ns, name), aid in self.named_actors.items():
            if ns is not None and actor_ns != ns:
                continue
            if self.actors.get(aid, {}).get("state") != DEAD:
                out.append({"name": name, "namespace": actor_ns})
        return out

    async def list_actors(self, payload, conn):
        rows = [{k: v for k, v in info.items() if k != "create_spec"}
                for info in self.actors.values()]
        return paginate(rows, payload, "actor_id")

    async def wait_actor_alive(self, payload, conn):
        aid = payload["actor_id"]
        info = self.actors.get(aid)
        if info is None:
            return {"error": "unknown actor"}
        if info["state"] == ALIVE or info["state"] == DEAD:
            return {k: v for k, v in info.items() if k != "create_spec"}
        fut = asyncio.get_running_loop().create_future()
        self._actor_creation_waiters.setdefault(aid, []).append(fut)
        timeout = payload.get("timeout", 120.0)
        try:
            info = await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return {"error": "timeout waiting for actor to start"}
        return {k: v for k, v in info.items() if k != "create_spec"}

    # ------------------------------------------------------------- scheduling

    def _feasible(self, node: NodeInfo, demand: Dict[str, float]) -> bool:
        if not node.alive or node.draining:
            return False
        for k, v in demand.items():
            if node.available_resources.get(k, 0.0) + 1e-9 < v:
                return False
        return True

    def _pick_node(self, demand: Dict[str, float],
                   sched: Dict[str, Any] | None = None,
                   deps: Optional[List[str]] = None) -> Optional[str]:
        """Hybrid policy + locality (reference:
        hybrid_scheduling_policy.cc, scheduling_policy.cc scorer, and
        lease_policy.cc locality): prefer the preferred/local node until
        its utilization crosses scheduler_spread_threshold, then score
        the feasible nodes — dependencies already present beat lower
        utilization, so data-heavy tasks run where their args live.
        NodeAffinity is a strict filter."""
        sched = sched or {}
        if sched.get("node_id"):
            node = self.nodes.get(sched["node_id"])
            if node is not None and self._feasible(node, demand):
                return node.node_id
            if not sched.get("soft", False):
                return None
        candidates = [n for n in self.nodes.values()
                      if self._feasible(n, demand)]
        if not candidates:
            return None
        util = {n.node_id: self._utilization(n) for n in candidates}
        chosen: Optional[str] = None
        if sched.get("spread"):
            # utilization is report-driven (stale between polls): a burst
            # of SPREAD tasks all see identical numbers, so break ties
            # round-robin or they all land on one node
            candidates.sort(key=lambda n: (util[n.node_id], n.node_id))
            low = util[candidates[0].node_id]
            tied = [n for n in candidates
                    if util[n.node_id] - low < 0.05]
            self._spread_rr += 1
            chosen = tied[self._spread_rr % len(tied)].node_id
        if chosen is None:
            preferred = sched.get("preferred_node")
            if preferred:
                node = self.nodes.get(preferred)
                if node is not None and node in candidates and \
                        util[preferred] < \
                        self.config.scheduler_spread_threshold:
                    chosen = preferred
        if chosen is None:
            def score(n: NodeInfo):
                # deps-local first — but only while the holder can take
                # this demand under the pessimistic view (locality must
                # not pile a burst onto a node that, once spilled-to,
                # cannot re-spill) — then lower utilization, stable by id
                loc = (self._locality(n.node_id, deps)
                       if self._pessimistic_headroom(n, demand) else 0)
                return (-loc, util[n.node_id], n.node_id)

            chosen = min(candidates, key=score).node_id
        # pessimistic self-accounting: this placement occupies resources
        # NOW even though the node's next report hasn't seen it yet
        self._ephemeral_allocs.setdefault(chosen, []).append(
            (time.monotonic(), dict(demand)))
        return chosen

    def _locality(self, node_id: str, deps: Optional[List[str]]) -> int:
        """How many of the task's plasma dependencies this node already
        holds (object-size-weighted in the reference; the directory here
        tracks locations, not sizes — count is the proxy)."""
        if not deps:
            return 0
        return sum(1 for hex_id in deps
                   if node_id in self.object_locations.get(hex_id, ()))

    _EPHEMERAL_TTL = 3.0

    def _pending_for(self, node_id: str) -> Dict[str, float]:
        """Sum of this scheduler's unexpired in-flight placements."""
        now = time.monotonic()
        pending: Dict[str, float] = {}
        allocs = self._ephemeral_allocs.get(node_id)
        if allocs:
            allocs[:] = [(t, d) for t, d in allocs
                         if now - t < self._EPHEMERAL_TTL]
            for _t, demand in allocs:
                for k, v in demand.items():
                    pending[k] = pending.get(k, 0.0) + v
        return pending

    def _effective_avail(self, node: NodeInfo, key: str,
                         pending: Dict[str, float]) -> float:
        """The reported availability (lags node state) and total-minus-
        recent-placements (this scheduler's own view) are EACH an upper
        bound on what's free; take the min — summing them double-counts
        any task that is both reported-running and still in the
        ephemeral window."""
        reported = node.available_resources.get(key, 0.0)
        own_view = node.total_resources.get(key, 0.0) - \
            pending.get(key, 0.0)
        return max(0.0, min(reported, own_view))

    def _pessimistic_headroom(self, node: NodeInfo,
                              demand: Dict[str, float]) -> bool:
        pending = self._pending_for(node.node_id)
        return all(self._effective_avail(node, k, pending) >= v
                   for k, v in demand.items())

    def _utilization(self, node: NodeInfo) -> float:
        # node reports are poll-driven and lag the GCS's own decisions;
        # fold in this scheduler's recent placements (ephemeral
        # allocations, reference: cluster_resource_manager's local view)
        # or a burst of schedule() calls piles onto one node
        pending = self._pending_for(node.node_id)
        worst = 0.0
        for k, total in node.total_resources.items():
            if total <= 0:
                continue
            avail = self._effective_avail(node, k, pending)
            worst = max(worst, 1.0 - avail / total)
        return worst

    async def schedule(self, payload, conn):
        """Spillback scheduling for tasks a raylet can't place locally."""
        node_id = self._pick_node(payload.get("demand", {}),
                                  payload.get("scheduling"),
                                  deps=payload.get("deps"))
        if node_id is None:
            return {"node_id": None}
        return {"node_id": node_id,
                "raylet_address": self.nodes[node_id].raylet_address}

    # ------------------------------------------------------ placement groups

    async def create_placement_group(self, payload, conn):
        """2-phase commit of bundles (reference:
        gcs_placement_group_scheduler.cc Prepare/Commit/CancelResourceReserve
        over node_manager.proto:377-384). STRICT_PACK over a TPU slice
        co-schedules all hosts of that slice — the ICI domain is the locality
        unit (SURVEY.md §7 phase 1)."""
        pg_id = payload["pg_id"]
        bundles: List[Dict[str, float]] = payload["bundles"]
        strategy = payload.get("strategy", "PACK")

        def park_pending():
            # a PG that can't place NOW is queued and retried as
            # resources free up — it must never be dropped (a burst of
            # creations all reading the same stale reports routinely
            # fails the 2-phase prepare; reference:
            # gcs_placement_group_manager's pending queue)
            self.placement_groups[pg_id] = {
                "pg_id": pg_id, "state": "PENDING", "bundles": bundles,
                "strategy": strategy, "assignment": None,
                "name": payload.get("name"),
            }
            self._persist_pg(pg_id)
            protocol.spawn(
                self._retry_pg(pg_id))
            return {"state": "PENDING"}

        assignment = self._place_bundles(bundles, strategy)
        if assignment is None:
            return park_pending()
        ok = await self._commit_bundles(pg_id, bundles, assignment)
        if not ok:
            return park_pending()
        self.placement_groups[pg_id] = {
            "pg_id": pg_id, "state": "CREATED", "bundles": bundles,
            "strategy": strategy, "assignment": assignment,
            "name": payload.get("name"),
        }
        self._persist_pg(pg_id)
        return {"state": "CREATED", "assignment": assignment}

    def _pg_ever_feasible(self, bundles) -> bool:
        """Can the CURRENT cluster's totals ever host every bundle?
        (Pending PGs demanding more than any node will ever have back
        off hard instead of re-running placement every interval.)"""
        totals = [dict(n.total_resources) for n in self.nodes.values()
                  if n.alive and not n.draining]
        for b in bundles:
            if not any(all(t.get(k, 0) >= v for k, v in b.items())
                       for t in totals):
                return False
        return True

    async def _retry_pg(self, pg_id: str):
        # retries until the PG places or is removed (pending PGs are
        # legitimate under autoscaling — capacity may yet arrive); the
        # interval backs off so hundreds of pending PGs cost the loop
        # little, and never-satisfiable ones poll at the slowest rate
        delay = 0.25
        while True:
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 2.0)
            pg = self.placement_groups.get(pg_id)
            if pg is None:
                return
            if pg["state"] != "PENDING":
                return
            if not self._pg_ever_feasible(pg["bundles"]):
                delay = 10.0
                continue
            assignment = self._place_bundles(pg["bundles"], pg["strategy"])
            if assignment is None:
                continue
            if await self._commit_bundles(pg_id, pg["bundles"], assignment):
                pg["state"] = "CREATED"
                pg["assignment"] = assignment
                self._persist_pg(pg_id)
                await self._publish("pg_events",
                                    {"pg_id": pg_id, "state": "CREATED"})
                return

    def _place_bundles(self, bundles, strategy) -> Optional[List[str]]:
        # pessimistic view: reported availability folded with this
        # scheduler's own recent placements, so a burst of concurrent
        # creations doesn't stampede one node on stale reports
        avail = {}
        for nid, n in self.nodes.items():
            if not n.alive or n.draining:
                continue
            pending = self._pending_for(nid)
            avail[nid] = {
                k: self._effective_avail(n, k, pending)
                for k in set(n.total_resources) | set(pending)}

        def fits(nid, bundle):
            return all(avail[nid].get(k, 0) + 1e-9 >= v
                       for k, v in bundle.items())

        def take(nid, bundle):
            for k, v in bundle.items():
                avail[nid][k] = avail[nid].get(k, 0) - v

        assignment: List[str] = []
        node_ids = list(avail)
        if strategy in ("PACK", "STRICT_PACK"):
            # try to fit all on one node first
            for nid in node_ids:
                ok = True
                tmp = dict(avail[nid])
                for b in bundles:
                    if all(tmp.get(k, 0) + 1e-9 >= v for k, v in b.items()):
                        for k, v in b.items():
                            tmp[k] = tmp.get(k, 0) - v
                    else:
                        ok = False
                        break
                if ok:
                    return [nid] * len(bundles)
            if strategy == "STRICT_PACK":
                return None
        used_nodes: Set[str] = set()
        for b in bundles:
            placed = None
            for nid in sorted(node_ids,
                              key=lambda n: (n in used_nodes)
                              if strategy in ("SPREAD", "STRICT_SPREAD")
                              else (n not in used_nodes)):
                if strategy == "STRICT_SPREAD" and nid in used_nodes:
                    continue
                if fits(nid, b):
                    placed = nid
                    break
            if placed is None:
                return None
            take(placed, b)
            used_nodes.add(placed)
            assignment.append(placed)
        return assignment

    async def _commit_bundles(self, pg_id, bundles, assignment) -> bool:
        # phase 1: prepare (reserve) on each raylet
        prepared: List[Tuple[str, int]] = []
        ok = True
        for idx, (bundle, nid) in enumerate(zip(bundles, assignment)):
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                ok = False
                break
            try:
                r = await node.conn.call("prepare_bundle", {
                    "pg_id": pg_id, "bundle_index": idx, "resources": bundle})
                if not r.get("ok"):
                    ok = False
                    break
                prepared.append((nid, idx))
            except Exception:
                ok = False
                break
        if not ok:
            for nid, idx in prepared:
                node = self.nodes.get(nid)
                if node is not None:
                    try:
                        await node.conn.call("cancel_bundle",
                                             {"pg_id": pg_id,
                                              "bundle_index": idx})
                    except Exception:
                        logger.debug(
                            "pg %s: cancel_bundle %d on %s failed "
                            "(node dying? resources refund on its "
                            "death path)", pg_id, idx, nid,
                            exc_info=True)
            return False
        # phase 2: commit; record the reservations in the ephemeral view
        # so concurrent placements see them before the next node report
        for (nid, idx), bundle in zip(prepared, bundles):
            self._ephemeral_allocs.setdefault(nid, []).append(
                (time.monotonic(), dict(bundle)))
            try:
                await self.nodes[nid].conn.call(
                    "commit_bundle", {"pg_id": pg_id, "bundle_index": idx})
            except Exception:
                logger.warning(
                    "pg %s: commit_bundle %d on %s failed after a "
                    "successful prepare; bundle rides on the prepare "
                    "reservation until the node report reconciles",
                    pg_id, idx, nid, exc_info=True)
        return True

    async def remove_placement_group(self, payload, conn):
        pg = self.placement_groups.pop(payload["pg_id"], None)
        if pg is None:
            return {}
        self.store.delete("pgs", payload["pg_id"])
        if pg.get("assignment"):
            for idx, nid in enumerate(pg["assignment"]):
                node = self.nodes.get(nid)
                if node is not None and node.alive:
                    try:
                        await node.conn.call("return_bundle", {
                            "pg_id": pg["pg_id"], "bundle_index": idx})
                    except Exception:
                        logger.debug(
                            "pg %s: return_bundle %d on %s failed "
                            "(node death refunds it)", pg["pg_id"],
                            idx, nid, exc_info=True)
        return {}

    async def get_placement_group(self, payload, conn):
        pg = self.placement_groups.get(payload["pg_id"])
        if pg is None:
            return {"error": "unknown placement group"}
        return pg

    async def list_placement_groups(self, payload, conn):
        return paginate(list(self.placement_groups.values()), payload,
                        "pg_id")

    # -------------------------------------------------------- object registry

    async def add_object_location(self, payload, conn):
        oid = payload["object_id"]
        self.object_locations.setdefault(oid, set()).add(payload["node_id"])
        if payload.get("owner"):
            self.object_owners[oid] = payload["owner"]
        # long-poll object channel (reference: GCS pubsub
        # WORKER_OBJECT_LOCATIONS_CHANNEL): borrowers waiting on this
        # object wake on the notification instead of polling the
        # directory
        if f"obj:{oid}" in self.subscribers:
            await self._publish(f"obj:{oid}",
                                {"object_id": oid,
                                 "node_id": payload["node_id"]})
        return {}

    async def remove_object_location(self, payload, conn):
        locs = self.object_locations.get(payload["object_id"])
        if locs:
            locs.discard(payload["node_id"])
        return {}

    async def get_object_locations(self, payload, conn):
        oid = payload["object_id"]
        locs = self.object_locations.get(oid, set())
        out = []
        for nid in locs:
            node = self.nodes.get(nid)
            if node is not None and node.alive:
                out.append({"node_id": nid,
                            "raylet_address": node.raylet_address,
                            # 1.8: pullers prefer the netx plane
                            "netx_address": node.netx_address})
        return {"locations": out, "owner": self.object_owners.get(oid)}

    async def ping(self, payload, conn):
        return {"t": time.time()}


async def run_gcs(config: SystemConfig, host: str, port: int,
                  ready_cb=None) -> GcsServer:
    gcs = GcsServer(config)
    actual = await gcs.start(host, port)
    if ready_cb:
        ready_cb(actual)
    return gcs
