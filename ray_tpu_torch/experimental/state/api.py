"""Cluster state API — `list tasks/objects/actors/nodes/jobs/placement
groups` with cursor pagination and server-side filtering.

Reference analogue: python/ray/experimental/state/api.py (+ the
dashboard-side state_aggregator.py). Queries go straight to the GCS
over the driver's existing connection. Every list call is PAGED on the
wire (``limit`` + ``continuation_token`` + filter pushdown): a single
RPC never carries a full table, and the client either walks pages
transparently (default) or hands control of the cursor to the caller
(pass ``page_size``/``continuation_token``).

The port's copy of the JAX package's
``ray_tpu/experimental/state/api.py`` (imports renamed to
``ray_tpu_torch``, env vars ``RTPU_*`` to ``RTT_*``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as _worker_mod

# page size used when the client auto-walks the cursor for callers
# that just want "the list"
_AUTO_PAGE = 1000


class StateListResult(list):
    """A plain list of rows plus the paging metadata that rode the last
    reply: ``next_token`` (None = exhausted), ``total`` (server-side
    filtered count), ``dropped`` (records the bounded server table has
    evicted — >0 means history, not live state, is missing)."""

    def __init__(self, items=(), next_token: Optional[str] = None,
                 total: Optional[int] = None, dropped: int = 0):
        super().__init__(items)
        self.next_token = next_token
        self.total = total
        self.dropped = dropped


def _gcs_call(method: str, payload: Optional[dict] = None,
              timeout: float = 30) -> dict:
    w = _worker_mod._global_worker
    if w is None or not w.connected:
        raise RuntimeError("ray_tpu_torch is not initialized")
    return w.call_sync(w.gcs, method, payload or {}, timeout=timeout)


def _list_paged(method: str, filters: Optional[Dict[str, Any]],
                limit: Optional[int], continuation_token: Optional[str],
                page_size: Optional[int], timeout: float = 30,
                extra: Optional[dict] = None) -> StateListResult:
    """Shared cursor walker. Explicit ``page_size``/``continuation_
    token`` = manual paging (ONE page per call, resume via
    ``.next_token``); otherwise pages are walked transparently until
    ``limit`` (or the table) is exhausted."""
    manual = page_size is not None or continuation_token is not None
    token = continuation_token
    out = StateListResult()
    while True:
        want = page_size or _AUTO_PAGE
        if limit is not None:
            want = min(want, max(1, limit - len(out)))
        payload = {"paged": True, "limit": want,
                   "continuation_token": token, **(extra or {})}
        if filters:
            payload["filters"] = filters
        r = _gcs_call(method, payload, timeout=timeout)
        out.extend(r.get("items") or ())
        out.next_token = r.get("next_token")
        out.total = r.get("total", out.total)
        out.dropped = r.get("dropped", out.dropped)
        token = out.next_token
        if manual or token is None or \
                (limit is not None and len(out) >= limit):
            return out


def list_nodes(filters: Optional[Dict[str, Any]] = None,
               limit: Optional[int] = None,
               continuation_token: Optional[str] = None,
               page_size: Optional[int] = None) -> StateListResult:
    return _list_paged("get_nodes", filters, limit, continuation_token,
                       page_size)


def list_actors(filters: Optional[Dict[str, Any]] = None,
                limit: Optional[int] = None,
                continuation_token: Optional[str] = None,
                page_size: Optional[int] = None) -> StateListResult:
    return _list_paged("list_actors", filters, limit, continuation_token,
                       page_size)


def list_tasks(filters: Optional[Dict[str, Any]] = None,
               limit: Optional[int] = None,
               continuation_token: Optional[str] = None,
               page_size: Optional[int] = None) -> StateListResult:
    """Cluster-wide task listing from the GCS's bounded task table
    (fed by the task-event pipeline). Filter keys: state, name,
    job_id, node_id, task_id — pushed down to the server. The result's
    ``dropped`` reports table evictions (cap exceeded)."""
    return _list_paged("list_tasks", filters, limit, continuation_token,
                       page_size)


def list_objects(filters: Optional[Dict[str, Any]] = None,
                 limit: Optional[int] = None,
                 continuation_token: Optional[str] = None,
                 page_size: Optional[int] = None,
                 node_id: Optional[str] = None) -> StateListResult:
    """Cluster object listing aggregated from per-raylet plasma
    indexes (pinned + spilled primaries); each row carries locations,
    owner, size. ``node_id`` narrows the fan-out to one raylet."""
    return _list_paged("list_objects", filters, limit,
                       continuation_token, page_size,
                       extra={"node_id": node_id} if node_id else None)


def profile_stacks(node_id: Optional[str] = None,
                   worker_id: Optional[str] = None) -> Dict[str, Any]:
    """Live stack snapshot of workers (reference:
    dashboard/modules/reporter/profile_manager.py — on-demand worker
    profiling; faulthandler-style dumps here)."""
    return _gcs_call("profile_stacks",
                     {"node_id": node_id, "worker_id": worker_id})


def profile_flamegraph(node_id: Optional[str] = None,
                       worker_id: Optional[str] = None,
                       duration_s: float = 2.0,
                       interval_s: Optional[float] = None
                       ) -> Dict[str, Any]:
    """Timed sampling profile of workers -> folded stacks (the
    flamegraph-collapsed format flamegraph.pl and speedscope import;
    reference: profile_manager.py py-spy flamegraphs)."""
    return _gcs_call("profile_flamegraph",
                     {"node_id": node_id, "worker_id": worker_id,
                      "duration_s": duration_s,
                      "interval_s": interval_s},
                     # the whole GCS->raylet->worker chain runs for
                     # duration_s before replying
                     timeout=min(float(duration_s), 30.0) + 25)


def node_stats(node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Per-node agent snapshots: physical cpu/mem/disk plus the native
    scheduler/object-store gauges (reference: dashboard/agent.py
    reporter + src/ray/stats/metric_defs.cc)."""
    return _gcs_call("get_node_stats", {"node_id": node_id})["nodes"]


def list_jobs(filters: Optional[Dict[str, Any]] = None,
              limit: Optional[int] = None,
              continuation_token: Optional[str] = None,
              page_size: Optional[int] = None) -> StateListResult:
    return _list_paged("get_jobs", filters, limit, continuation_token,
                       page_size)


def list_placement_groups(filters: Optional[Dict[str, Any]] = None,
                          limit: Optional[int] = None,
                          continuation_token: Optional[str] = None,
                          page_size: Optional[int] = None
                          ) -> StateListResult:
    return _list_paged("list_placement_groups", filters, limit,
                       continuation_token, page_size)


def list_cluster_events(limit: int = 200,
                        severity: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """Structured events from the GCS ring (reference: `ray list
    cluster-events` / dashboard event browsing)."""
    return _gcs_call("list_events", {"limit": limit,
                                     "severity": severity})


def list_logs() -> List[str]:
    """Names of log files under the driver's session dir (reference:
    `ray logs` listing via the dashboard agent)."""
    import os
    w = _worker_mod._global_worker
    if w is None or not w.connected:
        raise RuntimeError("ray_tpu_torch is not initialized")
    d = os.path.join(w.session_dir, "logs")
    out = []
    for root, _dirs, files in os.walk(d):
        rel = os.path.relpath(root, d)
        for f in sorted(files):
            out.append(f if rel == "." else os.path.join(rel, f))
    return sorted(out)


def get_log(filename: str, tail: int = 1000) -> str:
    """Tail a session log file by its list_logs name."""
    import os
    w = _worker_mod._global_worker
    if w is None or not w.connected:
        raise RuntimeError("ray_tpu_torch is not initialized")
    base = os.path.realpath(os.path.join(w.session_dir, "logs"))
    path = os.path.realpath(os.path.join(base, filename))
    if not path.startswith(base + os.sep):
        raise ValueError(f"log path escapes the session dir: {filename!r}")
    from collections import deque
    with open(path, errors="replace") as f:
        # bounded: never load a multi-GB log whole to return its tail
        lines = deque(f, maxlen=tail)
    return "".join(lines)


def summarize_cluster() -> Dict[str, Any]:
    """One-RPC cluster summary: the GCS counts its own tables
    (node/actor/job/PG/task counts + resource totals) instead of
    shipping them whole just to be len()'d client-side."""
    return _gcs_call("summarize")


def list_traces(filters: Optional[Dict[str, Any]] = None,
                limit: Optional[int] = None,
                continuation_token: Optional[str] = None,
                page_size: Optional[int] = None) -> StateListResult:
    """Trace summaries from the GCS's bounded trace table (explicit
    spans + task-only traces): {trace_id, root, spans, start_ts,
    duration_s, status}. Filter keys (pushed down): status, root.
    ``dropped`` reports spans the bounded table has evicted."""
    return _list_paged("list_traces", filters, limit,
                       continuation_token, page_size)


def get_trace(trace_id: str) -> Dict[str, Any]:
    """One trace's full span set in one RPC: explicit spans (serve
    request, dag hops, object pulls) merged with task-lifecycle spans
    the GCS synthesizes from the task table. Feed the result's
    ``spans`` to ``tracing.critical_path`` / ``tracing.tree_complete``
    (docs/TRACING.md)."""
    return _gcs_call("get_trace", {"trace_id": trace_id})


def summarize_tasks() -> Dict[str, Any]:
    """Per-function task aggregation (`ray-tpu-torch summary tasks`):
    {summary: [{name, count, by_state, mean_duration_s}, ...],
    by_state, dropped, ...} computed GCS-side over the bounded task
    table."""
    return _gcs_call("summarize_tasks")
