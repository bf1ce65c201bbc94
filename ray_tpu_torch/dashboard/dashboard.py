"""Dashboard — HTTP observability + job REST API.

Reference analogue: dashboard/dashboard.py + head.py (aiohttp module
registry) and modules/{node,actor,job,metrics,healthz}. Endpoints:

  GET  /api/cluster_status   resources + node/actor/task summary
  GET  /api/nodes            node table
  GET  /api/actors           actor table
  GET  /api/tasks            paginated task table (state/name/job_id
                             filters, limit + continuation token)
  GET  /api/objects          cluster object listing (per-raylet index)
  GET  /api/summary/tasks    per-function task aggregation
  GET  /api/timeline         merged chrome-trace task timeline (+ ring
                             drop counter)
  GET  /api/traces           paginated trace summaries
  GET  /api/trace/<id>       one trace: span tree + critical-path
                             phase attribution + completeness verdict
  GET  /api/serve/metrics    live serve panel (queue/shed/p99)
  GET  /api/gameday          last game-day SLO report (client-side
                             p50/p99/p99.9, ledger counts, budget
                             burn, reconciliation verdict)
  GET  /api/jobs/            job list      POST /api/jobs/  submit
  GET  /api/jobs/<id>        job info      GET /api/jobs/<id>/logs
  POST /api/jobs/<id>/stop
  GET  /metrics              Prometheus exposition (util.metrics hub
                             + cluster/node/serve gauges)
  GET  /healthz

Copied from the JAX package's ``ray_tpu/dashboard/dashboard.py``
(imports renamed to ``ray_tpu_torch``, metric names ``ray_tpu_*`` to
``ray_tpu_torch_*``). Differences: ``/metrics`` exports each raylet's
``"gpu"`` block (``ray_tpu_torch_node_gpu_num_gpus``,
``ray_tpu_torch_node_gpu_gpus_available``) where JAX exports its
``"tpu"`` block; ``port=0`` binds a free port, which ``get_port`` and
``start_dashboard`` return.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional


class DashboardActor:
    """Runs the HTTP server inside a detached actor (like the Serve
    proxy), so `ray-tpu-torch start --head` and tests manage it uniformly."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self.host, self.port = host, port
        self._server: Optional[ThreadingHTTPServer] = None
        self._start_server()

    def _start_server(self):

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, doc: Any):
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _text(self, code: int, text: str,
                      ctype: str = "text/plain"):
                data = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    self._route("GET", None)
                except Exception as e:
                    self._json(500, {"error": repr(e)})

            def do_POST(self):
                self._with_body("POST")

            def do_PUT(self):
                self._with_body("PUT")

            def _with_body(self, method: str):
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(n) or b"{}") \
                        if n else {}
                except Exception as e:
                    return self._json(400, {"error": f"bad body: {e!r}"})
                try:
                    self._route(method, body)
                except Exception as e:
                    self._json(500, {"error": repr(e)})

            def _route(self, method: str, body):
                from ray_tpu_torch.experimental.state import api as state
                from ray_tpu_torch.job_submission import JobSubmissionClient
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    from ray_tpu_torch.dashboard.frontend import INDEX_HTML
                    return self._text(200, INDEX_HTML,
                                      ctype="text/html")
                if path == "/healthz":
                    return self._text(200, "ok")
                if path == "/metrics":
                    from ray_tpu_torch.util import metrics
                    try:
                        text = metrics.prometheus_text()
                    except Exception:
                        text = ""
                    try:
                        text += _cluster_gauges(state)
                    except Exception:
                        pass
                    try:
                        text += _node_gauges(state)
                    except Exception:
                        pass
                    try:
                        text += _serve_gauges()
                    except Exception:
                        pass
                    try:
                        text += _slo_gauges()
                    except Exception:
                        pass
                    return self._text(200, text)
                if path == "/api/cluster_status":
                    return self._json(200, state.summarize_cluster())
                if path == "/api/nodes":
                    return self._json(200, {"nodes": state.list_nodes()})
                if path == "/api/nodes/stats":
                    return self._json(200,
                                      {"nodes": state.node_stats()})
                if path == "/api/actors":
                    return self._json(200,
                                      {"actors": state.list_actors()})
                if path == "/api/tasks":
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)

                    def one(k):
                        return (q.get(k) or [None])[0]
                    filters = {k: one(k) for k in
                               ("state", "name", "job_id", "node_id")
                               if one(k)}
                    page = state.list_tasks(
                        filters=filters or None,
                        page_size=int(one("limit") or 200),
                        continuation_token=one("token"))
                    return self._json(200, {
                        "tasks": list(page),
                        "next_token": page.next_token,
                        "total": page.total,
                        "dropped": page.dropped})
                if path == "/api/objects":
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    page = state.list_objects(
                        page_size=int((q.get("limit") or ["200"])[0]),
                        continuation_token=(q.get("token") or [None])[0])
                    return self._json(200, {
                        "objects": list(page),
                        "next_token": page.next_token,
                        "total": page.total})
                if path == "/api/summary/tasks":
                    return self._json(200, state.summarize_tasks())
                if path == "/api/timeline":
                    from ray_tpu_torch.util.timeline import (
                        dump_dropped_total, timeline_dump)
                    evs = timeline_dump()
                    return self._json(200, {
                        "events": evs,
                        "dropped": dump_dropped_total(evs)})
                if path == "/api/traces":
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    page = state.list_traces(
                        page_size=int((q.get("limit") or ["100"])[0]),
                        continuation_token=(q.get("token")
                                            or [None])[0])
                    return self._json(200, {
                        "traces": list(page),
                        "next_token": page.next_token,
                        "total": page.total,
                        "dropped": page.dropped})
                m = re.match(r"^/api/trace/([^/]+)$", path)
                if m:
                    from ray_tpu_torch._private import tracing
                    doc = state.get_trace(m.group(1))
                    spans = doc.get("spans") or []
                    doc["critical_path"] = tracing.critical_path(spans)
                    ok, detail = tracing.tree_complete(spans)
                    doc["complete"], doc["complete_detail"] = ok, detail
                    return self._json(200, doc)
                if path == "/api/serve/metrics":
                    from ray_tpu_torch import serve as _serve
                    return self._json(200,
                                      {"deployments": _serve.metrics()})
                if path == "/api/gameday":
                    from ray_tpu_torch.gameday import store as _gd_store
                    return self._json(200,
                                      {"report": _gd_store.load_report()})
                if path == "/api/placement_groups":
                    return self._json(
                        200, {"placement_groups":
                              state.list_placement_groups()})
                if path == "/api/profile/stacks":
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    return self._json(200, state.profile_stacks(
                        node_id=(q.get("node_id") or [None])[0],
                        worker_id=(q.get("worker_id") or [None])[0]))
                if path == "/api/grafana/dashboards":
                    from ray_tpu_torch.dashboard.grafana import (
                        generate_dashboards)
                    return self._json(200, generate_dashboards())
                if path == "/api/profile/flamegraph":
                    # timed sampling -> folded stacks (reference:
                    # reporter/profile_manager.py py-spy flamegraphs)
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    return self._json(200, state.profile_flamegraph(
                        node_id=(q.get("node_id") or [None])[0],
                        worker_id=(q.get("worker_id") or [None])[0],
                        duration_s=float(
                            (q.get("duration_s") or ["2.0"])[0])))
                if path == "/api/events":
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    return self._json(200, {"events":
                                            state.list_cluster_events(
                        limit=int(q.get("limit", ["200"])[0]),
                        severity=(q.get("severity") or [None])[0])})
                if path in ("/api/logs", "/api/logs/"):
                    return self._json(200, {"logs": state.list_logs()})
                m = re.match(r"^/api/logs/(.+)$", path)
                if m:
                    try:
                        return self._text(200, state.get_log(m.group(1)))
                    except (ValueError, OSError) as e:
                        return self._json(404, {"error": str(e)})
                if path == "/api/serve/applications":
                    from ray_tpu_torch import serve as _serve
                    if method == "PUT":
                        # declarative deploy (reference: serve REST API,
                        # PUT /api/serve/applications/)
                        from ray_tpu_torch.serve.schema import deploy_config
                        names = deploy_config(body or {})
                        return self._json(200, {"deployed": names})
                    return self._json(200, {
                        "applications": _serve.list_applications(),
                        "deployments": _serve.status()})
                client = JobSubmissionClient()
                if path in ("/api/jobs", "/api/jobs/"):
                    if method == "POST":
                        job_id = client.submit_job(
                            entrypoint=body["entrypoint"],
                            job_id=body.get("job_id"),
                            runtime_env=body.get("runtime_env"),
                            metadata=body.get("metadata"))
                        return self._json(200, {"job_id": job_id})
                    return self._json(200, {"jobs": client.list_jobs()})
                m = re.match(r"^/api/jobs/([^/]+)(/logs|/stop)?$", path)
                if m:
                    job_id, sub = m.group(1), m.group(2)
                    if sub == "/logs":
                        return self._json(
                            200, {"logs": client.get_job_logs(job_id)})
                    if sub == "/stop":
                        return self._json(
                            200, {"stopped": client.stop_job(job_id)})
                    info = client.get_job_info(job_id)
                    info["status"] = client.get_job_status(job_id)
                    return self._json(200, info)
                return self._json(404, {"error": f"no route {path}"})

        for attempt in range(32):
            try:
                self._server = ThreadingHTTPServer(
                    (self.host, self.port + attempt if self.port else 0),
                    Handler)
                self.port = self._server.server_address[1]
                break
            except OSError:
                continue
        if self._server is None:
            raise RuntimeError("no free port for dashboard")
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def get_port(self) -> int:
        return self.port

    def ping(self):
        return "pong"

    def shutdown(self):
        if self._server:
            self._server.shutdown()
        return "ok"


DASHBOARD_NAME = "DASHBOARD"


def _cluster_gauges(state) -> str:
    """Cluster-level gauges appended to /metrics (the native-metrics
    breadth the per-process registries can't see: node counts, resource
    totals, actor states — reference: the GCS-exported ray_* gauges)."""
    s = state.summarize_cluster()
    lines = []

    def g(name, value, help_):
        lines.append(f"# HELP ray_tpu_torch_{name} {help_}")
        lines.append(f"# TYPE ray_tpu_torch_{name} gauge")
        lines.append(f"ray_tpu_torch_{name} {float(value)}")

    g("cluster_nodes_alive", s["nodes_alive"], "Alive nodes")
    g("cluster_nodes_total", s["nodes_total"], "All registered nodes")
    g("cluster_actors_alive", s["actors_alive"], "Alive actors")
    g("cluster_actors_total", s["actors_total"], "All actors")
    tasks = s.get("tasks") or {}
    for st, n in sorted((tasks.get("by_state") or {}).items()):
        lines.append(
            f'ray_tpu_torch_cluster_tasks{{state="{st}"}} {float(n)}')
    g("cluster_task_table_dropped", tasks.get("dropped", 0),
      "Task records evicted past the bounded-table cap")
    for metric, key in (("cluster_resource_total", "cluster_resources"),
                        ("cluster_resource_available",
                         "available_resources")):
        for k, v in (s.get(key) or {}).items():
            if isinstance(v, (int, float)):
                lines.append(
                    f'ray_tpu_torch_{metric}{{resource="{k}"}} {float(v)}')
    return "\n" + "\n".join(lines) + "\n"


def _node_gauges(state) -> str:
    """Per-node native metric set, labeled by node (reference:
    src/ray/stats/metric_defs.cc — ray_scheduler_tasks,
    ray_object_store_*, ray_spill_manager_*, and the reporter agent's
    node_cpu/node_mem gauges), scraped live from each raylet agent."""
    lines = []
    seen_help = set()

    def g(name, node, value, help_):
        full = f"ray_tpu_torch_node_{name}"
        if full not in seen_help:
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} gauge")
            seen_help.add(full)
        lines.append(f'{full}{{node="{node}"}} {float(value)}')

    for n in state.node_stats():
        if "error" in n:
            continue
        nid = n["node_id"][:16]
        for k, v in n.get("physical", {}).items():
            g(k, nid, v, f"host {k.replace('_', ' ')}")
        sched = n.get("scheduler", {})
        for k in ("tasks_pending", "tasks_running",
                  "tasks_dispatched_total", "tasks_spilled_back_total",
                  "workers_alive", "workers_idle", "actors_alive",
                  "sched_native", "event_loop_lag_s",
                  "event_loop_lag_peak_s"):
            g(f"scheduler_{k}", nid, sched.get(k, 0), f"scheduler {k}")
        for res, v in (sched.get("resources_available") or {}).items():
            if isinstance(v, (int, float)):
                lines.append(
                    f'ray_tpu_torch_node_resource_available'
                    f'{{node="{nid}",resource="{res}"}} {float(v)}')
        store = n.get("object_store", {})
        for k, v in store.items():
            if isinstance(v, (int, float)):
                g(f"object_store_{k}", nid, v, f"object store {k}")
        gpu = n.get("gpu", {})
        for k in ("num_gpus", "gpus_available"):
            g(f"gpu_{k}", nid, gpu.get(k, 0), f"GPU {k}")
    return "\n" + "\n".join(lines) + "\n" if lines else ""


def _serve_gauges() -> str:
    """Per-deployment serve data-plane gauges (queue depth, shed
    total/rate, p99/EWMA service time) from the controller's
    replica_load telemetry — the live serve panel, in exposition
    format. Empty when serve isn't running."""
    from ray_tpu_torch import serve as _serve
    mets = _serve.metrics()
    if not mets:
        return ""
    lines = []
    seen_help = set()

    def g(name, dep, value, help_):
        full = f"ray_tpu_torch_serve_{name}"
        if full not in seen_help:
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} gauge")
            seen_help.add(full)
        lines.append(f'{full}{{deployment="{dep}"}} {float(value)}')

    for dep, m in sorted(mets.items()):
        g("replicas", dep, m.get("replicas") or 0, "live replicas")
        g("queue_len", dep, m.get("queue_len") or 0,
          "queued + ongoing requests across replicas")
        g("shed_total", dep, m.get("shed_total") or 0,
          "requests shed (backpressure) total")
        g("shed_rate_per_s", dep, m.get("shed_rate_per_s") or 0,
          "shed rate since the previous scrape")
        g("requests_total", dep, m.get("requests_total") or 0,
          "requests admitted total")
        g("p99_seconds", dep, m.get("p99_s") or 0,
          "p99 service time over the replica latency reservoirs")
        g("ewma_seconds", dep, m.get("ewma_s") or 0,
          "EWMA service time (slowest replica)")
        llm = m.get("llm")
        if not isinstance(llm, dict):
            continue
        # LLM engine gauges (serve/llm): the autoscaler's signal set,
        # exported so capacity decisions are explainable from Grafana
        g("llm_tokens_per_s", dep, llm.get("tokens_per_s") or 0,
          "generated tokens/s across replica engines (5s window)")
        g("llm_kv_occupancy", dep, llm.get("kv_occupancy") or 0,
          "mean paged-KV pool occupancy across replicas (0..1)")
        g("llm_running_sequences", dep, llm.get("running") or 0,
          "sequences in the in-flight decode batches")
        g("llm_waiting_sequences", dep, llm.get("waiting") or 0,
          "sequences queued for admission")
        g("llm_generated_tokens_total", dep,
          llm.get("generated_tokens_total") or 0,
          "tokens generated since replica start")
        g("llm_ttft_p99_seconds", dep, llm.get("ttft_p99_s") or 0,
          "p99 time-to-first-token (worst replica reservoir)")
    return "\n" + "\n".join(lines) + "\n" if lines else ""


def _slo_gauges() -> str:
    """Client-side SLO gauges from the last published game-day report
    (``@gameday/report`` in the GCS KV) — the only exported metrics
    measured from the LOAD GENERATOR's side of the wire, labeled by
    scenario + phase. Empty when no game day has run."""
    from ray_tpu_torch.gameday import store as gd_store
    report = gd_store.load_report()
    if not report:
        return ""
    scen = report.get("scenario", "unknown")
    lines = []
    seen_help = set()

    def g(name, labels, value, help_):
        full = f"ray_tpu_torch_slo_{name}"
        if full not in seen_help:
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} gauge")
            seen_help.add(full)
        lbl = ",".join(f'{k}="{v}"' for k, v in labels.items())
        lines.append(f"{full}{{{lbl}}} {float(value)}")

    phases = dict(report.get("phases") or {})
    phases["_overall"] = report.get("overall") or {}
    for phase, st in sorted(phases.items()):
        base = {"scenario": scen, "phase": phase}
        for outcome in ("admitted", "shed", "failed"):
            g("requests", {**base, "outcome": outcome},
              st.get(outcome) or 0,
              "client-observed request count by outcome")
        for q in ("p50", "p99", "p999"):
            g(f"latency_{q}_seconds", base,
              (st.get(f"{q}_ms") or 0.0) / 1e3,
              f"client-observed open-loop latency {q}")
    slo = report.get("slo") or {}
    g("error_budget_burn", {"scenario": scen, "slo": "availability"},
      slo.get("availability_burn") or 0.0,
      "error budget spent (1.0 = exhausted; -1 = zero-budget SLO)")
    if "latency_burn" in slo:
        g("error_budget_burn", {"scenario": scen, "slo": "latency"},
          slo.get("latency_burn") or 0.0,
          "error budget spent (1.0 = exhausted; -1 = zero-budget SLO)")
    recon = report.get("reconciliation") or {}
    g("reconcile_ok", {"scenario": scen},
      1.0 if recon.get("ok") else 0.0,
      "1 when the client ledger reconciled exactly with the "
      "server-side records")
    g("passed", {"scenario": scen},
      1.0 if report.get("passed") else 0.0,
      "1 when the scenario met its SLO and reconciled")
    return "\n" + "\n".join(lines) + "\n"


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> int:
    """Start (or find) the dashboard actor; returns the bound port."""
    import ray_tpu_torch
    try:
        d = ray_tpu_torch.get_actor(DASHBOARD_NAME)
        return ray_tpu_torch.get(d.get_port.remote(), timeout=10.0)
    except Exception:
        pass
    cls = ray_tpu_torch.remote(name=DASHBOARD_NAME, lifetime="detached",
                         max_concurrency=16)(DashboardActor)
    d = cls.remote(host, port)
    return ray_tpu_torch.get(d.get_port.remote(), timeout=30.0)
