"""`ray-tpu-torch` command line.

Reference analogue: python/ray/scripts/scripts.py (`ray start/stop/
status/memory/timeline`) + dashboard/modules/job/cli.py (`ray job ...`).
argparse-based (zero extra deps).

Copied from the JAX package's ``ray_tpu/scripts/cli.py`` (imports
renamed to ``ray_tpu_torch``, ``RTPU_ADDRESS`` to ``RTT_ADDRESS``).
Differences: ``start`` takes ``--num-gpus`` where JAX takes
``--num-tpus``, and a ``--block``ed head shuts its cluster down on
SIGTERM as on Ctrl-C (``down`` relies on it); ``stop`` signals the
port's processes (``STOP_PATTERNS``); ``lint`` runs the port's rtpulint
(``ray_tpu_torch/analysis/cli.py``) over ``ray_tpu_torch/``. Not ported
yet: ``gameday list`` and ``gameday run`` (they need the game-day
runner).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def _connect(address=None):
    import ray_tpu_torch
    ray_tpu_torch.init(address=address or os.environ.get("RTT_ADDRESS"),
                 ignore_reinit_error=True)
    return ray_tpu_torch


def cmd_start(args):
    import ray_tpu_torch
    if args.head:
        ctx = ray_tpu_torch.init(
            num_cpus=args.num_cpus, num_gpus=args.num_gpus,
            resources=json.loads(args.resources)
            if args.resources else None)
        print(f"started head; GCS at {ctx['gcs_address']}")
        print(f"export RTT_ADDRESS={ctx['gcs_address']}", flush=True)
        if args.ray_client_server_port is not None:
            from ray_tpu_torch.util.client.server import ClientServer
            srv = ClientServer(port=args.ray_client_server_port)
            print(f"ray:// client server on port {srv.port} "
                  f"(connect with "
                  f"ray_tpu_torch.init('ray://<host>:{srv.port}'))")
            if not args.block:
                # the server lives on daemon threads in THIS process; if
                # the CLI exits, clients get connection-refused while the
                # cluster subprocesses keep running
                print("note: --ray-client-server-port implies --block")
                args.block = True
        if args.dashboard:
            from ray_tpu_torch.dashboard.dashboard import start_dashboard
            port = start_dashboard(port=args.dashboard_port)
            print(f"dashboard at http://127.0.0.1:{port}")
        if args.block:
            print("blocking; Ctrl-C to stop", flush=True)
            _interrupt_on_sigterm()
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass
            ray_tpu_torch.shutdown()
    else:
        if not args.address:
            sys.exit("--address required for worker nodes")
        from ray_tpu_torch._private import node as node_mod
        info = node_mod.add_node(
            node_mod.new_session_dir(), args.address,
            resources={"CPU": args.num_cpus or 1,
                       **({"GPU": args.num_gpus}
                          if args.num_gpus is not None else {})})
        print(f"started worker node {info['node_id'][:8]} "
              f"against {args.address}")
        if args.block:
            _interrupt_on_sigterm()
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                info["proc"].terminate()
                info["proc"].wait()


def _interrupt_on_sigterm():
    """Make SIGTERM end a ``--block`` wait as Ctrl-C does, so the node
    shuts down (the raylet reaps its workers) instead of dying at once."""
    def _raise(signum, frame):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, _raise)


# the command lines of the port's GCS, raylet and worker processes
STOP_PATTERNS = ["ray_tpu_torch._private.gcs_main",
                 "ray_tpu_torch._private.raylet_main",
                 "ray_tpu_torch._private.default_worker"]


def cmd_stop(args):
    # reference `ray stop`: kill every framework process on this machine
    n = 0
    for pat in STOP_PATTERNS:
        r = subprocess.run(["pkill", "-f", pat], capture_output=True)
        n += int(r.returncode == 0)
    print(f"stopped ({n} process groups signalled)")


def cmd_status(args):
    rt = _connect(args.address)
    from ray_tpu_torch.experimental.state import summarize_cluster
    s = summarize_cluster()
    print(json.dumps(s, indent=2, default=str))


def cmd_memory(args):
    rt = _connect(args.address)
    w = rt._worker_mod.global_worker()
    refs = w.reference_counter.debug_dump() if hasattr(
        w.reference_counter, "debug_dump") else {}
    print(json.dumps({"local_references": len(refs) if refs else 0},
                     indent=2))


def cmd_timeline(args):
    rt = _connect(args.address)
    from ray_tpu_torch.util.timeline import timeline_dump
    out = args.output or "timeline.json"
    with open(out, "w") as f:
        json.dump(timeline_dump(), f)
    print(f"wrote {out}")


def cmd_job_submit(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    client = JobSubmissionClient(args.address)
    job_id = client.submit_job(
        entrypoint=" ".join(args.entrypoint),
        runtime_env=json.loads(args.runtime_env)
        if args.runtime_env else None)
    print(f"submitted job {job_id}")
    if args.wait:
        status = client.wait_until_finish(job_id, timeout=args.timeout)
        print(f"job {job_id}: {status}")
        print(client.get_job_logs(job_id))
        sys.exit(0 if status == "SUCCEEDED" else 1)


def cmd_job_status(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    print(JobSubmissionClient(args.address).get_job_status(args.job_id))


def cmd_job_logs(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    print(JobSubmissionClient(args.address).get_job_logs(args.job_id))


def cmd_job_list(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    for j in JobSubmissionClient(args.address).list_jobs():
        print(f"{j.get('job_id')}\t{j.get('status')}\t"
              f"{j.get('entrypoint')}")


def cmd_job_stop(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient
    JobSubmissionClient(args.address).stop_job(args.job_id)
    print(f"stopped {args.job_id}")


def _print_table(rows, cols):
    """Aligned plain-text table (no deps); values stringified, None
    printed as '-'."""
    def cell(r, c):
        v = r.get(c)
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.6g}"
        if isinstance(v, (dict, list)):
            return json.dumps(v)
        return str(v)
    table = [[cell(r, c) for c in cols] for r in rows]
    widths = [max(len(c), *(len(t[i]) for t in table)) if table
              else len(c) for i, c in enumerate(cols)]
    print("  ".join(c.ljust(w) for c, w in zip(cols, widths)))
    for t in table:
        print("  ".join(v.ljust(w) for v, w in zip(t, widths)))


_LIST_COLUMNS = {
    "tasks": ["task_id", "name", "state", "attempt", "node_id",
              "worker_pid", "duration_s", "error"],
    "objects": ["object_id", "size_bytes", "pinned", "spilled",
                "locations", "owner"],
    "actors": ["actor_id", "class_name", "state", "name",
               "num_restarts", "node_id"],
    "nodes": ["node_id", "alive", "draining", "is_head", "resources",
              "available"],
    "jobs": ["job_id", "status", "namespace", "driver_pid"],
    "placement-groups": ["pg_id", "state", "strategy", "name"],
}


def cmd_list(args):
    """`ray-tpu-torch list tasks|objects|actors|nodes|jobs|placement-groups`
    (reference: `ray list ...` backed by the state API): paginated,
    server-side filtered listings."""
    _connect(args.address)
    from ray_tpu_torch.experimental.state import api as state
    filters = {}
    for f in args.filter or ():
        k, sep, v = f.partition("=")
        if not sep:
            sys.exit(f"--filter wants key=value, got {f!r}")
        filters[k] = v
    if getattr(args, "state", None):
        filters["state"] = args.state
    fn = {"tasks": state.list_tasks, "objects": state.list_objects,
          "actors": state.list_actors, "nodes": state.list_nodes,
          "jobs": state.list_jobs,
          "placement-groups": state.list_placement_groups}[args.resource]
    rows = fn(filters=filters or None, limit=args.limit)
    if args.json:
        print(json.dumps(list(rows), indent=2, default=str))
    else:
        cols = _LIST_COLUMNS[args.resource]
        short = {"task_id", "actor_id", "node_id", "object_id", "pg_id"}
        view = [{c: (str(r.get(c))[:16] if c in short and r.get(c)
                     else r.get(c)) for c in cols} for r in rows]
        _print_table(view, cols)
    total = rows.total if rows.total is not None else len(rows)
    note = f"{len(rows)} shown / {total} matched"
    if rows.dropped:
        note += f" ({rows.dropped} evicted past the table cap)"
    if rows.next_token:
        note += " — more available (raise --limit)"
    print(note, file=sys.stderr)


def cmd_summary(args):
    """`ray-tpu-torch summary tasks`: per-function aggregation computed
    GCS-side over the bounded task table."""
    _connect(args.address)
    from ray_tpu_torch.experimental.state import api as state
    s = state.summarize_tasks()
    rows = [{"name": a["name"], "count": a["count"],
             "mean_duration_s": a.get("mean_duration_s"),
             **{st: a["by_state"].get(st, 0)
                for st in ("RUNNING", "FINISHED", "FAILED")}}
            for a in s.get("summary", ())]
    _print_table(rows, ["name", "count", "RUNNING", "FINISHED",
                        "FAILED", "mean_duration_s"])
    print(f"table: {s.get('total', 0)} tracked, "
          f"{s.get('dropped', 0)} evicted, "
          f"{s.get('events_dropped', 0)} events dropped at source",
          file=sys.stderr)


def cmd_trace_list(args):
    """`ray-tpu-torch trace list`: recent traces from the GCS trace table."""
    _connect(args.address)
    from ray_tpu_torch.experimental.state import api as state
    rows = state.list_traces(limit=args.limit)
    view = sorted(rows, key=lambda r: -(r.get("start_ts") or 0))
    for r in view:
        r["start"] = time.strftime(
            "%H:%M:%S", time.localtime(r.get("start_ts") or 0))
    _print_table(view, ["trace_id", "root", "spans", "start",
                        "duration_s", "status"])
    if rows.dropped:
        print(f"{rows.dropped} spans evicted past the table cap",
              file=sys.stderr)


def cmd_trace_show(args):
    """`ray-tpu-torch trace show <id>`: the span tree, indented; --chrome
    writes a chrome://tracing document merged with any CUDA device
    spans (gpu_profiler) on the same wall-clock axis."""
    _connect(args.address)
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.experimental.state import api as state
    doc = state.get_trace(args.trace_id)
    spans = doc.get("spans") or []
    if not spans:
        sys.exit(f"no spans for trace {args.trace_id!r}")
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(tracing.export_chrome(spans), f)
        print(f"wrote {args.chrome} ({len(spans)} spans)")
        return
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
        return
    by_parent = {}
    ids = {s.get("span_id") for s in spans}
    for s in spans:
        p = s.get("parent_span_id")
        key = p if p in ids else None
        by_parent.setdefault(key, []).append(s)
    t0 = min(s["start_ts"] for s in spans if s.get("start_ts"))

    def walk(parent, depth):
        for s in sorted(by_parent.get(parent, ()),
                        key=lambda x: x.get("start_ts") or 0):
            dur = ((s.get("end_ts") or 0) - (s.get("start_ts") or 0))
            off = (s.get("start_ts") or t0) - t0
            mark = "" if s.get("status") in (None, "ok") \
                else f"  [{s['status'].upper()}]"
            print(f"{'  ' * depth}{s.get('name')}  "
                  f"+{off * 1e3:.2f}ms {dur * 1e3:.2f}ms "
                  f"({s.get('phase')}){mark}")
            walk(s.get("span_id"), depth + 1)

    walk(None, 0)
    ok, detail = tracing.tree_complete(spans)
    print(f"tree: {'complete' if ok else 'INCOMPLETE'} — {detail}",
          file=sys.stderr)


def cmd_trace_critical_path(args):
    """`ray-tpu-torch trace critical-path <id>`: attribute the trace's wall
    time to named phases (queue/schedule/dispatch/transfer/execute/
    deserialize) with the deepest-span sweep; --gameday-p99 aggregates
    the published game-day report's p99 cohort instead."""
    _connect(args.address)
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.experimental.state import api as state
    if args.trace_id:
        doc = state.get_trace(args.trace_id)
        spans = doc.get("spans") or []
        if not spans:
            sys.exit(f"no spans for trace {args.trace_id!r}")
        cp = tracing.critical_path(spans)
        total = cp["total_s"] or 1.0
        print(f"trace {args.trace_id}: {cp['total_s'] * 1e3:.2f}ms "
              f"wall, {cp['attributed_frac'] * 100:.1f}% attributed")
        _print_table(
            [{"phase": k, "ms": round(v * 1e3, 3),
              "pct": round(100 * v / total, 1)}
             for k, v in cp["phases"].items()],
            ["phase", "ms", "pct"])
        if args.segments:
            base = cp["segments"][0]["t0"] if cp["segments"] else 0.0
            for seg in cp["segments"]:
                off_ms = (seg["t0"] - base) * 1e3
                dur_ms = (seg["t1"] - seg["t0"]) * 1e3
                print(f"  +{off_ms:8.2f}ms  {dur_ms:8.2f}ms  "
                      f"{seg['phase']:<12} {seg['name']}")
        return
    # --gameday-p99: the published report names the slowest requests;
    # aggregate their traces (where does the tail spend its time?)
    from ray_tpu_torch.gameday import store as gd_store
    report = gd_store.load_report()
    if not report:
        sys.exit("no trace id given and no game-day report published")
    slowest = report.get("slowest") or []
    traces = []
    for entry in slowest:
        tid = entry.get("trace_id")
        if not tid:
            continue
        spans = state.get_trace(tid).get("spans") or []
        if spans:
            traces.append(spans)
    if not traces:
        sys.exit("the published report's slowest requests have no "
                 "stored traces (sampled out or evicted)")
    agg = tracing.aggregate_critical_path(traces)
    print(f"{agg['traces']} tail traces, "
          f"{agg['total_s'] * 1e3:.1f}ms total")
    _print_table(
        [{"phase": k, "ms": round(v * 1e3, 3),
          "pct": round(100 * agg.get("phase_frac", {}).get(k, 0), 1)}
         for k, v in agg["phases"].items()],
        ["phase", "ms", "pct"])


def cmd_events(args):
    _connect(args.address)
    from ray_tpu_torch.experimental.state import api as state
    for e in state.list_cluster_events(limit=args.limit,
                                       severity=args.severity):
        ts = time.strftime("%H:%M:%S",
                           time.localtime(e.get("timestamp", 0)))
        print(f"[{ts}] {e.get('severity', ''):7} "
              f"{e.get('source', ''):7} {e.get('label', '')}: "
              f"{e.get('message', '')}")


def cmd_grafana(args):
    from ray_tpu_torch.dashboard.grafana import write_dashboards
    for path in write_dashboards(args.out):
        print(path)


def cmd_up(args):
    from ray_tpu_torch.autoscaler.commands import create_or_update_cluster
    state = create_or_update_cluster(args.config_file)
    print(f"cluster {state['cluster_name']!r} up "
          f"({len(state.get('nodes', {}))} worker nodes)")
    head = state.get("head") or {}
    if head.get("gcs_address"):
        print(f"export RTT_ADDRESS={head['gcs_address']}")
    if state.get("bootstrap"):
        print(state["bootstrap"])


def cmd_down(args):
    from ray_tpu_torch.autoscaler.commands import teardown_cluster
    n = teardown_cluster(args.config_file)
    print(f"tore down {n} nodes")


def _serve_connect(args):
    import ray_tpu_torch
    ray_tpu_torch.init(address=args.address, ignore_reinit_error=True)


def cmd_serve_run(args):
    """`ray-tpu-torch serve run module:app` (reference:
    serve/scripts.py run)."""
    _serve_connect(args)
    from ray_tpu_torch.serve.schema import ServeApplicationSchema, build_app
    from ray_tpu_torch.serve.api import run as serve_run
    sys.path.insert(0, os.getcwd())
    schema = ServeApplicationSchema(
        name=args.name, import_path=args.import_path,
        route_prefix=args.route_prefix)
    app = build_app(schema)
    serve_run(app, name=args.name, route_prefix=args.route_prefix,
              http_port=args.port)
    print(f"app {args.name!r} deployed from {args.import_path} "
          f"on port {args.port}")
    if args.blocking:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass


def cmd_serve_deploy(args):
    _serve_connect(args)
    import yaml
    from ray_tpu_torch.serve.schema import deploy_config
    sys.path.insert(0, os.getcwd())
    with open(args.config_file) as f:
        config = yaml.safe_load(f)
    names = deploy_config(config)
    print(f"deployed applications: {', '.join(names)}")


def cmd_serve_status(args):
    _serve_connect(args)
    from ray_tpu_torch import serve
    print(json.dumps({"applications": serve.list_applications(),
                      "deployments": serve.status()}, indent=2,
                     default=str))


def cmd_serve_shutdown(args):
    _serve_connect(args)
    from ray_tpu_torch import serve
    serve.shutdown()
    print("serve shut down")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ray-tpu-torch",
        description="distributed compute framework (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="start head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="GCS address for worker nodes")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--resources", help="JSON dict of extra resources")
    sp.add_argument("--dashboard", action="store_true")
    sp.add_argument("--dashboard-port", type=int, default=8265)
    sp.add_argument("--ray-client-server-port", type=int, default=None,
                    help="serve ray:// clients on this port (0 = pick)")
    sp.add_argument("--block", action="store_true")
    sp.set_defaults(func=cmd_start)

    sp = sub.add_parser("stop", help="stop all local processes")
    sp.set_defaults(func=cmd_stop)

    sp = sub.add_parser("status", help="cluster summary")
    sp.add_argument("--address", default=None)
    sp.set_defaults(func=cmd_status)

    sp = sub.add_parser("memory", help="reference/memory summary")
    sp.add_argument("--address", default=None)
    sp.set_defaults(func=cmd_memory)

    sp = sub.add_parser("timeline", help="dump chrome trace")
    sp.add_argument("--address", default=None)
    sp.add_argument("--output", default=None)
    sp.set_defaults(func=cmd_timeline)

    jp = sub.add_parser("job", help="job submission")
    jsub = jp.add_subparsers(dest="job_command", required=True)
    sp = jsub.add_parser("submit")
    sp.add_argument("--address", default=None)
    sp.add_argument("--runtime-env", default=None)
    sp.add_argument("--wait", action="store_true")
    sp.add_argument("--timeout", type=float, default=600.0)
    sp.add_argument("entrypoint", nargs="+")
    sp.set_defaults(func=cmd_job_submit)
    for name, fn in (("status", cmd_job_status), ("logs", cmd_job_logs),
                     ("stop", cmd_job_stop)):
        sp = jsub.add_parser(name)
        sp.add_argument("--address", default=None)
        sp.add_argument("job_id")
        sp.set_defaults(func=fn)
    sp = jsub.add_parser("list")
    sp.add_argument("--address", default=None)
    sp.set_defaults(func=cmd_job_list)

    sp = sub.add_parser(
        "list", help="paginated state listings (tasks/objects/...)")
    sp.add_argument("resource",
                    choices=["tasks", "objects", "actors", "nodes",
                             "jobs", "placement-groups"])
    sp.add_argument("--address", default=None)
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--state", default=None,
                    help="shorthand for --filter state=...")
    sp.add_argument("--filter", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="server-side equality filter (repeatable)")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(func=cmd_list)

    sp = sub.add_parser("summary", help="aggregated state summaries")
    sp.add_argument("what", choices=["tasks"])
    sp.add_argument("--address", default=None)
    sp.set_defaults(func=cmd_summary)

    tp = sub.add_parser(
        "trace", help="distributed traces (docs/TRACING.md)")
    tsub = tp.add_subparsers(dest="trace_command", required=True)
    sp = tsub.add_parser("list", help="recent traces")
    sp.add_argument("--address", default=None)
    sp.add_argument("--limit", type=int, default=50)
    sp.set_defaults(func=cmd_trace_list)
    sp = tsub.add_parser("show", help="span tree of one trace")
    sp.add_argument("trace_id")
    sp.add_argument("--address", default=None)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="write a chrome://tracing doc (merged with "
                         "CUDA device spans on one time axis)")
    sp.set_defaults(func=cmd_trace_show)
    sp = tsub.add_parser(
        "critical-path",
        help="attribute a trace's wall time to named phases")
    sp.add_argument("trace_id", nargs="?", default=None)
    sp.add_argument("--address", default=None)
    sp.add_argument("--segments", action="store_true",
                    help="print the attributed time slices")
    sp.add_argument("--gameday-p99", action="store_true",
                    help="aggregate the published game-day report's "
                         "slowest requests instead of one trace")
    sp.set_defaults(func=cmd_trace_critical_path)

    sp = sub.add_parser("events", help="structured cluster events")
    sp.add_argument("--address", default=None)
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--severity", default=None)
    sp.set_defaults(func=cmd_events)

    sp = sub.add_parser(
        "grafana",
        help="generate importable Grafana dashboards for /metrics")
    sp.add_argument("--out", default="./grafana_dashboards")
    sp.set_defaults(func=cmd_grafana)

    sp = sub.add_parser("up", help="create/update a cluster from YAML")
    sp.add_argument("config_file")
    sp.set_defaults(func=cmd_up)
    sp = sub.add_parser("down", help="tear down a cluster from YAML")
    sp.add_argument("config_file")
    sp.set_defaults(func=cmd_down)

    svp = sub.add_parser("serve", help="model serving")
    ssub = svp.add_subparsers(dest="serve_command", required=True)
    sp = ssub.add_parser("run", help="deploy module:app and block")
    sp.add_argument("--address", default=None)
    sp.add_argument("--name", default="default")
    sp.add_argument("--route-prefix", default="/")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--blocking", action="store_true", default=True)
    sp.add_argument("--non-blocking", dest="blocking",
                    action="store_false")
    sp.add_argument("import_path")
    sp.set_defaults(func=cmd_serve_run)
    sp = ssub.add_parser("deploy", help="deploy a YAML config file")
    sp.add_argument("--address", default=None)
    sp.add_argument("config_file")
    sp.set_defaults(func=cmd_serve_deploy)
    sp = ssub.add_parser("status")
    sp.add_argument("--address", default=None)
    sp.set_defaults(func=cmd_serve_status)
    sp = ssub.add_parser("shutdown")
    sp.add_argument("--address", default=None)
    sp.set_defaults(func=cmd_serve_shutdown)

    # `ray-tpu-torch lint ...` delegates argv wholesale to the rtpulint
    # CLI (ray_tpu_torch/analysis/cli.py) so `ray-tpu-torch lint` and
    # `python -m ray_tpu_torch.analysis` stay one surface
    sp = sub.add_parser(
        "lint", add_help=False,
        help="project-aware static analysis of ray_tpu_torch/ (rtpulint)")
    sp.set_defaults(func=None)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "lint":
        from ray_tpu_torch.analysis.cli import main as lint_main
        sys.exit(lint_main(argv[1:]))

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
