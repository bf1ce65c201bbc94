"""The port's cluster operations against the JAX package's, on the CPU:
the state API, job submission (in-cluster and over the dashboard's REST
routes), the dashboard, ``util.metrics``, the CLI and ``ray_perf``.

One cluster of each package for the module (``init(num_cpus=4)``), and
one dashboard on each (the port's on port 0, JAX's on a free port found
first). Each program runs on both at once (two driver threads) and the
two must agree: the same keys in the state API's rows and summaries,
the same status sequences for jobs that succeed, fail and are stopped,
the same top-level keys on every dashboard route, the same ``/metrics``
gauge families (``ray_tpu_*`` reads ``ray_tpu_torch_*``, the TPU gauges
read GPU ones), the same Prometheus text for the same recorded points,
the same CLI options (``--num-gpus`` for ``--num-tpus``; no
``gameday``). The CLI's ``status``, ``list actors`` and ``job list`` run
as fresh processes against the port cluster and load no torch. Actor
classes and task functions are defined inside the programs (cloudpickle
ships them by value). Every wait has a time limit.
"""

import concurrent.futures
import contextlib
import importlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from unittest import mock

import pytest

import ray_tpu
import ray_tpu_torch

STORE_BYTES = 128 * 1024 * 1024
PACKAGES = ("ray_tpu", "ray_tpu_torch")
PORT_ENV = {"RTT_VALIDATE_WIRE": "1", "RTT_PRESTART_WORKERS": "0"}
TIMEOUT_S = 60
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def clusters():
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    with mock.patch.dict(os.environ, PORT_ENV):
        ray_tpu.init(num_cpus=4, object_store_memory=STORE_BYTES)
        try:
            ray_tpu_torch.init(num_cpus=4, object_store_memory=STORE_BYTES)
            try:
                from ray_tpu.dashboard import start_dashboard as jax_dash
                from ray_tpu_torch.dashboard import (
                    start_dashboard as port_dash)
                ports = {"ray_tpu": jax_dash(port=_free_port()),
                         "ray_tpu_torch": port_dash(port=0)}
                assert ports["ray_tpu_torch"] > 0
                yield ports
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()


def _both(program, timeout=TIMEOUT_S):
    """``program(pkg)`` for each package, the two at once: {pkg: its
    result}."""
    with concurrent.futures.ThreadPoolExecutor(len(PACKAGES)) as pool:
        futures = {pkg: pool.submit(program, pkg) for pkg in PACKAGES}
        return {pkg: f.result(timeout=timeout)
                for pkg, f in futures.items()}


def _port_names(text):
    """A JAX name as the port spells it."""
    for a, b in (("ray_tpu_", "ray_tpu_torch_"),
                 ("node_tpu_num_chips", "node_gpu_num_gpus"),
                 ("node_tpu_chips_available", "node_gpu_gpus_available")):
        text = text.replace(a, b)
    return text.replace("ray_tpu_torch_torch_", "ray_tpu_torch_")


def _get(port, path, timeout=TIMEOUT_S):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _work(pkg):
    """Three tasks and an actor with two calls, finished."""
    rt = importlib.import_module(pkg)

    @rt.remote
    def ops_task(x):
        return x + 1

    @rt.remote
    class OpsActor:
        def ping(self):
            return "pong"

    assert rt.get([ops_task.remote(i) for i in range(3)],
                  timeout=TIMEOUT_S) == [1, 2, 3]
    a = OpsActor.options(name="ops_actor").remote()
    assert rt.get([a.ping.remote(), a.ping.remote()],
                  timeout=TIMEOUT_S) == ["pong", "pong"]
    return a


@pytest.fixture(scope="module")
def work(clusters):
    actors = _both(_work)
    time.sleep(1.5)          # the task-event flush tick ships the rows
    return actors


# ---------------------------------------------------------- state API


LISTS = ("list_nodes", "list_actors", "list_tasks", "list_jobs",
         "list_objects", "list_placement_groups", "list_traces")


@pytest.mark.parametrize("name", LISTS)
def test_state_list_keys_match_jax(work, name):
    def program(pkg):
        api = importlib.import_module(pkg + ".experimental.state.api")
        rows = getattr(api, name)(limit=100)
        # JAX's node rows carry the raylet's TPU topology ("tpu"); the
        # port's runtime keeps GPUs as plain resources, with no such block
        keys = sorted({k for r in rows for k in r} - {"tpu"})
        return keys, type(rows.total).__name__, rows.dropped >= 0
    got = _both(program)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    if name not in ("list_objects", "list_placement_groups", "list_traces"):
        assert got["ray_tpu_torch"][0]


@pytest.mark.parametrize("name", ("summarize_tasks", "summarize_cluster",
                                  "node_stats", "list_cluster_events",
                                  "list_logs"))
def test_state_summaries_match_jax(work, name):
    def program(pkg):
        api = importlib.import_module(pkg + ".experimental.state.api")
        out = getattr(api, name)()
        if isinstance(out, dict):
            return sorted(out)
        # a raylet's "tpu" block is the port's "gpu" one
        return sorted({"gpu" if k == "tpu" else k
                       for r in out if isinstance(r, dict) for k in r})
    got = _both(program)
    assert got["ray_tpu_torch"] == [_port_names(k) for k in got["ray_tpu"]]


def test_state_counts_the_work(work):
    def program(pkg):
        api = importlib.import_module(pkg + ".experimental.state.api")
        tasks = api.summarize_tasks()["summary"]
        mine = [t for t in tasks if "ops_task" in t["name"]]
        actors = api.list_actors(filters={"name": "ops_actor"})
        return (sum(t["count"] for t in mine), [a["state"] for a in actors],
                len(api.list_nodes()))
    got = _both(program)
    assert got["ray_tpu_torch"] == got["ray_tpu"] == (3, ["ALIVE"], 1)


# -------------------------------------------------------------- jobs


ENTRY = {"succeeded": "sleep 0.5; echo out ${RTPU_JOB_ID:+jax}"
                      "${RTT_JOB_ID:+port} cvd=[${CUDA_VISIBLE_DEVICES-}]",
         "failed": "sleep 0.5; echo failing; exit 3",
         "stopped": "echo started; exec sleep 60"}


def _job_run(pkg, transport, outcome, port):
    js = importlib.import_module(pkg + ".job_submission")
    client = js.JobSubmissionClient(
        f"http://127.0.0.1:{port}" if transport == "rest" else None)
    # a fresh id each run: JAX's supervisor appends to the log file a
    # job of the same id left in the temp dir
    job_id = client.submit_job(
        entrypoint=ENTRY[outcome],
        job_id=f"ops-{transport}-{outcome}-{os.getpid()}-{time.time_ns()}")
    seen = []
    deadline = time.time() + TIMEOUT_S
    while time.time() < deadline:
        s = client.get_job_status(job_id)
        if not seen or seen[-1] != s:
            seen.append(s)
        if outcome == "stopped" and s == "RUNNING" and \
                "started" in client.get_job_logs(job_id):
            assert client.stop_job(job_id) is True
        if s in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        time.sleep(0.05)
    info = client.get_job_info(job_id)
    listed = [j["job_id"] for j in client.list_jobs()]
    return (seen, sorted(info), info.get("return_code"),
            client.get_job_logs(job_id).strip(), job_id in listed)


@pytest.mark.parametrize("outcome", sorted(ENTRY))
@pytest.mark.parametrize("transport", ("in_cluster", "rest"))
def test_jobs_match_jax(clusters, transport, outcome):
    got = _both(lambda pkg: _job_run(pkg, transport, outcome,
                                     clusters[pkg]))
    jax, port = got["ray_tpu"], got["ray_tpu_torch"]
    want_end = {"succeeded": "SUCCEEDED", "failed": "FAILED",
                "stopped": "STOPPED"}[outcome]
    assert port[0] == jax[0] == ["RUNNING", want_end]
    assert port[1:3] == jax[1:3] and port[4] and jax[4]
    if outcome == "succeeded":
        assert jax[3].startswith("out jax cvd=")
        assert port[3] == "out port cvd=[]"      # the entrypoint has no card
    else:
        assert port[3] == jax[3]


# --------------------------------------------------------- dashboard


ROUTES = ("/", "/healthz", "/api/cluster_status", "/api/nodes",
          "/api/nodes/stats", "/api/actors", "/api/tasks?limit=5",
          "/api/objects", "/api/summary/tasks", "/api/timeline",
          "/api/traces", "/api/trace/none", "/api/serve/metrics",
          "/api/gameday", "/api/placement_groups", "/api/profile/stacks",
          "/api/profile/flamegraph?duration_s=0.2", "/api/grafana/dashboards",
          "/api/events", "/api/logs", "/api/serve/applications",
          "/api/jobs/", "/api/nope")


@pytest.mark.parametrize("route", ROUTES)
def test_dashboard_route_matches_jax(clusters, work, route):
    def program(pkg):
        code, ctype, body = _get(clusters[pkg], route)
        if ctype == "application/json":
            doc = json.loads(body)
            return code, ctype, sorted(_port_names(k) for k in doc)
        return code, ctype, len(body) > 0
    got = _both(program)
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def _families(text):
    return {m.group(1) for m in re.finditer(
        r"^# TYPE (ray_tpu\w*) ", text, re.M)}


def test_metrics_gauge_families_match_jax(clusters, work):
    got = _both(lambda pkg: _get(clusters[pkg], "/metrics")[2].decode())
    jax = {_port_names(f) for f in _families(got["ray_tpu"])}
    port = _families(got["ray_tpu_torch"])
    assert port == jax
    assert {"ray_tpu_torch_node_gpu_num_gpus",
            "ray_tpu_torch_node_gpu_gpus_available"} <= port
    assert re.search(r'^ray_tpu_torch_node_gpu_num_gpus\{node="\w+"\} 0\.0$',
                     got["ray_tpu_torch"], re.M)


def _record(pkg, prefix):
    metrics = importlib.import_module(pkg + ".util.metrics")
    metrics.Counter(f"{prefix}_requests", "requests",
                    tag_keys=("route",)).inc(2, {"route": "/a"})
    c = metrics.Counter(f"{prefix}_requests", "requests",
                        tag_keys=("route",))
    c.inc(3, {"route": "/a"})
    c.inc(1, {"route": 'we"ird\n'})
    metrics.Gauge(f"{prefix}_depth", "depth").set(7)
    metrics.Gauge(f"{prefix}_depth", "depth").set(5)
    h = metrics.Histogram(f"{prefix}_latency", "latency",
                          boundaries=[1.0, 10.0])
    for v in (0.5, 5.0, 50.0, 1.0):
        h.observe(v)
    metrics.flush_metrics()
    return "\n".join(line for line in metrics.prometheus_text().split("\n")
                     if prefix in line)


def test_prometheus_text_matches_jax(clusters):
    got = _both(lambda pkg: _record(pkg, "opsmetric"))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert 'opsmetric_requests{route="/a"} 5.0' in got["ray_tpu_torch"]
    assert 'opsmetric_latency_bucket{le="+Inf"} 4' in got["ray_tpu_torch"]


def test_metrics_from_an_actor_reach_the_dashboard(clusters):
    def program(pkg):
        rt = importlib.import_module(pkg)

        @rt.remote
        class Recorder:
            def record(self, n):
                metrics = importlib.import_module(pkg + ".util.metrics")
                metrics.Counter("opsactor_batches", "batches").inc(n)
                metrics.flush_metrics()
                return n

        a = Recorder.remote()
        rt.get(a.record.remote(4), timeout=TIMEOUT_S)
        text = _get(clusters[pkg], "/metrics")[2].decode()
        rt.kill(a)
        return [line for line in text.split("\n")
                if line.startswith("opsactor_batches")]
    got = _both(program)
    assert got["ray_tpu_torch"] == got["ray_tpu"] == ["opsactor_batches 4.0"]


# --------------------------------------------------------------- CLI


def _cli_help(pkg, argv):
    cli = importlib.import_module(pkg + ".scripts.cli")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        cli.main(argv + ["--help"])
    assert e.value.code == 0
    return out.getvalue()


def _subcommands(pkg):
    text = _cli_help(pkg, [])
    return set(re.search(r"\{([\w,-]+)\}", text).group(1).split(","))


COMMANDS = (["start"], ["stop"], ["status"], ["memory"], ["timeline"],
            ["job", "submit"], ["job", "status"], ["job", "logs"],
            ["job", "list"], ["job", "stop"], ["list"], ["summary"],
            ["trace", "list"], ["trace", "show"], ["trace", "critical-path"],
            ["events"], ["grafana"], ["up"], ["down"], ["serve", "run"],
            ["serve", "deploy"], ["serve", "status"], ["serve", "shutdown"])


def test_cli_subcommands_match_jax():
    assert _subcommands("ray_tpu_torch") == \
        _subcommands("ray_tpu") - {"gameday"}
    for argv in COMMANDS:
        assert argv[0] in _subcommands("ray_tpu_torch")


@pytest.mark.parametrize("argv", COMMANDS, ids=" ".join)
def test_cli_options_match_jax(argv):
    def options(pkg):
        return sorted(set(re.findall(r"--[\w-]+", _cli_help(pkg, argv))))
    jax = [o.replace("--num-tpus", "--num-gpus") for o in options("ray_tpu")]
    assert options("ray_tpu_torch") == sorted(jax)


def test_cli_stop_patterns_name_the_port():
    from ray_tpu_torch._private import (default_worker, gcs_main,
                                        raylet_main)
    from ray_tpu_torch.scripts import cli
    assert cli.STOP_PATTERNS == [m.__name__ for m in
                                 (gcs_main, raylet_main, default_worker)]


def test_cli_grafana_writes_gpu_boards(tmp_path):
    from ray_tpu_torch.scripts import cli
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["grafana", "--out", str(tmp_path)])
    nodes = json.loads((tmp_path / "ray_tpu_torch_nodes.json").read_text())
    exprs = [t["expr"] for p in nodes["panels"] for t in p["targets"]]
    assert "ray_tpu_torch_node_gpu_num_gpus" in exprs
    assert not any("tpu_num_chips" in e for e in exprs)


CLI_PROBE = ("import atexit, sys\n"
             "atexit.register(lambda: print('TORCH', 'torch' in sys.modules))"
             "\nfrom ray_tpu_torch.scripts import cli\n"
             "cli.main(sys.argv[1:])\n")


def test_cli_processes_load_no_torch(work):
    """``status``, ``list actors`` and ``job list`` as fresh processes
    against the port cluster: each exits 0, names what it lists, and
    never imports torch."""
    from ray_tpu_torch.job_submission import JobSubmissionClient
    JobSubmissionClient().submit_job(entrypoint="true", job_id="ops-cli")
    address = ray_tpu_torch._worker_mod.global_worker().gcs_address
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", CLI_PROBE, *argv, "--address", address],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, argv in (("status", ["status"]),
                           ("actors", ["list", "actors"]),
                           ("jobs", ["job", "list"]))}
    outs = {n: p.communicate(timeout=TIMEOUT_S) for n, p in procs.items()}
    for name, p in procs.items():
        assert p.returncode == 0, (name, outs[name][1][-2000:])
        assert outs[name][0].rstrip().endswith("TORCH False"), name
    assert '"nodes_alive": 1' in outs["status"][0]
    assert "OpsActor" in outs["actors"][0]
    assert "ops-cli" in outs["jobs"][0]


# --------------------------------------------------------- ray_perf


def test_ray_perf_timeit_matches_jax():
    def program(pkg):
        perf = importlib.import_module(pkg + "._private.ray_perf")
        with contextlib.redirect_stdout(io.StringIO()):
            name, mean, sd = perf.timeit("noop", lambda: None, reps=2,
                                         window_s=0.05)
        return name, mean > 0, sd >= 0
    got = _both(program)
    assert got["ray_tpu_torch"] == got["ray_tpu"] == ("noop", True, True)


def test_ray_perf_breakdown_keys_match_jax(clusters):
    """Last in the module: JAX's ``breakdown`` shuts its cluster down at
    the end; the port's leaves the caller's cluster up."""
    def program(pkg):
        perf = importlib.import_module(pkg + "._private.ray_perf")
        with contextlib.redirect_stdout(io.StringIO()):
            out = perf.breakdown(n=50)
        return {k: sorted(v) for k, v in out.items()}
    got = _both(program)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert sorted(got["ray_tpu_torch"]) == ["dispatch", "execute", "reply",
                                            "total", "wire"]
    assert ray_tpu_torch.is_initialized()


def test_rpc_server_closed_from_another_thread():
    """A driver's shutdown closes its RPC server from its own thread, not
    the server's loop: the close runs on the loop, raises nothing, and
    the server's connections end. (asyncio's Server is not thread-safe:
    closed off its loop while a connection detached, its second _wakeup
    raised TypeError, and the connections' read loops were left pending
    — "Task was destroyed but it is pending!" at teardown.)"""
    from ray_tpu_torch._private import protocol
    io = protocol.EventLoopThread("close-test")
    srv = protocol.Server({})
    clients = []
    try:
        port = io.run(srv.start_tcp("127.0.0.1", 0))
        clients = [io.run(protocol.connect(f"127.0.0.1:{port}"))
                   for _ in range(4)]
        deadline = time.time() + 10
        while len(srv.connections) < 4 and time.time() < deadline:
            time.sleep(0.01)
        assert len(srv.connections) == 4
        for c in clients[:2]:           # peers leaving as it closes
            c.close()
        srv.close()
        io.run(srv._server.wait_closed(), timeout=10)
        assert not srv._server.is_serving()
        deadline = time.time() + 10
        while srv.connections and time.time() < deadline:
            time.sleep(0.01)
        assert not srv.connections
    finally:
        for c in clients:
            c.close()
        io.stop()
