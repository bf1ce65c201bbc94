"""The authoritative ``RTT_*`` configuration registry of the port.

Every environment variable the port reads is declared here — rtpulint
RTPU005 fails on any ``RTT_*`` read missing from this table (with
near-miss typo detection), and the round-trip test fails on any entry
that neither ``ray_tpu_torch/``, its tests (``tests/test_torch_*.py``)
nor ``chip_smoke.py`` mentions, so the registry can't drift in either
direction. ``python -m ray_tpu_torch.analysis --gen-docs`` renders it
into docs/torch/CONFIGURATION.md.

Two sources compose :data:`CONFIG_VARS`:

* :data:`STATIC_VARS` — variables read by name somewhere in
  ``ray_tpu_torch/`` (or by the test harness, subsystem ``testing``).
* the ``SystemConfig`` dataclass (``ray_tpu_torch/common/config.py``),
  whose every field is overridable as ``RTT_<FIELD_UPPER>`` via
  ``apply_env_overrides()`` — those names are derived programmatically
  so a new config field is registered the moment it's declared.

Entry shape: ``{"subsystem": str, "default": str, "description": str}``.

The port's copy of ``ray_tpu/analysis/config_registry.py``: the JAX
package's entries under their ``RTT_*`` names, less the knobs the port
never reads (``RTPU_NUM_TPUS``, the native-RPC and scheduler switches,
the data plane's and the checkpointer's env knobs, which are arguments
there, the attention's ``RTPU_ATTN_*`` fallbacks, the game day's and
workflows' knobs, and the JAX test harness's), plus ``RTT_NUM_GPUS``
and ``RTT_CHIP_SMOKE_RUN``.
"""

from __future__ import annotations

from dataclasses import fields as _dc_fields
from typing import Dict

__all__ = ["CONFIG_VARS", "STATIC_VARS", "system_config_vars"]


def _e(subsystem: str, default: str, description: str) -> Dict[str, str]:
    return {"subsystem": subsystem, "default": default,
            "description": description}


STATIC_VARS: Dict[str, Dict[str, str]] = {
    # ---------------------------------------------------- bootstrap/core
    "RTT_ADDRESS": _e(
        "core", "(unset)",
        "GCS address to connect to (`ray_tpu_torch.init()` default, the "
        "CLI, job submission and the autoscaler all honor it)."),
    "RTT_SESSION_DIR": _e(
        "core", "(per-session tmpdir)",
        "Per-session scratch directory: sockets, logs, object-store "
        "files, profiles."),
    "RTT_GCS_ADDRESS": _e(
        "core", "(set by node launcher)",
        "GCS endpoint handed to spawned raylets/workers."),
    "RTT_GCS_PORT": _e(
        "core", "0 (auto)",
        "Listen port for a standalone GCS process (`gcs_main`)."),
    "RTT_GCS_STORE_DIR": _e(
        "core", "(unset = in-memory)",
        "Directory for the GCS persistent store (journal survives a "
        "GCS restart)."),
    "RTT_RAYLET_ADDRESS": _e(
        "core", "(set by raylet)",
        "Raylet RPC address injected into spawned workers."),
    "RTT_STORE_PATH": _e(
        "core", "(set by raylet)",
        "Plasma object-store socket path injected into workers."),
    "RTT_NODE_ID": _e(
        "core", "(generated)",
        "Node id of the hosting raylet (workers, tracing and the GPU "
        "profiler tag records with it)."),
    "RTT_WORKER_ID": _e(
        "core", "(generated)",
        "Worker id assigned by the spawning raylet."),
    "RTT_IS_HEAD": _e(
        "core", "(set by launcher)",
        "Marks the raylet as the head node (hosts GCS-adjacent "
        "services; chaos `head` filters key off it)."),
    "RTT_LABELS": _e(
        "core", "{}",
        "JSON dict of node labels for label-aware scheduling."),
    "RTT_RESOURCES": _e(
        "core", "{}",
        "JSON dict of custom resources the raylet registers."),
    "RTT_NUM_GPUS": _e(
        "core", "(autodetect)",
        "GPUs a raylet schedules by index when `gpus_per_host` is "
        "unset: before an inherited `CUDA_VISIBLE_DEVICES` and the "
        "`/dev/nvidia*` files (`raylet.detect_gpus`)."),
    "RTT_OBJECT_STORE_BYTES": _e(
        "core", "(SystemConfig default)",
        "Object-store capacity for a launched raylet."),
    "RTT_SYSTEM_CONFIG": _e(
        "core", "(unset)",
        "JSON `SystemConfig` overrides distributed cluster-wide from "
        "the head (see the SystemConfig table below for per-field "
        "`RTT_*` overrides)."),
    "RTT_LOG_LEVEL": _e(
        "core", "INFO (WARNING in workers)",
        "Python logging level for GCS/raylet/worker processes."),
    "RTT_JOB_ID": _e(
        "core", "(generated)",
        "Job id tag propagated to tasks submitted through the job "
        "API."),
    # --------------------------------------------------------- wire/rpc
    "RTT_LOOP_STALL_S": _e(
        "rpc", "0 (off)",
        "Event-loop stall detector threshold in seconds: a loop "
        "blocked longer logs a stall with the offending stack."),
    "RTT_VALIDATE_WIRE": _e(
        "rpc", "0",
        "Validate every inbound RPC payload against the schema table "
        "(tests enable it so schema drift fails immediately)."),
    # ------------------------------------------------------------- netx
    "RTT_NETX": _e(
        "netx", "1",
        "Enable the cross-node transport plane (schema 1.8): TCP "
        "endpoint advertisement, direct-lane actor/task calls off-box, "
        "and chunk-pipelined object pulls; 0 keeps everything on the "
        "unix/asyncio paths."),
    "RTT_NODE_IP": _e(
        "netx", "(resolved hostname)",
        "IP this node advertises for its TCP endpoints (raylet, direct "
        "lane, dag channels). Falls back to the resolved non-loopback "
        "hostname, then 127.0.0.1."),
    "RTT_NET_FORCE_TCP": _e(
        "netx", "0",
        "Prefer host:port endpoints even for same-host peers (the "
        "multi-\"host\" test harness uses it to exercise the TCP lanes "
        "on one machine)."),
    "RTT_NET_KEEPALIVE_S": _e(
        "netx", "10",
        "Quiet-connection ping interval for the netx pool; a peer "
        "missing ~3 windows is declared dead and redialed with "
        "backoff."),
    "RTT_NET_IDLE_S": _e(
        "netx", "60",
        "Idle cross-node connections are reaped from the netx pool "
        "after this many seconds."),
    "RTT_NET_RECONNECT_S": _e(
        "netx", "0.2",
        "Initial redial backoff after a netx connection failure; "
        "doubles per failure up to a 5 s cap."),
    "RTT_NET_POOL_MAX": _e(
        "netx", "16",
        "Soft cap on pooled netx connections per process; LRU-idle "
        "peers are evicted beyond it."),
    "RTT_NET_STALL_S": _e(
        "netx", "10",
        "A chunked object pull making no progress for this long is "
        "cancelled and resumed from its contiguous high-water mark "
        "(fresh connection, remaining attempts)."),
    # ------------------------------------------------------- observability
    "RTT_CPROFILE_DIR": _e(
        "observability", "(unset = off)",
        "Write per-process cProfile dumps here on exit."),
    "RTT_CPROFILE_PROCS": _e(
        "observability", "worker/raylet",
        "Comma list of roles to profile when RTT_CPROFILE_DIR is "
        "set."),
    "RTT_TASK_EVENTS_BUFFER": _e(
        "observability", "4096",
        "Per-worker task-event ring capacity before drops (drop "
        "counters ride the flush)."),
    "RTT_TASK_EVENTS_FLUSH_S": _e(
        "observability", "1.0",
        "Task-event batch flush interval to the GCS state engine."),
    "RTT_TASK_TABLE_MAX": _e(
        "observability", "10000",
        "Bounded GCS task-table size (oldest finished evicted "
        "first)."),
    "RTT_ACTOR_TASK_EVENTS": _e(
        "observability", "0",
        "Extend the task-event pipeline to actor method calls so "
        "serve request flow reconciles per request (game days enable "
        "it)."),
    "RTT_TRACING": _e(
        "observability", "1",
        "Master switch for distributed tracing spans."),
    "RTT_TRACE_SAMPLE": _e(
        "observability", "0.1",
        "Head-sampling probability for traces (slow/failed requests "
        "are always kept)."),
    "RTT_TRACE_SLOW_S": _e(
        "observability", "1.0",
        "Latency threshold above which a trace is always kept "
        "regardless of sampling."),
    "RTT_TRACE_BUFFER": _e(
        "observability", "2048",
        "Per-process span ring capacity before drops."),
    "RTT_TRACE_FLUSH_S": _e(
        "observability", "1.0",
        "Span batch flush interval to the GCS trace table."),
    "RTT_TRACE_TABLE_MAX": _e(
        "observability", "50000",
        "Bounded GCS trace-table span capacity."),
    "RTT_TRACE_MAX_SPANS": _e(
        "observability", "512",
        "Per-trace span cap in the GCS trace table."),
    "RTT_METRICS_SYNC": _e(
        "observability", "0",
        "1 = ship every metric point as its own actor call instead of "
        "the batched background flusher (tests that assert "
        "immediately)."),
    "RTT_METRICS_FLUSH_S": _e(
        "observability", "1.0",
        "Metrics local-table flush interval (one record_batch call "
        "per interval)."),
    "RTT_USAGE_STATS_ENABLED": _e(
        "observability", "0",
        "Opt-in anonymous usage stats."),
    # ------------------------------------------------------------- chaos
    "RTT_CHAOS": _e(
        "chaos", "(unset = off)",
        "Chaos engine config: a bare integer seed or a JSON object "
        "with `seed`/`schedule`/`p`/`delay_s` (docs/"
        "FAULT_TOLERANCE.md); inherited by every spawned process."),
    "RTT_CHAOS_LOG": _e(
        "chaos", "(unset)",
        "JSONL path where every fired fault is appended (replay "
        "comparisons project the `ts` field away)."),
    # ------------------------------------------------------------- serve
    "RTT_SERVE_ROUTING": _e(
        "serve", "p2c",
        "Router policy: `p2c` load-aware power-of-two-choices or "
        "`local` in-flight only."),
    "RTT_SERVE_LOAD_STALENESS_S": _e(
        "serve", "5.0",
        "Max age of replica load reports before the router falls back "
        "to local in-flight counts."),
    "RTT_SERVE_OVERLOAD_RETRIES": _e(
        "serve", "2",
        "How many other replicas the proxy tries after a shed "
        "(ReplicaOverloadedError) before returning 503."),
    "RTT_SERVE_MAX_QUEUED": _e(
        "serve", "(per-deployment)",
        "Default bounded ingress queue per replica on top of "
        "max_concurrent_queries; overflow sheds retriably."),
    "RTT_SERVE_REQUEST_LOG_MAX": _e(
        "serve", "10000",
        "Per-replica request-ledger capacity (game-day reconcile reads "
        "it)."),
    "RTT_SERVE_ADAPTIVE_BATCH": _e(
        "serve", "1",
        "AIMD adaptive micro-batch wait window (0 = fixed "
        "batch_wait_timeout_s)."),
    "RTT_SERVE_BATCH_SUBMIT_TIMEOUT_S": _e(
        "serve", "30.0",
        "Watchdog for a wedged batch function: pending items error "
        "instead of waiting forever."),
    "RTT_SERVE_GRACEFUL_SHUTDOWN_S": _e(
        "serve", "10.0",
        "Drain window for replicas on shutdown/rolling update before "
        "force-kill."),
    "RTT_SERVE_HEALTH_FAILURES": _e(
        "serve", "3",
        "Consecutive health-check failures before the controller "
        "replaces a replica."),
    "RTT_SERVE_HEALTH_TIMEOUT_S": _e(
        "serve", "5.0",
        "Per-probe health-check timeout."),
    "RTT_SERVE_MAX_SURGE": _e(
        "serve", "1",
        "Extra replicas a rolling update may run beyond target while "
        "a wave's new replicas come up (k8s maxSurge analogue)."),
    "RTT_SERVE_PROXY_ASSIGN_TIMEOUT_S": _e(
        "serve", "15.0",
        "Proxy-side cap on waiting for a replica assignment before "
        "504."),
    # -------------------------------------------------------------- data
    "RTT_DATA_STREAMING": _e(
        "data", "1",
        "Streaming data-plane executor (0 = bulk materialization "
        "fallback)."),
    # ----------------------------------------------------- train/tune/ckpt
    "RTT_RESULTS_DIR": _e(
        "train", "~/ray_tpu_torch_results",
        "Root directory for trainer/tuner run results and "
        "checkpoints."),
    "RTT_TUNE_DISK_CKPT": _e(
        "tune", "1",
        "Persist trial checkpoints to disk (0 = in-memory only)."),
    "RTT_TUNE_SNAPSHOT_PERIOD": _e(
        "tune", "10",
        "Experiment-state snapshot period in seconds."),
    # ------------------------------------------------------------ storage
    "RTT_STORAGE": _e(
        "storage", "(unset)",
        "Default cluster storage URI "
        "(`ray_tpu_torch.init(storage=...)` fallback; raylets mount it "
        "for spill)."),
    # ----------------------------------------------------------- runtime_env
    "RTT_CONTAINER_RUNTIME": _e(
        "runtime_env", "(autodetect)",
        "Container runtime binary for containerized runtime_envs "
        "(podman/docker)."),
    # ------------------------------------------------------------- testing
    "RTT_CHIP_SMOKE_RUN": _e(
        "testing", "(set by chip_smoke.py)",
        "This run's mark, inherited by every process `chip_smoke.py` "
        "starts; at its end the script stops any process that still "
        "carries it."),
}


def system_config_vars() -> Dict[str, Dict[str, str]]:
    """``RTT_<FIELD>`` overrides derived from the SystemConfig
    dataclass — every field is env-overridable via
    ``apply_env_overrides()``."""
    from ray_tpu_torch.common.config import SystemConfig
    out: Dict[str, Dict[str, str]] = {}
    for f in _dc_fields(SystemConfig):
        name = f"RTT_{f.name.upper()}"
        out[name] = _e("system-config", repr(f.default),
                       f"Overrides `SystemConfig.{f.name}` "
                       f"(ray_tpu_torch/common/config.py) "
                       f"cluster-wide.")
    return out


def _build() -> Dict[str, Dict[str, str]]:
    out = system_config_vars()
    out.update(STATIC_VARS)  # hand-written entries win on collision
    return out


CONFIG_VARS: Dict[str, Dict[str, str]] = _build()
