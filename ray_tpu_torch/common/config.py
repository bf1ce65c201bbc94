"""System config registry, env-var overridable.

Copied from the JAX package's ``ray_tpu/common/config.py``. Equivalent in
role to the reference's RAY_CONFIG system (reference:
src/ray/common/ray_config_def.h — 184 entries, each overridable by
``RAY_<name>`` env var or ``ray.init(_system_config=...)``). Here every
entry is declared once with a type and default, overridable by an
``RTT_<NAME>`` env var or ``ray_tpu_torch.init(_system_config={...})``;
the head process snapshots the resolved config and distributes it to
every worker via the control-plane handshake so all processes agree.

The port's runtime reads these environment variables, all with the one
prefix ``RTT_`` (the JAX package's ``RTPU_*`` names are never read):

  - every field below as ``RTT_<FIELD>`` (``RTT_GPUS_PER_HOST``,
    ``RTT_OBJECT_STORE_MEMORY_BYTES``, ...), and the whole config as JSON in
    ``RTT_SYSTEM_CONFIG`` (head → GCS, raylet);
  - process plumbing, set by the raylet for each worker:
    ``RTT_NODE_ID``, ``RTT_RAYLET_ADDRESS``, ``RTT_GCS_ADDRESS``,
    ``RTT_STORE_PATH``, ``RTT_WORKER_ID``, ``RTT_SESSION_DIR``, and by
    the node for its GCS and raylet: ``RTT_GCS_PORT``,
    ``RTT_GCS_STORE_DIR``, ``RTT_RESOURCES``, ``RTT_LABELS``,
    ``RTT_OBJECT_STORE_BYTES``, ``RTT_IS_HEAD``, ``RTT_NODE_IP``;
  - the driver: ``RTT_ADDRESS`` (cluster to join), ``RTT_STORAGE``;
  - the GPU count a raylet schedules: ``RTT_NUM_GPUS`` (after
    ``gpus_per_host``, before ``CUDA_VISIBLE_DEVICES`` and
    ``/dev/nvidia*``; ``raylet.detect_gpus``). ``CUDA_VISIBLE_DEVICES``
    is read and set, never renamed: an inherited list names the devices
    the raylet's indices stand for, and each worker gets its grant in it;
  - transports: ``RTT_NETX``, ``RTT_NET_FORCE_TCP``, ``RTT_NET_IDLE_S``,
    ``RTT_NET_KEEPALIVE_S``, ``RTT_NET_POOL_MAX``,
    ``RTT_NET_RECONNECT_S``, ``RTT_NET_STALL_S``, ``RTT_VALIDATE_WIRE``;
  - observability and faults: ``RTT_LOG_LEVEL``, ``RTT_LOOP_STALL_S``,
    ``RTT_CPROFILE_DIR``, ``RTT_CPROFILE_PROCS``, ``RTT_CHAOS``,
    ``RTT_CHAOS_LOG``, ``RTT_TRACING``, ``RTT_TRACE_SAMPLE``,
    ``RTT_TRACE_SLOW_S``, ``RTT_TRACE_BUFFER``, ``RTT_TRACE_FLUSH_S``,
    ``RTT_TRACE_MAX_SPANS``, ``RTT_TRACE_TABLE_MAX``,
    ``RTT_TASK_EVENTS_BUFFER``, ``RTT_TASK_EVENTS_FLUSH_S``,
    ``RTT_TASK_TABLE_MAX``, ``RTT_ACTOR_TASK_EVENTS``,
    ``RTT_USAGE_STATS_ENABLED``;
  - runtime envs: ``RTT_CONTAINER_RUNTIME``;
  - libraries: ``RTT_DATA_STREAMING`` ("0": the data plane's bulk path
    in place of the streaming executor) and ``RTT_RESULTS_DIR`` (the
    train runs' checkpoint roots when ``RunConfig.storage_path`` is
    unset).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict


def _env(name: str, typ, default):
    raw = os.environ.get(f"RTT_{name.upper()}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes")
    return typ(raw)


@dataclass
class SystemConfig:
    # ---- object store ----
    object_store_memory_bytes: int = 2 * 1024**3
    # objects smaller than this are inlined in the in-process memory store and
    # carried through the control plane rather than the shm store (analogue of
    # the reference's max_direct_call_object_size, ray_config_def.h)
    max_inline_object_size: int = 100 * 1024
    object_spilling_threshold: float = 0.8
    object_store_fallback_dir: str = ""
    # JSON spec for the spill backend (reference: object_spilling_config
    # in ray_config_def.h + _private/external_storage.py): e.g.
    # {"type": "smart_open", "params": {"uri_prefix": "s3://bkt/spill"}}
    object_spilling_config: str = ""
    # cap on in-flight inbound pull bytes as a fraction of store
    # capacity (reference: pull_manager.cc admission under pressure)
    pull_admission_fraction: float = 0.5
    # ---- scheduler ----
    scheduler_spread_threshold: float = 0.5
    worker_lease_timeout_s: float = 30.0
    max_pending_lease_requests_per_key: int = 10
    # ---- workers ----
    num_workers_soft_limit: int = -1  # -1: num_cpus
    idle_worker_kill_s: float = 300.0
    worker_start_timeout_s: float = 60.0
    # how long an executing task waits for an ObjectRef argument before
    # erroring (a freed/lost arg must not wedge the executor forever)
    arg_fetch_timeout_s: float = 300.0
    # max concurrent outbound object-pull streams a node serves for
    # LARGE objects; the surplus gets "busy" and retries against the
    # growing source set (tree broadcast — see raylet.handle_pull_object)
    object_serve_concurrency: int = 3
    object_serve_tree_min_bytes: int = 256 * 1024 * 1024
    prestart_workers: bool = True
    # ---- memory monitor / OOM protection (reference:
    # src/ray/common/memory_monitor.h + raylet/worker_killing_policy.h) ----
    memory_monitor_enabled: bool = True
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 500
    # ---- fault tolerance ----
    task_max_retries_default: int = 3
    actor_max_restarts_default: int = 0
    lineage_max_bytes: int = 1024**3
    health_check_period_s: float = 1.0
    # Death window. The reference's GCS declares death only after a
    # FAILURE STREAK of active probes (health_check_period 3s x
    # failure_threshold 5 on top of a 10s probe timeout — i.e. tens of
    # seconds), precisely so load spikes don't read as deaths. 10s here
    # killed 50 healthy-but-starved raylets during the 1 GiB broadcast
    # on the single-core CI box.
    health_check_timeout_s: float = 30.0
    # a raylet whose liveness thread beats but whose event loop reports
    # lag beyond this is treated as dead (wedged loop = dead node; busy
    # loop = alive). See raylet._start_liveness_thread.
    loop_stall_death_s: float = 60.0
    # default preemption grace window (TPU spot semantics: notice →
    # drain → host reclaim); a notice may carry its own grace_s
    preemption_grace_s: float = 10.0
    # how long a revoked lease waits for the owner's drain ack
    # (release_lease with inflight=0) before being force-reclaimed
    lease_revoke_ack_timeout_s: float = 5.0
    # ---- control plane ----
    gcs_port: int = 0  # 0 = auto
    rpc_connect_timeout_s: float = 10.0
    pubsub_poll_timeout_s: float = 30.0
    # ---- GPUs ----
    # GPUs this raylet schedules by index; -1: detect (raylet.detect_gpus)
    gpus_per_host: int = -1
    # ---- metrics/events ----
    metrics_report_period_s: float = 5.0
    event_log_enabled: bool = True

    def apply_env_overrides(self):
        for f in fields(self):
            cur = getattr(self, f.name)
            setattr(self, f.name, _env(f.name, type(cur), cur))
        return self

    def update(self, overrides: Dict[str, Any]):
        for k, v in (overrides or {}).items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown system config key: {k}")
            setattr(self, k, v)
        return self

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_json(cls, s: str) -> "SystemConfig":
        cfg = cls()
        cfg.update(json.loads(s))
        return cfg


_global_config: SystemConfig | None = None


def global_config() -> SystemConfig:
    global _global_config
    if _global_config is None:
        _global_config = SystemConfig().apply_env_overrides()
    return _global_config


def set_global_config(cfg: SystemConfig):
    global _global_config
    _global_config = cfg
