"""User-facing metrics API: Counter / Gauge / Histogram.

Reference analogue: python/ray/util/metrics.py flowing into the C++
stats pipeline (SURVEY.md §5.5). Here metrics aggregate in a named
metrics-hub actor and export in Prometheus text format
(``ray_tpu_torch.util.metrics.prometheus_text()``), which the dashboard
scrapes.

Recording is PRE-AGGREGATED process-locally (reference: the per-core-
worker OpenCensus view aggregation before export): each data point
folds into a local table under a plain lock, and a background flusher
ships ONE ``record_batch`` actor call per interval
(``RTT_METRICS_FLUSH_S``, default 1 s). A hot loop incrementing a
Counter therefore costs a dict update, not a dispatch-plane message
per point. ``RTT_METRICS_SYNC=1`` restores the old one-call-per-point
behavior (tests that assert immediately after recording).

The port's copy of the JAX package's ``ray_tpu/util/metrics.py``
(imports renamed to ``ray_tpu_torch``, env vars ``RTPU_*`` to
``RTT_*``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import ray_tpu_torch

_HUB_NAME = "METRICS_HUB"
_local_lock = threading.Lock()

# process-local pre-aggregation buffer: (name, sorted-tags) -> entry
_pending: Dict[Tuple[str, tuple], dict] = {}
_pending_lock = threading.Lock()
_flusher_started = False


def _sync_mode() -> bool:
    return os.environ.get("RTT_METRICS_SYNC") == "1"


def _flush_interval() -> float:
    return float(os.environ.get("RTT_METRICS_FLUSH_S", 1.0))


class _MetricsHub:
    """Cluster-wide aggregation point (one named actor)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, tuple], dict] = {}
        self._lock = threading.Lock()

    def record(self, name: str, kind: str, value: float,
               tags: Optional[Dict[str, str]], description: str,
               boundaries: Optional[List[float]] = None):
        key = (name, tuple(sorted((tags or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = {"name": name, "kind": kind, "tags": tags or {},
                     "description": description, "value": 0.0,
                     "count": 0, "sum": 0.0,
                     "boundaries": boundaries or [],
                     "buckets": [0] * (len(boundaries or []) + 1)}
                self._metrics[key] = m
            if kind == "counter":
                m["value"] += value
            elif kind == "gauge":
                m["value"] = value
            else:  # histogram
                m["count"] += 1
                m["sum"] += value
                for i, b in enumerate(m["boundaries"]):
                    if value <= b:
                        m["buckets"][i] += 1
                        break
                else:
                    m["buckets"][-1] += 1

    def record_batch(self, entries: List[dict]):
        """Apply pre-aggregated per-process entries in one call: a
        counter entry carries the summed delta, a gauge the last
        value, a histogram its locally-bucketed counts + sum."""
        for e in entries:
            key = (e["name"], tuple(sorted((e.get("tags")
                                            or {}).items())))
            boundaries = e.get("boundaries") or []
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = {"name": e["name"], "kind": e["kind"],
                         "tags": e.get("tags") or {},
                         "description": e.get("description", ""),
                         "value": 0.0, "count": 0, "sum": 0.0,
                         "boundaries": boundaries,
                         "buckets": [0] * (len(boundaries) + 1)}
                    self._metrics[key] = m
                kind = e["kind"]
                if kind == "counter":
                    m["value"] += e.get("value", 0.0)
                elif kind == "gauge":
                    m["value"] = e.get("value", 0.0)
                else:  # histogram: merge bucketed counts
                    m["count"] += e.get("count", 0)
                    m["sum"] += e.get("sum", 0.0)
                    for i, c in enumerate(e.get("buckets") or []):
                        if i < len(m["buckets"]):
                            m["buckets"][i] += c

    def dump(self) -> List[dict]:
        with self._lock:
            return [dict(m) for m in self._metrics.values()]


def _hub():
    try:
        return ray_tpu_torch.get_actor(_HUB_NAME)
    except Exception:
        pass
    with _local_lock:
        try:
            return ray_tpu_torch.get_actor(_HUB_NAME)
        except Exception:
            cls = ray_tpu_torch.remote(name=_HUB_NAME, lifetime="detached",
                                 max_concurrency=8)(_MetricsHub)
            try:
                return cls.remote()
            except Exception:
                return ray_tpu_torch.get_actor(_HUB_NAME)


class _Metric:
    KIND = ""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._boundaries: Optional[List[float]] = None

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _record(self, value: float, tags: Optional[Dict[str, str]]):
        merged = {**self._default_tags, **(tags or {})}
        if _sync_mode():
            # escape hatch: one fire-and-forget per point (tests)
            _hub().record.remote(self._name, self.KIND, float(value),
                                 merged, self._description,
                                 self._boundaries)
            return
        # pre-aggregate locally; the flusher ships one batch per tick
        key = (self._name, tuple(sorted(merged.items())))
        value = float(value)
        with _pending_lock:
            e = _pending.get(key)
            if e is None:
                e = {"name": self._name, "kind": self.KIND,
                     "tags": merged, "description": self._description,
                     "boundaries": self._boundaries,
                     "value": 0.0, "count": 0, "sum": 0.0,
                     "buckets": [0] * (len(self._boundaries or []) + 1)}
                _pending[key] = e
            if self.KIND == "counter":
                e["value"] += value
            elif self.KIND == "gauge":
                e["value"] = value
            else:  # histogram: bucket locally
                e["count"] += 1
                e["sum"] += value
                for i, b in enumerate(self._boundaries or []):
                    if value <= b:
                        e["buckets"][i] += 1
                        break
                else:
                    e["buckets"][-1] += 1
        _ensure_flusher()


class Counter(_Metric):
    KIND = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        self._record(value, tags)


class Gauge(_Metric):
    KIND = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._record(value, tags)


class Histogram(_Metric):
    KIND = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Optional[Tuple[str, ...]] = None):
        super().__init__(name, description, tag_keys)
        self._boundaries = sorted(boundaries or [1.0])

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        self._record(value, tags)


def _drain_pending() -> List[dict]:
    with _pending_lock:
        entries = list(_pending.values())
        _pending.clear()
    return entries


def flush_metrics(sync: bool = True):
    """Ship the process-local aggregation buffer to the hub now. With
    ``sync`` the call is awaited so a dump immediately after sees the
    data; the background flusher uses fire-and-forget."""
    entries = _drain_pending()
    if not entries:
        return
    try:
        ref = _hub().record_batch.remote(entries)
        if sync:
            ray_tpu_torch.get(ref, timeout=30.0)
    except Exception:
        # hub unreachable (e.g. shutdown racing the flusher): requeue
        # nothing — metrics are lossy telemetry, not a ledger
        pass


def _ensure_flusher():
    global _flusher_started
    if _flusher_started:
        return
    with _local_lock:
        if _flusher_started:
            return
        _flusher_started = True

    def loop():
        while True:
            time.sleep(_flush_interval())
            try:
                flush_metrics(sync=False)
            except Exception:
                pass

    threading.Thread(target=loop, daemon=True,
                     name="rtt-metrics-flush").start()


def dump_metrics() -> List[dict]:
    flush_metrics(sync=True)
    return ray_tpu_torch.get(_hub().dump.remote(), timeout=30.0)


def _escape_label(v: str) -> str:
    """Prometheus exposition format requires \\\\, \\\" and newline
    escapes in label values."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def prometheus_text() -> str:
    """Prometheus exposition format of every recorded metric."""
    lines = []
    for m in dump_metrics():
        tag_str = ",".join(f'{k}="{_escape_label(v)}"'
                           for k, v in sorted(m["tags"].items()))
        tag_part = f"{{{tag_str}}}" if tag_str else ""
        if m["kind"] in ("counter", "gauge"):
            lines.append(f"# TYPE {m['name']} {m['kind']}")
            lines.append(f"{m['name']}{tag_part} {m['value']}")
        else:
            lines.append(f"# TYPE {m['name']} histogram")
            acc = 0
            for b, c in zip(m["boundaries"], m["buckets"]):
                acc += c
                sep = "," if tag_str else ""
                lines.append(
                    f'{m["name"]}_bucket{{{tag_str}{sep}le="{b}"}} {acc}')
            sep = "," if tag_str else ""
            lines.append(
                f'{m["name"]}_bucket{{{tag_str}{sep}le="+Inf"}} '
                f'{m["count"]}')
            lines.append(f"{m['name']}_sum{tag_part} {m['sum']}")
            lines.append(f"{m['name']}_count{tag_part} {m['count']}")
    return "\n".join(lines) + "\n"
