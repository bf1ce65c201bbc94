"""Chrome-trace timeline events.

Reference analogue: the profile-event pipeline behind `ray timeline`
(core_worker/profiling.cc → StatsGcsService.AddProfileData →
_private/state.py:414 chrome_tracing_dump). Here each worker buffers
task begin/end events locally and pushes them to the GCS KV; the driver
merges all per-process buffers into one chrome://tracing JSON.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List

_events: List[Dict[str, Any]] = []
_lock = threading.Lock()
_MAX_EVENTS = 10_000  # ring-buffer cap: bounds memory + kv payload
_total_recorded = 0  # monotonic: dirty-check survives ring trimming
_dropped = 0  # monotonic: events the ring trimmed (surfaced in dumps)
_flusher_started = False
_flusher_stop = None


def _ensure_flusher():
    """Background flusher so events recorded just before a worker goes
    idle still reach the GCS (flush-on-record alone would strand them
    inside the min_interval window)."""
    global _flusher_started, _flusher_stop
    if _flusher_started:
        return
    _flusher_started = True
    stop = _flusher_stop = threading.Event()

    def loop():
        while not stop.wait(1.0):
            try:
                flush()
            except Exception:
                pass

    threading.Thread(target=loop, daemon=True,
                     name="rtpu-timeline-flush").start()


def stop_flusher():
    """Worker shutdown hook: end the flusher thread and reset the
    started flag so a reconnect in the same process starts a fresh one
    (the unreset flag leaked one daemon thread per init/shutdown
    cycle)."""
    global _flusher_started, _flusher_stop
    if _flusher_stop is not None:
        _flusher_stop.set()
    _flusher_stop = None
    _flusher_started = False


def dropped_count() -> int:
    with _lock:
        return _dropped


def record(name, ph, ts, pid=0, tid=0, **kw):
    global _total_recorded, _dropped
    with _lock:
        _events.append({"name": name, "ph": ph, "ts": ts, "pid": pid,
                        "tid": tid, **kw})
        _total_recorded += 1
        if len(_events) > _MAX_EVENTS:
            _dropped += len(_events) - _MAX_EVENTS
            del _events[:len(_events) - _MAX_EVENTS]


def record_task(name: str, t0: float, t1: float, pid: int = 0,
                failed: bool = False, trace_ctx: Dict[str, Any] = None):
    """Complete ('X') event per task execution; flushed opportunistically
    to the GCS so the driver can merge cross-process. ``trace_ctx``
    carries the propagated span identifiers (reference:
    tracing_helper.py _DictPropagator riding the TaskSpec) so the merged
    timeline reconstructs the driver→task→child call tree."""
    with _lock:
        _events.append({
            "name": name, "ph": "X", "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6, "pid": pid,
            "tid": threading.get_ident() % 1_000_000,
            "cname": "terrible" if failed else None,
            "cat": "task",
            "args": dict(trace_ctx or {}),
        })
        global _total_recorded, _dropped
        _total_recorded += 1
        if len(_events) > _MAX_EVENTS:
            _dropped += len(_events) - _MAX_EVENTS
            del _events[:len(_events) - _MAX_EVENTS]
    # async: the background flusher pushes to GCS so the task-completion
    # path never blocks on a kv_put
    _ensure_flusher()


def collect() -> List[Dict[str, Any]]:
    with _lock:
        return list(_events)


_last_pushed_total = 0


def flush():
    """Push this process's buffer to GCS KV under a per-pid key (no-op
    when nothing new was recorded since the previous push). Dirty check
    uses the monotonic recorded-event counter — the buffer *length*
    plateaus at the ring cap, which would make a length-based check a
    permanent no-op once 10k events accumulate.

    The cursor only advances AFTER the kv_put succeeds: advancing it
    first turned any failed push (GCS restart window, timeout) into
    silently dropping every event recorded since the last successful
    flush — the next flush would see a clean dirty-check and never
    retry them."""
    global _last_pushed_total
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod._global_worker
    if w is None or not w.connected:
        return
    with _lock:
        if _total_recorded == _last_pushed_total:
            return
        events = list(_events)
        if _dropped:
            # ring-trim loss travels WITH the buffer: the merged dump
            # can report "history missing" instead of silently looking
            # complete (metadata event, invisible to the track renderer)
            events.append(_dropped_meta(_dropped))
        snapshot = _total_recorded
    try:
        w.call_sync(w.gcs, "kv_put", {
            "key": f"@timeline/{w.node_id[:8]}-{os.getpid()}",
            "value": json.dumps(events).encode(),
            "overwrite": True}, timeout=5)
    except Exception:
        return  # cursor untouched; the next flush retries these events
    with _lock:
        # concurrent flushes may complete out of order; never regress
        _last_pushed_total = max(_last_pushed_total, snapshot)


def _dropped_meta(n: int) -> Dict[str, Any]:
    return {"name": "rtpu_timeline_dropped", "ph": "M", "ts": 0,
            "pid": os.getpid(), "tid": 0, "args": {"dropped": n}}


def dump_dropped_total(events: List[Dict[str, Any]]) -> int:
    """Sum of ring-trim losses across every process's buffer in a
    merged dump (the dashboard surfaces this next to the timeline)."""
    return sum(int((e.get("args") or {}).get("dropped") or 0)
               for e in events
               if e.get("name") == "rtpu_timeline_dropped")


def timeline_dump() -> List[Dict[str, Any]]:
    """Merge every process's events into one chrome-trace list
    (driver-side; reference: `ray timeline`)."""
    from ray_tpu_torch._private import worker as worker_mod
    flush()
    w = worker_mod._global_worker
    merged: List[Dict[str, Any]] = []
    if w is not None and w.connected:
        try:
            keys = w.call_sync(w.gcs, "kv_keys",
                               {"prefix": "@timeline/"},
                               timeout=10).get("keys", [])
            for k in keys:
                v = w.call_sync(w.gcs, "kv_get", {"key": k},
                                timeout=10).get("value")
                if v:
                    merged.extend(json.loads(v))
        except Exception:
            pass
    if not merged:
        merged = collect()
        with _lock:
            if _dropped:
                merged.append(_dropped_meta(_dropped))
    return [{k: v for k, v in e.items() if v is not None}
            for e in merged]
