"""End-to-end distributed tracing: typed spans + critical-path analysis.

Reference analogue: Dapper-style request tracing
(util/tracing/tracing_helper.py propagates OpenTelemetry context through
TaskSpecs in the reference; the dashboard's timeline only ever renders
flat events). Here the ``trace_ctx`` that already rides every task spec
(trace_id/span_id/parent_span_id, worker.py ``_trace_ctx_for_submit``)
becomes queryable: every subsystem records *typed spans* into a bounded
per-process buffer, a background flusher ships them in batches to the
GCS (``trace_spans`` RPC → ``gcs.TraceTable``, bounded + indexed + a
visible drop counter, the PR-6 pattern), and ``get_trace`` merges them
with task-lifecycle spans synthesized from the state engine's task
records — no new instrumentation on the task hot path.

Span shape (one dict per span; only non-None fields ride the wire)::

    {"trace_id", "span_id", "parent_span_id",   # linkage
     "name",                                    # human label
     "kind",     # serve.request|serve.replica|task|dag.hop|object.pull
     "phase",    # queue|schedule|dispatch|transfer|execute|deserialize
     "start_ts", "end_ts",                      # wall-clock seconds
     "status",   # ok | error | shed
     "node_id", "pid", "attrs"}

Sampling (bounds overhead end to end):
  - head sampling: ``RTT_TRACE_SAMPLE`` in [0,1] (default 0.1, the
    Dapper stance: production tracing is sampled) decides per *trace
    id* with a deterministic hash, so every process agrees on whether
    a trace is recorded without coordination. Unsampled serve requests
    skip span recording AND context propagation — their only cost is
    two clock reads on the root span. Task-lifecycle spans are NOT
    subject to this rate: they are synthesized from the state engine's
    task events, so ``get_trace`` always explains a task.
  - tail keep: spans that FAILED or ran longer than
    ``RTT_TRACE_SLOW_S`` (default 1.0 s) are always recorded, even
    when head-sampled out — the slow/broken tail is exactly what the
    critical-path analyzer exists for;
  - ``RTT_TRACING=0`` disables recording entirely (the overhead gate
    in ``_BENCH_TRACE`` compares default sampling against this).

The critical-path analyzer (``critical_path``) attributes a root span's
wall time to named phases with a deepest-active-span sweep: at every
instant of the root's interval the deepest span covering it wins, so
overlapping parent/child spans never double-count and uncovered gaps
fall to the nearest enclosing span's phase. ``aggregate_critical_path``
sums the same attribution across a cohort (e.g. a game day's p99
requests).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

PHASES = ("queue", "schedule", "dispatch", "transfer", "execute",
          "deserialize", "submit", "other")

_ROOT_PARENTS = (None, "", "root")

# ------------------------------------------------------------------ config

_enabled: Optional[bool] = None
_sample_rate: Optional[float] = None
_slow_s: Optional[float] = None
_node_id: str = ""

DEFAULT_SAMPLE_RATE = 0.1


def refresh() -> None:
    """Re-read the env knobs (tests and the bench toggle them within
    one process; the hot path must not touch os.environ per span)."""
    global _enabled, _sample_rate, _slow_s, _node_id
    _enabled = os.environ.get("RTT_TRACING", "1") not in ("0", "false")
    try:
        _sample_rate = min(1.0, max(0.0, float(
            os.environ.get("RTT_TRACE_SAMPLE", DEFAULT_SAMPLE_RATE))))
    except ValueError:
        _sample_rate = DEFAULT_SAMPLE_RATE
    try:
        _slow_s = float(os.environ.get("RTT_TRACE_SLOW_S", 1.0))
    except ValueError:
        _slow_s = 1.0
    _node_id = (os.environ.get("RTT_NODE_ID") or "")[:12]


def enabled() -> bool:
    if _enabled is None:
        refresh()
    return _enabled


def sampled(trace_id: Optional[str]) -> bool:
    """Deterministic head-sampling decision for one trace id: every
    process hashes the id the same way, so a trace is either recorded
    by ALL its participants or by none (no half-traces from skewed
    coin flips)."""
    if _enabled is None:
        refresh()
    if not _enabled:
        return False
    if _sample_rate >= 1.0:
        return True
    if _sample_rate <= 0.0 or not trace_id:
        return False
    h = zlib.crc32(trace_id.encode()) & 0xFFFFFFFF
    return h / 4294967296.0 < _sample_rate


# span ids: a per-process random salt + counter instead of an
# os.urandom syscall per span (several spans per serve request ride
# the hot path; the 1-core overhead gate counts every microsecond)
_id_salt = os.urandom(5).hex()
_id_lock = threading.Lock()
_id_n = 0


def new_span_id() -> str:
    global _id_n
    with _id_lock:
        _id_n += 1
        n = _id_n
    return f"{_id_salt}{n:06x}"


def new_trace_id() -> str:
    return new_span_id()


# ------------------------------------------------------------------ buffer

def _ring_cap() -> int:
    return int(os.environ.get("RTT_TRACE_BUFFER", 8192))


def _flush_interval() -> float:
    return float(os.environ.get("RTT_TRACE_FLUSH_S", 0.5))


_lock = threading.Lock()
_buf: List[Dict[str, Any]] = []
_dropped = 0
_flusher_started = False
_flusher_stop: Optional[threading.Event] = None
_sender: Optional[Callable[[Dict[str, Any]], bool]] = None

_BATCH_MAX = 4000


def record_span(trace_id: str, span_id: str, name: str, *,
                parent_span_id: Optional[str] = None,
                kind: str = "span", phase: str = "other",
                start_ts: float, end_ts: float,
                status: str = "ok",
                attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record one finished span. O(1) lock-append, never an RPC.

    Head-sampled-out spans are still kept when they are slow or broken
    (tail keep) — a partial trace for the p99.9 straggler beats a
    complete trace for the median request."""
    if not enabled():
        return
    if not sampled(trace_id) and status == "ok" \
            and (end_ts - start_ts) < _slow_s:
        return
    span = {"trace_id": trace_id, "span_id": span_id, "name": name,
            "kind": kind, "phase": phase,
            "start_ts": start_ts, "end_ts": end_ts,
            "status": status, "pid": os.getpid()}
    if parent_span_id is not None:
        span["parent_span_id"] = parent_span_id
    if attrs:
        span["attrs"] = attrs
    if _node_id:
        span["node_id"] = _node_id
    global _dropped
    with _lock:
        _buf.append(span)
        over = len(_buf) - _ring_cap()
        if over > 0:
            del _buf[:over]
            _dropped += over
    _ensure_flusher()


class Span:
    """A live span handle: start now, ``finish()`` records it.

    ``child_ctx()`` is the propagation payload (what rides a task spec,
    a serve kwarg, or a dag frame) — the receiving side parents its own
    spans under this span."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name",
                 "kind", "phase", "start_ts", "attrs", "_done")

    def __init__(self, trace_id: str, name: str, *,
                 parent_span_id: Optional[str] = None,
                 kind: str = "span", phase: str = "other",
                 attrs: Optional[Dict[str, Any]] = None,
                 start_ts: Optional[float] = None):
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_span_id = parent_span_id
        self.name = name
        self.kind = kind
        self.phase = phase
        self.attrs = attrs
        self.start_ts = time.time() if start_ts is None else start_ts
        self._done = False

    def child_ctx(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def trace_ctx(self) -> Dict[str, str]:
        """worker.task_context-compatible ctx: submits made while this
        span is current parent under it."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id or "root"}

    def finish(self, status: str = "ok",
               end_ts: Optional[float] = None) -> None:
        if self._done:  # idempotent: error paths may double-finish
            return
        self._done = True
        record_span(self.trace_id, self.span_id, self.name,
                    parent_span_id=self.parent_span_id, kind=self.kind,
                    phase=self.phase, start_ts=self.start_ts,
                    end_ts=time.time() if end_ts is None else end_ts,
                    status=status, attrs=self.attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish("error" if exc_type is not None else "ok")


def span_if(trace_id: Optional[str], name: str, **kw) -> Optional[Span]:
    """A Span when tracing is on and the trace is worth starting, else
    None (callers guard each touch with ``if s is not None``). Unlike
    ``record_span``'s tail keep, a *head* decision must be made here —
    slow/failed spans under a sampled-out trace are still caught
    because ``Span.finish`` routes through ``record_span``."""
    if not enabled() or not trace_id:
        return None
    return Span(trace_id, name, **kw)


# ------------------------------------------------------------------ flush

def drain(max_n: int = _BATCH_MAX) -> Tuple[List[Dict[str, Any]], int]:
    global _dropped
    with _lock:
        batch = _buf[:max_n]
        del _buf[:max_n]
        dropped, _dropped = _dropped, 0
    return batch, dropped


def requeue(spans: List[Dict[str, Any]], dropped: int = 0) -> None:
    global _dropped
    if not spans and not dropped:
        return
    with _lock:
        _buf[:0] = spans
        _dropped += dropped
        over = len(_buf) - _ring_cap()
        if over > 0:
            del _buf[:over]
            _dropped += over


def pending_count() -> int:
    with _lock:
        return len(_buf)


def set_sender(fn: Optional[Callable[[Dict[str, Any]], bool]]) -> None:
    global _sender
    _sender = fn


def _default_send(payload: Dict[str, Any], timeout: float = 5.0) -> bool:
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod._global_worker
    if w is None or not w.connected:
        return False
    try:
        w.call_sync(w.gcs, "trace_spans", payload, timeout=timeout)
        return True
    except Exception:
        return False


def flush(send_timeout: float = 5.0) -> bool:
    batch, dropped = drain()
    if not batch and not dropped:
        return True
    payload = {"spans": batch, "dropped": dropped}
    ok = (_sender(payload) if _sender is not None
          else _default_send(payload, timeout=send_timeout))
    if ok:
        return True
    requeue(batch, dropped)
    return False


def flush_all(timeout: float = 2.0) -> None:
    """Best-effort full drain (process teardown), bounded by ``timeout``
    so a dead GCS cannot stall shutdown."""
    deadline = time.monotonic() + timeout
    while pending_count():
        left = deadline - time.monotonic()
        if left <= 0 or not flush(send_timeout=max(0.1, left)):
            return


def _ensure_flusher() -> None:
    global _flusher_started, _flusher_stop
    if _flusher_started:
        return
    _flusher_started = True
    stop = _flusher_stop = threading.Event()

    def loop():
        while not stop.wait(_flush_interval()):
            try:
                flush()
            except Exception:
                pass

    threading.Thread(target=loop, daemon=True,
                     name="rtpu-trace-spans").start()


def stop_flusher() -> None:
    """Worker shutdown: stop the flusher thread and allow a later
    reconnect to start a fresh one (leaving ``_flusher_started`` set
    leaks one thread per init/shutdown cycle in tests)."""
    global _flusher_started, _flusher_stop
    if _flusher_stop is not None:
        _flusher_stop.set()
    _flusher_stop = None
    _flusher_started = False


# ------------------------------------------------- task-span synthesis

def synthesize_task_spans(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Task-lifecycle phase spans from ONE state-engine task record —
    no extra instrumentation on the submit/execute hot paths; the
    task-event pipeline already carries every timestamp this needs.

    Layout (ids derive from the propagated span id, so the task span
    slots into the trace tree exactly where ``_trace_ctx_for_submit``
    said it would)::

        <span_id>            name=<fn>      phase=submit  (whole task)
          <span_id>:queue    owner submit -> raylet queue
          <span_id>:schedule raylet queue -> worker picked
          <span_id>:dispatch worker picked -> RUNNING (push + args)
          <span_id>:execute  RUNNING -> terminal
            <span_id>:deser    arg deserialization (deser_s)
            <span_id>:ship     return shipping     (ship_s)
    """
    tc = rec.get("trace_ctx") or {}
    trace_id, span_id = tc.get("trace_id"), tc.get("span_id")
    if not trace_id or not span_id:
        return []
    st = rec.get("state_ts") or {}
    submit = st.get("PENDING_SCHEDULING") or rec.get("created_ts")
    queued = st.get("PENDING_NODE_ASSIGNMENT")
    dispatched = rec.get("dispatch_ts")
    running = st.get("RUNNING") or rec.get("start_ts")
    end = rec.get("end_ts")
    if submit is None:
        return []
    last = max(v for v in (submit, queued, dispatched, running, end)
               if v is not None)
    status = "error" if rec.get("state") == "FAILED" else (
        "ok" if end is not None else "running")
    name = rec.get("name") or rec.get("task_id", "")[:12]
    base = {"trace_id": trace_id, "kind": "task",
            "node_id": rec.get("node_id"), "pid": rec.get("worker_pid")}
    spans = [{**base, "span_id": span_id,
              "parent_span_id": tc.get("parent_span_id"),
              "name": name, "phase": "submit",
              "start_ts": submit, "end_ts": last, "status": status,
              "attrs": {"task_id": rec.get("task_id"),
                        "state": rec.get("state"),
                        "attempt": rec.get("attempt", 0)}}]

    def child(suffix, phase, t0, t1, parent=span_id):
        if t0 is None or t1 is None or t1 < t0:
            return
        spans.append({**base, "span_id": f"{span_id}:{suffix}",
                      "parent_span_id": parent,
                      "name": f"{name}:{suffix}", "phase": phase,
                      "start_ts": t0, "end_ts": t1, "status": "ok"})

    child("queue", "queue", submit, queued)
    child("schedule", "schedule", queued, dispatched or running)
    if dispatched is not None:
        child("dispatch", "dispatch", dispatched, running)
    child("execute", "execute", running, end)
    if running is not None and rec.get("deser_s"):
        child("deser", "deserialize", running,
              running + float(rec["deser_s"]), parent=f"{span_id}:execute")
    if end is not None and rec.get("ship_s"):
        child("ship", "transfer", end - float(rec["ship_s"]), end,
              parent=f"{span_id}:execute")
    return spans


# ------------------------------------------------- tree / critical path

def build_tree(spans: List[Dict[str, Any]]
               ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(roots, orphans). A root's parent is absent-by-design
    (None/""/"root"); an orphan names a parent that is not in the span
    set — the reconcile completeness check fails on orphans."""
    ids = {s.get("span_id") for s in spans}
    roots, orphans = [], []
    for s in spans:
        p = s.get("parent_span_id")
        if p in _ROOT_PARENTS:
            roots.append(s)
        elif p not in ids:
            orphans.append(s)
    return roots, orphans


def tree_complete(spans: List[Dict[str, Any]]) -> Tuple[bool, str]:
    """Is this span set a well-formed tree? (>=1 root, no orphans)."""
    if not spans:
        return False, "no spans"
    roots, orphans = build_tree(spans)
    if not roots:
        return False, "no root span"
    if orphans:
        return False, (f"{len(orphans)} orphan spans, e.g. "
                       f"{orphans[0].get('name')} -> missing parent "
                       f"{orphans[0].get('parent_span_id')}")
    return True, f"{len(spans)} spans, {len(roots)} root(s)"


def _depths(spans: List[Dict[str, Any]]) -> Dict[str, int]:
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    depths: Dict[str, int] = {}

    def depth(sid: str, hop: int = 0) -> int:
        if sid in depths:
            return depths[sid]
        s = by_id.get(sid)
        if s is None or hop > len(by_id):  # cycle guard
            return 0
        p = s.get("parent_span_id")
        d = 0 if p in _ROOT_PARENTS or p not in by_id \
            else depth(p, hop + 1) + 1
        depths[sid] = d
        return d

    for sid in by_id:
        depth(sid)
    return depths


def critical_path(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Attribute the root span's wall time to named phases.

    Sweep attribution: sort all span starts/ends; inside the root's
    interval, each time slice charges the DEEPEST active span's phase
    (ties: the most recently started). Overlap never double-counts and
    gaps fall to the enclosing span — so ``attributed_s`` always equals
    the root interval and the phase table sums to 100% of it.
    """
    spans = [s for s in spans
             if s.get("start_ts") is not None
             and s.get("end_ts") is not None
             and s["end_ts"] >= s["start_ts"]]
    if not spans:
        return {"total_s": 0.0, "phases": {}, "segments": [],
                "attributed_s": 0.0}
    roots, _ = build_tree(spans)
    if not roots:  # orphan-only set: attribute over the envelope
        t0 = min(s["start_ts"] for s in spans)
        t1 = max(s["end_ts"] for s in spans)
    else:
        t0 = min(r["start_ts"] for r in roots)
        t1 = max(r["end_ts"] for r in roots)
    depths = _depths(spans)
    events: List[Tuple[float, int, int]] = []
    for i, s in enumerate(spans):
        events.append((max(s["start_ts"], t0), 0, i))
        events.append((min(s["end_ts"], t1), 1, i))
    events.sort(key=lambda e: (e[0], e[1]))
    active: Dict[int, None] = {}
    phases: Dict[str, float] = {}
    segments: List[Dict[str, Any]] = []
    prev = t0

    def charge(upto: float):
        nonlocal prev
        if upto <= prev or not active:
            prev = max(prev, upto)
            return
        # deepest active span wins; among equals the latest start
        i = max(active, key=lambda j: (depths.get(
            spans[j].get("span_id", ""), 0), spans[j]["start_ts"]))
        s = spans[i]
        phase = s.get("phase") or "other"
        phases[phase] = phases.get(phase, 0.0) + (upto - prev)
        if segments and segments[-1]["span_id"] == s.get("span_id") \
                and abs(segments[-1]["t1"] - prev) < 1e-9:
            segments[-1]["t1"] = upto  # coalesce adjacent slices
        else:
            segments.append({"t0": prev, "t1": upto,
                             "span_id": s.get("span_id"),
                             "name": s.get("name"), "phase": phase})
        prev = upto

    for ts, kind, i in events:
        charge(min(max(ts, t0), t1))
        if kind == 0:
            active[i] = None
        else:
            active.pop(i, None)
    charge(t1)
    total = t1 - t0
    attributed = sum(phases.values())
    return {
        "total_s": round(total, 6),
        "attributed_s": round(attributed, 6),
        "attributed_frac": round(attributed / total, 4) if total else 0.0,
        "phases": {k: round(v, 6)
                   for k, v in sorted(phases.items(),
                                      key=lambda kv: -kv[1])},
        "segments": [{**seg, "t0": round(seg["t0"], 6),
                      "t1": round(seg["t1"], 6)} for seg in segments],
    }


def aggregate_critical_path(traces: List[List[Dict[str, Any]]]
                            ) -> Dict[str, Any]:
    """Phase attribution summed over a cohort of traces (the p99 slice
    of a game day): where does the tail actually spend its time?"""
    phases: Dict[str, float] = {}
    total = 0.0
    n = 0
    for spans in traces:
        cp = critical_path(spans)
        if not cp["phases"]:
            continue
        n += 1
        total += cp["total_s"]
        for k, v in cp["phases"].items():
            phases[k] = phases.get(k, 0.0) + v
    out = {"traces": n, "total_s": round(total, 6),
           "phases": {k: round(v, 6)
                      for k, v in sorted(phases.items(),
                                         key=lambda kv: -kv[1])}}
    if total > 0:
        out["phase_frac"] = {k: round(v / total, 4)
                             for k, v in out["phases"].items()}
    return out


# ------------------------------------------------------ chrome export

def chrome_events(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Spans -> chrome-trace 'X' events (one row per process, nested by
    tree depth), wall-clock microseconds — the same time axis
    ``util/timeline.py`` and the CUDA device spans merged by
    ``util/gpu_profiler.py`` already use, so the outputs concatenate
    into one chrome://tracing document."""
    depths = _depths(spans)
    out = []
    for s in spans:
        if s.get("start_ts") is None or s.get("end_ts") is None:
            continue
        out.append({
            "name": s.get("name", "?"), "ph": "X", "cat": "trace",
            "ts": s["start_ts"] * 1e6,
            "dur": max(s["end_ts"] - s["start_ts"], 0) * 1e6,
            "pid": s.get("pid") or 0,
            "tid": depths.get(s.get("span_id", ""), 0),
            "cname": "terrible" if s.get("status") == "error" else None,
            "args": {"trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "parent_span_id": s.get("parent_span_id"),
                     "phase": s.get("phase"),
                     "kind": s.get("kind")},
        })
    return [{k: v for k, v in e.items() if v is not None} for e in out]


def export_chrome(spans: List[Dict[str, Any]],
                  device_events: Optional[List[Dict[str, Any]]] = None,
                  pad_s: float = 0.05) -> List[Dict[str, Any]]:
    """One chrome-trace document for a trace: its spans plus any device
    spans (``gpu_profiler`` rows in the merged timeline, pids >=
    ``_DEVICE_PID_BASE``) that overlap the trace window. Pass
    ``device_events=None`` to pull the merged timeline automatically."""
    out = chrome_events(spans)
    if not out:
        return out
    t0 = min(e["ts"] for e in out) - pad_s * 1e6
    t1 = max(e["ts"] + e.get("dur", 0) for e in out) + pad_s * 1e6
    if device_events is None:
        try:
            from ray_tpu_torch.util import timeline
            device_events = timeline.timeline_dump()
        except Exception:
            device_events = []
    from ray_tpu_torch.util.gpu_profiler import _DEVICE_PID_BASE
    for e in device_events or ():
        pid = e.get("pid", 0)
        if not isinstance(pid, int) or pid < _DEVICE_PID_BASE:
            continue
        if e.get("ph") == "M":  # process_name rows label the device lanes
            out.append(e)
        elif e.get("ph") == "X" and t0 <= e.get("ts", 0) <= t1:
            out.append(e)
    return out
