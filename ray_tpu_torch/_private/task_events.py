"""Task lifecycle event pipeline (worker/raylet side).

Reference analogue: the task-event backend behind `ray list tasks`
(src/ray/core_worker/task_event_buffer.cc shipping batched
TaskEventData to gcs_task_manager.cc). Every process that observes a
task-state transition — the owner at submit, the raylet at queue/death,
the executing worker at run/finish — records it into a process-local
bounded ring and a background flusher ships batches to the GCS, which
folds them into a bounded, indexed table (`gcs.TaskEventTable`).

Design constraints (the whole point of this pipeline):
  - recording is O(1), lock-append, never an RPC: safe inside the
    hot submit loop (`submit_task_batch`) and the worker execute path;
  - memory is bounded end-to-end: the ring drops oldest events past
    ``RTT_TASK_EVENTS_BUFFER`` (drop count ships with each batch so
    the head's table can report lossiness instead of lying), the GCS
    table evicts oldest-finished past its own cap;
  - shipping is batched: one ``task_events`` RPC per flush tick
    (``RTT_TASK_EVENTS_FLUSH_S``, default 0.5 s), never per event.

States (reference: src/ray/protobuf/gcs.proto TaskStatus):
  PENDING_SCHEDULING -> PENDING_NODE_ASSIGNMENT -> RUNNING ->
  FINISHED | FAILED
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

PENDING_SCHEDULING = "PENDING_SCHEDULING"
PENDING_NODE_ASSIGNMENT = "PENDING_NODE_ASSIGNMENT"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"

TERMINAL_STATES = (FINISHED, FAILED)

# Later states win a merge race at the GCS (events from different
# processes arrive out of order); FAILED outranks FINISHED so a
# worker-death report isn't papered over by a stale success.
STATE_RANK = {
    PENDING_SCHEDULING: 0,
    PENDING_NODE_ASSIGNMENT: 1,
    RUNNING: 2,
    FINISHED: 3,
    FAILED: 4,
}


_RING_CAP: Optional[int] = None


def _ring_cap() -> int:
    # cached: this sits on the per-task emit path and an environ read
    # per event is measurable there (tests that change the env call
    # _reset_ring_cap / set the module global directly)
    global _RING_CAP
    if _RING_CAP is None:
        _RING_CAP = int(os.environ.get("RTT_TASK_EVENTS_BUFFER", 8192))
    return _RING_CAP


def _reset_ring_cap():
    global _RING_CAP
    _RING_CAP = None


def _flush_interval() -> float:
    return float(os.environ.get("RTT_TASK_EVENTS_FLUSH_S", 0.5))


_lock = threading.Lock()
_buf: List[Dict[str, Any]] = []
_dropped = 0          # ring overflow since the last shipped batch
_flusher_started = False
# raylets pump the buffer from their own asyncio loop (set_external_
# flusher); worker/driver processes start the default thread flusher
_external = False
_sender: Optional[Callable[[Dict[str, Any]], bool]] = None

_BATCH_MAX = 4000  # events per task_events RPC


def emit(task_id: str, state: str, **fields) -> None:
    """Record one lifecycle transition. O(1); never blocks on I/O.

    ``fields``: name, job_id, node_id, worker_pid, attempt, error,
    trace_ctx, plus the tracing-plane stamps the GCS synthesizes task
    phase spans from (docs/TRACING.md): ``dispatch_ts`` (raylet, at
    worker handoff), ``deser_s`` / ``ship_s`` (worker, arg
    deserialization and return shipping). Only non-None values ride
    the wire.
    """
    if not task_id:
        return
    ev = {"task_id": task_id, "state": state, "ts": time.time()}
    for k, v in fields.items():
        if v is not None:
            ev[k] = v
    global _dropped
    with _lock:
        _buf.append(ev)
        over = len(_buf) - _ring_cap()
        if over > 0:
            del _buf[:over]
            _dropped += over
    if not _external:
        _ensure_flusher()


def drain(max_n: int = _BATCH_MAX) -> Tuple[List[Dict[str, Any]], int]:
    """Take up to ``max_n`` buffered events (+ the drop count accrued
    since the last drain). Used by external pumps (the raylet loop)."""
    global _dropped
    with _lock:
        batch = _buf[:max_n]
        del _buf[:max_n]
        dropped, _dropped = _dropped, 0
    return batch, dropped


def requeue(events: List[Dict[str, Any]], dropped: int = 0) -> None:
    """Put a failed batch back at the front (bounded: oldest events past
    the ring cap are dropped and counted — a dead GCS must not grow an
    unbounded retry queue in every process)."""
    global _dropped
    if not events and not dropped:
        return
    with _lock:
        _buf[:0] = events
        _dropped += dropped
        over = len(_buf) - _ring_cap()
        if over > 0:
            del _buf[:over]
            _dropped += over


def pending_count() -> int:
    with _lock:
        return len(_buf)


def set_external_flusher() -> None:
    """The raylet owns flushing on its asyncio loop; don't start the
    thread flusher in this process."""
    global _external
    _external = True


def set_sender(fn: Optional[Callable[[Dict[str, Any]], bool]]) -> None:
    """Override the default ship-via-global-worker sender (tests)."""
    global _sender
    _sender = fn


def _default_send(payload: Dict[str, Any],
                  timeout: float = 5.0) -> bool:
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod._global_worker
    if w is None or not w.connected:
        return False
    try:
        w.call_sync(w.gcs, "task_events", payload, timeout=timeout)
        return True
    except Exception:
        return False


def flush(send_timeout: float = 5.0) -> bool:
    """Ship one batch to the GCS. Returns False when nothing could be
    sent (batch is requeued — cursor semantics: events are only dropped
    by the bounded ring, never by a failed send)."""
    batch, dropped = drain()
    if not batch and not dropped:
        return True
    payload = {"events": batch, "dropped": dropped}
    if _sender is not None:
        ok = _sender(payload)
    else:
        ok = _default_send(payload, timeout=send_timeout)
    if ok:
        return True
    requeue(batch, dropped)
    return False


def flush_all(timeout: float = 2.0) -> None:
    """Best-effort full drain (process teardown): each send is capped
    by the remaining budget so a dead GCS can't stall shutdown."""
    deadline = time.monotonic() + timeout
    while pending_count():
        left = deadline - time.monotonic()
        if left <= 0 or not flush(send_timeout=max(0.1, left)):
            return


def _ensure_flusher() -> None:
    global _flusher_started
    if _flusher_started:
        return
    _flusher_started = True

    def loop():
        while True:
            time.sleep(_flush_interval())
            try:
                flush()
            except Exception:
                pass

    threading.Thread(target=loop, daemon=True,
                     name="rtpu-task-events").start()
