"""Structured cluster events (the RAY_EVENT framework analogue).

Reference analogue: src/ray/util/event.cc + dashboard event browsing —
components emit typed, severity-tagged events; each process appends them
to a JSONL file under the session dir AND ships them to the GCS, which
keeps a bounded ring visible through the state API, the dashboard
(/api/events), and `ray-tpu events`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

DEBUG, INFO, WARNING, ERROR, FATAL = (
    "DEBUG", "INFO", "WARNING", "ERROR", "FATAL")

_lock = threading.Lock()
_file = None
_source = "unknown"


def init_emitter(source: str, session_dir: Optional[str] = None):
    """Per-process setup: names the component and opens its JSONL log."""
    global _file, _source
    _source = source
    if session_dir:
        d = os.path.join(session_dir, "logs", "events")
        os.makedirs(d, exist_ok=True)
        with _lock:
            if _file is not None:
                try:
                    _file.close()
                except Exception:
                    pass
            _file = open(os.path.join(
                d, f"events_{source}_{os.getpid()}.log"), "a")


def make_event(severity: str, label: str, message: str,
               **fields) -> Dict[str, Any]:
    return {"timestamp": time.time(), "severity": severity,
            "source": _source, "pid": os.getpid(), "label": label,
            "message": message, "fields": fields}


def emit_local(event: Dict[str, Any]):
    """Append to this process's event log (always safe to call)."""
    with _lock:
        if _file is None:
            return
        try:
            json.dump(event, _file, default=str)
            _file.write("\n")
            _file.flush()
        except Exception:
            pass


def report(severity: str, label: str, message: str,
           gcs_notify=None, **fields) -> Dict[str, Any]:
    """Record an event locally and (best-effort) ship it to the GCS.

    ``gcs_notify(method, payload)`` is the caller's fire-and-forget GCS
    channel (worker.try_notify / raylet's connection) — None for the GCS
    itself, which stores directly."""
    ev = make_event(severity, label, message, **fields)
    emit_local(ev)
    if gcs_notify is not None:
        try:
            gcs_notify("add_event", ev)
        except Exception:
            pass
    return ev
