"""Long-poll config propagation.

Copy of ``ray_tpu/serve/_private/long_poll.py``. Reference analogue:
serve/_private/long_poll.py (LongPollHost:185,
LongPollClient:68). The host lives inside the controller actor; clients
issue blocking ``listen`` calls (served on the controller's thread pool)
that return only when the keyed snapshot's version advances — push-like
latency with pull-only plumbing.

Controller HA: versions are per-controller-incarnation. A restarted
controller starts its counters at zero, so a client can legitimately
hold a ``last_version`` AHEAD of the host. The host returns immediately
in that case (instead of parking the regressed client for a full
timeout), and the client treats a version regression as a restart
signal: it resets its cursor and applies the fresh snapshot. While the
controller is down, clients keep their last snapshot (routers/proxy
keep serving from it) and redial the listen with exponential backoff.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


class LongPollHost:
    """Versioned key→snapshot store with blocking listeners."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._versions: Dict[str, int] = {}
        self._snapshots: Dict[str, Any] = {}

    def notify_changed(self, key: str, snapshot: Any):
        with self._cv:
            self._versions[key] = self._versions.get(key, 0) + 1
            self._snapshots[key] = snapshot
            self._cv.notify_all()

    def listen(self, key: str, last_version: int,
               timeout: float = 30.0) -> Tuple[int, Any]:
        """Block until version(key) > last_version (or timeout); returns
        (current_version, snapshot). A ``last_version`` from a previous
        controller incarnation (> current) returns immediately so the
        client can resync instead of stalling a full timeout."""
        # One absolute deadline: notify_all fires for *any* key, so each
        # wakeup must wait only the remaining time, not a fresh `timeout`
        # (otherwise churn on other keys can block far past `timeout`).
        deadline = time.monotonic() + timeout
        with self._cv:
            if last_version > self._versions.get(key, 0):
                return (self._versions.get(key, 0),
                        self._snapshots.get(key))
            while self._versions.get(key, 0) <= last_version:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    break
            return (self._versions.get(key, 0),
                    self._snapshots.get(key))

    def get(self, key: str) -> Tuple[int, Any]:
        with self._lock:
            return self._versions.get(key, 0), self._snapshots.get(key)


class LongPollClient:
    """Background thread repeatedly calling ``listen`` on the controller
    and firing callbacks on change. Survives controller restarts: RPC
    failures back off exponentially (the cached snapshot keeps serving),
    and a version regression from a restarted controller resets the
    cursor and re-applies the fresh snapshot."""

    _BACKOFF_MIN_S = 0.2
    _BACKOFF_MAX_S = 5.0

    def __init__(self, controller_handle, key: str,
                 callback: Callable[[Any], None]):
        import ray_tpu_torch
        self._ray = ray_tpu_torch
        self._controller = controller_handle
        self._key = key
        self._callback = callback
        self._version = -1  # -1 so the first listen returns immediately
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        backoff = self._BACKOFF_MIN_S
        while not self._stopped.is_set():
            try:
                version, snapshot = self._ray.get(
                    self._controller.listen_for_change.remote(
                        self._key, self._version), timeout=60.0)
                backoff = self._BACKOFF_MIN_S
            except Exception:
                if self._stopped.is_set():
                    return
                # controller down/restarting: keep the cached snapshot,
                # redial with backoff
                self._stopped.wait(backoff)
                backoff = min(backoff * 2, self._BACKOFF_MAX_S)
                continue
            if version > self._version:
                self._version = version
                try:
                    self._callback(snapshot)
                except Exception:
                    pass
            elif version < self._version:
                # restarted controller: version counters reset. Adopt
                # its cursor; apply its snapshot if it already has one
                # (None = nothing published yet — the next publish will
                # advance past the adopted cursor and fire normally).
                self._version = version
                if snapshot is not None:
                    try:
                        self._callback(snapshot)
                    except Exception:
                        pass

    def stop(self):
        self._stopped.set()
