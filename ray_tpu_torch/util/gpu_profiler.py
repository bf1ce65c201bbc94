"""CUDA profiler integration — torch.profiler traces merged into the
framework timeline by host.

The port's counterpart of ``ray_tpu/util/tpu_profiler.py`` (reference
analogue: the reference's profile pipeline, core_worker/profiling.cc +
dashboard reporter/profile_manager.py): keep the chrome-trace timeline,
and merge per-worker ``torch.profiler`` captures (the CUDA kernels, the
runtime calls and the aten ops they ran) into it so the merged timeline
shows framework task spans and the kernels they launched, host by host,
on one time axis.

Worker-side usage::

    from ray_tpu_torch.util import gpu_profiler
    with gpu_profiler.trace():
        loss = train_step(model, batch)   # CUDA work

The capture lands in two places:
  - the raw ``*.pt.trace.json.gz`` files that
    ``torch.profiler.tensorboard_trace_handler`` writes under the session
    dir, for TensorBoard's profile plugin or chrome://tracing;
  - the significant chrome events, rebased to wall-clock and re-tagged
    with this host's identity, recorded into
    ``ray_tpu_torch.util.timeline`` — the existing per-process → GCS KV →
    driver merge carries them cross-host exactly like task spans.

Differences from the JAX module: ``trace(device=)`` picks the
activities (``"cuda"``: CPU and CUDA, raising without CUDA; ``"cpu"``:
CPU only); ``serve(port)`` raises, since torch has no live profiler
server to match ``jax.profiler.start_server``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
import time
import zlib
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import timeline

# chrome pids are ints; device process rows get their own block so they
# never collide with framework task pids (os.getpid()-based)
_DEVICE_PID_BASE = 1 << 24


def load_chrome_events(log_dir: str) -> List[Dict[str, Any]]:
    """Chrome events from every ``*.trace.json.gz`` under a capture dir
    (torch.profiler writes ``<worker>.<ts>.pt.trace.json.gz``)."""
    events: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(
            os.path.join(log_dir, "**", "*.trace.json.gz"),
            recursive=True)):
        with gzip.open(path, "rt") as f:
            doc = json.load(f)
        events.extend(doc.get("traceEvents", []))
    return events


def _significant(events: List[Dict[str, Any]], max_events: int,
                 min_dur_us: float) -> List[Dict[str, Any]]:
    """Complete ('X') spans above the duration floor, longest first,
    capped — a raw capture holds far more events than the timeline
    ring buffer should absorb."""
    spans = [e for e in events
             if e.get("ph") == "X" and e.get("dur", 0) >= min_dur_us]
    spans.sort(key=lambda e: -e.get("dur", 0))
    return spans[:max_events]


def _as_int(v) -> int:
    """A chrome pid or tid as an int: torch.profiler names some rows
    with strings, which get a stable number from their crc32."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return zlib.crc32(str(v).encode()) & 0x7FFFFFFF


def merge_into_timeline(events: List[Dict[str, Any]], *,
                        wall_start_us: float, label: str = "cuda",
                        max_events: int = 4000,
                        min_dur_us: float = 5.0) -> int:
    """Rebase a capture's events to wall-clock and record them into the
    framework timeline under per-(host, profiled process) rows. Returns
    the number of events merged."""
    spans = _significant(events, max_events, min_dur_us)
    if not spans:
        return 0
    base = min(e["ts"] for e in spans)
    node = os.environ.get("RTT_NODE_ID", "")[:8] or "local"
    seen_pids: Dict[int, int] = {}
    for e in spans:
        src_pid = _as_int(e.get("pid", 0))
        pid = seen_pids.get(src_pid)
        if pid is None:
            # Deterministic digest (not Python's randomized hash()) so
            # device process rows are stable across restarts and don't
            # collide between hosts within the 16-bit space.
            digest = zlib.crc32(f"{node}:{src_pid}".encode())
            pid = _DEVICE_PID_BASE + (digest & 0xFFFF)
            seen_pids[src_pid] = pid
            timeline.record(
                "process_name", "M", 0, pid=pid,
                args={"name": f"{label} {node} p{src_pid}"})
        timeline.record(
            e.get("name", "?"), "X",
            wall_start_us + (e["ts"] - base),
            pid=pid, tid=_as_int(e.get("tid", 0)) % 1_000_000,
            dur=e.get("dur", 0), cat=label,
            args=e.get("args") or None)
    timeline.flush()
    return len(spans)


def _capture_dir() -> str:
    root = os.environ.get("RTT_SESSION_DIR") or tempfile.gettempdir()
    d = os.path.join(root, "gpu_profiles")
    os.makedirs(d, exist_ok=True)
    return tempfile.mkdtemp(prefix="capture_", dir=d)


@contextmanager
def trace(label: str = "cuda", *, log_dir: Optional[str] = None,
          max_events: int = 4000, min_dur_us: float = 5.0,
          keep_artifacts: bool = True, device: str = "cuda"):
    """Capture a torch.profiler trace around the body and merge its
    chrome events into the framework timeline (see module docstring).
    ``device="cuda"`` records CPU and CUDA activities and raises without
    CUDA; ``"cpu"`` records CPU activities only."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from ray_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    d = log_dir or _capture_dir()
    wall_start_us = time.time() * 1e6
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(
                         d, use_gzip=True)):
            try:
                yield d
            finally:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    finally:
        try:
            merge_into_timeline(
                load_chrome_events(d), wall_start_us=wall_start_us,
                label=label, max_events=max_events,
                min_dur_us=min_dur_us)
        except Exception:  # a merge failure must not fail the traced op
            pass
        if not keep_artifacts:
            import shutil
            shutil.rmtree(d, ignore_errors=True)


def serve(port: int = 9012):
    """The JAX module's live profiler server for on-demand TensorBoard
    capture has no torch counterpart: capture with ``trace`` instead."""
    raise NotImplementedError(
        "gpu_profiler.serve: torch has no live profiler server to match "
        "jax.profiler.start_server; wrap the work in gpu_profiler.trace()")
