"""Usage stats collection (opt-IN, local-only).

Reference analogue: ``python/ray/_private/usage/usage_lib.py`` +
``gcs_client/usage_stats_client.cc`` — the reference collects cluster
metadata (version, python, OS, library usage, node counts) and reports
it opt-OUT. This environment has zero egress, so the redesign is
opt-IN (``RTT_USAGE_STATS_ENABLED=1``) and writes the report to
``<session_dir>/usage_stats.json`` only; the ``report_url`` seam is
where a deployment would POST it.

Copied from the JAX package's ``ray_tpu/_private/usage``; the report names
the installed torch version (read from the package metadata, so no
process imports torch to write it).
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Any, Dict, Optional, Set

_lib_usages: Set[str] = set()


def usage_stats_enabled() -> bool:
    return os.environ.get("RTT_USAGE_STATS_ENABLED", "") not in ("", "0")


def record_library_usage(name: str):
    """Called by library entry points (tune.run, serve.start, ...);
    cheap set-add, collected into the report (reference:
    usage_lib.record_library_usage)."""
    _lib_usages.add(name)


def _collect(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    from importlib import metadata
    try:
        torch_version = metadata.version("torch")
    except metadata.PackageNotFoundError:
        torch_version = None
    report = {
        "schema_version": 1,
        "collected_at": time.time(),
        "python_version": platform.python_version(),
        "os": sys.platform,
        "machine": platform.machine(),
        "torch_version": torch_version,
        "libraries_used": sorted(_lib_usages),
        "total_success": 0,  # would-be report deliveries (no egress here)
        "total_failed": 0,
        "seq_no": 1,
    }
    report.update(extra or {})
    return report


def write_report(session_dir: str,
                 extra: Optional[Dict[str, Any]] = None
                 ) -> Optional[str]:
    """Write the usage report under the session dir if enabled;
    returns the path (reference: usage_lib.put_cluster_metadata +
    the reporter writing usage_stats.json)."""
    if not usage_stats_enabled():
        return None
    path = os.path.join(session_dir, "usage_stats.json")
    try:
        with open(path, "w") as f:
            json.dump(_collect(extra), f, indent=1)
    except OSError:
        return None
    return path
