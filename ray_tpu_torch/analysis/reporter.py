"""rtpulint output: text (one finding per line, grep-able) and JSON
(stable schema for tooling — the tier-1 gate and the CLI smoke test
both consume it).

The port's copy of ``ray_tpu/analysis/reporter.py``."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ray_tpu_torch.analysis.baseline import BaselineEntry
from ray_tpu_torch.analysis.core import Finding, registry

__all__ = ["render_text", "render_json", "summary_counts"]


def summary_counts(findings: List[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return dict(sorted(out.items()))


def render_text(unsuppressed: List[Finding],
                baselined: Optional[List[Finding]] = None,
                stale: Optional[List[BaselineEntry]] = None,
                files_scanned: int = 0, verbose: bool = False) -> str:
    lines: List[str] = []
    for f in unsuppressed:
        lines.append(f.render())
    if verbose and baselined:
        for f in baselined:
            lines.append(f"{f.render()}  (baselined)")
    for e in stale or []:
        lines.append(
            f"stale baseline entry (finding no longer fires — delete "
            f"it): {e.code} {e.relpath} {e.scope} {e.fingerprint}")
    counts = summary_counts(unsuppressed)
    tally = ", ".join(f"{c}×{n}" for c, n in counts.items()) or "none"
    lines.append(
        f"rtpulint: {len(unsuppressed)} finding(s) [{tally}] in "
        f"{files_scanned} file(s)"
        + (f"; {len(baselined)} baselined" if baselined else "")
        + (f"; {len(stale)} STALE baseline entr(y/ies)" if stale else ""))
    return "\n".join(lines)


def render_json(unsuppressed: List[Finding],
                baselined: Optional[List[Finding]] = None,
                stale: Optional[List[BaselineEntry]] = None,
                files_scanned: int = 0) -> str:
    doc: Dict[str, Any] = {
        "version": 1,
        "files_scanned": files_scanned,
        "counts": summary_counts(unsuppressed),
        "findings": [f.as_dict() for f in unsuppressed],
        "baselined": [f.as_dict() for f in (baselined or [])],
        "stale_baseline": [
            {"code": e.code, "relpath": e.relpath, "scope": e.scope,
             "fingerprint": e.fingerprint, "comment": e.comment}
            for e in (stale or [])],
        "checkers": {code: {"name": cls.name,
                            "description": cls.description}
                     for code, cls in registry().items()},
    }
    return json.dumps(doc, indent=2, sort_keys=True)
