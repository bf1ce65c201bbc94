"""Reviewed baseline of grandfathered rtpulint findings.

A baseline entry acknowledges a finding without fixing it — every
entry needs a justification comment, and the tier-1 gate fails if the
file grows stale entries (finding fixed but entry kept) so the list
only shrinks. Format, one finding per line::

    RTPU003 foo/bar.py Class.method 1a2b3c4d5e6f  # why it's ok

The fingerprint hashes (code, relpath, enclosing scope, message) — not
the line number — so unrelated edits that move code don't churn the
baseline, while any change to the finding itself invalidates the entry
for re-review.

The port's copy of ``ray_tpu/analysis/baseline.py``. The port's
baseline is a file of its own, ``.rtpulint-torch-baseline`` at the
repo root (relpaths under ``ray_tpu_torch/``); the JAX package's
``.rtpulint-baseline`` covers ``ray_tpu/`` only.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch.analysis.core import Finding

__all__ = ["BaselineEntry", "load", "save", "apply", "default_path",
           "format_entry", "DEFAULT_BASENAME"]

DEFAULT_BASENAME = ".rtpulint-torch-baseline"

_LINE_RE = re.compile(
    r"^(?P<code>RTPU\d{3})\s+(?P<relpath>\S+)\s+(?P<scope>\S+)\s+"
    r"(?P<fp>[0-9a-f]{12})\s*(?:#\s*(?P<comment>.*))?$")


class BaselineEntry:
    __slots__ = ("code", "relpath", "scope", "fingerprint", "comment",
                 "lineno")

    def __init__(self, code: str, relpath: str, scope: str,
                 fingerprint: str, comment: str = "", lineno: int = 0):
        self.code = code
        self.relpath = relpath
        self.scope = scope
        self.fingerprint = fingerprint
        self.comment = comment
        self.lineno = lineno

    def key(self) -> Tuple[str, str]:
        return (self.code, self.fingerprint)


def default_path(start: str) -> Optional[str]:
    """Walk up from ``start`` looking for the baseline file."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        cand = os.path.join(cur, DEFAULT_BASENAME)
        if os.path.isfile(cand):
            return cand
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return None
        cur = nxt


def load(path: str) -> List[BaselineEntry]:
    entries: List[BaselineEntry] = []
    with open(path, encoding="utf-8") as fh:
        for i, raw in enumerate(fh, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            m = _LINE_RE.match(line)
            if not m:
                raise ValueError(
                    f"{path}:{i}: malformed baseline line: {line!r}")
            if not m.group("comment"):
                raise ValueError(
                    f"{path}:{i}: baseline entry needs a justification "
                    f"comment: {line!r}")
            entries.append(BaselineEntry(
                m.group("code"), m.group("relpath"), m.group("scope"),
                m.group("fp"), (m.group("comment") or "").strip(), i))
    return entries


def format_entry(f: Finding, comment: str = "TODO: justify") -> str:
    return (f"{f.code} {f.relpath} {f.scope} {f.fingerprint()}"
            f"  # {comment}")


def save(path: str, findings: Iterable[Finding],
         header: Optional[str] = None) -> None:
    lines = [header.rstrip() if header else
             "# rtpulint baseline — reviewed, grandfathered findings.\n"
             "# One per line: CODE relpath scope fingerprint  # why"]
    for f in sorted(findings, key=lambda f: (f.relpath, f.line, f.code)):
        lines.append(format_entry(f))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def apply(findings: List[Finding], entries: List[BaselineEntry]
          ) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Split ``findings`` against the baseline.

    Returns ``(unsuppressed, baselined, stale_entries)`` — stale
    entries match no live finding and must be deleted (the gate fails
    on them: a baseline may only shrink)."""
    by_key: Dict[Tuple[str, str], BaselineEntry] = {
        e.key(): e for e in entries}
    matched: set = set()
    unsuppressed: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        key = (f.code, f.fingerprint())
        if key in by_key:
            matched.add(key)
            baselined.append(f)
        else:
            unsuppressed.append(f)
    stale = [e for e in entries if e.key() not in matched]
    return unsuppressed, baselined, stale
