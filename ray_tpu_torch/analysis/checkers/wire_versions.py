"""RTPU006 — version-gated wire fields need a negotiated-version guard.

Wire schema minors add fields to *pre-existing* methods
(``release_lease.inflight`` at 1.2, ``actor_call.trace_ctx`` at 1.6,
``worker_register.direct_address`` at 1.7, the ``tc`` trace context on
channel frames at 1.6 — the full map is
``ray_tpu_torch._private.schema.FIELD_VERSIONS``). A peer that
negotiated an older minor simply never sends them, so handler code has
exactly two safe ways to touch such a field:

* **absence-tolerant read** — ``payload.get("tc")`` plus a truthiness
  check (the receive-side idiom in ``dag/channel.py`` and
  ``_private/direct.py``: a pre-1.6 owner just never sets ``tc``);
* **hard read under a version guard** — ``payload["inflight"]`` only
  inside a function that consults the negotiated version
  (``conn.meta["peer_protocol_version"]`` / a ``>= (1, N)`` tuple
  compare / a negotiated-feature flag like ``_trace_peers`` computed
  from one, the ``compiled_dag._negotiate`` pattern).

This checker flags hard subscript reads of gated fields on
payload-shaped names (``payload``/``reply``/``frame``/...) in
functions with no recognizable guard — the read that raises
``KeyError`` the day a legacy peer connects.

The port's copy of ``ray_tpu/analysis/checkers/wire_versions.py``: the
gated fields are the port's own ``_private/schema.py``'s.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         const_str, dotted_name, register)

# names that hold decoded wire payloads in this codebase's handlers
PAYLOAD_NAMES = {"payload", "reply", "frame", "msg", "message", "resp",
                 "response", "req", "request", "r", "body"}

# identifiers that mark a function as version-aware
_GUARD_ATTR_RE = re.compile(
    r"peer_protocol_version|peer_ver|min_peer|negotiat|_trace_peers"
    r"|protocol_version")


def _field_versions(ctx: ModuleContext) -> Dict[str, Tuple[int, int]]:
    """field name -> version introduced, for fields added to
    pre-existing methods after 1.0 (the gated set)."""
    fv = ctx.config.get("field_versions")
    if fv is None:
        from ray_tpu_torch._private.schema import FIELD_VERSIONS
        fv = FIELD_VERSIONS
    out: Dict[str, Tuple[int, int]] = {}
    for key, ver in fv.items():
        field = key[1] if isinstance(key, tuple) else \
            str(key).rsplit(".", 1)[-1]
        ver = tuple(ver)
        if ver > (1, 0):
            prev = out.get(field)
            if prev is None or ver < prev:
                out[field] = ver  # earliest introduction wins
    return out


def _has_version_guard(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Attribute) and _GUARD_ATTR_RE.search(
                sub.attr):
            return True
        if isinstance(sub, ast.Name) and _GUARD_ATTR_RE.search(sub.id):
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and _GUARD_ATTR_RE.search(sub.value):
            return True
        if isinstance(sub, ast.Compare):
            for comp in sub.comparators:
                if isinstance(comp, ast.Tuple) and \
                        len(comp.elts) == 2 and all(
                            isinstance(e, ast.Constant) and
                            isinstance(e.value, int)
                            for e in comp.elts):
                    return True
    return False


@register
class WireVersionChecker(Checker):
    code = "RTPU006"
    name = "unguarded-versioned-field"
    description = ("hard read of a wire field introduced after schema "
                   "1.0 without a negotiated-version guard — breaks "
                   "against legacy peers")

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        gated: Optional[Dict[str, Tuple[int, int]]] = None
        guarded_fns: Dict[int, bool] = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Subscript):
                continue
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                continue  # writing/deleting a field we produce is fine
            base = dotted_name(node.value)
            if base is None or base.split(".")[-1] not in PAYLOAD_NAMES:
                continue
            field = const_str(node.slice)
            if field is None:
                continue
            if gated is None:
                gated = _field_versions(ctx)
            ver = gated.get(field)
            if ver is None:
                continue
            fn = self._enclosing_fn(ctx, node)
            if fn is None:
                continue
            key = id(fn)
            if key not in guarded_fns:
                guarded_fns[key] = _has_version_guard(fn)
            if guarded_fns[key]:
                continue
            out.append(ctx.finding(
                self.code, node,
                f"`{base}[\"{field}\"]` reads a schema-"
                f"{ver[0]}.{ver[1]} field without a negotiated-"
                f"version guard — a pre-{ver[0]}.{ver[1]} peer never "
                f"sends it; use .get() with an absence check or gate "
                f"on conn.meta[\"peer_protocol_version\"]"))
        return out

    @staticmethod
    def _enclosing_fn(ctx: ModuleContext, node: ast.AST
                      ) -> Optional[ast.AST]:
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None
