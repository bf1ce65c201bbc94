"""RTPU007 — silent exception swallow in a reconcile/control loop.

The controller tick, raylet dispatch loop, GCS serving loop and LLM
engine step loop are all shaped ``while True: try: ... except
Exception: <keep going>``. Keep-going is correct — a control loop must
survive anything — but *silent* keep-going turns real faults into
permanent mysteries: the loop spins, the subsystem is broken, and
nothing says why. Every swallow in a loop must either log (with
context) or re-raise; ``pass`` is only acceptable with an inline
pragma explaining why the error is genuinely meaningless.

Scope: ``except Exception:``/bare ``except:`` handlers that (a) sit
inside a ``while``/``for`` loop in the same function, (b) are
*inert* — every statement is ``pass``/``continue``/``break``/a bare
constant, so the error is neither logged, re-raised, recorded, nor
handled in any way, and (c) live in a control-plane module
(``controller``, ``raylet``, ``gcs``, ``engine``, ``reconcile``,
``runner`` — override with config key ``reconcile_modules``).
Handlers that do *anything* with the failure (requeue, dead-list the
peer, stash ``_last_error``) are deliberate keep-going policies, not
silence.

The port's copy of ``ray_tpu/analysis/checkers/excepts.py``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         register)

_DEFAULT_MODULE_RE = (
    r"(controller|raylet|gcs|engine|reconcile|runner|disagg|router)"
    r"[^/]*\.py$")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    if isinstance(t, ast.Name) and t.id in ("Exception", "BaseException"):
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and
                   e.id in ("Exception", "BaseException")
                   for e in t.elts)
    return False


def _handler_inert(handler: ast.ExceptHandler) -> bool:
    """True when the handler does literally nothing with the error —
    only pass/continue/break/constant expressions."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


def _in_loop(ctx: ModuleContext, handler: ast.ExceptHandler) -> bool:
    for anc in ctx.ancestors(handler):
        if isinstance(anc, (ast.While, ast.For, ast.AsyncFor)):
            return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False  # left the function without crossing a loop
    return False


@register
class SilentExceptChecker(Checker):
    code = "RTPU007"
    name = "silent-swallow-in-loop"
    description = ("except Exception/bare except inside a control-"
                   "plane loop that neither logs nor re-raises")

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        mod_re = ctx.config.get("reconcile_modules", _DEFAULT_MODULE_RE)
        if not re.search(mod_re, ctx.relpath):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node):
                continue
            if not _in_loop(ctx, node):
                continue
            if not _handler_inert(node):
                continue
            out.append(ctx.finding(
                self.code, node,
                "broad except inside a control-loop is inert — the "
                "loop keeps spinning with the fault invisible; log "
                "it with context, record it, or narrow the except"))
        return out
