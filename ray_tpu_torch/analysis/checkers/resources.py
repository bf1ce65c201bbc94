"""RTPU003 — unpaired resource acquire/release.

Three concrete leak shapes from the bug history, all checked at class
granularity (a long-lived object owns the resource; pairing inside a
single call is often legitimately split across methods):

* **refcount pairing** — a class whose methods call ``*.incref(...)``
  but never ``decref`` anywhere leaks shared pages the moment an error
  path skips the happy-path release (the KV-page class needed a
  zero-leaked-pages gate for exactly this). Additionally, a *function*
  that increfs and then decrefs only on the straight-line path — with
  fallible calls in between and no ``try/finally``/``except`` guarding
  the decref — leaks on the error path.
* **span pairing** — opening a tracing span (``tracing.Span(...)`` /
  ``start_span``) without ``finish``/``end``/``__exit__`` in the same
  class leaves the span out of the trace tree forever (breaks the
  tree-completeness reconcile).
* **daemon-thread lifecycle** — a class that starts a
  ``threading.Thread(daemon=True)`` and has no ``join``/stop path
  (``stop``/``close``/``shutdown``/``__exit__``/an ``Event.set`` the
  loop polls) re-leaks a thread per instance: the data-prefetch
  thread leak and the tracing-flusher leak, twice-learned.

The port's copy of ``ray_tpu/analysis/checkers/resources.py``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         call_name, register)

_STOPPISH_METHODS = {
    "stop", "close", "shutdown", "join", "stop_all", "teardown",
    "__exit__", "__del__", "drain", "abort", "cancel", "stop_flusher",
}
_SPAN_OPENERS = {"start_span", "Span"}
_SPAN_CLOSERS = {"finish", "end", "end_span", "record_span"}


def _attr_calls(node: ast.AST) -> Iterable[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def _leaf(call: ast.Call) -> Optional[str]:
    name = call_name(call)
    return name.rsplit(".", 1)[-1] if name else None


def _has_daemon_true(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _names_in(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            out.add(sub.attr)
        elif isinstance(sub, ast.Name):
            out.add(sub.id)
    return out


@register
class ResourcePairingChecker(Checker):
    code = "RTPU003"
    name = "unpaired-acquire-release"
    description = ("incref without decref, span open without close, or "
                   "daemon thread started by a long-lived object with "
                   "no stop/join path")

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_error_path(ctx, node))
        return out

    # ------------------------------------------------------ class pairing

    def _check_class(self, ctx: ModuleContext, cls: ast.ClassDef
                     ) -> Iterable[Finding]:
        leaves: List[str] = []
        first_incref: Optional[ast.Call] = None
        first_span: Optional[ast.Call] = None
        thread_start: Optional[ast.Call] = None
        method_names = {n.name for n in cls.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        span_is_ctxmgr = False
        for call in _attr_calls(cls):
            leaf = _leaf(call)
            if leaf is None:
                continue
            leaves.append(leaf)
            if leaf == "incref" and first_incref is None:
                first_incref = call
            if leaf in _SPAN_OPENERS and first_span is None:
                first_span = call
                # `with tracing.Span(...)` / `with span_if(...)` closes
                # via __exit__
                parent = ctx.parent(call)
                if isinstance(parent, ast.withitem):
                    span_is_ctxmgr = True
            if leaf == "Thread" and _has_daemon_true(call):
                thread_start = call

        leafset = set(leaves)
        if first_incref is not None and "decref" not in leafset:
            yield ctx.finding(
                self.code, first_incref,
                f"class `{cls.name}` calls incref but never decref — "
                f"refcounted pages leak on every path; pair the "
                f"release (error paths included)")
        if first_span is not None and not span_is_ctxmgr \
                and not (leafset & _SPAN_CLOSERS):
            yield ctx.finding(
                self.code, first_span,
                f"class `{cls.name}` opens tracing spans but never "
                f"finishes them — incomplete trace trees; use `with` "
                f"or call .finish()")
        if thread_start is not None and "start" in leafset:
            has_stop = bool(method_names & _STOPPISH_METHODS) \
                or "join" in leafset \
                or ("set" in leafset and any(
                    "stop" in n or "shutdown" in n or "exit" in n
                    for n in _names_in(cls)))
            if not has_stop:
                yield ctx.finding(
                    self.code, thread_start,
                    f"class `{cls.name}` starts a daemon thread but "
                    f"has no join/stop path (no "
                    f"stop/close/shutdown/join) — threads accumulate "
                    f"per instance (the rtpu-data-prefetch bug class)")

    # ------------------------------------------- intra-function error path

    def _check_error_path(self, ctx: ModuleContext,
                          fn: ast.AST) -> Iterable[Finding]:
        """incref then decref in one function, with fallible work
        between and the decref not exception-guarded → leaks when that
        work raises."""
        body_stmts = list(fn.body)
        increfs: List[ast.Call] = []
        decrefs: List[ast.Call] = []
        for call in _attr_calls(fn):
            leaf = _leaf(call)
            if leaf == "incref":
                increfs.append(call)
            elif leaf == "decref":
                decrefs.append(call)
        if not increfs or not decrefs:
            return
        guarded = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Try):
                regions = list(sub.finalbody) + [
                    h for h in sub.handlers]
                for region in regions:
                    for c in _attr_calls(region):
                        if _leaf(c) == "decref":
                            guarded.add(id(c))
        if all(id(d) not in guarded for d in decrefs):
            first_inc = min(increfs, key=lambda c: c.lineno)
            last_dec = max(decrefs, key=lambda c: c.lineno)
            # fallible work between acquire and release?
            fallible = [
                c for c in _attr_calls(fn)
                if first_inc.lineno < c.lineno < last_dec.lineno
                and _leaf(c) not in ("incref", "decref", "append",
                                     "get", "len")]
            has_await = any(
                isinstance(s, ast.Await) and
                first_inc.lineno < s.lineno < last_dec.lineno
                for s in ast.walk(fn))
            if fallible or has_await:
                yield ctx.finding(
                    self.code, first_inc,
                    f"incref at line {first_inc.lineno} is released "
                    f"only on the straight-line path (decref line "
                    f"{last_dec.lineno}, not in finally/except) — an "
                    f"exception in between leaks the reference")
