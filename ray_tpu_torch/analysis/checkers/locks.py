"""RTPU002 — thread lock held across ``await``.

The serve router's ``ReplicaSet.assign`` race was exactly this shape: a
``threading.Lock`` taken in a coroutine, an ``await`` inside the
``with`` body, and a second task re-entering while the first was
suspended — the lock serializes *threads*, not *tasks*, so the
critical section silently stopped being one. Worse, if another
coroutine on the same loop tries the same lock it deadlocks the whole
loop (the holder can only resume on the thread the waiter is
blocking).

Flagged: a sync ``with`` statement whose context expression names a
lock (leaf identifier contains ``lock`` or ``mutex``) containing an
``await``/``async for``/``async with`` that executes while the lock is
held. ``async with`` on an ``asyncio.Lock`` is the correct idiom and
is not flagged. Nested function bodies are skipped (they don't execute
under the lock).

The port's copy of ``ray_tpu/analysis/checkers/locks.py``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         dotted_name, register,
                                         walk_no_nested_defs)

_LOCKISH = ("lock", "mutex", "sem")


def _lock_leaf(expr: ast.AST) -> Optional[str]:
    """The lock-ish identifier a with-item takes, if any. Handles
    ``with self._lock:``, ``with lock:``, and acquire-style calls
    (``with self._lock.acquire_timeout(1):`` still holds the lock)."""
    target = expr
    if isinstance(target, ast.Call):
        target = target.func
    name = dotted_name(target)
    if name is None:
        return None
    for part in name.split("."):
        low = part.lower()
        if any(t in low for t in _LOCKISH):
            return name
    return None


@register
class LockAcrossAwaitChecker(Checker):
    code = "RTPU002"
    name = "lock-across-await"
    description = ("sync `with <lock>:` body containing await — the "
                   "critical section breaks on suspension and can "
                   "deadlock the loop")

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            lock_name = None
            for item in node.items:
                lock_name = _lock_leaf(item.context_expr)
                if lock_name:
                    break
            if not lock_name:
                continue
            for sub in walk_no_nested_defs(node):
                if isinstance(sub, (ast.Await, ast.AsyncFor,
                                    ast.AsyncWith)):
                    kind = type(sub).__name__.lower()
                    out.append(ctx.finding(
                        self.code, sub,
                        f"`{kind}` at line {sub.lineno} while holding "
                        f"`{lock_name}` (taken line {node.lineno}) — a "
                        f"thread lock does not protect across task "
                        f"suspension; narrow the critical section or "
                        f"use asyncio.Lock with `async with`"))
                    break  # one finding per with-block is enough
        return out
