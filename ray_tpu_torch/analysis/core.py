"""rtpulint core: the project-aware static analysis framework.

The substrate mixes asyncio loops, an epoll reactor, plain threads and
refcounted shared pages — and its bug history (the rtpu-data-prefetch
thread leak, the ``ReplicaSet.assign`` lock race, the tracing-flusher
daemon-thread leak, unbounded ``pending_tasks`` growth, KV-page refcount
pairing) is a catalog of *invariant* violations, not logic errors.
Generic linters cannot see those invariants; this framework encodes
them as AST checkers that run over the tree in tier-1, so the next
violation fails a test instead of a game day.

Architecture (stdlib ``ast`` only — no new dependencies):

* :class:`Checker` subclasses declare a ``code`` (``RTPU0xx``) and
  implement ``check_module(ctx)``; the ``@register`` decorator adds
  them to the global registry.
* :class:`ModuleContext` wraps one parsed file: source, AST, a
  node→enclosing-scope map, per-line pragma suppressions, and a
  ``config`` dict checkers read overrides from (tests inject fixture
  registries there; production runs use the live ones).
* ``analyze_paths()`` walks ``*.py`` files (skipping ``__pycache__``
  and generated code), runs every registered checker, and filters
  findings through inline pragmas:

      something_suspicious()  # rtpulint: ignore[RTPU002]
      # rtpulint: ignore[RTPU001,RTPU003]   <- bare line: covers next line
      anything_goes()         # rtpulint: ignore

* Grandfathered findings live in a reviewed baseline file
  (:mod:`ray_tpu_torch.analysis.baseline`); everything else fails the
  tier-1 gate (``tests/test_torch_analysis.py``).

See docs/STATIC_ANALYSIS.md for the workflow and checker catalog.

The port's copy of ``ray_tpu/analysis/core.py`` (imports renamed to
``ray_tpu_torch``); the codes keep their ``RTPU0xx`` names, so a pragma
reads the same in both packages.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Type

__all__ = [
    "Finding", "Checker", "ModuleContext", "register", "registry",
    "analyze_source", "analyze_file", "analyze_paths", "iter_py_files",
]

_PRAGMA_RE = re.compile(
    r"#\s*rtpulint:\s*ignore(?:\[(?P<codes>[A-Z0-9_,\s]+)\])?")

# directories never scanned (relative path components)
_SKIP_DIRS = {"__pycache__", ".git", ".eggs", "build", "dist"}


@dataclasses.dataclass
class Finding:
    """One checker hit. ``scope`` is the dotted enclosing-definition
    chain (``Class.method`` or ``<module>``) — it feeds the baseline
    fingerprint so unrelated edits moving line numbers don't churn the
    baseline."""

    code: str
    message: str
    path: str          # as given to the analyzer
    relpath: str       # relative to the scan root (fingerprint key)
    line: int
    col: int = 0
    scope: str = "<module>"

    def fingerprint(self) -> str:
        h = hashlib.sha1(
            f"{self.code}|{self.relpath}|{self.scope}|{self.message}"
            .encode()).hexdigest()[:12]
        return h

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"[{self.scope}] {self.message}")

    def as_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "message": self.message,
                "path": self.path, "relpath": self.relpath,
                "line": self.line, "col": self.col, "scope": self.scope,
                "fingerprint": self.fingerprint()}


class ModuleContext:
    """Everything a checker needs about one parsed module."""

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.Module, config: Optional[Dict[str, Any]] = None):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.config: Dict[str, Any] = config or {}
        self._scopes: Dict[int, str] = {}
        self._parents: Dict[int, ast.AST] = {}
        self._build_maps()

    def _build_maps(self) -> None:
        def walk(node: ast.AST, scope: str, parent: Optional[ast.AST]):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node
                child_scope = scope
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    child_scope = (child.name if scope == "<module>"
                                   else f"{scope}.{child.name}")
                    self._scopes[id(child)] = child_scope
                else:
                    self._scopes[id(child)] = scope
                walk(child, child_scope, child)
        self._scopes[id(self.tree)] = "<module>"
        walk(self.tree, "<module>", None)

    def scope(self, node: ast.AST) -> str:
        """Enclosing dotted definition chain for ``node`` (the node's
        own name if it *is* a def/class)."""
        return self._scopes.get(id(node), "<module>")

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def finding(self, code: str, node: ast.AST, message: str) -> Finding:
        return Finding(code=code, message=message, path=self.path,
                       relpath=self.relpath,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       scope=self.scope(node))

    # ------------------------------------------------------------- pragmas

    def suppressed_codes(self, line: int) -> Optional[Set[str]]:
        """Codes suppressed at ``line`` (empty set = all codes), or
        None when no pragma applies. A pragma on its own line covers
        the next source line."""
        cache = getattr(self, "_pragma_cache", None)
        if cache is None:
            cache = self._pragma_cache = self._parse_pragmas()
        return cache.get(line)

    def _parse_pragmas(self) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if not m:
                continue
            codes: Set[str] = set()
            if m.group("codes"):
                codes = {c.strip() for c in m.group("codes").split(",")
                         if c.strip()}
            target = i
            if text[:m.start()].strip() == "":
                target = i + 1  # bare pragma line covers the next line
            prev = out.get(target)
            if prev is not None:
                # merging an ignore-all (empty set) with a code list
                # keeps ignore-all
                codes = set() if (not prev or not codes) else prev | codes
            out[target] = codes
        return out

    def is_suppressed(self, finding: Finding) -> bool:
        codes = self.suppressed_codes(finding.line)
        if codes is None:
            return False
        return not codes or finding.code in codes


class Checker:
    """Base class. Subclasses set ``code``/``name``/``description`` and
    implement :meth:`check_module`."""

    code: str = "RTPU000"
    name: str = "base"
    description: str = ""

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Checker]] = {}


def register(cls: Type[Checker]) -> Type[Checker]:
    if cls.code in _REGISTRY:
        raise ValueError(f"duplicate checker code {cls.code}")
    _REGISTRY[cls.code] = cls
    return cls


def registry() -> Dict[str, Type[Checker]]:
    """code -> Checker class, with the default checker set loaded."""
    # importing the package registers every built-in checker
    from ray_tpu_torch.analysis import checkers  # noqa: F401
    return dict(sorted(_REGISTRY.items()))


def _instantiate(select: Optional[Iterable[str]] = None) -> List[Checker]:
    reg = registry()
    if select:
        sel = set(select)
        unknown = sel - set(reg)
        if unknown:
            raise ValueError(f"unknown checker codes: {sorted(unknown)}")
        reg = {c: k for c, k in reg.items() if c in sel}
    return [cls() for cls in reg.values()]


# --------------------------------------------------------------- execution

def analyze_source(source: str, path: str = "<string>",
                   relpath: Optional[str] = None,
                   config: Optional[Dict[str, Any]] = None,
                   select: Optional[Iterable[str]] = None,
                   respect_pragmas: bool = True) -> List[Finding]:
    """Run checkers over one source string (fixture-test entrypoint)."""
    tree = ast.parse(source, filename=path)
    ctx = ModuleContext(path, relpath or path, source, tree, config)
    out: List[Finding] = []
    for checker in _instantiate(select):
        for f in checker.check_module(ctx):
            if respect_pragmas and ctx.is_suppressed(f):
                continue
            out.append(f)
    out.sort(key=lambda f: (f.relpath, f.line, f.code))
    return out


def analyze_file(path: str, root: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 select: Optional[Iterable[str]] = None) -> List[Finding]:
    with open(path, encoding="utf-8", errors="replace") as fh:
        source = fh.read()
    relpath = os.path.relpath(path, root) if root else path
    try:
        return analyze_source(source, path=path, relpath=relpath,
                              config=config, select=select)
    except SyntaxError as e:
        return [Finding(code="RTPU000",
                        message=f"syntax error: {e.msg}",
                        path=path, relpath=relpath.replace(os.sep, "/"),
                        line=e.lineno or 1, col=e.offset or 0)]


def iter_py_files(paths: Iterable[str],
                  exclude: Optional[Iterable[str]] = None
                  ) -> Iterable[str]:
    """Yield ``*.py`` files under ``paths`` (files pass through),
    skipping ``__pycache__``-style dirs and ``exclude`` substrings."""
    excludes = list(exclude or [])

    def skip(p: str) -> bool:
        q = p.replace(os.sep, "/")
        return any(x in q for x in excludes)

    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py") and not skip(p):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    if not skip(full):
                        yield full


def analyze_paths(paths: Iterable[str], root: Optional[str] = None,
                  config: Optional[Dict[str, Any]] = None,
                  select: Optional[Iterable[str]] = None,
                  exclude: Optional[Iterable[str]] = None,
                  on_file: Optional[Callable[[str], None]] = None
                  ) -> List[Finding]:
    """Analyze every python file under ``paths``. ``root`` anchors the
    relative paths used by baseline fingerprints (defaults to the
    common parent of ``paths``)."""
    paths = list(paths)
    if root is None:
        root = os.path.commonpath([os.path.abspath(p) for p in paths]) \
            if paths else os.getcwd()
        if os.path.isfile(root):
            root = os.path.dirname(root)
    out: List[Finding] = []
    for fp in iter_py_files(paths, exclude=exclude):
        if on_file:
            on_file(fp)
        out.extend(analyze_file(fp, root=root, config=config,
                                select=select))
    out.sort(key=lambda f: (f.relpath, f.line, f.code))
    return out


# ----------------------------------------------------------- AST helpers
# shared by checkers; kept here so every checker resolves names the
# same way

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_no_nested_defs(node: ast.AST, *, skip_async: bool = True,
                        skip_sync: bool = True) -> Iterable[ast.AST]:
    """Yield descendants of ``node`` without entering nested function
    definitions (their bodies run in their own context, not the
    enclosing one). ``node`` itself is not yielded."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if isinstance(cur, ast.AsyncFunctionDef) and skip_async:
            continue
        if isinstance(cur, (ast.FunctionDef, ast.Lambda)) and skip_sync:
            continue
        stack.extend(ast.iter_child_nodes(cur))


def module_constants(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments (used to resolve
    constants passed where a checker wants a literal)."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            val = const_str(stmt.value)
            if val is not None:
                out[stmt.targets[0].id] = val
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name) \
                and stmt.value is not None:
            val = const_str(stmt.value)
            if val is not None:
                out[stmt.target.id] = val
    return out
