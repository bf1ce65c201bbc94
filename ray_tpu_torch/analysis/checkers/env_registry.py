"""RTPU005 — every ``RTT_*`` env read must be in the config registry.

Dozens of ``RTT_*`` environment variables steer the port, and nothing
ever tied them together: a typo'd read (``RTT_TRACE_SAMPEL``) is a
knob that silently does nothing, and an undocumented knob might as
well not exist. The authoritative registry is
``ray_tpu_torch.analysis.config_registry.CONFIG_VARS`` (rendered to
docs/torch/CONFIGURATION.md by ``python -m ray_tpu_torch.analysis
--gen-docs``);
this checker finds every environment read of an ``RTT_*`` name —
``os.environ.get/[]/setdefault``, ``os.getenv``, ``in os.environ`` —
and fails on names missing from the registry, with near-miss typo
detection against the registered names.

Stale registry entries (registered but never read) are caught by the
round-trip test in ``tests/test_torch_analysis.py``.

The port's copy of ``ray_tpu/analysis/checkers/env_registry.py``: it
checks the ``RTT_*`` names (the JAX package's ``RTPU_*`` names are
never read by the port, and this checker leaves them alone).
"""

from __future__ import annotations

import ast
import difflib
from typing import Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         call_name, const_str, dotted_name,
                                         register)


def env_reads(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    """All (env-var-name, node) reads in the module, every access
    idiom. Only constant-resolvable names are returned."""
    out: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name is None:
                continue
            if name.endswith("os.getenv") or name == "getenv":
                if node.args:
                    v = const_str(node.args[0])
                    if v:
                        out.append((v, node))
            elif name.endswith("environ.get") \
                    or name.endswith("environ.setdefault") \
                    or name.endswith("environ.pop"):
                if node.args:
                    v = const_str(node.args[0])
                    if v:
                        out.append((v, node))
        elif isinstance(node, ast.Subscript):
            base = dotted_name(node.value)
            if base and base.endswith("environ"):
                v = const_str(node.slice)
                if v:
                    out.append((v, node))
        elif isinstance(node, ast.Compare):
            # "X" in os.environ
            if len(node.ops) == 1 and isinstance(node.ops[0],
                                                 (ast.In, ast.NotIn)):
                base = dotted_name(node.comparators[0])
                if base and base.endswith("environ"):
                    v = const_str(node.left)
                    if v:
                        out.append((v, node))
    return out


def _registered(ctx: ModuleContext) -> Set[str]:
    reg = ctx.config.get("env_registry")
    if reg is not None:
        return set(reg)
    from ray_tpu_torch.analysis.config_registry import CONFIG_VARS
    return set(CONFIG_VARS)


@register
class EnvRegistryChecker(Checker):
    code = "RTPU005"
    name = "unregistered-env-var"
    description = ("RTT_* env read missing from the config registry "
                   "(docs/torch/CONFIGURATION.md) — typo or undocumented "
                   "knob")

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        registered: Optional[Set[str]] = None
        for name, node in env_reads(ctx.tree):
            if not name.startswith("RTT_"):
                continue
            if registered is None:
                registered = _registered(ctx)
            if name in registered:
                continue
            close = difflib.get_close_matches(
                name, sorted(registered), n=1, cutoff=0.8)
            if close:
                msg = (f"env var `{name}` is not in the config "
                       f"registry — near-miss of registered "
                       f"`{close[0]}`; likely a typo")
            else:
                msg = (f"env var `{name}` is not in the config "
                       f"registry — add it to "
                       f"analysis/config_registry.py (and regenerate "
                       f"docs/torch/CONFIGURATION.md) or remove the "
                       f"read")
            out.append(ctx.finding(self.code, node, msg))
        return out
