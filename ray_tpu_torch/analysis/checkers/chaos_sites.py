"""RTPU004 — chaos sites must be declared before they're hit.

The chaos engine is only as trustworthy as its site catalog: a typo'd
site string in ``chaos.hit("raylet.dispach")`` silently never fires
and the fault path it was supposed to exercise ships untested. Sites
are therefore *declared* in ``ray_tpu_torch._private.chaos.SITES``
(site → ops → where injected — the same table docs/torch/
FAULT_TOLERANCE.md renders) and every ``chaos.hit(...)`` call must pass
a declared site, as a string literal or a module-level string constant
the checker can resolve.

The converse direction — every declared site is actually exercised by
the port's tests — is enforced by the registry round-trip in
``tests/test_torch_analysis.py`` (it needs the test tree, which the
per-module checker doesn't see).

The port's copy of ``ray_tpu/analysis/checkers/chaos_sites.py``: the
sites are the port's own ``_private/chaos.py``'s.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         call_name, const_str,
                                         module_constants, register)


def _declared_sites(ctx: ModuleContext) -> Set[str]:
    sites = ctx.config.get("chaos_sites")
    if sites is not None:
        return set(sites)
    from ray_tpu_torch._private.chaos import SITES
    return set(SITES)


@register
class ChaosSiteChecker(Checker):
    code = "RTPU004"
    name = "undeclared-chaos-site"
    description = ("chaos.hit(site) literal must match the declared "
                   "site registry in _private/chaos.py")

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        # the registry module itself declares the sites; hits inside it
        # are table plumbing, not injection points
        if ctx.relpath.endswith("_private/chaos.py"):
            return []
        out: List[Finding] = []
        sites: Optional[Set[str]] = None
        consts = None
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            # match any `<obj>.hit(...)` leaf: injection points go
            # through `chaos.hit` or a cached engine (`eng.hit`)
            if name is None or not (
                    name.rsplit(".", 1)[-1] == "hit"
                    or name == "chaos_hit"):
                continue
            if not node.args:
                continue
            if sites is None:
                sites = _declared_sites(ctx)
                consts = module_constants(ctx.tree)
            arg = node.args[0]
            site = const_str(arg)
            if site is None and isinstance(arg, ast.Name):
                site = consts.get(arg.id)
            if site is None:
                out.append(ctx.finding(
                    self.code, node,
                    "chaos.hit() site is not a string literal or "
                    "resolvable module-level constant — declared-site "
                    "conformance can't be checked statically"))
                continue
            if site not in sites:
                import difflib
                close = difflib.get_close_matches(site, sorted(sites),
                                                  n=1)
                hint = f" (did you mean `{close[0]}`?)" if close else ""
                out.append(ctx.finding(
                    self.code, node,
                    f"chaos site `{site}` is not declared in "
                    f"chaos.SITES{hint} — declare it (site → ops → "
                    f"where) or fix the literal"))
        return out
