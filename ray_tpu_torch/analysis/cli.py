"""``ray-tpu-torch lint`` / ``python -m ray_tpu_torch.analysis``.

Exit codes: 0 clean (baselined findings allowed), 1 unsuppressed
findings or stale baseline entries, 2 usage error. The tier-1 gate
(`tests/test_torch_analysis.py`) runs the same code path in-process.

The port's copy of ``ray_tpu/analysis/cli.py``: it lints
``ray_tpu_torch/`` by default, against ``.rtpulint-torch-baseline``, and
``--gen-docs`` writes ``docs/torch/``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ray_tpu_torch.analysis import baseline as baseline_mod
from ray_tpu_torch.analysis import reporter
from ray_tpu_torch.analysis.core import (analyze_paths, iter_py_files,
                                         registry)

DEFAULT_EXCLUDES = ["__pycache__", "/generated/", "_pb2.py"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray-tpu-torch lint",
        description=("rtpulint: project-aware static analysis — "
                     "enforces ray_tpu_torch's concurrency, resource and "
                     "wire-protocol invariants (see docs/"
                     "STATIC_ANALYSIS.md)"))
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to lint (default: the ray_tpu_torch "
                        "package next to this install)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--select", metavar="CODES",
                   help="comma list of checker codes to run "
                        "(default: all)")
    p.add_argument("--baseline", metavar="PATH", default=None,
                   help="baseline file (default: nearest "
                        f"{baseline_mod.DEFAULT_BASENAME} above the "
                        "first path)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings as the new baseline "
                        "(entries still need hand-written "
                        "justifications before the gate accepts them)")
    p.add_argument("--exclude", action="append", default=None,
                   metavar="SUBSTR",
                   help="path substrings to skip (repeatable; default "
                        f"{DEFAULT_EXCLUDES})")
    p.add_argument("--list-checkers", action="store_true",
                   help="print the checker catalog and exit")
    p.add_argument("--gen-docs", action="store_true",
                   help="regenerate docs/torch/CONFIGURATION.md and "
                        "the chaos-site table in "
                        "docs/torch/FAULT_TOLERANCE.md")
    p.add_argument("--check-docs", action="store_true",
                   help="like --gen-docs but fail (exit 1) instead of "
                        "writing when the committed docs are stale")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also print baselined findings")
    return p


def _default_paths() -> List[str]:
    import ray_tpu_torch
    return [os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))]


def _repo_root(paths: List[str]) -> str:
    root = os.path.abspath(paths[0])
    if os.path.isfile(root):
        root = os.path.dirname(root)
    # the package dir's parent is the repo root when linting
    # ray_tpu_torch/
    if os.path.basename(root) == "ray_tpu_torch":
        return os.path.dirname(root)
    return root


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_checkers:
        for code, cls in registry().items():
            print(f"{code}  {cls.name:28s} {cls.description}")
        return 0

    paths = args.paths or _default_paths()

    if args.gen_docs or args.check_docs:
        from ray_tpu_torch.analysis.docs_gen import generate_all
        results = generate_all(_repo_root(paths),
                               write=not args.check_docs)
        stale = [p for p, (_, changed) in results.items() if changed]
        for p in sorted(results):
            _, changed = results[p]
            state = ("STALE" if args.check_docs else "regenerated") \
                if changed else "up to date"
            print(f"{p}: {state}")
        return 1 if (args.check_docs and stale) else 0

    select = [c.strip() for c in args.select.split(",")] \
        if args.select else None
    excludes = args.exclude if args.exclude is not None \
        else list(DEFAULT_EXCLUDES)

    files = list(iter_py_files(paths, exclude=excludes))
    try:
        findings = analyze_paths(paths, select=select, exclude=excludes)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    bl_path = None
    if not args.no_baseline:
        bl_path = args.baseline or baseline_mod.default_path(paths[0])

    if args.write_baseline:
        target = bl_path or os.path.join(
            _repo_root(paths), baseline_mod.DEFAULT_BASENAME)
        baseline_mod.save(target, findings)
        print(f"wrote {len(findings)} entr(y/ies) to {target} — add a "
              f"justification comment to each before committing")
        return 0

    entries = []
    if bl_path and os.path.isfile(bl_path):
        try:
            entries = baseline_mod.load(bl_path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    unsuppressed, baselined, stale = baseline_mod.apply(findings,
                                                        entries)

    if args.as_json:
        print(reporter.render_json(unsuppressed, baselined, stale,
                                   files_scanned=len(files)))
    else:
        print(reporter.render_text(unsuppressed, baselined, stale,
                                   files_scanned=len(files),
                                   verbose=args.verbose))
    return 1 if (unsuppressed or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
