"""rtpulint — project-aware static analysis for ray_tpu_torch.

Enforces the concurrency, resource and wire-protocol invariants the
substrate's bug history keeps re-teaching (blocking calls on event
loops, locks across ``await``, unpaired incref/decref and daemon
threads, undeclared chaos sites, unregistered ``RTT_*`` knobs,
unguarded version-gated wire fields, silent swallows in control
loops). Runs in tier-1 over ``ray_tpu_torch/``
(``tests/test_torch_analysis.py``); the workflow and the checker
catalog are the JAX package's (docs/STATIC_ANALYSIS.md), with the
port's registries, baseline file and generated docs (``docs/torch/``).

    ray-tpu-torch lint [--json] [paths...]
    python -m ray_tpu_torch.analysis --list-checkers

Public surface: :func:`analyze_paths` / :func:`analyze_source` for
programmatic runs, :class:`Finding`, :func:`registry`, and the
:mod:`~ray_tpu_torch.analysis.baseline` helpers.

The port's copy of ``ray_tpu/analysis/__init__.py``: the same codes
(RTPU001-RTPU007) and pragma syntax (``# rtpulint: ignore[...]``), over
``ray_tpu_torch/`` and its ``RTT_*`` knobs.
"""

from ray_tpu_torch.analysis.core import (Checker, Finding, ModuleContext,
                                         analyze_file, analyze_paths,
                                         analyze_source, register,
                                         registry)

__all__ = ["Checker", "Finding", "ModuleContext", "analyze_file",
           "analyze_paths", "analyze_source", "register", "registry"]
