"""Where the runtime's three C++ libraries come from and go.

The sources are the port's own copies (``_private/csrc/``: ``rpcx.cc``,
``store.cc``, ``schedcore.cc``, copied from the JAX package's ``src/``);
each library is built with ``g++`` on first use into
``ray_tpu_torch/core/`` (git-ignored ``*.so``), never into the JAX
package's ``ray_tpu/core/``, so the two packages never race on one file.
A build goes to a temp file and is renamed into place, so processes that
start at once on a fresh checkout do not corrupt each other's build.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
CORE = os.path.join(os.path.dirname(_HERE), "core")


def paths(source: str, lib: str) -> Tuple[str, str]:
    """(source path, library path) for ``csrc/<source>`` and
    ``core/<lib>``."""
    return os.path.join(CSRC, source), os.path.join(CORE, lib)


def stale(src: str, out: str) -> bool:
    return not os.path.exists(out) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(out))


def build(src: str, out: str, libs: Sequence[str] = ()) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.check_call(
            ["g++", "-O2", "-fPIC", "-shared", "-o", tmp, src, *libs])
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
