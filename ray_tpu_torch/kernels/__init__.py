"""Hand-written CUDA kernels for Hopper: build, load and launch counts.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface
(tile helpers shared between sources live in ``csrc/*.cuh``).
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library at
first use and loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). Libraries go to ``kernels/build/`` inside the
package, named by a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is reused.

Every build runs with ``-Xptxas -v`` and keeps the compiler's report
beside the library; ``resource_usage`` reads it (registers and spills
per kernel instance; ``python3 -m ray_tpu_torch.kernels`` prints it).

Every wrapper that launches a kernel adds one to that kernel's launch
count (``count_launch``), so a run can show that its main path went
through the kernel: ``reset_launch_counts()`` before, ``launch_counts()``
after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {}


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, every shared
    header in ``csrc/`` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all), one ``nvcc`` process
    per source, all started together. Returns name -> library path."""
    names = list(sources() if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, n + ".cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
        else:
            with open(_log_path(paths[n]), "w") as fh:
                fh.write(log)
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def _log_path(lib_path: str) -> str:
    return lib_path[:-3] + ".ptxas.txt"


_ENTRY = re.compile(r"Compiling entry function '([^']*)'")
# a kernel's name, then its template arguments in its mangled name:
# element type (paged decode, attention delta) and head dim (attention,
# attention delta) or query heads per kv head, then head dim (paged
# decode)
_NAME = re.compile(r"((?:flash_(?:fwd|dkv|dq)|whole_(?:fwd|bwd))_[a-z0-9]+"
                   r"|paged_decode_(?:split|combine|kernel)"
                   r"|attention_delta_kernel)"
                   r"(?:I(13__nv_bfloat16|f)?(?:Li(\d+)E)?(?:Li(\d+)E)?)?")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(log: str) -> List[dict]:
    """One dict per kernel instance in ``nvcc -Xptxas -v`` output:
    kernel, template head dim and element type (where the kernel takes
    them), registers per thread at launch, stack and spill bytes.
    Entries of other kernels are left out."""
    out: List[dict] = []
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            n = _NAME.search(m.group(1))
            arg = int(n.group(3)) if n and n.group(3) else None
            if n and n.group(1).startswith("paged_decode"):
                out.append({"kernel": n.group(1),
                            "d": int(n.group(4)) if n.group(4) else None})
                if arg is not None:
                    out[-1]["g"] = arg
            else:
                out.append({"kernel": n and n.group(1), "d": arg})
            if n and n.group(2):
                out[-1]["dtype"] = ("bfloat16" if n.group(2) != "f"
                                    else "float32")
        elif out and _SPILL.search(line):
            st, ss, sl = map(int, _SPILL.search(line).groups())
            out[-1].update(stack_bytes=st, spill_stores=ss, spill_loads=sl)
        elif out and _REGS.search(line):
            out[-1]["registers"] = int(_REGS.search(line).group(1))
    return [r for r in out if r["kernel"]]


def resource_usage(name: str) -> List[dict]:
    """``parse_ptxas`` of the build log of source ``name`` (built first
    if it is not)."""
    with open(_log_path(build([name])[name])) as fh:
        return parse_ptxas(fh.read())


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.rtt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def count_launch(name: str):
    with _lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts():
    with _lock:
        _launches.clear()
