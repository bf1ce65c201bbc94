"""Runtime environment materialization.

Role-equivalent to the reference's runtime_env stack
(reference: python/ray/_private/runtime_env/pip.py — venv per env,
packaging.py — working_dir/py_modules URI upload + content-addressed cache,
dashboard/modules/runtime_env/runtime_env_agent.py — per-node installer).

TPU-first redesign: no separate agent process — the raylet materializes
environments inline (venv creation offloaded to a thread) into a
content-addressed per-host cache, and workers are pooled keyed by env hash
(already the case in the worker pool). Fields supported:

  env_vars:    dict[str, str]                 (merged into worker env)
  working_dir: local dir (driver packs+uploads) or package URI
  py_modules:  list of local dirs/files or URIs (prepended to PYTHONPATH)
  pip:         list of requirement specs / local wheel paths
               (installed into a venv with --system-site-packages)
  conda:       env name / env dir / {"dependencies": [...]} spec
               (gated on a conda binary being installed on the host)
  container:   {"image": ..., "run_options": [...]} — worker runs inside
               the image via podman/docker (gated on the runtime binary;
               reference: runtime_env/container.py worker_setup_hook)
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import zipfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

PKG_PREFIX = "@pkg/"
URI_SCHEME = "gcs://"


def env_hash(runtime_env: Optional[Dict[str, Any]]) -> str:
    if not runtime_env:
        return ""
    return hashlib.sha1(
        json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:12]


def dir_fingerprint(path: str) -> str:
    """Cheap content fingerprint (mtime_ns + size over the tree) so driver-
    side upload caching notices edits between submits."""
    h = hashlib.sha1()
    if os.path.isfile(path):
        st = os.stat(path)
        h.update(f"{path}:{st.st_mtime_ns}:{st.st_size}".encode())
    else:
        for root, dirs, files in sorted(os.walk(path)):
            dirs.sort()
            for name in sorted(files):
                full = os.path.join(root, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                h.update(f"{os.path.relpath(full, path)}:"
                         f"{st.st_mtime_ns}:{st.st_size}".encode())
    return h.hexdigest()[:16]


# --------------------------------------------------------------- packaging

def _zip_dir(path: str, include_base: bool = False) -> bytes:
    """Deterministic zip of a directory tree (or single file).

    include_base=True keeps the top-level directory name in the archive —
    needed for py_modules (the extracted parent goes on PYTHONPATH, so the
    package dir itself must exist); working_dir extracts contents at the
    root (it becomes the cwd)."""
    buf = tempfile.SpooledTemporaryFile()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            base = os.path.abspath(path)
            arc_root = os.path.basename(base.rstrip(os.sep)) \
                if include_base else ""
            for root, dirs, files in sorted(os.walk(base)):
                dirs.sort()
                if "__pycache__" in root:
                    continue
                for name in sorted(files):
                    full = os.path.join(root, name)
                    rel = os.path.relpath(full, base)
                    zf.write(full, os.path.join(arc_root, rel))
    buf.seek(0)
    return buf.read()


def upload_local_paths(runtime_env: Dict[str, Any],
                       kv_put: Callable[[str, bytes], None]
                       ) -> Dict[str, Any]:
    """Driver side: replace local working_dir/py_modules paths with
    content-addressed URIs backed by GCS KV blobs (reference:
    packaging.py upload_package_to_gcs). Idempotent: URIs pass through."""
    if not runtime_env:
        return runtime_env
    out = dict(runtime_env)

    def _pack(path: str, include_base: bool) -> str:
        if path.startswith(URI_SCHEME):
            return path
        data = _zip_dir(path, include_base=include_base)
        digest = hashlib.sha1(data).hexdigest()[:20]
        uri = f"{URI_SCHEME}{digest}"
        kv_put(PKG_PREFIX + digest, data)
        return uri

    if isinstance(out.get("working_dir"), str) and \
            not out["working_dir"].startswith(URI_SCHEME) and \
            os.path.exists(out["working_dir"]):
        out["working_dir"] = _pack(out["working_dir"], include_base=False)
    if out.get("py_modules"):
        out["py_modules"] = [
            _pack(m, include_base=True)
            if os.path.exists(m) or m.startswith(URI_SCHEME) else m
            for m in out["py_modules"]]
    return out


# ------------------------------------------------------------ materialize

@dataclass
class MaterializedEnv:
    python_exe: str = sys.executable
    env_vars: Dict[str, str] = field(default_factory=dict)
    cwd: Optional[str] = None
    pythonpath: List[str] = field(default_factory=list)


def _extract_uri(uri: str, cache_dir: str,
                 kv_get: Callable[[str], Optional[bytes]]) -> str:
    digest = uri[len(URI_SCHEME):]
    dest = os.path.join(cache_dir, "pkg", digest)
    if os.path.isdir(dest):
        return dest
    blob = kv_get(PKG_PREFIX + digest)
    if blob is None:
        raise RuntimeError(f"package {uri} not found in GCS")
    # unique tmp per caller: concurrent materializations of the same URI
    # (batch submits) must not fight over one .tmp dir
    os.makedirs(os.path.join(cache_dir, "pkg"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{digest}-", dir=os.path.join(
        cache_dir, "pkg"))
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, dest)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.isdir(dest):  # a concurrent extract won; else re-raise
            raise
    return dest


def _ensure_pip_venv(reqs: List[str], cache_dir: str) -> str:
    """Create (or reuse) a venv with the given requirements installed.
    Returns its python executable (reference: pip.py PipProcessor)."""
    import fcntl
    key = hashlib.sha1(json.dumps(sorted(reqs)).encode()).hexdigest()[:16]
    venv_dir = os.path.join(cache_dir, "venvs", key)
    py = os.path.join(venv_dir, "bin", "python")
    marker = os.path.join(venv_dir, ".ready")
    if os.path.exists(marker):
        return py
    # cross-process/thread lock: the cache dir is shared by all raylets on
    # the host; without it two materializations rmtree each other mid-install
    # and a .ready marker could bless a corrupted venv
    os.makedirs(os.path.join(cache_dir, "venvs"), exist_ok=True)
    lock_path = os.path.join(cache_dir, "venvs", f".{key}.lock")
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            return _build_pip_venv_locked(reqs, venv_dir, py, marker)
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _build_pip_venv_locked(reqs: List[str], venv_dir: str, py: str,
                           marker: str) -> str:
    if os.path.exists(marker):  # re-check under the lock
        return py
    shutil.rmtree(venv_dir, ignore_errors=True)
    subprocess.check_call(
        [sys.executable, "-m", "venv", "--system-site-packages", venv_dir],
        stdout=subprocess.DEVNULL)
    # --system-site-packages chains to the BASE interpreter; when this
    # process itself runs in a venv (typical), the parent venv's packages
    # (numpy, jax, ...) would be invisible. Expose them via a .pth — the
    # new venv's own site-packages still shadows these (it sorts first).
    import sysconfig
    new_site = sysconfig.get_path(
        "purelib", vars={"base": venv_dir, "platbase": venv_dir})
    parent_sites = [p for p in sys.path
                    if p.endswith("site-packages") and os.path.isdir(p)]
    if parent_sites:
        with open(os.path.join(new_site, "_rtpu_parent_env.pth"), "w") as f:
            f.write("\n".join(parent_sites) + "\n")
    if reqs:
        # local wheel/sdist paths install with --no-index (offline);
        # name-based specs go through the configured index
        offline = all(os.path.exists(r) or r.startswith(("/", "."))
                      for r in reqs)
        cmd = [py, "-m", "pip", "install", "--no-input", "--quiet",
               "--disable-pip-version-check"]
        if offline:
            cmd.append("--no-index")
        subprocess.check_call(cmd + reqs, stdout=subprocess.DEVNULL)
    open(marker, "w").close()
    return py


def _conda_exe() -> Optional[str]:
    """The host's conda binary, if any (reference: conda.py get_conda_activate_commands
    resolving $CONDA_EXE). None means the feature is unavailable here."""
    exe = os.environ.get("CONDA_EXE") or shutil.which("conda")
    return exe if exe and os.path.exists(exe) else None


def _ensure_conda_env(spec: Any, cache_dir: str) -> str:
    """Resolve/create a conda env and return its python executable
    (reference: runtime_env/conda.py — named envs activate in place,
    dict specs materialize a content-addressed env). Raises RuntimeError
    when conda isn't installed — the feature is gated, not stubbed."""
    conda = _conda_exe()
    if conda is None:
        raise RuntimeError(
            "runtime_env['conda'] requires a conda installation "
            "(none found via $CONDA_EXE or PATH)")
    if isinstance(spec, str):
        if os.path.isdir(spec):  # explicit env dir
            return os.path.join(spec, "bin", "python")
        base = subprocess.check_output(
            [conda, "info", "--base"], text=True).strip()
        env_dir = os.path.join(base, "envs", spec)
        py = os.path.join(env_dir, "bin", "python")
        if not os.path.exists(py):
            raise RuntimeError(f"conda env {spec!r} not found at {env_dir}")
        return py
    # dict spec: content-addressed env under the shared cache, guarded by
    # the same flock discipline as pip venvs
    import fcntl
    key = hashlib.sha1(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    env_dir = os.path.join(cache_dir, "conda", key)
    py = os.path.join(env_dir, "bin", "python")
    marker = os.path.join(env_dir, ".ready")
    if os.path.exists(marker):
        return py
    os.makedirs(os.path.join(cache_dir, "conda"), exist_ok=True)
    lock_path = os.path.join(cache_dir, "conda", f".{key}.lock")
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if os.path.exists(marker):
            return py
        shutil.rmtree(env_dir, ignore_errors=True)
        yml = os.path.join(cache_dir, "conda", f"{key}.yml")
        with open(yml, "w") as f:
            json.dump(spec, f)  # YAML is a JSON superset
        subprocess.check_call(
            [conda, "env", "create", "-p", env_dir, "-f", yml, "--yes"],
            stdout=subprocess.DEVNULL)
        open(marker, "w").close()
    return py


def container_command(container: Dict[str, Any], session_dir: str,
                      cache_dir: str,
                      env_keys: Optional[List[str]] = None) -> List[str]:
    """Command prefix that wraps the worker in a container (reference:
    runtime_env/container.py — podman run with the session dir mounted).
    Gated on a runtime binary: $RTT_CONTAINER_RUNTIME overrides the
    podman/docker PATH lookup (and is how tests inject a fake).
    ``env_keys`` are forwarded with bare ``-e KEY`` (both podman and
    docker then read the value from the spawning environment, which the
    raylet populates via Popen(env=...))."""
    image = container.get("image")
    if not image:
        raise RuntimeError("runtime_env['container'] requires 'image'")
    runtime = os.environ.get("RTT_CONTAINER_RUNTIME") or \
        shutil.which("podman") or shutil.which("docker")
    if not runtime:
        raise RuntimeError(
            "runtime_env['container'] requires podman or docker "
            "(none found; set RTT_CONTAINER_RUNTIME to override)")
    cmd = [runtime, "run", "--rm", "--network=host", "--ipc=host",
           "-v", f"{session_dir}:{session_dir}",
           "-v", f"{cache_dir}:{cache_dir}"]
    for k in env_keys or ():
        cmd += ["-e", k]
    cmd += list(container.get("run_options") or [])
    cmd.append(image)
    return cmd


def materialize(runtime_env: Optional[Dict[str, Any]], cache_dir: str,
                kv_get: Callable[[str], Optional[bytes]]
                ) -> MaterializedEnv:
    """Node side: turn a runtime_env spec into concrete process parameters.
    Safe to call repeatedly — every artifact is content-addressed."""
    m = MaterializedEnv()
    if not runtime_env:
        return m
    os.makedirs(cache_dir, exist_ok=True)
    m.env_vars.update(runtime_env.get("env_vars") or {})
    wd = runtime_env.get("working_dir")
    if wd:
        if wd.startswith(URI_SCHEME):
            m.cwd = _extract_uri(wd, cache_dir, kv_get)
        elif os.path.isdir(wd):
            m.cwd = wd  # local path (same-host dev convenience)
        m.pythonpath.append(m.cwd or "")
    for mod in runtime_env.get("py_modules") or ():
        if mod.startswith(URI_SCHEME):
            m.pythonpath.append(_extract_uri(mod, cache_dir, kv_get))
        elif os.path.exists(mod):
            m.pythonpath.append(os.path.abspath(
                os.path.dirname(mod) if os.path.isfile(mod) else mod))
    if runtime_env.get("pip") and runtime_env.get("conda"):
        # the reference rejects this combination too (validation.py):
        # pip packages inside a conda env go in the conda spec's
        # nested {"dependencies": [..., {"pip": [...]}]} form
        raise ValueError(
            "runtime_env cannot specify both 'pip' and 'conda'; put pip "
            "packages inside the conda spec's dependencies.pip list")
    if runtime_env.get("pip"):
        reqs = list(runtime_env["pip"]) if not isinstance(
            runtime_env["pip"], dict) else \
            list(runtime_env["pip"].get("packages", []))
        m.python_exe = _ensure_pip_venv(reqs, cache_dir)
    if runtime_env.get("conda"):
        m.python_exe = _ensure_conda_env(runtime_env["conda"], cache_dir)
    m.pythonpath = [p for p in m.pythonpath if p]
    return m
