"""Function/actor-class distribution via GCS KV.

Reference semantics: python/ray/_private/function_manager.py +
_private/import_thread.py — functions are cloudpickled once, exported to the
GCS KV keyed by hash, and lazily imported (and cached) in workers. Here the
fetch is pull-based at first use instead of an import thread; the cache is
per-process.
"""

from __future__ import annotations

import hashlib
import os
import sys
import sysconfig
import threading
from typing import Any, Dict

import cloudpickle

_STDLIB = sysconfig.get_paths().get("stdlib", "")
_SITE = sysconfig.get_paths().get("purelib", "")
_by_value_registered: set = set()


def _ensure_serializable_by_value(obj: Any, _depth: int = 0):
    """Functions/classes from user script modules (not site-packages or
    the framework itself) are pickled BY VALUE, so workers that can't
    import the driver's script still execute them (the reference ships
    the working_dir runtime env instead; by-value is the zero-install
    equivalent for single-file drivers). Closure cells and defaults are
    walked so captured user functions get the same treatment."""
    if _depth > 2:
        return
    closure = getattr(obj, "__closure__", None)
    if closure:
        for cell in closure:
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if callable(v) or isinstance(v, type):
                _ensure_serializable_by_value(v, _depth + 1)
    for d in (getattr(obj, "__defaults__", None) or ()):
        if callable(d) or isinstance(d, type):
            _ensure_serializable_by_value(d, _depth + 1)
    mod_name = getattr(obj, "__module__", None)
    if not mod_name or mod_name in ("__main__", "builtins"):
        return  # cloudpickle already handles __main__ by value
    if mod_name in _by_value_registered:
        return
    if mod_name == "ray_tpu_torch" or mod_name.startswith("ray_tpu_torch."):
        return
    mod = sys.modules.get(mod_name)
    mod_file = getattr(mod, "__file__", None)
    if mod is None or not mod_file:
        return
    mod_file = os.path.abspath(mod_file)
    # installed packages (any site-packages/dist-packages, incl. --user
    # installs) and the stdlib are importable on workers → by reference
    if ("site-packages" in mod_file or "dist-packages" in mod_file
            or (_STDLIB and mod_file.startswith(_STDLIB + os.sep))):
        return
    try:
        cloudpickle.register_pickle_by_value(mod)
        _by_value_registered.add(mod_name)
    except Exception:
        pass


class FunctionManager:
    def __init__(self, kv_call):
        """kv_call(method, payload) -> reply; bound to the process's GCS conn."""
        self._kv_call = kv_call
        self._cache: Dict[str, Any] = {}
        self._exported: set[str] = set()
        self._lock = threading.Lock()

    def export(self, obj: Any, kind: str = "fn") -> str:
        _ensure_serializable_by_value(obj)
        try:
            blob = cloudpickle.dumps(obj, protocol=5)
        except Exception:
            # a module registered by value may hold unpicklable state;
            # fall back to by-reference for everything we registered
            for m in list(_by_value_registered):
                mod = sys.modules.get(m)
                if mod is not None:
                    try:
                        cloudpickle.unregister_pickle_by_value(mod)
                    except Exception:
                        pass
                _by_value_registered.discard(m)
            blob = cloudpickle.dumps(obj, protocol=5)
        key = f"{kind}:{hashlib.sha1(blob).hexdigest()}"
        with self._lock:
            if key in self._exported:
                return key
        self._kv_call("kv_put", {"key": "@fn/" + key, "value": blob,
                                 "overwrite": False})
        with self._lock:
            self._exported.add(key)
            self._cache[key] = obj
        return key

    def fetch(self, key: str) -> Any:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        reply = self._kv_call("kv_get", {"key": "@fn/" + key})
        blob = reply.get("value")
        if blob is None:
            raise KeyError(f"function {key} not found in GCS")
        obj = cloudpickle.loads(blob)
        with self._lock:
            self._cache[key] = obj
        return obj
