"""Cross-language function registry.

Reference analogue: python/ray/cross_language.py + the Java/C++ workers'
named-function invocation: a non-Python driver cannot ship pickled
callables, so it invokes functions a Python process REGISTERED by name,
with msgpack-native argument/return values (the wire format the whole
control plane already speaks).

    # Python side (e.g. the process running the ray:// client server)
    from ray_tpu_torch.util import cross_language
    cross_language.register_function("math.add", lambda a, b: a + b)

    // C++ side (src/cpp_client/ray_tpu_client.hpp)
    auto ref = client.CallNamed("math.add", {mp::Int(1), mp::Int(41)});
    int v = client.Get(ref).AsInt();   // 42

Copied from the JAX package's ``ray_tpu/util/cross_language.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

_lock = threading.Lock()
_registry: Dict[str, Callable] = {}


def register_function(name: str, fn: Callable):
    """Expose ``fn`` to non-Python drivers under ``name``."""
    if not callable(fn):
        raise TypeError("fn must be callable")
    with _lock:
        _registry[name] = fn


def unregister_function(name: str):
    with _lock:
        _registry.pop(name, None)


def get_function(name: str) -> Callable:
    with _lock:
        fn = _registry.get(name)
    if fn is None:
        raise KeyError(
            f"no cross-language function registered as {name!r} "
            f"(known: {sorted(_registry)})")
    return fn


def list_functions() -> List[str]:
    with _lock:
        return sorted(_registry)
