"""Client-side handle types for ray:// connections.

Reference analogue: python/ray/util/client/common.py (ClientObjectRef:104,
ClientActorHandle, ClientRemoteFunc). Handles hold only an id; every
operation rides the msgpack protocol to the client server, which owns the
real refs/handles.

Copied from the JAX package's ``ray_tpu/util/client/common.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


def _current_client():
    from ray_tpu_torch.util.client import worker as client_worker
    c = client_worker._client
    if c is None:
        raise RuntimeError("no ray:// client connection active")
    return c


# Set by the server while deserializing client payloads so that pickled
# client handles resolve to the server-side real objects (see
# server.py _resolve_ref / _resolve_actor).
_server_resolver = threading.local()


def _rehydrate_ref(ref_hex: str):
    """Unpickle hook for ClientObjectRef: on the server this returns the
    REAL ObjectRef from the connection's table; on a client process it
    rebuilds a client ref."""
    resolver = getattr(_server_resolver, "table", None)
    if resolver is not None:
        return resolver.resolve_ref(ref_hex)
    return ClientObjectRef(ref_hex, owned=False)


def _rehydrate_actor(actor_hex: str, class_name: str):
    resolver = getattr(_server_resolver, "table", None)
    if resolver is not None:
        return resolver.resolve_actor(actor_hex)
    return ClientActorHandle(actor_hex, class_name)


class ClientObjectRef:
    """A future living in the cluster, named by the server-side ref hex."""

    def __init__(self, ref_hex: str, owned: bool = True):
        self._hex = ref_hex
        self._owned = owned

    def hex(self) -> str:
        return self._hex

    def binary(self) -> bytes:
        return bytes.fromhex(self._hex)

    def __hash__(self):
        return hash(self._hex)

    def __eq__(self, other):
        return isinstance(other, ClientObjectRef) and \
            other._hex == self._hex

    def __repr__(self):
        return f"ClientObjectRef({self._hex[:16]})"

    def __reduce__(self):
        return (_rehydrate_ref, (self._hex,))

    def __del__(self):
        if not self._owned:
            return
        try:
            from ray_tpu_torch.util.client import worker as client_worker
            c = client_worker._client
            if c is not None and c.connected:
                c.release(self._hex)
        except Exception:
            pass

    def future(self):
        import concurrent.futures
        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(_current_client().get([self], timeout=None)[0])
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut


class ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._name = name
        self._options = options or {}

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        return _current_client().actor_call(
            self._handle._hex, self._name, args, kwargs)

    def options(self, **opts) -> "ClientActorMethod":
        return ClientActorMethod(self._handle, self._name, opts)

    def __call__(self, *a, **k):
        raise TypeError(f"Actor methods cannot be called directly; use "
                        f".{self._name}.remote()")


class ClientActorHandle:
    def __init__(self, actor_hex: str, class_name: str = ""):
        self._hex = actor_hex
        self._class_name = class_name

    @property
    def _id_hex(self) -> str:
        return self._hex

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self, name)

    def __repr__(self):
        return f"ClientActorHandle({self._class_name}, {self._hex[:12]})"

    def __reduce__(self):
        return (_rehydrate_actor, (self._hex, self._class_name))


