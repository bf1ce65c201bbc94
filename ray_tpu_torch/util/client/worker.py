"""Client-side ray:// connection: routes the public API over the wire.

Reference analogue: python/ray/util/client/worker.py:81 (Worker.connect,
get :225, put :379, remote :508). The transport is the same msgpack
protocol the rest of the control plane speaks (protocol.py) instead of
gRPC; values cross as cloudpickle payloads with handle types swapped at
(de)serialization boundaries (common.py rehydrate hooks).

Copied from the JAX package's ``ray_tpu/util/client/worker.py``.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch._private import protocol
from ray_tpu_torch.util.client.common import ClientActorHandle, ClientObjectRef

_client: Optional["ClientWorker"] = None


def client_mode() -> Optional["ClientWorker"]:
    return _client


class ClientWorker:
    def __init__(self, address: str, namespace: str = "",
                 timeout: float = 30.0):
        # address: "host:port" (the ray:// prefix already stripped)
        self._address = address
        self._io = protocol.EventLoopThread("ray-client")
        self._conn = self._io.run(protocol.connect(address))
        self._lock = threading.Lock()
        self._fn_keys: Dict[str, str] = {}  # content sha -> server key
        self.connected = True
        self.namespace = namespace
        info = self._call("client_hello", {"namespace": namespace},
                          timeout=timeout)
        self.server_info = info

    # ------------------------------------------------------------ plumbing

    def _call(self, method: str, payload: Any,
              timeout: Optional[float] = 120.0) -> Any:
        if not self.connected:
            raise ConnectionError("ray:// client disconnected")
        return self._io.run(
            self._conn.call(method, payload, timeout=timeout),
            timeout=(timeout + 10) if timeout else None)

    def disconnect(self):
        self.connected = False
        try:
            self._conn.close()
        finally:
            self._io.stop()

    # ------------------------------------------------------------- objects

    def put(self, value: Any) -> ClientObjectRef:
        if isinstance(value, (ClientObjectRef, ClientActorHandle)):
            raise TypeError("put() of a ref/handle is not allowed "
                            "(same restriction as the reference client)")
        data = cloudpickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        ref_hex = self._call("client_put", {"data": data})
        return ClientObjectRef(ref_hex)

    def get(self, refs: Sequence[ClientObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        out = self._call("client_get",
                         {"ids": [r.hex() for r in refs],
                          "timeout": timeout},
                         timeout=None if timeout is None
                         else timeout + 30.0)
        values = []
        for item in out:
            if item.get("error") is not None:
                raise cloudpickle.loads(item["error"])
            values.append(cloudpickle.loads(item["data"]))
        return values

    def wait(self, refs: Sequence[ClientObjectRef], num_returns: int,
             timeout: Optional[float]
             ) -> Tuple[List[ClientObjectRef], List[ClientObjectRef]]:
        by_hex = {r.hex(): r for r in refs}
        out = self._call("client_wait",
                         {"ids": [r.hex() for r in refs],
                          "num_returns": num_returns, "timeout": timeout},
                         timeout=None if timeout is None
                         else timeout + 30.0)
        ready = [by_hex[h] for h in out["ready"]]
        not_ready = [by_hex[h] for h in out["not_ready"]]
        return ready, not_ready

    def release(self, ref_hex: str):
        try:
            self._io.run(
                self._conn.notify("client_release", {"ids": [ref_hex]}),
                timeout=5.0)
        except Exception:
            pass

    # --------------------------------------------------------------- tasks

    def _export_fn(self, fn, kind: str) -> str:
        # cache by CONTENT hash — an id(fn) key outlives the function
        # object and a reused address would submit the wrong code
        import hashlib
        data = cloudpickle.dumps(fn, protocol=pickle.HIGHEST_PROTOCOL)
        sha = hashlib.sha256(data).hexdigest()
        key = self._fn_keys.get(sha)
        if key is None:
            key = self._call("client_export", {"data": data, "kind": kind})
            self._fn_keys[sha] = key
        return key

    def submit_fn(self, fn, args, kwargs, opts: Dict[str, Any]):
        key = self._export_fn(fn, "fn")
        payload = {
            "key": key,
            "args": cloudpickle.dumps((list(args), kwargs),
                                      protocol=pickle.HIGHEST_PROTOCOL),
            "opts": _clean_opts(opts),
        }
        ref_hexes = self._call("client_task", payload)
        refs = [ClientObjectRef(h) for h in ref_hexes]
        num_returns = opts.get("num_returns")
        if num_returns is None or num_returns == 1:
            return refs[0]
        return refs

    # -------------------------------------------------------------- actors

    def create_actor(self, cls, args, kwargs,
                     opts: Dict[str, Any]) -> ClientActorHandle:
        key = self._export_fn(cls, "cls")
        payload = {
            "key": key,
            "class_name": cls.__name__,
            "args": cloudpickle.dumps((list(args), kwargs),
                                      protocol=pickle.HIGHEST_PROTOCOL),
            "opts": _clean_opts(opts),
        }
        actor_hex = self._call("client_actor_create", payload)
        return ClientActorHandle(actor_hex, cls.__name__)

    def actor_call(self, actor_hex: str, method: str, args,
                   kwargs) -> ClientObjectRef:
        payload = {
            "actor_id": actor_hex,
            "method": method,
            "args": cloudpickle.dumps((list(args), kwargs),
                                      protocol=pickle.HIGHEST_PROTOCOL),
        }
        ref_hex = self._call("client_actor_call", payload)
        return ClientObjectRef(ref_hex)

    def cancel(self, ref_hex: str, force: bool = False):
        self._call("client_cancel", {"id": ref_hex, "force": force})

    def kill_actor(self, actor_hex: str, no_restart: bool = True):
        self._call("client_actor_kill",
                   {"actor_id": actor_hex, "no_restart": no_restart})

    def get_named_actor(self, name: str,
                        namespace: Optional[str]) -> ClientActorHandle:
        out = self._call("client_get_actor",
                         {"name": name, "namespace": namespace})
        if out.get("error"):
            raise ValueError(out["error"])
        return ClientActorHandle(out["actor_id"],
                                 out.get("class_name", ""))

    # ------------------------------------------------------------- cluster

    def cluster_info(self, kind: str) -> Any:
        return self._call("client_cluster_info", {"kind": kind})


def _clean_opts(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Only msgpack-able option values cross the wire."""
    out = {}
    for k, v in (opts or {}).items():
        if isinstance(v, (str, int, float, bool, type(None))):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _clean_opts(v)
        elif isinstance(v, (list, tuple)):
            out[k] = list(v)
    return out


def connect(address: str, namespace: str = "") -> ClientWorker:
    """Establish the global ray:// connection (address without scheme)."""
    global _client
    if _client is not None and _client.connected:
        raise RuntimeError("ray:// client already connected")
    _client = ClientWorker(address, namespace=namespace)
    return _client


def disconnect():
    global _client
    if _client is not None:
        _client.disconnect()
        _client = None
