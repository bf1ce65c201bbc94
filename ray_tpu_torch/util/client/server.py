"""Client server: hosts ray:// connections inside a cluster process.

Reference analogue: python/ray/util/client/server/server.py (RayletServicer)
+ server/proxier.py. This server runs in a process that has a real driver
connection (ray_tpu_torch.init() already done); each client connection
gets its own table of real ObjectRefs/ActorHandles, freed wholesale on
disconnect. Client payloads are cloudpickle; real refs embedded in results
are swapped for client refs at serialization time (reducer_override) and
back at deserialization time (common._server_resolver).

Copied from the JAX package's ``ray_tpu/util/client/server.py``.
"""

from __future__ import annotations

import hashlib
import io
import pickle
import threading
from typing import Any, Dict, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private import protocol, worker as worker_mod
from ray_tpu_torch.util.client import common as client_common


class _ConnTable:
    """Per-connection real-object tables (the server-side ownership)."""

    def __init__(self):
        self.refs: Dict[str, Any] = {}  # ref hex -> real ObjectRef
        self.actors: Dict[str, Any] = {}  # actor hex -> real ActorHandle
        self.exports: Dict[str, Any] = {}  # sha -> (deserialized fn/cls, kind)

    def track_ref(self, ref) -> str:
        h = ref.hex()
        self.refs[h] = ref
        return h

    def resolve_ref(self, ref_hex: str):
        try:
            return self.refs[ref_hex]
        except KeyError:
            raise KeyError(f"unknown client ref {ref_hex[:16]} "
                           "(already released?)")

    def track_actor(self, handle) -> str:
        h = handle._id_hex
        self.actors[h] = handle
        return h

    def resolve_actor(self, actor_hex: str):
        try:
            return self.actors[actor_hex]
        except KeyError:
            raise KeyError(f"unknown client actor {actor_hex[:16]}")


class _ServerPickler(cloudpickle.CloudPickler):
    """Swaps real ObjectRefs/ActorHandles in outgoing values for client
    handles, registering them in the connection table on the way out."""

    def __init__(self, file, table: _ConnTable, **kw):
        super().__init__(file, **kw)
        self._table = table

    def reducer_override(self, obj):
        from ray_tpu_torch._private.worker import ObjectRef
        from ray_tpu_torch.actor import ActorHandle
        if isinstance(obj, ObjectRef):
            self._table.track_ref(obj)
            return (client_common._rehydrate_ref, (obj.hex(),))
        if isinstance(obj, ActorHandle):
            self._table.track_actor(obj)
            return (client_common._rehydrate_actor,
                    (obj._id_hex, obj._class_name))
        return NotImplemented


def _server_dumps(value: Any, table: _ConnTable) -> bytes:
    buf = io.BytesIO()
    _ServerPickler(buf, table, protocol=pickle.HIGHEST_PROTOCOL).dump(value)
    return buf.getvalue()


def _server_loads(data: bytes, table: _ConnTable) -> Any:
    client_common._server_resolver.table = table
    try:
        return cloudpickle.loads(data)
    finally:
        client_common._server_resolver.table = None


class ClientServer:
    """Serves ray:// clients on a TCP port. Blocking cluster calls run on
    a per-server executor thread pool so the protocol loop stays live."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        if not ray_tpu_torch.is_initialized():
            raise RuntimeError("ClientServer requires ray_tpu_torch.init() first")
        from concurrent.futures import ThreadPoolExecutor
        self._exec = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="ray-client-srv")
        self._io = protocol.EventLoopThread("ray-client-server")
        self._server = protocol.Server(self._handlers())
        self.port = self._io.run(self._server.start_tcp(host, port))

    # every handler: payload, conn -> result (async); blocking work hops
    # to the executor
    def _handlers(self):
        async def _run(fn, *args):
            import asyncio
            return await asyncio.get_running_loop().run_in_executor(
                self._exec, fn, *args)

        def table(conn) -> _ConnTable:
            t = conn.meta.get("client_table")
            if t is None:
                t = conn.meta["client_table"] = _ConnTable()
            return t

        async def client_hello(payload, conn):
            table(conn)
            return {"version": ray_tpu_torch.__version__,
                    "namespace": payload.get("namespace", "")}

        async def client_put(payload, conn):
            t = table(conn)

            def _do():
                value = _server_loads(payload["data"], t)
                return t.track_ref(ray_tpu_torch.put(value))
            return await _run(_do)

        async def client_get(payload, conn):
            t = table(conn)

            def _do():
                out = []
                for h in payload["ids"]:
                    try:
                        ref = t.resolve_ref(h)
                        value = ray_tpu_torch.get(ref,
                                            timeout=payload.get("timeout"))
                        out.append({"data": _server_dumps(value, t),
                                    "error": None})
                    except BaseException as e:  # ships to the client
                        out.append({"data": None,
                                    "error": cloudpickle.dumps(e)})
                return out
            return await _run(_do)

        async def client_wait(payload, conn):
            t = table(conn)

            def _do():
                refs = [t.resolve_ref(h) for h in payload["ids"]]
                ready, not_ready = ray_tpu_torch.wait(
                    refs, num_returns=payload["num_returns"],
                    timeout=payload.get("timeout"))
                return {"ready": [r.hex() for r in ready],
                        "not_ready": [r.hex() for r in not_ready]}
            return await _run(_do)

        async def client_release(payload, conn):
            t = table(conn)
            for h in payload.get("ids", []):
                t.refs.pop(h, None)

        async def client_export(payload, conn):
            # exports live in the per-connection table (freed on
            # disconnect) so a long-lived head serving many client
            # sessions doesn't grow memory without bound; the client's
            # sha->key cache is per-connection too, so re-export after
            # reconnect is automatic.
            t = table(conn)

            def _do():
                sha = hashlib.sha256(payload["data"]).hexdigest()[:32]
                if sha not in t.exports:
                    t.exports[sha] = (cloudpickle.loads(payload["data"]),
                                      payload.get("kind", "fn"))
                return sha
            return await _run(_do)

        async def client_task(payload, conn):
            t = table(conn)

            def _do():
                fn, _ = t.exports[payload["key"]]
                args, kwargs = _server_loads(payload["args"], t)
                opts = payload.get("opts") or {}
                rf = ray_tpu_torch.remote(fn) if not opts else \
                    ray_tpu_torch.remote(**opts)(fn)
                refs = rf.remote(*args, **kwargs)
                if not isinstance(refs, list):
                    refs = [refs]
                return [t.track_ref(r) for r in refs]
            return await _run(_do)

        async def client_actor_create(payload, conn):
            t = table(conn)

            def _do():
                cls, _ = t.exports[payload["key"]]
                args, kwargs = _server_loads(payload["args"], t)
                opts = payload.get("opts") or {}
                ac = ray_tpu_torch.remote(cls) if not opts else \
                    ray_tpu_torch.remote(**opts)(cls)
                handle = ac.remote(*args, **kwargs)
                return t.track_actor(handle)
            return await _run(_do)

        async def client_actor_call(payload, conn):
            t = table(conn)

            def _do():
                handle = t.resolve_actor(payload["actor_id"])
                args, kwargs = _server_loads(payload["args"], t)
                method = getattr(handle, payload["method"])
                return t.track_ref(method.remote(*args, **kwargs))
            return await _run(_do)

        async def client_cancel(payload, conn):
            t = table(conn)

            def _do():
                ref = t.resolve_ref(payload["id"])
                ray_tpu_torch.cancel(ref, force=payload.get("force", False))
                return True
            return await _run(_do)

        async def client_actor_kill(payload, conn):
            t = table(conn)

            def _do():
                handle = t.resolve_actor(payload["actor_id"])
                ray_tpu_torch.kill(handle,
                             no_restart=payload.get("no_restart", True))
                return True
            return await _run(_do)

        async def client_get_actor(payload, conn):
            t = table(conn)

            def _do():
                try:
                    handle = ray_tpu_torch.get_actor(
                        payload["name"],
                        namespace=payload.get("namespace"))
                except ValueError as e:
                    return {"error": str(e)}
                return {"actor_id": t.track_actor(handle),
                        "class_name": handle._class_name}
            return await _run(_do)

        # ---- raw (msgpack-native) surface for non-Python clients ----
        # Values ride as protocol-native msgpack structures, no pickling;
        # tasks are invoked by cross_language registry name (reference:
        # the Java/C++ workers' named-function invocation).

        async def client_put_raw(payload, conn):
            t = table(conn)

            def _do():
                return t.track_ref(ray_tpu_torch.put(payload["value"]))
            return await _run(_do)

        async def client_get_raw(payload, conn):
            t = table(conn)

            def _do():
                out = []
                for h in payload["ids"]:
                    try:
                        value = ray_tpu_torch.get(t.resolve_ref(h),
                                            timeout=payload.get("timeout"))
                        out.append({"value": value, "error": None})
                    except BaseException as e:
                        out.append({"value": None,
                                    "error": f"{type(e).__name__}: {e}"})
                return out
            return await _run(_do)

        async def client_call_named(payload, conn):
            t = table(conn)

            def _do():
                from ray_tpu_torch.util import cross_language
                fn = cross_language.get_function(payload["name"])
                opts = payload.get("opts") or {}
                rf = ray_tpu_torch.remote(fn) if not opts else \
                    ray_tpu_torch.remote(**opts)(fn)
                args = payload.get("args") or []
                refs = rf.remote(*args)
                if not isinstance(refs, list):
                    refs = [refs]
                return [t.track_ref(r) for r in refs]
            return await _run(_do)

        async def client_list_named(payload, conn):
            from ray_tpu_torch.util import cross_language
            return cross_language.list_functions()

        async def client_kv(payload, conn):
            def _do():
                from ray_tpu_torch._private import worker as wm
                w = wm.global_worker()
                op = payload["op"]
                if op == "put":
                    w.call_sync(w.gcs, "kv_put",
                                {"key": payload["key"],
                                 "value": payload["value"],
                                 "overwrite": True})
                    return True
                if op == "get":
                    r = w.call_sync(w.gcs, "kv_get",
                                    {"key": payload["key"]})
                    return r.get("value")
                raise ValueError(f"bad kv op {op!r}")
            return await _run(_do)

        async def client_cluster_info(payload, conn):
            def _do():
                kind = payload["kind"]
                if kind == "cluster_resources":
                    return ray_tpu_torch.cluster_resources()
                if kind == "available_resources":
                    return ray_tpu_torch.available_resources()
                if kind == "nodes":
                    return ray_tpu_torch.nodes()
                raise ValueError(f"unknown cluster info kind {kind!r}")
            return await _run(_do)

        async def _on_disconnect(conn):
            # wholesale release of the client's refs (owner-side GC kicks
            # in when the table entries drop)
            conn.meta.pop("client_table", None)

        return {
            "client_hello": client_hello,
            "client_put": client_put,
            "client_get": client_get,
            "client_wait": client_wait,
            "client_release": client_release,
            "client_export": client_export,
            "client_task": client_task,
            "client_cancel": client_cancel,
            "client_actor_create": client_actor_create,
            "client_actor_call": client_actor_call,
            "client_actor_kill": client_actor_kill,
            "client_get_actor": client_get_actor,
            "client_put_raw": client_put_raw,
            "client_get_raw": client_get_raw,
            "client_call_named": client_call_named,
            "client_list_named": client_list_named,
            "client_kv": client_kv,
            "client_cluster_info": client_cluster_info,
            "_on_disconnect": _on_disconnect,
        }

    def stop(self):
        self._server.close()
        self._io.stop()
        self._exec.shutdown(wait=False)
