"""Actor API: ``@ray_tpu_torch.remote`` classes, handles, and the actor transport.

Role-equivalent to the reference's python/ray/actor.py (ActorClass._remote
:657, ActorMethod._remote :161) over the direct actor transport
(core_worker/transport/direct_actor_task_submitter.cc): after creation, method
calls go *directly* to the actor's worker process over a peer connection with
no raylet involvement; the GCS only mediates creation, restarts, and naming
(gcs_actor_manager.cc semantics).

Copied from the JAX package's ``ray_tpu/actor.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._private import netx, serialization, worker as worker_mod
from ray_tpu_torch._private.worker import (ObjectRef, PendingTaskState,
                                     global_worker)
from ray_tpu_torch.common.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch.common.options import (resource_dict_from_options,
                                    validate_options)
from ray_tpu_torch import exceptions as exc


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._name = name
        self._options = options or {}

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._handle._remote_call(self._name, args, kwargs,
                                         self._options)

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, opts)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor methods cannot be called directly; use "
            f".{self._name}.remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str,
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries
        self._worker_address: Optional[str] = None
        # picked direct-lane endpoint (unix same-host, host:port off-box);
        # "" = none advertised — calls then ride the asyncio peer path
        self._direct_addr: str = ""
        self._seq = 0
        self._lock = threading.Lock()
        self._dead_reason: Optional[str] = None

    @property
    def _id_hex(self) -> str:
        return self._actor_id.hex()

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._max_task_retries))

    # ------------------------------------------------------------------ calls

    def _resolve_address(self, timeout: float = 120.0) -> str:
        w = global_worker()
        if self._worker_address:
            return self._worker_address
        info = w.call_sync(w.gcs, "wait_actor_alive",
                           {"actor_id": self._id_hex, "timeout": timeout},
                           timeout=timeout + 5)
        if info.get("error"):
            raise exc.ActorDiedError(self._id_hex, info["error"])
        if info["state"] == "DEAD":
            raise exc.ActorDiedError(self._id_hex,
                                     info.get("death_cause") or "dead")
        self._worker_address = info["worker_address"]
        self._direct_addr = netx.pick(info.get("direct_address"),
                                      info.get("direct_tcp_address"))
        return self._worker_address

    def _remote_call(self, method: str, args, kwargs,
                     opts: Dict[str, Any]) -> ObjectRef:
        w = global_worker()
        task_id = TaskID.for_task(w.current_task_id
                                  or TaskID.for_driver(w.job_id))
        # _serialize_args (not bare serialize): promotes large numpy args
        # to plasma AND pins contained refs via add_submitted — without the
        # pin, a temporary like m.remote(put(x)) lets the driver free the
        # arg object while the call is in flight, and the actor's arg
        # resolution waits forever on an object that will never reappear
        # (the un-pinned path wedged every Ape-X/IMPALA weight broadcast)
        arg_blob, _plasma_deps, arg_refs = w._serialize_args(
            list(args), kwargs)
        payload = {
            "task_id": task_id.hex(),
            "method": method,
            "args": arg_blob,
            # "seq"/"processed_up_to" are stamped at enqueue time below
            "caller": w.address,
            # span propagation (1.6): the executing actor adopts this
            # ctx so tasks it submits parent under the call, not under
            # the actor worker's own root trace
            "trace_ctx": w._trace_ctx_for_submit(),
        }
        oid = ObjectID.for_return(task_id, 0)
        state = PendingTaskState({"task_id": task_id.hex(),
                                  "fn_name": f"{self._class_name}.{method}",
                                  "arg_refs": arg_refs},
                                 self._max_task_retries, [oid])
        w.pending_tasks[task_id.hex()] = state
        w.reference_counter.add_owned(oid)

        async def _call(attempt: int = 0):
            try:
                await _call_inner(attempt)
            except BaseException as e:  # noqa: BLE001 — last resort
                # a send task dying WITHOUT storing a result strands the
                # caller forever (observed rarely under load); convert
                # any leak through the structured paths below into a
                # visible, retryable error instead
                if not state.done:
                    _store_actor_error(w, state, exc.ActorUnavailableError(
                        f"actor call send task failed: "
                        f"{type(e).__name__}: {e}"))
                    w.mark_actor_seq_done(self._id_hex, payload["seq"])

        async def _call_inner(attempt: int = 0):
            try:
                # cached-address fast path: no executor hop, so the task
                # body runs straight through conn.call's synchronous
                # write — event-loop start order (= seq order, see the
                # enqueue below) is then the wire order, and receiver-
                # side parking stays a cold-start/retry backstop instead
                # of a steady-state cost
                addr = self._worker_address
                if addr is None:
                    addr = await _to_thread(self._resolve_address)
                # retries skip the direct lane: a severed TCP direction
                # (net.partition) must not pin every retry to the dead
                # fast path while the worker's own socket still answers
                direct = self._direct_addr if attempt == 0 else ""
                nx = netx.get_client() if direct else None
                if nx is not None:
                    # direct lane (1.8): frame goes out inside call_async
                    # itself, so event-loop start order is still the wire
                    # order; failures surface as ConnectionError and take
                    # the same restart/retry path as a dropped peer conn
                    ret = await nx.call_async(direct, "actor_call", payload)
                else:
                    conn = await w._peer(addr)
                    ret = await conn.call("actor_call", payload)
                _store_actor_result(w, state, ret)
                w.mark_actor_seq_done(self._id_hex, payload["seq"])
            except exc.ActorDiedError as e:
                _store_actor_error(w, state, e)
                w.mark_actor_seq_done(self._id_hex, payload["seq"])
            except Exception as e:  # connection error → maybe restart
                self._worker_address = None
                self._direct_addr = ""
                info = None
                try:
                    info = await w.gcs.call(
                        "get_actor", {"actor_id": self._id_hex})
                except Exception:
                    pass
                restartable = info and info.get("state") in (
                    "RESTARTING", "PENDING_CREATION", "ALIVE")
                if restartable and (self._max_task_retries == -1
                                    or attempt < max(self._max_task_retries, 0)):
                    await _to_thread(time.sleep, 0.2)
                    await _call_inner(attempt + 1)
                elif restartable and self._max_task_retries == 0:
                    _store_actor_error(
                        w, state, exc.ActorUnavailableError(
                            f"actor {self._id_hex[:8]} restarting; call not "
                            f"retried (max_task_retries=0): {e}"))
                    w.mark_actor_seq_done(self._id_hex, payload["seq"])
                else:
                    reason = (info or {}).get("death_cause") or str(e)
                    _store_actor_error(
                        w, state, exc.ActorDiedError(self._id_hex, reason))
                    w.mark_actor_seq_done(self._id_hex, payload["seq"])

        # seq allocation and event-loop enqueue are ATOMIC: sequence
        # numbers are per (process, actor) in caller program order, and
        # run_coroutine_threadsafe preserves enqueue order, so with the
        # fast path above the frames leave in seq order (reference:
        # actor_scheduling_queue.cc per-caller ordering; the receiver
        # parks out-of-order arrivals as the backstop)
        seq = w.enqueue_actor_call(self._id_hex, payload, _call)
        return ObjectRef(oid, w.address)


async def _to_thread(fn, *args):
    import asyncio
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


def _release_submitted_args(w, state: PendingTaskState):
    for hex_ref, _owner in state.spec.get("arg_refs", []):
        w.reference_counter.remove_submitted(ObjectID.from_hex(hex_ref))
    state.spec["arg_refs"] = []


def _store_actor_result(w, state: PendingTaskState, ret: Dict[str, Any]):
    _release_submitted_args(w, state)
    oid = ObjectID.from_hex(ret["object_id"])
    target = state.return_ids[0]
    if ret.get("inline") is not None:
        w.memory_store.put(target, ret["inline"])
    else:
        ind = worker_mod._PlasmaIndirect(ret.get("node_id", ""))
        # the actor shipped the value under its own oid; alias it
        if oid != target:
            w.memory_store.put(target,
                               serialization.serialize(ind).to_bytes())
        else:
            w.memory_store.put(target,
                               serialization.serialize(ind).to_bytes())
    state.done = True
    state.result_event.set()


def _store_actor_error(w, state: PendingTaskState, e: Exception):
    """A call that failed in transport or with its actor's death. A
    return the actor already sealed in this node's plasma resolves to
    its value: ``wait`` reports such a return ready before the reply
    arrives, so a caller may kill the actor (a Dataset actor pool does,
    once every block is ready) and lose the reply, not the result."""
    _release_submitted_args(w, state)
    payload = serialization.serialize_error(e).to_bytes()
    for oid in state.return_ids:
        if w.plasma is not None and w.plasma.contains(oid):
            w.memory_store.put(oid, serialization.serialize(
                worker_mod._PlasmaIndirect(w.node_id)).to_bytes())
        else:
            w.memory_store.put(oid, payload)
    state.done = True
    state.result_event.set()


def _normalize_concurrency_groups(groups) -> Dict[str, int]:
    """Accept {name: n} or the reference's [{"name":..,
    "max_concurrency":..}] list form (actor concurrency groups)."""
    if not groups:
        return {}
    if isinstance(groups, dict):
        return {str(k): int(v) for k, v in groups.items()}
    out = {}
    for g in groups:
        out[str(g["name"])] = int(g.get("max_concurrency", 1))
    return out


class ActorClass:
    """Result of decorating a class with ``@ray_tpu_torch.remote``."""

    def __init__(self, cls, default_opts: Dict[str, Any]):
        self._cls = cls
        self._default_opts = validate_options(default_opts, is_actor=True)
        self._class_key: Optional[str] = None
        self._class_key_mgr = None

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actors must be created with {self._cls.__name__}.remote()")

    def options(self, **opts) -> "_BoundActorClass":
        merged = {**self._default_opts, **validate_options(opts, is_actor=True)}
        return _BoundActorClass(self, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._create(self._default_opts, args, kwargs)

    def bind(self, *args, **kwargs):
        """DAG authoring (reference: python/ray/dag ClassNode)."""
        from ray_tpu_torch.dag import ClassNode
        return ClassNode(self, args, kwargs, self._default_opts)

    def _create(self, opts: Dict[str, Any], args, kwargs) -> ActorHandle:
        from ray_tpu_torch.util.client.worker import client_mode
        c = client_mode()
        if c is not None and c.connected:
            return c.create_actor(self._cls, args, kwargs, opts)
        w = global_worker()
        if self._class_key is None or \
                self._class_key_mgr is not w.function_manager:
            self._class_key = w.function_manager.export(self._cls, kind="cls")
            self._class_key_mgr = w.function_manager
        actor_id = ActorID.of(w.job_id)
        # same pinning as method calls: Actor.remote(put(x)) must keep x
        # alive until the constructor has run. Released once the actor
        # settles (ALIVE or DEAD) — note a later RESTART re-running the
        # constructor after release relies on lineage reconstruction.
        arg_blob, _deps, arg_refs = w._serialize_args(list(args), kwargs)

        def _release_ctor_args():
            if not arg_refs:
                return

            async def _go():
                try:
                    await w.gcs.call(
                        "wait_actor_alive",
                        {"actor_id": actor_id.hex(), "timeout": 600},
                        timeout=610)
                except Exception:
                    pass
                for hex_ref, _owner in arg_refs:
                    w.reference_counter.remove_submitted(
                        ObjectID.from_hex(hex_ref))
            try:
                w.io.run_async(_go())
            except Exception:
                pass

        resources = resource_dict_from_options(opts, is_actor=True)
        sched = w._scheduling_from_opts(opts)
        pg = w._pg_from_opts(opts)
        create_spec = {
            "actor_id": actor_id.hex(),
            "class_key": self._class_key,
            "class_name": self._cls.__name__,
            "init_args": arg_blob,
            "max_concurrency": opts.get("max_concurrency", 1),
            "concurrency_groups": _normalize_concurrency_groups(
                opts.get("concurrency_groups")),
            "runtime_env": w.prepare_runtime_env(opts.get("runtime_env")),
            "placement_group": pg,
            "job_id": w.job_id.hex(),
        }
        reg = w.call_sync(w.gcs, "register_actor", {
            "actor_id": actor_id.hex(),
            "name": opts.get("name"),
            "namespace": opts.get("namespace", w.namespace),
            "class_name": self._cls.__name__,
            "owner_address": w.address,
            "detached": opts.get("lifetime") == "detached",
            "resources": resources,
            "max_restarts": opts.get(
                "max_restarts", w.config.actor_max_restarts_default),
            "scheduling": sched,
            "get_if_exists": opts.get("get_if_exists", False),
            "create_spec": create_spec,
        })
        if reg.get("error") or reg.get("existing"):
            # no creation will run: drop the constructor-arg pins now
            for hex_ref, _owner in arg_refs:
                w.reference_counter.remove_submitted(
                    ObjectID.from_hex(hex_ref))
            if reg.get("error"):
                raise ValueError(reg["error"])
            return get_actor_by_id(reg["actor_id"])
        try:
            w.call_sync(w.gcs, "create_actor", {
                "actor_id": actor_id.hex(), "create_spec": create_spec})
        except BaseException:
            for hex_ref, _owner in arg_refs:
                w.reference_counter.remove_submitted(
                    ObjectID.from_hex(hex_ref))
            raise
        _release_ctor_args()
        return ActorHandle(actor_id, self._cls.__name__,
                           opts.get("max_task_retries", 0))


class _BoundActorClass:
    def __init__(self, actor_class: ActorClass, opts: Dict[str, Any]):
        self._actor_class = actor_class
        self._opts = opts

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._actor_class._create(self._opts, args, kwargs)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode
        return ClassNode(self._actor_class, args, kwargs, self._opts)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    from ray_tpu_torch.util.client.worker import client_mode
    c = client_mode()
    if c is not None and c.connected:
        return c.get_named_actor(name, namespace)
    w = global_worker()
    info = w.call_sync(w.gcs, "get_named_actor", {
        "name": name, "namespace": namespace if namespace is not None
        else w.namespace})
    if info.get("error"):
        raise ValueError(info["error"])
    handle = ActorHandle(ActorID.from_hex(info["actor_id"]),
                         info.get("class_name", ""))
    if info.get("worker_address"):
        handle._worker_address = info["worker_address"]
        handle._direct_addr = netx.pick(info.get("direct_address"),
                                        info.get("direct_tcp_address"))
    return handle


def get_actor_by_id(actor_id_hex: str) -> ActorHandle:
    w = global_worker()
    info = w.call_sync(w.gcs, "get_actor", {"actor_id": actor_id_hex})
    if info.get("error"):
        raise ValueError(info["error"])
    handle = ActorHandle(ActorID.from_hex(actor_id_hex),
                         info.get("class_name", ""))
    if info.get("worker_address"):
        handle._worker_address = info["worker_address"]
        handle._direct_addr = netx.pick(info.get("direct_address"),
                                        info.get("direct_tcp_address"))
    return handle


def kill(actor: ActorHandle, *, no_restart: bool = True):
    w = global_worker()
    w.call_sync(w.gcs, "kill_actor", {"actor_id": actor._id_hex,
                                      "no_restart": no_restart})
