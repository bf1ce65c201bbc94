"""The per-process core runtime: driver and worker share this.

Copied from the JAX package's ``ray_tpu/_private/worker.py``: a worker
holds its granted GPU indices (``gpu_ids``) where JAX holds TPU chips,
and the compiled-DAG and ``air.session`` branches raise
``NotImplementedError`` naming their ROADMAP items.

Role-equivalent to the reference's CoreWorker + the Python worker layer
(reference: src/ray/core_worker/core_worker.cc SubmitTask:1621 / Get:1143 /
Put:936 / ExecuteTask:2235; python/ray/_private/worker.py). Every process —
driver or worker — embeds one ``Worker``:

  - an RPC server on a unix socket (the process's "core worker service";
    reference: core_worker.proto) handling task pushes, actor calls, result
    delivery, borrower registration, and object waits
  - an in-process memory store for small objects + a plasmax client for the
    node's shared-memory segment (reference: store_provider/)
  - the owner-side task manager: pending tasks, retries, and lineage for
    reconstruction (reference: task_manager.cc, max_retries semantics)
  - owner-side reference counting with a borrower protocol (simplified from
    reference_count.cc: borrowers register with the owner on deserialize and
    notify on release; owner frees cluster-wide when counts reach zero)
  - the task execution loop (workers) and the actor runtime with per-caller
    ordering and max_concurrency thread pools (reference:
    actor_scheduling_queue.cc / concurrency_group_manager.cc)
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import queue
import sys
import threading
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import chaos, protocol, serialization
from ray_tpu_torch._private import task_events as tev

# ray_tpu_torch.util imports back into this module, so the timeline module is
# bound lazily on first task execution (cached here — a per-task
# ``from ray_tpu_torch.util import timeline`` showed up in lane profiles)
_timeline = None
from ray_tpu_torch._private.function_manager import FunctionManager
from ray_tpu_torch._private.object_store import MemoryStore, PlasmaxStore
from ray_tpu_torch.common.config import SystemConfig, global_config, set_global_config
from ray_tpu_torch.common.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch import exceptions as exc

logger = logging.getLogger(__name__)

MODE_DRIVER = "driver"
MODE_WORKER = "worker"

# _execute_task reply sentinel: the direct lane (direct.py) executes on
# the receiving thread and wants the result dict RETURNED, not delivered
# through an asyncio future
DIRECT_REPLY = "direct"


# --------------------------------------------------------------------------
# ObjectRef


class ObjectRef:
    """A future for an object in the cluster.

    Carries the owner's address so any holder can reach the owner for the
    borrower protocol and result waiting (reference: ObjectRefs carry owner
    addresses in their custom reducer, SURVEY.md §8.4).
    """

    def __init__(self, oid: ObjectID, owner_address: str = "",
                 *, _register: bool = True):
        self._id = oid
        self._owner_address = owner_address
        self._held_buffer = None
        w = _global_worker
        self._worker = w if (w is not None and w.connected) else None
        if self._worker is not None and _register:
            self._worker.reference_counter.add_local(oid)

    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def owner_address(self) -> str:
        return self._owner_address

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        # GC can fire INSIDE a region that already holds the refcount
        # lock (observed: a dict resize in add_local triggered GC, which
        # collected a ref whose __del__ then re-took the non-reentrant
        # lock — a self-deadlock). __del__ therefore only enqueues; the
        # actual decrement runs from normal code paths.
        w = self._worker
        if w is not None and w.connected:
            try:
                w.reference_counter.defer_remove_local(
                    self._id, self._owner_address)
            except Exception:
                pass

    def __reduce__(self):
        from ray_tpu_torch._private import ref_serialization
        ref_serialization.record_ref((self._id.hex(), self._owner_address))
        return (_deserialize_ref, (self._id.binary(), self._owner_address))

    def on_done(self, cb) -> bool:
        """Fire ``cb()`` (no value fetch) when the producing task
        completes. Returns False when completion can't be tracked (e.g.
        this process didn't submit the task) — caller must fall back."""
        w = self._worker
        if w is None or not w.connected:
            return False
        state = w.pending_tasks.get(self._id.task_id().hex())
        if state is not None:
            state.result_event.add_callback(cb)
            return True
        if (w.memory_store.contains(self._id)
                or w.plasma.contains(self._id)):
            cb()
            return True
        return False

    def future(self):
        """A concurrent.futures.Future resolved with the object's value."""
        from concurrent.futures import Future
        f: Future = Future()

        def _resolve():
            try:
                f.set_result(get(self))
            except BaseException as e:  # noqa: BLE001
                f.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return f

    def __await__(self):
        fut = asyncio.wrap_future(self.future())
        return fut.__await__()


def _deserialize_ref(binary: bytes, owner_address: str) -> ObjectRef:
    oid = ObjectID(binary)
    ref = ObjectRef(oid, owner_address, _register=False)
    w = _global_worker
    if w is not None and w.connected:
        w.reference_counter.add_borrowed(oid, owner_address)
    return ref


# --------------------------------------------------------------------------
# Reference counting (owner side + borrower side)


class ReferenceCounter:
    """Simplified distributed refcounting (reference: reference_count.cc).

    Owner tracks local refs, submitted-task refs, and registered borrowers.
    Borrowers count their local refs and tell the owner when they hit zero.
    When the owner's total reaches zero the object is freed cluster-wide.
    """

    def __init__(self, worker: "Worker"):
        self.worker = worker
        self.lock = threading.Lock()
        # oid -> [local, submitted, borrowers:set, owned:bool, spec|None]
        self.table: Dict[ObjectID, Dict[str, Any]] = {}
        # removals queued by ObjectRef.__del__ (GC-safe: deque.append is
        # atomic and takes no lock); drained by drain_deferred()
        self._deferred: collections.deque = collections.deque()

    def defer_remove_local(self, oid: ObjectID, owner_address: str):
        self._deferred.append((oid, owner_address))

    def drain_deferred(self):
        """Apply queued __del__ decrements. Called from ordinary (non-GC)
        code paths and a periodic io-loop tick; O(1) when empty."""
        while self._deferred:
            try:
                oid, owner = self._deferred.popleft()
            except IndexError:
                return
            self.remove_local(oid, owner)

    def _entry(self, oid: ObjectID):
        return self.table.setdefault(oid, {
            "local": 0, "submitted": 0, "borrowers": set(),
            "owned": False, "lineage": None, "in_plasma": False,
        })

    def mark_in_plasma(self, oid: ObjectID):
        """Flag an existing entry as plasma-backed (no-op if the ref was
        already freed)."""
        with self.lock:
            e = self.table.get(oid)
            if e is not None:
                e["in_plasma"] = True

    def add_owned(self, oid: ObjectID, in_plasma: bool = False,
                  lineage=None):
        with self.lock:
            e = self._entry(oid)
            e["owned"] = True
            e["in_plasma"] = e["in_plasma"] or in_plasma
            if lineage is not None:
                e["lineage"] = lineage

    def add_local(self, oid: ObjectID):
        with self.lock:
            self._entry(oid)["local"] += 1

    def remove_local(self, oid: ObjectID, owner_address: str):
        free = False
        notify_owner = False
        with self.lock:
            e = self.table.get(oid)
            if e is None:
                return
            e["local"] -= 1
            if e["local"] <= 0 and e["submitted"] <= 0:
                if e["owned"]:
                    if not e["borrowers"]:
                        free = True
                else:
                    notify_owner = True
        if free:
            self._free(oid)
        elif notify_owner and owner_address and \
                owner_address != self.worker.address:
            self.worker.try_notify(owner_address, "borrow_del",
                                   {"object_id": oid.hex(),
                                    "borrower": self.worker.address})

    def add_submitted(self, oid: ObjectID):
        with self.lock:
            self._entry(oid)["submitted"] += 1

    def remove_submitted(self, oid: ObjectID):
        free = False
        with self.lock:
            e = self.table.get(oid)
            if e is None:
                return
            e["submitted"] -= 1
            if e["local"] <= 0 and e["submitted"] <= 0 and e["owned"] and \
                    not e["borrowers"]:
                free = True
        if free:
            self._free(oid)

    def add_borrowed(self, oid: ObjectID, owner_address: str):
        """Called when a ref deserializes in this process."""
        with self.lock:
            e = self._entry(oid)
            e["local"] += 1
            registered = e.get("registered_borrow", False)
            e["registered_borrow"] = True
        if not registered and owner_address and \
                owner_address != self.worker.address:
            self.worker.try_notify(owner_address, "borrow_add",
                                   {"object_id": oid.hex(),
                                    "borrower": self.worker.address})

    def on_borrow_add(self, oid_hex: str, borrower: str):
        with self.lock:
            self._entry(ObjectID.from_hex(oid_hex))["borrowers"].add(borrower)

    def on_borrow_del(self, oid_hex: str, borrower: str):
        oid = ObjectID.from_hex(oid_hex)
        free = False
        with self.lock:
            e = self.table.get(oid)
            if e is None:
                return
            e["borrowers"].discard(borrower)
            if e["local"] <= 0 and e["submitted"] <= 0 and e["owned"] and \
                    not e["borrowers"]:
                free = True
        if free:
            self._free(oid)

    def on_borrower_dead(self, borrower: str) -> int:
        """A borrower's process is gone: it counts as having released
        every ref it borrowed, as Ray's owner drops a borrower whose
        ``WaitForRefRemoved`` fails. Frees what only it held; returns the
        number of objects freed. (The JAX package keeps a dead borrower
        forever, so what it held leaks.)"""
        freed = []
        with self.lock:
            for oid, e in self.table.items():
                if borrower in e["borrowers"]:
                    e["borrowers"].discard(borrower)
                    if e["local"] <= 0 and e["submitted"] <= 0 and \
                            e["owned"] and not e["borrowers"]:
                        freed.append(oid)
        for oid in freed:
            self._free(oid)
        return len(freed)

    def set_lineage(self, oid: ObjectID, spec: Dict[str, Any]):
        with self.lock:
            self._entry(oid)["lineage"] = spec

    def get_lineage(self, oid: ObjectID):
        with self.lock:
            e = self.table.get(oid)
            return e.get("lineage") if e else None

    def _free(self, oid: ObjectID):
        with self.lock:
            e = self.table.pop(oid, None)
        if e is None:
            return
        self.worker.memory_store.delete(oid)
        if e.get("in_plasma"):
            self.worker.free_plasma([oid])


# --------------------------------------------------------------------------
# Worker


_global_worker: Optional["Worker"] = None


def global_worker() -> "Worker":
    if _global_worker is None or not _global_worker.connected:
        raise RuntimeError(
            "ray_tpu_torch.init() must be called before using the API")
    return _global_worker


class _CallbackEvent(threading.Event):
    """threading.Event that also fires one-shot callbacks on set() —
    lets ObjectRef.on_done release resources (e.g. Serve router
    backpressure slots) without a waiter thread per ref."""

    def __init__(self):
        super().__init__()
        self._cbs: List = []
        self._cb_lock = threading.Lock()

    def add_callback(self, cb):
        fire = False
        with self._cb_lock:
            if self.is_set():
                fire = True
            else:
                self._cbs.append(cb)
        if fire:
            cb()

    def set(self):
        super().set()
        with self._cb_lock:
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass


class PendingTaskState:
    __slots__ = ("spec", "retries_left", "return_ids", "done",
                 "result_event", "worker_address", "attempt", "direct")

    def __init__(self, spec, retries_left, return_ids):
        self.spec = spec
        self.retries_left = retries_left
        self.return_ids = return_ids
        self.done = False
        self.result_event = _CallbackEvent()
        self.worker_address = None
        self.attempt = 0  # bumped per retry; rides spec["attempt"]
        self.direct = False  # in flight on the native direct lane


class _LeaseState:
    """Driver-side record of one worker lease (reference:
    normal_task_submitter.cc LeaseEntry).  `busy` is best-effort under
    the GIL — two racing callers both landing on the lease just queue
    serially at the worker, which is correct, only slower."""

    __slots__ = ("key", "lease_id", "addr", "inflight", "last_used",
                 "acquiring", "revoked")

    # pipeline depth per leased worker: execution is serial, so this
    # just hides the RPC round-trip, it does not add parallelism
    MAX_INFLIGHT = 8

    def __init__(self, key):
        self.key = key
        self.lease_id = None
        self.addr = None
        self.inflight = 0
        self.last_used = 0.0
        self.acquiring = True  # constructed on the way to acquisition
        self.revoked = False   # raylet revoked; ack once inflight drains


class Worker:
    def __init__(self):
        self.mode = MODE_DRIVER
        self.connected = False
        self.io: Optional[protocol.EventLoopThread] = None
        self.raylet: Optional[protocol.Connection] = None
        self.gcs: Optional[protocol.Connection] = None
        self.memory_store = MemoryStore()
        self.plasma: Optional[PlasmaxStore] = None
        self.node_id: str = ""
        self.worker_id = WorkerID.from_random()
        self.job_id = JobID.nil()
        self.address = ""  # this process's core-worker RPC address
        self.config: SystemConfig = global_config()
        self.function_manager: Optional[FunctionManager] = None
        self.reference_counter = ReferenceCounter(self)
        self.current_task_id: Optional[TaskID] = None
        self.current_actor_id: Optional[ActorID] = None
        self.log_to_driver = True
        self._prepared_envs: Dict[str, Any] = {}
        self.task_context = threading.local()
        self._put_counter = 0
        self._put_lock = threading.Lock()
        self.pending_tasks: Dict[str, PendingTaskState] = {}
        # fn_key -> (opts snapshot, shared spec fields); see submit_task
        self._shared_spec_cache: Dict[str, Tuple] = {}
        self._submit_buf: List[Tuple[Dict[str, Any], PendingTaskState]] = []
        self._submit_lock = threading.Lock()
        self._submit_flush_scheduled = False
        # io-loop only; see protocol.single_flight_connect
        self._peer_conns: Dict[str, protocol.Connection] = {}
        self._peer_pending: Dict[str, "asyncio.Future"] = {}
        # worker-lease pools for direct pushes, keyed by sorted resource
        # items; one pool entry per leased worker
        self._worker_leases: Dict[Tuple, List["_LeaseState"]] = {}
        self._lease_fail_at: Dict[Tuple, float] = {}
        self._lease_waiters: Dict[Tuple, List[Tuple]] = {}
        self.session_dir = ""
        self.namespace = ""
        self.runtime_context: Dict[str, Any] = {}
        # worker-mode execution state
        self._task_queue: "queue.Queue" = queue.Queue()
        self._leased_executed = 0
        self._leased_stats_scheduled = False
        self._actor_instance = None
        self._actor_threads: Optional[ThreadPoolExecutor] = None
        self._actor_lock = threading.Lock()
        self._actor_async_loop = None
        self._cancelled_tasks: set = set()
        self.gpu_ids: List[int] = []
        self._server: Optional[protocol.Server] = None
        # owner side of dead-borrower detection: borrower address -> the
        # connection this process dialed to it, whose close prompts a
        # check (_check_borrower)
        self._borrower_watch: Dict[str, protocol.Connection] = {}
        # receive side: highest actor-call seq dispatched per caller +
        # parked out-of-order arrivals (reference:
        # actor_scheduling_queue.cc ordering by sequence_no)
        self._actor_seq: Dict[str, int] = {}
        self._actor_waiting: Dict[str, Dict[int, Any]] = {}
        # send side: per-actor monotone counters, program-order allocated,
        # plus the contiguous completed-prefix ("processed up to") that
        # rides every call so a restarted actor learns its baseline from
        # the first message instead of stalling on a phantom gap
        # (reference: actor_scheduling_queue.cc client_processed_up_to)
        self._actor_send_seq: Dict[str, int] = {}
        self._actor_done_seqs: Dict[str, set] = {}
        self._actor_processed_upto: Dict[str, int] = {}
        self._actor_send_lock = threading.Lock()
        # per-object location channels (long-poll pubsub): hex -> [Event,
        # waiter refcount]
        self._obj_channels: Dict[str, list] = {}
        self._obj_channel_lock = threading.Lock()
        # native direct-execution lane (direct.py):
        # workers run a DirectServer beside the asyncio server, drivers
        # route qualifying leased tasks through a DirectClient
        self.direct_address = ""
        self.direct_tcp_address = ""
        self._direct_server = None
        self._direct_client = None

    # ------------------------------------------------------------- lifecycle

    def connect(self, mode: str, gcs_address: str, raylet_address: str,
                store_path: str, node_id: str, session_dir: str,
                namespace: str = "", job_id: Optional[JobID] = None):
        global _global_worker
        self.mode = mode
        self.session_dir = session_dir
        self.namespace = namespace
        self.node_id = node_id
        self.io = protocol.EventLoopThread()
        sock = os.path.join(session_dir,
                            f"cw_{self.worker_id.hex()[:12]}.sock")
        self._server = protocol.Server(
            {**self._handlers(), "_on_disconnect": self._on_peer_disconnect})
        self.io.run(self._server.start_unix(sock))
        self.address = f"unix:{sock}"
        if mode == MODE_WORKER:
            # direct-execution lane (perf; docs/WIRE_PROTOCOL.md
            # "Implementations"): a second listening socket served by the
            # native frame pump, where leased unary tasks run
            # recv→decode→execute→reply on one thread. Any failure here
            # (the library didn't build or load) just leaves the
            # asyncio path in charge.
            from ray_tpu_torch._private import rpccore
            if rpccore.available():
                try:
                    from ray_tpu_torch._private import direct
                    dsock = os.path.join(
                        session_dir,
                        f"cw_{self.worker_id.hex()[:12]}.direct.sock")
                    from ray_tpu_torch._private import netx
                    self._direct_server = direct.DirectServer(
                        self, dsock,
                        tcp_host=netx.node_ip() if netx.enabled()
                        else None)
                    self.direct_address = self._direct_server.address
                    self.direct_tcp_address = \
                        self._direct_server.tcp_address
                except Exception:
                    logger.warning("direct lane unavailable; using the "
                                   "asyncio path", exc_info=True)
                    self._direct_server = None
                    self.direct_address = ""
                    self.direct_tcp_address = ""
        self.gcs_address = gcs_address
        # survives a GCS restart: calls retry after re-dial (GCS fault
        # tolerance; reference: gcs_rpc_client.h reconnection). The
        # constructor is loop-free; it dials lazily on first call.
        self.gcs = protocol.ReconnectingConnection(
            gcs_address, handler=self._handle_request)
        self.plasma = PlasmaxStore(store_path)
        self.function_manager = FunctionManager(
            lambda m, p: self.io.run(self.gcs.call(m, p)))
        if raylet_address:
            if mode == MODE_WORKER:
                # A worker whose raylet vanished (SIGKILL, node death) is an
                # orphan: nothing can ever schedule onto it again, and leaked
                # workers keep shm segments mapped. Exit hard.
                on_close = lambda _conn: os._exit(1)  # noqa: E731
            else:
                # Driver: batched submissions were acked by the raylet
                # and get their dispatch failures via notify — a dead
                # connection can deliver neither, so every still-pending
                # submission must fail (and retry/fatal-resolve) NOW or
                # ray_tpu_torch.get() on those refs hangs forever.
                def on_close(_conn):
                    self._fail_pending_submissions("RAYLET_UNREACHABLE",
                                                   "raylet connection lost")
            self.raylet = self.io.run(protocol.connect(
                raylet_address, handler=self._handle_request,
                on_close=on_close))
            # negotiate on the long-lived raylet link: the raylet gates
            # minor-version features (batched dispatch statuses) on the
            # version we declare here; a pre-hello raylet answers "no
            # such method", which is fine — we just look legacy to it
            try:
                from ray_tpu_torch._private import schema
                self.io.run(self.raylet.call(
                    "__hello__", schema.hello_payload(), timeout=10))
            except Exception:
                pass
        if mode == MODE_DRIVER:
            if self.raylet is not None:
                from ray_tpu_torch._private import rpccore
                if rpccore.available():
                    try:
                        from ray_tpu_torch._private import direct
                        self._direct_client = direct.DirectClient(self)
                    except Exception:
                        logger.warning(
                            "direct client unavailable; using the "
                            "asyncio lease pool", exc_info=True)
                        self._direct_client = None
            chaos.init_from_env("driver")
            r = self.io.run(self.gcs.call("next_job_id", {}))
            self.job_id = JobID.from_int(r["job_index"])
            self.io.run(self.gcs.call("add_job", {
                "job_id": self.job_id.hex(), "driver_pid": os.getpid(),
                "namespace": namespace}))
            self.current_task_id = TaskID.for_driver(self.job_id)
            if self.log_to_driver:
                # mirror worker stdout/stderr here (reference: log_monitor
                # pubsub → driver); re-subscribe after a GCS restart
                async def _resub(conn):
                    await conn.call("subscribe",
                                    {"channels": ["worker_logs"]})
                self.gcs.on_reconnect = _resub
                self.io.run(self.gcs.call("subscribe",
                                          {"channels": ["worker_logs"]}))
        elif job_id is not None:
            self.job_id = job_id
        self.connected = True

        # periodic drain of GC-deferred ref removals (ObjectRef.__del__
        # only enqueues — see ReferenceCounter.drain_deferred)
        async def _drain_loop():
            while self.connected:
                await asyncio.sleep(1.0)
                try:
                    self.reference_counter.drain_deferred()
                except Exception:
                    pass
        self.io.run_async(_drain_loop())
        _global_worker = self

    def disconnect(self):
        # flush deferred decrements BEFORE teardown: the borrow_del/free
        # notifies for refs dropped in the last drain interval must still
        # reach their owners or they leak cluster-wide
        try:
            self.reference_counter.drain_deferred()
        except Exception:
            pass
        # ship the last task-event + trace-span batches while the GCS
        # link still lives, then stop the background flusher threads —
        # _flusher_started flags never reset, so without the stop every
        # init/shutdown cycle (tests reconnect dozens of times) leaked
        # one timeline/tracing thread per cycle
        try:
            tev.flush_all(timeout=1.0)
        except Exception:
            pass
        try:
            from ray_tpu_torch._private import tracing
            tracing.flush_all(timeout=1.0)
            tracing.stop_flusher()
        except Exception:
            pass
        try:
            from ray_tpu_torch.util import timeline
            timeline.stop_flusher()
        except Exception:
            pass
        self.connected = False
        # native direct lane: stop the lane/delivery threads and free
        # the pumps before the io loop (their fallback resubmits and
        # lease releases ride it)
        dc, self._direct_client = self._direct_client, None
        if dc is not None:
            try:
                dc.close()
            except Exception:
                pass
        ds, self._direct_server = self._direct_server, None
        if ds is not None:
            try:
                ds.close()
            except Exception:
                pass
        self.direct_address = ""
        self.direct_tcp_address = ""
        # compiled-DAG channels: close the listener + stage sockets and
        # free the plasmax ring slots before the store goes away
        ep = getattr(self, "_dag_endpoint", None)
        if ep is not None:
            self._dag_endpoint = None
            try:
                ep.close()
            except Exception:
                pass
        watches, self._borrower_watch = self._borrower_watch, {}
        for conn in watches.values():
            conn.close()
        if self._server is not None:
            self._server.close()
        if self.io is not None:
            self.io.stop()

    # -------------------------------------------------------------- plumbing

    def _handlers(self):
        return {
            "task_result": self._h_task_result,
            "task_failed": self._h_task_failed,
            "task_dispatch_status": self._h_task_dispatch_status,
            "task_dispatch_status_batch": self._h_task_dispatch_status_batch,
            "revoke_lease": self._h_revoke_lease,
            "push_task": self._h_push_task,
            "leased_task": self._h_leased_task,
            "become_actor": self._h_become_actor,
            "actor_call": self._h_actor_call,
            "cancel_task": self._h_cancel_task,
            "wait_object": self._h_wait_object,
            "borrow_add": self._h_borrow_add,
            "borrow_del": self._h_borrow_del,
            "exit_worker": self._h_exit_worker,
            "preemption_notice": self._h_preemption_notice,
            "dag_channel_open": self._h_dag_channel_open,
            "dag_channel_close": self._h_dag_channel_close,
            "dag_stage_error": self._h_dag_stage_error,
            "dag_peer_down": self._h_dag_peer_down,
            "ping": self._h_ping,
            "pubsub": self._h_pubsub,
            "dump_stacks": self._h_dump_stacks,
            "profile_worker": self._h_profile_worker,
        }

    async def _h_dump_stacks(self, payload, conn):
        """Live stack snapshot of every thread in this process
        (reference: dashboard/modules/reporter/profile_manager.py —
        py-spy there; faulthandler-style sys._current_frames here, no
        external tooling needed)."""
        import traceback as _tb
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        parts = []
        for tid, frame in frames.items():
            parts.append(
                f"--- thread {names.get(tid, '?')} ({tid}) ---\n"
                + "".join(_tb.format_stack(frame)))
        return {"pid": os.getpid(), "worker_id": self.worker_id.hex(),
                "current_task": self.current_task_id.hex()
                if self.current_task_id else None,
                "stacks": "\n".join(parts),
                # actor-call ordering state: dispatched watermark and any
                # parked out-of-order seqs per caller (a stuck parked seq
                # here is the first thing to look for in a wedge)
                "actor_seq": dict(self._actor_seq),
                "parked_seqs": {c: sorted(m) for c, m in
                                self._actor_waiting.items() if m}}

    async def _h_profile_worker(self, payload, conn):
        """Timed SAMPLING profile of this process -> folded stacks
        (flamegraph-collapsed format, speedscope-importable).
        Reference: dashboard/modules/reporter/profile_manager.py (py-spy
        there; a sys._current_frames sampler here — no external tools).
        The sampler runs on an executor thread so the io loop keeps
        serving while the profile is taken."""
        duration = min(float(payload.get("duration_s") or 2.0), 30.0)
        interval = max(0.001, float(payload.get("interval_s") or 0.01))

        def _sample():
            import collections
            folded: collections.Counter = collections.Counter()
            me = threading.get_ident()
            end = time.monotonic() + duration
            n = 0
            while time.monotonic() < end:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = []
                    f = frame
                    while f is not None:
                        code = f.f_code
                        stack.append(
                            f"{code.co_name}@"
                            f"{os.path.basename(code.co_filename)}:"
                            f"{f.f_lineno}")
                        f = f.f_back
                    folded[";".join(reversed(stack))] += 1
                n += 1
                time.sleep(interval)
            return folded, n

        folded, n = await asyncio.get_running_loop().run_in_executor(
            None, _sample)
        # report the RAYLET-REGISTRY worker id (the one
        # profile_flamegraph(worker_id=...) filters by), not the
        # process's random uid
        return {"pid": os.getpid(),
                "worker_id": os.environ.get("RTT_WORKER_ID")
                or self.worker_id.hex(),
                "samples": n, "duration_s": duration,
                "folded": "\n".join(f"{k} {v}"
                                    for k, v in folded.most_common())}

    async def _h_pubsub(self, payload, conn):
        """GCS pubsub push. Drivers mirror 'worker_logs' lines to their own
        stdout/stderr (reference: log_monitor → print_logs in worker.py);
        obj:* channels wake waiters blocked on an object's location."""
        channel = payload.get("channel") or ""
        if channel.startswith("obj:"):
            with self._obj_channel_lock:
                ent = self._obj_channels.get(channel[4:])
            if ent is not None:
                ent[0].set()
            return {}
        if channel != "worker_logs" or not self.log_to_driver:
            return {}
        msg = payload.get("message") or {}
        job = msg.get("job_id")
        if job and job != self.job_id.hex():
            return {}
        stream = sys.stderr if msg.get("is_err") else sys.stdout
        prefix = f"({msg.get('worker_id', '?')} pid={msg.get('pid', '?')})"
        for line in msg.get("lines", ()):
            print(f"{prefix} {line}", file=stream, flush=True)
        return {}

    async def _handle_request(self, method, payload, conn):
        fn = self._handlers().get(method)
        if fn is None:
            raise protocol.RpcError(f"core worker: no method {method}")
        return await fn(payload, conn)

    async def _peer(self, address: str) -> protocol.Connection:
        return await protocol.single_flight_connect(
            self._peer_conns, self._peer_pending, address,
            lambda a: protocol.connect(a, handler=self._handle_request))

    def prepare_runtime_env(self, runtime_env):
        """Upload local working_dir/py_modules to GCS KV, rewriting the env
        to content-addressed URIs (reference: packaging.py upload). Cached
        per env-json so repeated submits don't re-zip."""
        if not runtime_env:
            return runtime_env
        import json as _json
        from ray_tpu_torch._private import runtime_env as renv
        # key includes a content fingerprint of local dirs so edits between
        # submits re-upload (interactive/notebook drivers)
        prints = []
        wd = runtime_env.get("working_dir")
        if isinstance(wd, str) and os.path.isdir(wd):
            prints.append(renv.dir_fingerprint(wd))
        for m in runtime_env.get("py_modules") or ():
            if isinstance(m, str) and os.path.exists(m):
                prints.append(renv.dir_fingerprint(m))
        key = _json.dumps([runtime_env, prints], sort_keys=True, default=str)
        cached = self._prepared_envs.get(key)
        if cached is not None:
            return cached

        def _kv_put(k: str, v: bytes):
            self.call_sync(self.gcs, "kv_put", {"key": k, "value": v})

        prepared = renv.upload_local_paths(runtime_env, _kv_put)
        self._prepared_envs[key] = prepared
        return prepared

    def try_notify(self, address: str, method: str, payload):
        """Fire-and-forget from any thread."""
        if self.io is None:
            return

        async def _go():
            try:
                conn = await self._peer(address)
                await conn.notify(method, payload)
            except Exception:
                pass
        try:
            self.io.run_async(_go())
        except Exception:
            pass

    def call_sync(self, conn: protocol.Connection, method: str, payload,
                  timeout=None):
        return self.io.run(conn.call(method, payload, timeout=timeout))

    # ------------------------------------------------------------------- put

    def next_put_id(self) -> ObjectID:
        with self._put_lock:
            self._put_counter += 1
            idx = self._put_counter
        task_id = self.current_task_id or TaskID.for_driver(self.job_id)
        return ObjectID.for_put(task_id, idx)

    def put_object(self, value: Any, owner_ref: Optional[ObjectRef] = None
                   ) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed")
        self.reference_counter.drain_deferred()
        oid = self.next_put_id()
        ser = serialization.serialize(value)
        self._store_serialized(oid, ser)
        self.reference_counter.add_owned(
            oid, in_plasma=ser.total_size > self.config.max_inline_object_size)
        return ObjectRef(oid, self.address)

    def _plasma_create_with_spill(self, oid: ObjectID, size: int):
        """plasma create with spill backpressure: a full store asks the
        raylet to spill cold primaries to disk and retries (reference:
        create_request_queue.cc retry-after-spill semantics)."""
        from ray_tpu_torch.exceptions import ObjectStoreFullError
        attempts = 3
        for i in range(attempts):
            try:
                # last attempt (spilling couldn't make room) may overflow
                # into the disk-backed fallback segment — reference
                # plasma's spill-then-fallback ordering
                return self.plasma.create(
                    oid, size, allow_fallback=(i == attempts - 1))
            except ObjectStoreFullError:
                if self.raylet is None or i == attempts - 1:
                    raise
                try:
                    self.call_sync(self.raylet, "request_spill",
                                   {"bytes_needed": size}, timeout=30)
                except Exception:
                    raise ObjectStoreFullError(
                        f"store full and spill request failed for {oid}")

    def _store_serialized(self, oid: ObjectID, ser) -> Dict[str, Any]:
        """Store a SerializedObject; returns a result descriptor."""
        if ser.total_size <= self.config.max_inline_object_size:
            payload = ser.to_bytes()
            self.memory_store.put(oid, payload)
            return {"object_id": oid.hex(), "inline": payload,
                    "owner": self.address}
        buf = self._plasma_create_with_spill(oid, ser.total_size)
        ser.write_into(buf)
        buf.release()
        self.plasma.seal(oid)
        # pin the primary copy at this node's raylet + publish location
        if self.raylet is not None:
            try:
                self.call_sync(self.raylet, "pin_object",
                               {"object_id": oid.hex(), "owner": self.address})
            except Exception:
                pass
        return {"object_id": oid.hex(), "plasma": True, "node_id": self.node_id,
                "owner": self.address}

    def free_plasma(self, oids: List[ObjectID]):
        """Fire-and-forget: may be called from ANY thread, including the IO
        loop itself (refcounts hit zero inside result handlers), so this must
        never block on the loop."""
        if self.raylet is None or self.io is None:
            return

        async def _go():
            try:
                await self.raylet.call(
                    "free_objects", {"object_ids": [o.hex() for o in oids]})
            except Exception:
                pass
        try:
            self.io.run_async(_go())
        except Exception:
            pass

    # ------------------------------------------------------------------- get

    def get_objects(self, refs: List[ObjectRef],
                    timeout: Optional[float] = None) -> List[Any]:
        self.reference_counter.drain_deferred()
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(ref, deadline) for ref in refs]

    def _remaining(self, deadline) -> Optional[float]:
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    def _get_one(self, ref: ObjectRef, deadline) -> Any:
        oid = ref.id()
        recovery_attempts = 0
        while True:
            # 1. in-process memory store
            payload = self.memory_store.get(oid)
            if payload is not None:
                try:
                    return self._deserialize_payload(oid, payload)
                except exc.ObjectLostError:
                    # stale descriptor: the node holding the primary died.
                    # Drop it and fall through to recovery — if we own the
                    # object, lineage reconstruction resubmits the creating
                    # task (reference: object_recovery_manager.cc). Lineage
                    # re-execution assumes idempotent tasks, same as the
                    # reference's ownership model. Attempts are bounded so a
                    # persistently failing fetch path can't re-execute the
                    # task forever.
                    recovery_attempts += 1
                    if recovery_attempts > 3:
                        raise
                    self.memory_store.delete(oid)
                    if self.mode == MODE_DRIVER or not ref.owner_address() \
                            or ref.owner_address() == self.address:
                        self._maybe_reconstruct(oid)
                    if deadline is not None and \
                            self._remaining(deadline) <= 0:
                        raise exc.GetTimeoutError(
                            f"get() timed out during recovery of {oid}")
                    continue
            # 2. a task WE submitted that is still in flight: wait for
            # completion before probing plasma — the sync-get hot path
            # was paying two ctypes store probes per wait loop for an
            # object that cannot be sealed yet
            state = self.pending_tasks.get(oid.task_id().hex())
            if state is not None and not state.done:
                if not self._resolve_remote(ref, deadline):
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {oid}")
                continue
            # 3. local plasma
            buf = self.plasma.get_buffer(oid)
            if buf is not None:
                return self._deserialize_plasma(oid, buf)
            # 4. ask the owner / locate
            if not self._resolve_remote(ref, deadline):
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {oid}")

    def _deserialize_payload(self, oid: ObjectID, payload: bytes) -> Any:
        value = serialization.deserialize(payload)
        if isinstance(value, _PlasmaIndirect):
            # owner sent us a descriptor: the real value sits in plasma
            self._ensure_local_plasma(oid)
            buf = self.plasma.get_buffer(oid)
            if buf is None:
                raise exc.ObjectLostError(oid)
            self.memory_store.delete(oid)
            return self._deserialize_plasma(oid, buf)
        return value

    def _ensure_local_plasma(self, oid: ObjectID) -> None:
        """Bring a plasma object referenced by a descriptor to this node.

        The descriptor (_PlasmaIndirect) names the node holding the primary;
        the local raylet pulls it chunk-wise (reference: object directory +
        PullManager; here raylet.handle_fetch_object)."""
        try:
            self._fetch_via_raylet(oid)
        except Exception as e:
            raise exc.ObjectLostError(
                oid, f"primary copy unreachable: {e}") from e

    def _deserialize_plasma(self, oid: ObjectID, buf) -> Any:
        try:
            value = serialization.deserialize(buf)
        except BaseException:
            buf.release()
            self.plasma.release(oid)
            raise
        # zero-copy values keep the store slot alive until GC'd
        try:
            weakref.finalize(value, _release_plasma, self.plasma, oid, buf)
        except TypeError:
            # not weakref-able: value cannot reference the buffer (envelope
            # copies scalars), safe to release now
            buf.release()
            self.plasma.release(oid)
        return value

    def _resolve_remote(self, ref: ObjectRef, deadline) -> bool:
        """Pull the object toward this process. True if progress was made."""
        oid = ref.id()
        owner = ref.owner_address()
        timeout = self._remaining(deadline)
        step = min(timeout, 2.0) if timeout is not None else 2.0
        if owner and owner != self.address:
            try:
                conn = self.io.run(self._peer(owner))
                r = self.call_sync(conn, "wait_object",
                                   {"object_id": oid.hex(), "timeout": step},
                                   timeout=step + 5)
            except Exception:
                r = None
            if r and r.get("ready"):
                if r.get("inline") is not None:
                    self.memory_store.put(oid, r["inline"])
                    return True
                # plasma object on some node: fetch into local store
                self._fetch_via_raylet(oid)
                return True
            if r is not None and not r.get("ready"):
                if r.get("lost"):
                    raise exc.ObjectLostError(oid, r.get("reason", ""))
                if timeout is not None and timeout <= 0:
                    return False
                return True  # keep waiting
            # owner unreachable
            if self._try_locations(oid):
                return True
            raise exc.ObjectLostError(
                oid, "owner is unreachable and no copies are registered "
                     "(owner failure is fatal for its objects, as in the "
                     "reference ownership model)")
        # we are the owner (or owner unknown): wait on local delivery
        state = self.pending_tasks.get(oid.task_id().hex())
        if state is not None and not state.done:
            dc = self._direct_client
            if dc is not None and state.direct and not dc._closed:
                # direct-lane task: reap the reply on THIS thread (the
                # getter pumps the native reactor; no delivery-thread
                # handoff on the sync path)
                dc.reap_result(state, step)
            else:
                state.result_event.wait(step)
            return timeout is None or self._remaining(deadline) > 0
        if self.memory_store.contains(oid) or self.plasma.contains(oid):
            return True
        if self._try_locations(oid):
            return True
        if self.mode == MODE_WORKER or not ref.owner_address():
            # borrower without owner info: long-poll the object channel
            # (reference: GCS pubsub object channels /
            # WORKER_OBJECT_LOCATIONS_CHANNEL) — subscribe, re-check
            # the directory to close the subscribe/add race, then block
            # on the notification instead of a poll loop
            ev = self._subscribe_object_channel(oid)
            try:
                if self._try_locations(oid):
                    return True
                ev.wait(step)
            finally:
                self._unsubscribe_object_channel(oid)
            return timeout is None or timeout > 0
        return self._maybe_reconstruct(oid)

    def _subscribe_object_channel(self, oid: ObjectID) -> threading.Event:
        """Subscribe to the per-object location channel; returns the
        event its pubsub notification sets. Refcounted: concurrent
        waiters on one object share a subscription."""
        hex_id = oid.hex()
        with self._obj_channel_lock:
            ent = self._obj_channels.get(hex_id)
            if ent is not None:
                ent[1] += 1
                return ent[0]
            ev = threading.Event()
            self._obj_channels[hex_id] = [ev, 1]
        try:
            self.call_sync(self.gcs, "subscribe",
                           {"channels": [f"obj:{hex_id}"]}, timeout=10)
        except Exception:
            pass  # degrade to the timed wait; re-check loop still runs
        return ev

    def _unsubscribe_object_channel(self, oid: ObjectID):
        hex_id = oid.hex()
        with self._obj_channel_lock:
            ent = self._obj_channels.get(hex_id)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] > 0:
                return
            self._obj_channels.pop(hex_id, None)
        try:
            self.io.run_async(self.gcs.call(
                "unsubscribe", {"channels": [f"obj:{hex_id}"]}))
        except Exception:
            pass

    def _try_locations(self, oid: ObjectID) -> bool:
        try:
            r = self.call_sync(self.gcs, "get_object_locations",
                               {"object_id": oid.hex()})
        except Exception:
            return False
        if r.get("locations"):
            self._fetch_via_raylet(oid)
            return True
        return False

    def _fetch_via_raylet(self, oid: ObjectID):
        if self.plasma.contains(oid):
            return
        if self.raylet is None:
            raise exc.ObjectLostError(oid, "no raylet to fetch through")
        # object-plane transfer span: a cross-node pull is the slow path
        # (chunked raylet↔raylet copy), exactly what latency attribution
        # must see; local hits returned above without touching tracing
        from ray_tpu_torch._private import tracing
        cur = self._current_trace() if tracing.enabled() else None
        sp = tracing.span_if(cur and cur.get("trace_id"),
                             f"object.pull:{oid.hex()[:12]}",
                             parent_span_id=cur and cur.get("span_id"),
                             kind="object.pull", phase="transfer",
                             attrs={"object_id": oid.hex()})
        try:
            self.call_sync(self.raylet, "fetch_object",
                           {"object_id": oid.hex()})
        except BaseException:
            if sp is not None:
                sp.finish("error")
            raise
        if sp is not None:
            sp.finish()

    def _maybe_reconstruct(self, oid: ObjectID) -> bool:
        """Lineage reconstruction: resubmit the creating task (reference:
        object_recovery_manager.h RecoverObject → TaskManager::ResubmitTask)."""
        state = self.pending_tasks.get(oid.task_id().hex())
        if state is not None and not state.done:
            return True  # a resubmit is already in flight
        spec = self.reference_counter.get_lineage(oid)
        if spec is None:
            raise exc.ObjectLostError(oid, "no lineage recorded")
        logger.warning("reconstructing %s via lineage resubmit", oid)
        self.submit_spec(spec, reconstruction=True)
        return True

    # ------------------------------------------------------------------ wait

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while len(ready) < num_returns:
            still = []
            for ref in pending:
                # cap at num_returns (reference ray.wait semantics):
                # extras stay pending for the next call
                if len(ready) < num_returns and self._is_ready(ref):
                    ready.append(ref)
                else:
                    still.append(ref)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        return ready, pending

    def _is_ready(self, ref: ObjectRef) -> bool:
        oid = ref.id()
        if self.memory_store.contains(oid) or self.plasma.contains(oid):
            return True
        state = self.pending_tasks.get(oid.task_id().hex())
        if state is not None:
            return state.done
        owner = ref.owner_address()
        if owner and owner != self.address:
            try:
                conn = self.io.run(self._peer(owner))
                r = self.call_sync(conn, "wait_object",
                                   {"object_id": oid.hex(), "timeout": 0},
                                   timeout=5)
                return bool(r.get("ready"))
            except Exception:
                return False
        return False

    # ------------------------------------------------------------ submit task

    def _shared_spec_fields(self, fn_key: str, fn_name: str,
                            opts: Dict[str, Any]) -> Dict[str, Any]:
        """Spec fields identical for every invocation of a function
        under one options set — the single source shared by the unary
        and batched submission paths (they must never drift)."""
        from ray_tpu_torch.common.options import resource_dict_from_options
        num_returns = opts.get("num_returns")
        if num_returns is None:
            num_returns = 1
        spec = {
            "fn_key": fn_key,
            "fn_name": fn_name,
            "num_returns": num_returns,
            "owner_address": self.address,
            "job_id": self.job_id.hex(),
            "resources": resource_dict_from_options(opts, is_actor=False),
            "max_retries": opts.get("max_retries",
                                    self.config.task_max_retries_default),
        }
        # optional fields ride the wire only when set (every consumer
        # reads them with .get): at thousands of tasks/s the empty
        # runtime_env/scheduling/placement_group/retry_exceptions keys
        # were measurable pack+unpack weight on each leased frame
        runtime_env = self.prepare_runtime_env(opts.get("runtime_env"))
        if runtime_env:
            spec["runtime_env"] = runtime_env
        scheduling = self._scheduling_from_opts(opts)
        if scheduling:
            spec["scheduling"] = scheduling
        pg = self._pg_from_opts(opts)
        if pg is not None:
            spec["placement_group"] = pg
        if opts.get("retry_exceptions"):
            spec["retry_exceptions"] = True
        return spec

    def submit_task(self, fn_key: str, fn_name: str, args, kwargs,
                    opts: Dict[str, Any]) -> List[ObjectRef]:
        task_id = TaskID.for_task(self.current_task_id
                                  or TaskID.for_driver(self.job_id))
        arg_blob, plasma_deps, arg_refs = self._serialize_args(args, kwargs)
        # shared fields are identical for every call of one function
        # under one options dict — cache them (hot unary path; a
        # runtime_env opts set is excluded: its content fingerprint of
        # local dirs must be recomputed per submit)
        cached = self._shared_spec_cache.get(fn_key)
        if cached is not None and cached[0] == opts:
            shared = cached[1]
        else:
            shared = self._shared_spec_fields(fn_key, fn_name, opts)
            if not opts.get("runtime_env"):
                self._shared_spec_cache[fn_key] = (dict(opts), shared)
        spec = dict(shared, task_id=task_id.hex(), args=arg_blob,
                    plasma_deps=plasma_deps, arg_refs=arg_refs)
        return self.submit_spec(spec)

    def submit_task_batch(self, fn_key: str, fn_name: str, arg_tuples,
                          opts: Dict[str, Any]) -> List[List[ObjectRef]]:
        """Bulk submission fast path: shared spec fields are computed
        once, per-task work is only arg serialization + IDs + ownership,
        and the whole batch rides submit_task_batch RPCs. This is the
        >=10k tasks/s path of the scale envelope (reference:
        release/benchmarks/README.md:11; the reference reaches its rates
        the same way — amortizing per-task overhead across a batch)."""
        parent = self.current_task_id or TaskID.for_driver(self.job_id)
        shared = self._shared_spec_fields(fn_key, fn_name, opts)
        num_returns = shared["num_returns"]
        batch = []
        out: List[List[ObjectRef]] = []
        add_owned = self.reference_counter.add_owned
        for item in arg_tuples:
            # each item is a tuple of positional args (kwargs: use the
            # unary path — batch submission keeps the hot loop lean)
            arg_blob, plasma_deps, arg_refs = self._serialize_args(
                tuple(item), {})
            task_id = TaskID.for_task(parent)
            spec = dict(shared, task_id=task_id.hex(), args=arg_blob,
                        plasma_deps=plasma_deps, arg_refs=arg_refs,
                        trace_ctx=self._trace_ctx_for_submit())
            return_ids = [ObjectID.for_return(task_id, i)
                          for i in range(num_returns)]
            state = PendingTaskState(spec, spec["max_retries"], return_ids)
            self.pending_tasks[spec["task_id"]] = state
            for oid in return_ids:
                add_owned(oid, lineage=spec)
            tev.emit(spec["task_id"], tev.PENDING_SCHEDULING,
                     name=spec.get("fn_name"), job_id=spec.get("job_id"))
            batch.append((spec, state))
            out.append([ObjectRef(oid, self.address) for oid in return_ids])
        with self._submit_lock:
            self._submit_buf.extend(batch)
            scheduled = self._submit_flush_scheduled
            self._submit_flush_scheduled = True
        if not scheduled:
            self.io.call_soon(self._spawn_submit_flush)
        return out

    # ---- tracing: span propagation through task specs (reference:
    # util/tracing/tracing_helper.py:160 _DictPropagator — the context
    # rides the TaskSpec; here it lands in the chrome timeline args so
    # `ray-tpu timeline` reconstructs the driver→task→child tree) ----

    def _current_trace(self) -> Dict[str, str]:
        ctx = getattr(self.task_context, "trace", None)
        if ctx:
            return ctx
        if not hasattr(self, "_root_trace"):
            self._root_trace = {"trace_id": os.urandom(8).hex(),
                                "span_id": "root"}
        return self._root_trace

    def _trace_ctx_for_submit(self) -> Dict[str, str]:
        cur = self._current_trace()
        return {"trace_id": cur["trace_id"],
                "span_id": os.urandom(8).hex(),  # one urandom per submit
                "parent_span_id": cur["span_id"]}

    def submit_spec(self, spec, reconstruction: bool = False) -> List[ObjectRef]:
        if "trace_ctx" not in spec:
            spec["trace_ctx"] = self._trace_ctx_for_submit()
        task_id = TaskID(bytes.fromhex(spec["task_id"]))
        num_returns = spec["num_returns"]
        return_ids = [ObjectID.for_return(task_id, i)
                      for i in range(num_returns)]
        state = PendingTaskState(spec, spec.get("max_retries", 0), return_ids)
        state.attempt = int(spec.get("attempt") or 0)
        self.pending_tasks[spec["task_id"]] = state
        for oid in return_ids:
            self.reference_counter.add_owned(oid, lineage=spec)
        tev.emit(spec["task_id"], tev.PENDING_SCHEDULING,
                 name=spec.get("fn_name"), job_id=spec.get("job_id"),
                 attempt=state.attempt or None)
        if reconstruction:
            # the original submission's counts were already removed on the
            # first completion; count the resubmit's arg refs again
            for hex_ref, _owner in spec.get("arg_refs", []):
                self.reference_counter.add_submitted(ObjectID.from_hex(hex_ref))

        if not self._try_leased_submit(spec, state):
            self._enqueue_submit(spec, state)
        refs = [ObjectRef(oid, self.address) for oid in return_ids]
        return refs

    # ---- worker leases: direct owner->worker pushes (reference:
    # src/ray/core_worker/transport/normal_task_submitter.cc — the
    # reference's normal-task path IS lease-based; this recovers it as a
    # fast lane beside the GCS-routed default, cutting a no-dep CPU task
    # from 6 messages across 3 processes to 2 messages total) ----

    _LEASE_IDLE_RELEASE_S = 2.0
    _LEASE_RETRY_COOLDOWN_S = 5.0
    # the pool grows until the raylet denies the lease (LEASE_UNAVAILABLE),
    # so its size naturally tracks node capacity; the cap is a sanity bound
    _LEASE_POOL_MAX = 16
    _LEASE_MAX_WAITERS = 512

    def _lease_qualifies(self, spec) -> bool:
        # plain CPU-only demands: custom resources imply placement on
        # specific nodes (the local raylet may not even have them) and
        # TPU chips are granted per task
        return (not spec.get("plasma_deps")
                and not spec.get("runtime_env")
                and not spec.get("placement_group")
                and not spec.get("scheduling")
                and not spec.get("spilled_from")
                and all(k == "CPU"
                        for k in (spec.get("resources") or {})))

    def _try_leased_submit(self, spec, state) -> bool:
        """Caller-thread side: only qualification + cheap reads happen
        here.  ALL lease state (pool, waiters, inflight) is mutated on
        the io thread — a caller-thread append racing the io-side drain
        silently orphaned parked tasks (round-5 review finding)."""
        if not self._lease_qualifies(spec):
            return False
        dc = self._direct_client
        if dc is not None and dc.usable():
            # the native lane owns leasing for this process: when it
            # declines (lease denied recently, parked queue overflow)
            # the task goes to the BATCHED raylet path — never to the
            # asyncio lease pool, which would build a second pool
            # competing for the same node capacity and thrash the
            # raylet's lease-revoke logic
            return dc.submit(spec, state)
        key = tuple(sorted((spec.get("resources") or {}).items()))
        pool = self._worker_leases.get(key)
        if not pool and time.monotonic() - self._lease_fail_at.get(
                key, 0.0) <= self._LEASE_RETRY_COOLDOWN_S:
            return False  # leasing recently denied — normal path
        self.io.call_soon(self._park_lease_waiter, key, spec, state)
        return True

    def cancel_leased_task(self, task_id: str):
        """Cancel a task the raylet never saw: drop it from the parked
        waiters, or send cancel_task straight to the leased worker it
        was pushed to (runs the io-side work on the io thread)."""
        state = self.pending_tasks.get(task_id)
        if state is None or state.done:
            return
        self.io.call_soon(self._cancel_leased_io, task_id, state)

    def _resolve_cancelled(self, task_id, state):
        """Resolve a never-dispatched task as cancelled (refs get the
        TaskCancelledError envelope, the state table goes terminal)."""
        err = exc.TaskCancelledError(task_id)
        ser = serialization.serialize_error(err)
        for oid in state.return_ids:
            self.memory_store.put(oid, ser.to_bytes())
        tev.emit(task_id, tev.FAILED,
                 name=state.spec.get("fn_name"),
                 job_id=state.spec.get("job_id"),
                 error="CANCELLED: never dispatched")
        state.done = True
        state.result_event.set()
        self.pending_tasks.pop(task_id, None)

    def _cancel_leased_io(self, task_id, state):
        dc = self._direct_client
        if dc is not None and dc.cancel(task_id, state):
            return
        for key, waiters in list(self._lease_waiters.items()):
            for item in waiters:
                if item[0]["task_id"] == task_id:
                    waiters.remove(item)
                    self._resolve_cancelled(task_id, state)
                    return
        if state.worker_address:
            async def _send():
                try:
                    conn = await self._peer(state.worker_address)
                    await conn.notify("cancel_task", {"task_id": task_id})
                except Exception:
                    pass  # worker gone — the task is dead anyway
            protocol.spawn(_send())

    def _park_lease_waiter(self, key, spec, state):
        """io thread: grow the pool if useful, park the task, drain."""
        pool = self._worker_leases.get(key)
        if pool is None:
            pool = []
            self._worker_leases[key] = pool
        best = None
        acquiring = False
        for L in pool:
            if L.acquiring:
                acquiring = True
            elif L.addr is not None and (best is None
                                         or L.inflight < best.inflight):
                best = L
        # grow when empty or saturated (each lease is one serial worker;
        # grow-until-denied sizes the pool to node capacity)
        if (best is None or best.inflight >= 2) \
                and len(pool) < self._LEASE_POOL_MAX and not acquiring:
            if time.monotonic() - self._lease_fail_at.get(key, 0.0) > \
                    self._LEASE_RETRY_COOLDOWN_S:
                L = _LeaseState(key)
                pool.append(L)
                protocol.spawn(self._acquire_lease(
                    L, dict(spec.get("resources") or {})))
        waiters = self._lease_waiters.setdefault(key, [])
        if len(waiters) >= self._LEASE_MAX_WAITERS:
            self._enqueue_submit(spec, state)  # overflow: batched path
            return
        waiters.append((spec, state))
        self._drain_lease_waiters(key)

    async def _acquire_lease(self, L, resources):
        try:
            r = await self.raylet.call("lease_worker",
                                       {"resources": resources})
        except Exception as e:  # noqa: BLE001
            r = {"error": "LEASE_RPC_FAILED", "message": str(e)}
        L.acquiring = False
        if r.get("error"):
            self._lease_fail_at[L.key] = time.monotonic()
            pool = self._worker_leases.get(L.key)
            if pool and L in pool:
                pool.remove(L)
            self._drain_lease_waiters(L.key)
            return
        L.lease_id = r["lease_id"]
        L.addr = r["worker_address"]
        L.last_used = time.monotonic()
        self.io.loop.call_later(self._LEASE_IDLE_RELEASE_S,
                                self._lease_idle_check, L)
        self._drain_lease_waiters(L.key)

    def _drain_lease_waiters(self, key):
        """Route parked tasks (io thread only).  Feed ready leases up to
        their pipeline depth; keep the rest parked while an acquisition
        is in flight or any lease exists (completions re-drain); flush
        to the normal path only when the pool is gone."""
        waiters = self._lease_waiters.get(key)
        if not waiters:
            return
        pool = self._worker_leases.get(key) or []
        ready = [L for L in pool if L.addr is not None]
        if not ready:
            if any(L.acquiring for L in pool):
                return  # stay parked; the acquisition settles the drain
            self._lease_waiters.pop(key, None)
            for spec, state in waiters:
                self._enqueue_submit(spec, state)
            return
        while waiters:
            L = min(ready, key=lambda x: x.inflight)
            if L.inflight >= L.MAX_INFLIGHT:
                break  # completions call back into this drain
            spec, state = waiters.pop(0)
            L.inflight += 1
            L.last_used = time.monotonic()
            protocol.spawn(self._leased_call(L, spec, state))
        if not waiters:
            self._lease_waiters.pop(key, None)

    def _lease_idle_check(self, L):
        """Release an idle lease so it stops pinning cluster capacity."""
        if L.addr is None:
            return
        idle = time.monotonic() - L.last_used
        if L.inflight or idle < self._LEASE_IDLE_RELEASE_S:
            self.io.loop.call_later(
                max(0.2, self._LEASE_IDLE_RELEASE_S - idle),
                self._lease_idle_check, L)
            return
        self._drop_lease(L, release=True)

    def _drop_lease(self, L, release: bool = False):
        lease_id, L.lease_id, L.addr = L.lease_id, None, None
        pool = self._worker_leases.get(L.key)
        if pool and L in pool:
            pool.remove(L)
        self._drain_lease_waiters(L.key)  # re-route or flush parked tasks
        if release and lease_id is not None:
            async def _rel():
                try:
                    await self.raylet.call("release_lease",
                                           {"lease_id": lease_id})
                except Exception:
                    pass  # raylet-side conn cleanup is the backstop
            protocol.spawn(_rel())

    async def _leased_call(self, L, spec, state):
        state.worker_address = L.addr
        try:
            conn = await self._peer(L.addr)
            reply = await conn.call("leased_task", {"spec": spec})
        except Exception:
            # lease broken (worker died / revoked / dial failed): drop
            # it — WITH a release RPC, which is idempotent raylet-side
            # and reclaims the resources when only the owner->worker
            # dial was at fault — and fall back to the normal path
            # (at-least-once, same as the task-retry contract)
            L.inflight -= 1
            self._drop_lease(L, release=True)
            state.worker_address = None  # else _fail_pending skips it
            self._enqueue_submit(spec, state)
            return
        L.inflight -= 1
        L.last_used = time.monotonic()
        if L.revoked and L.inflight == 0:
            self._ack_revoked_lease(L)
        self._drain_lease_waiters(L.key)
        await self._h_task_result(reply, None)

    # Micro-batched submission: specs enqueued between IO-loop ticks ride
    # ONE submit_task_batch RPC (reference gets its tasks/s the same way —
    # batched TaskSpec pushes). Dispatch failures come back as
    # task_dispatch_status notifies handled by _h_task_dispatch_status.
    _SUBMIT_BATCH_MAX = 2000

    def _enqueue_submit(self, spec, state):
        with self._submit_lock:
            self._submit_buf.append((spec, state))
            if self._submit_flush_scheduled:
                return
            self._submit_flush_scheduled = True
        self.io.call_soon(self._spawn_submit_flush)

    def _spawn_submit_flush(self):
        from ray_tpu_torch._private.protocol import spawn
        spawn(self._flush_submits())

    async def _flush_submits(self):
        while True:
            with self._submit_lock:
                batch = self._submit_buf[:self._SUBMIT_BATCH_MAX]
                del self._submit_buf[:self._SUBMIT_BATCH_MAX]
                if not batch:
                    self._submit_flush_scheduled = False
                    return
            try:
                await self.raylet.call(
                    "submit_task_batch",
                    {"specs": [spec for spec, _ in batch]})
            except Exception as e:
                reply = {"error": "RAYLET_UNREACHABLE", "message": str(e)}
                for _, state in batch:
                    self._on_submit_reply(state, dict(reply))

    async def _h_task_dispatch_status(self, payload, conn):
        """Raylet-side dispatch outcome for a batched submission; feed it
        through the same retry/fatal machinery as a unary submit reply
        (success carries worker_address, errors drive retries)."""
        state = self.pending_tasks.get(payload.get("task_id"))
        if state is not None and not state.done:
            self._on_submit_reply(state, payload)
        return {}

    async def _h_revoke_lease(self, payload, conn):
        """The raylet reclaims a lease under contention: stop routing new
        tasks through it, let in-flight calls finish on the worker's
        serial queue, then ACK the drain with a release_lease carrying
        ``inflight=0`` — the raylet defers re-idling the worker until
        that ack, so it never hands the dispatch loop a worker that is
        still executing our leased tasks."""
        lease_id = payload.get("lease_id")
        dc = self._direct_client
        if dc is not None and dc.on_revoke(lease_id):
            return {}
        for pool in self._worker_leases.values():
            for L in list(pool):
                if L.lease_id == lease_id:
                    self._lease_fail_at[L.key] = time.monotonic()
                    L.revoked = True
                    if L in pool:
                        pool.remove(L)
                    L.addr = None  # stop routing; in-flight calls
                    # already hold their worker connection
                    self._drain_lease_waiters(L.key)
                    if L.inflight == 0:
                        self._ack_revoked_lease(L)
                    return {}
        return {}

    def _ack_revoked_lease(self, L):
        """io thread: the revoked lease's in-flight calls drained —
        tell the raylet (inflight=0) so it reclaims the worker."""
        lease_id, L.lease_id = L.lease_id, None
        if lease_id is None:
            return

        async def _rel():
            try:
                await self.raylet.call("release_lease",
                                       {"lease_id": lease_id,
                                        "inflight": 0})
            except Exception:
                pass  # raylet-side revoke-ack timeout is the backstop
        protocol.spawn(_rel())

    async def _h_task_dispatch_status_batch(self, payload, conn):
        """Coalesced form: one notify carrying many statuses (the raylet
        batches success statuses per flush tick)."""
        for status in payload.get("statuses") or ():
            await self._h_task_dispatch_status(status, conn)
        return {}

    def _fail_pending_submissions(self, err: str, message: str):
        """The raylet connection died: every submission not yet known to
        be dispatched (no worker_address) can neither run nor report —
        push it through the standard error path so gets don't hang.
        Runs on the io loop (connection on_close)."""
        for state in list(self.pending_tasks.values()):
            if not state.done and state.worker_address is None:
                try:
                    self._on_submit_reply(
                        state, {"error": err, "message": message})
                except Exception:
                    logger.exception("failing pending submission")

    def _on_submit_reply(self, state: PendingTaskState, reply):
        err = reply.get("error")
        if err is None:
            state.worker_address = reply.get("worker_address")
            return
        if err in ("WORKER_DIED", "WORKER_START_FAILED",
                   "OBJECT_FETCH_FAILED", "RAYLET_UNREACHABLE",
                   "NODE_DRAINING") and \
                state.retries_left != 0:
            state.retries_left -= 1
            self._bump_attempt(state)
            logger.warning("task %s failed (%s), retrying (%d left)",
                           state.spec["fn_name"], err, state.retries_left)

            async def _resub():
                if err == "NODE_DRAINING":
                    # the draining raylet spills the resubmit to a peer;
                    # a beat of backoff keeps retries from burning out
                    # before peer capacity shows up in the scheduler
                    await asyncio.sleep(0.25)
                try:
                    reply = await self.raylet.call("submit_task", state.spec)
                except Exception as e:
                    reply = {"error": "RAYLET_UNREACHABLE", "message": str(e)}
                self._on_submit_reply(state, reply)
            self.io.run_async(_resub())
            return
        # fatal: store error into all return objects
        e: Exception
        if err == "CANCELLED":
            e = exc.TaskCancelledError(state.spec["task_id"])
        elif err == "WORKER_DIED":
            e = exc.WorkerCrashedError(reply.get("message", ""))
        else:
            e = exc.RayTpuError(f"{err}: {reply.get('message', '')}")
        ser = serialization.serialize_error(e)
        payload = ser.to_bytes()
        for oid in state.return_ids:
            self.memory_store.put(oid, payload)
        for hex_ref, _ in state.spec.get("arg_refs", []):
            self.reference_counter.remove_submitted(ObjectID.from_hex(hex_ref))
        # owner-side fatal resolution (cancel, retries exhausted,
        # unreachable raylet): the task must land terminal in the
        # state table even when no worker/raylet could report it
        tev.emit(state.spec.get("task_id"), tev.FAILED,
                 name=state.spec.get("fn_name"),
                 job_id=state.spec.get("job_id"),
                 attempt=state.attempt or None,
                 error=f"{err}: {reply.get('message', '')}"[:200])
        state.done = True
        state.result_event.set()
        self.pending_tasks.pop(state.spec.get("task_id"), None)

    _SCALAR_ARG_TYPES = (type(None), bool, int, float, str, bytes)

    def _serialize_args(self, args, kwargs):
        """Serialize task args. Large arg values are promoted to plasma
        objects (implicit put) so they ride the object plane; refs are listed
        as dependencies for the executing raylet to pre-fetch."""
        if not kwargs and all(type(a) in self._SCALAR_ARG_TYPES
                              for a in args):
            # scalar fast path: an msgpack-inline envelope — no pickle,
            # no ref collection (scalars can't contain ObjectRefs), no
            # deps. serialization.deserialize takes its existing
            # "inline" branch, so the executing worker skips
            # pickle.loads too. Exact-type checks keep user containers
            # (whose tuples must survive round-trip) on the pickle path.
            try:
                import struct as _struct
                import msgpack as _msgpack
                header = _msgpack.packb({"inline": [list(args), {}],
                                         "v": 1}, use_bin_type=True)
                return (_struct.pack("<I", len(header)) + header, [], [])
            except (OverflowError, ValueError, TypeError):
                pass  # e.g. an int beyond 64-bit: take the pickle path
        promoted_args = []
        for a in args:
            promoted_args.append(self._promote_arg(a))
        promoted_kwargs = {k: self._promote_arg(v) for k, v in kwargs.items()}
        ser = serialization.serialize((promoted_args, promoted_kwargs))
        arg_refs = list(ser.contained_refs)
        # Count submitted-task references NOW, before promoted ObjectRefs can
        # be GC'd (the matching remove_submitted runs at task completion).
        for hex_ref, _owner in arg_refs:
            self.reference_counter.add_submitted(ObjectID.from_hex(hex_ref))
        plasma_deps = []
        for hex_ref, owner in arg_refs:
            oid = ObjectID.from_hex(hex_ref)
            e = self.reference_counter.table.get(oid)
            if (e and e.get("in_plasma")) or self.plasma.contains(oid):
                plasma_deps.append(hex_ref)
        return ser.to_bytes(), plasma_deps, arg_refs

    def _promote_arg(self, value):
        if isinstance(value, ObjectRef):
            return value
        try:
            import numpy as np
            if isinstance(value, np.ndarray) and \
                    value.nbytes > self.config.max_inline_object_size:
                return self.put_object(value)
        except ImportError:
            pass
        return value

    @staticmethod
    def _scheduling_from_opts(opts) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        strategy = opts.get("scheduling_strategy")
        if strategy == "SPREAD":
            out["spread"] = True
        elif strategy is not None and not isinstance(strategy, str):
            # NodeAffinitySchedulingStrategy / PlacementGroup strategy objects
            node_id = getattr(strategy, "node_id", None)
            if node_id is not None:
                out["node_id"] = node_id
                out["soft"] = getattr(strategy, "soft", False)
        return out

    @staticmethod
    def _pg_from_opts(opts) -> Optional[Dict[str, Any]]:
        strategy = opts.get("scheduling_strategy")
        pg = getattr(strategy, "placement_group", None)
        if pg is None:
            return None
        return {"pg_id": pg.id_hex,
                "bundle_index": getattr(strategy,
                                        "placement_group_bundle_index", 0)}

    # --------------------------------------------------- result delivery (owner)

    async def _h_task_result(self, payload, conn):
        self._apply_task_result(payload)
        return {}

    def _apply_task_result(self, payload):
        """Store a task's returns and wake its getters.  Thread-safe
        (memory store / refcounter / result event all take their own
        locks): the asyncio handler above and the direct lane's
        delivery thread (direct.py) both land here — the latter is what
        lets a leased round trip complete without ever scheduling onto
        the io loop."""
        task_hex = payload["task_id"]
        state = self.pending_tasks.get(task_hex)
        for ret in payload["returns"]:
            oid = ObjectID.from_hex(ret["object_id"])
            if ret.get("inline") is not None:
                self.memory_store.put(oid, ret["inline"])
            else:
                # descriptor: value lives in plasma (possibly another node)
                ind = _PlasmaIndirect(ret.get("node_id", ""))
                ser = serialization.serialize(ind)
                if not self.plasma.contains(oid):
                    self.memory_store.put(oid, ser.to_bytes())
                # the owner's table must know this ref is plasma-backed —
                # downstream tasks list it in plasma_deps (prefetch +
                # locality-aware scheduling) even when the primary copy
                # is on another node
                self.reference_counter.mark_in_plasma(oid)
        if state is not None:
            if payload.get("app_error") and state.retries_left != 0 and \
                    state.spec.get("retry_exceptions"):
                state.retries_left -= 1
                self._bump_attempt(state)
                self.io.run_async(self._retry(state))
                return
            state.done = True
            state.result_event.set()
            for hex_ref, _ in state.spec.get("arg_refs", []):
                self.reference_counter.remove_submitted(
                    ObjectID.from_hex(hex_ref))
            # terminal: drop the tracking entry (the result lives in the
            # memory store / plasma, lineage lives in the refcounter's
            # table). Without this the dict grew one spec+state per task
            # for the process lifetime — real memory AND a growing gen-2
            # GC sweep that visibly decayed sustained task throughput.
            self.pending_tasks.pop(task_hex, None)

    async def _h_task_failed(self, payload, conn):
        """The raylet reports the executing worker died mid-task."""
        state = self.pending_tasks.get(payload["task_id"])
        if state is None or state.done:
            return {}
        self._on_submit_reply(state, payload)
        return {}

    def _bump_attempt(self, state: PendingTaskState):
        """A retry restarts the task lifecycle: stamp the new attempt
        number into the spec (raylet + worker events inherit it) and
        report the transition back to PENDING_SCHEDULING."""
        state.attempt += 1
        state.spec["attempt"] = state.attempt
        tev.emit(state.spec["task_id"], tev.PENDING_SCHEDULING,
                 name=state.spec.get("fn_name"),
                 job_id=state.spec.get("job_id"), attempt=state.attempt)

    async def _retry(self, state):
        try:
            reply = await self.raylet.call("submit_task", state.spec)
        except Exception as e:
            reply = {"error": "RAYLET_UNREACHABLE", "message": str(e)}
        self._on_submit_reply(state, reply)

    async def _h_wait_object(self, payload, conn):
        """Owner-side long poll: is this object ready? (borrowers call this)"""
        oid = ObjectID.from_hex(payload["object_id"])
        timeout = payload.get("timeout", 0)
        payload_bytes = self.memory_store.get(oid)
        if payload_bytes is None and not self.plasma.contains(oid):
            state = self.pending_tasks.get(oid.task_id().hex())
            if state is not None and not state.done and timeout:
                loop = asyncio.get_running_loop()
                await loop.run_in_executor(
                    None, state.result_event.wait, timeout)
            payload_bytes = self.memory_store.get(oid)
        if payload_bytes is not None:
            value = None
            try:
                value = serialization.deserialize(payload_bytes)
            except BaseException:
                pass  # error envelope: still ship it raw
            if isinstance(value, _PlasmaIndirect):
                return {"ready": True, "plasma": True,
                        "node_id": value.node_id}
            return {"ready": True, "inline": payload_bytes}
        if self.plasma.contains(oid):
            return {"ready": True, "plasma": True, "node_id": self.node_id}
        # the primary may have been spilled to disk by our raylet — still
        # ready; borrowers restore it via the pull path
        if self.raylet is not None:
            try:
                r = await self.raylet.call(
                    "contains_object", {"object_id": oid.hex()})
                if r.get("present"):
                    return {"ready": True, "plasma": True,
                            "node_id": self.node_id}
            except Exception:
                pass
        return {"ready": False}

    async def _h_borrow_add(self, payload, conn):
        self.reference_counter.on_borrow_add(payload["object_id"],
                                             payload["borrower"])
        if conn is not None:
            # the borrower's own connection: its close is the first sign
            # that the borrower died (_on_peer_disconnect)
            conn.meta.setdefault("borrowers", set()).add(
                payload["borrower"])
            if conn._closed:        # it closed before this frame was read
                await self._check_borrower(payload["borrower"])
        return {}

    # ---- dead borrowers (ROADMAP C6) ----
    #
    # A borrower killed before it reports release would hold its refs
    # forever. No poll: when a connection that carried a borrower's
    # borrow_add closes, the owner dials the borrower's address. Refused
    # means the process is gone and its borrows are released; answered
    # means it lives, and the dialed connection is kept so that its close
    # prompts the next check.

    async def _on_peer_disconnect(self, conn):
        for borrower in list(conn.meta.get("borrowers") or ()):
            await self._check_borrower(borrower)

    async def _check_borrower(self, borrower: str):
        if not self.connected:
            return
        watch = self._borrower_watch.get(borrower)
        if watch is not None and not watch._closed:
            return

        def closed(c, borrower=borrower):
            if self._borrower_watch.get(borrower) is c:
                del self._borrower_watch[borrower]
            protocol.spawn(self._check_borrower(borrower))
        try:
            conn = await asyncio.wait_for(protocol.connect(
                borrower, handler=self._handle_request, on_close=closed),
                timeout=5.0)
        except asyncio.TimeoutError:
            # a connect the kernel neither took nor refused: look again
            asyncio.get_running_loop().call_later(
                5.0, lambda: protocol.spawn(self._check_borrower(borrower)))
            return
        except OSError:
            n = self.reference_counter.on_borrower_dead(borrower)
            if n:
                logger.info("borrower %s is gone: freed %d object(s) "
                            "only it held", borrower, n)
            return
        self._borrower_watch[borrower] = conn

    async def _h_borrow_del(self, payload, conn):
        self.reference_counter.on_borrow_del(payload["object_id"],
                                             payload["borrower"])
        return {}

    async def _h_ping(self, payload, conn):
        return {"worker_id": self.worker_id.hex(), "mode": self.mode}

    async def _h_exit_worker(self, payload, conn):
        os._exit(0)

    # ---- compiled-DAG channels (ray_tpu_torch/dag/channel.py; schema 1.5) ----

    async def _h_dag_channel_open(self, payload, conn):
        """Pre-wire one compiled-DAG stage in this (actor) worker: build
        the stage runtime, dial its downstream peers, and hand back this
        process's channel address. The raylet learns about the stage so
        a worker death reaches the compiling owner (dag_peer_down)
        without waiting out an execute timeout."""
        from ray_tpu_torch.dag import channel as dagch
        loop = asyncio.get_running_loop()
        ep = dagch.get_endpoint(self)
        # dialing downstream peers is blocking socket work — keep it off
        # the io loop
        r = await loop.run_in_executor(None, ep.open_stage, payload)
        if self.raylet is not None:
            try:
                await self.raylet.notify("dag_register", {
                    "dag_id": payload["dag_id"],
                    "owner_address": payload["owner_address"]})
            except Exception:
                pass
        return r

    async def _h_dag_channel_close(self, payload, conn):
        ep = getattr(self, "_dag_endpoint", None)
        if ep is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, ep.close_stage, payload["dag_id"],
                payload.get("stage_id"))
        if self.raylet is not None:
            try:
                await self.raylet.notify(
                    "dag_unregister", {"dag_id": payload["dag_id"]})
            except Exception:
                pass
        return {}

    async def _h_dag_stage_error(self, payload, conn):
        """A stage's forward send broke (downstream peer died): the
        compiling owner tears the graph down and falls back."""
        from ray_tpu_torch.dag import compiled_dag
        compiled_dag.on_stage_error(payload)
        return {}

    async def _h_dag_peer_down(self, payload, conn):
        """Raylet-side death detection for a worker hosting compiled-DAG
        stages (raylet.py _handle_worker_death)."""
        from ray_tpu_torch.dag import compiled_dag
        compiled_dag.on_peer_down(payload)
        return {}

    async def _h_preemption_notice(self, payload, conn):
        """The raylet is draining (preemption): surface the deadline
        to any train session in this process so the train loop commits
        an out-of-band checkpoint before the node dies."""
        from ray_tpu_torch.air import session as air_session
        air_session.mark_preempted(
            deadline_unix=payload.get("deadline_unix"),
            grace_s=payload.get("grace_s"))
        return {}

    # ----------------------------------------------------- task execution side

    async def _h_push_task(self, payload, conn):
        self._task_queue.put(payload)
        return {}

    async def _h_leased_task(self, payload, conn):
        """Direct owner->worker execution under a lease: the reply IS
        the result delivery (2 messages/task; no raylet involvement —
        the lease holds the resources)."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._task_queue.put({"spec": payload["spec"], "gpu_ids": [],
                              "reply": (loop, fut)})
        result = await fut
        # leased tasks bypass the raylet, so its tasks_dispatched gauge
        # would go dark — coalesce executed-count deltas into one
        # task_stats notify per 0.3 s tick
        self._leased_executed += 1
        if not self._leased_stats_scheduled:
            self._leased_stats_scheduled = True
            loop.call_later(0.3, self._flush_leased_stats)
        return result

    def _flush_leased_stats(self):
        self._leased_stats_scheduled = False
        delta, self._leased_executed = self._leased_executed, 0
        if delta and self.raylet is not None:
            protocol.spawn(self.raylet.notify(
                "task_stats", {"executed": delta}))

    async def _h_cancel_task(self, payload, conn):
        self._cancelled_tasks.add(payload["task_id"])
        return {}

    def task_execution_loop(self):
        """Main loop of a worker process (reference:
        core_worker.cc:2180 RunTaskExecutionLoop → task_execution_handler)."""
        while True:
            item = self._task_queue.get()
            if item is None:
                break
            self._execute_task(item["spec"], item.get("gpu_ids") or [],
                               reply=item.get("reply"))

    def _execute_task(self, spec, gpu_ids, reply=None):
        if chaos._ENGINE is not None:
            # chaos injection point: "kill" at the N-th task this worker
            # starts executing (SIGKILL — the task dies mid-flight and
            # the owner's retry machinery takes over)
            chaos.hit("worker.execute", spec.get("fn_name"))
        task_hex = spec["task_id"]
        self.current_task_id = TaskID(bytes.fromhex(task_hex))
        self.gpu_ids = gpu_ids
        owner = spec["owner_address"]
        returns = []
        app_error = False
        global _timeline
        if _timeline is None:
            from ray_tpu_torch.util import timeline as _tl
            _timeline = _tl
        _t0 = time.time()
        _task_err: Optional[str] = None
        tev.emit(task_hex, tev.RUNNING, name=spec.get("fn_name"),
                 job_id=spec.get("job_id"), node_id=self.node_id,
                 worker_pid=os.getpid(), attempt=spec.get("attempt"),
                 trace_ctx=spec.get("trace_ctx"))
        # adopt the propagated span: child submits from inside this task
        # will parent to it
        self.task_context.trace = spec.get("trace_ctx")
        _deser_s = _ship_t0 = None
        try:
            if task_hex in self._cancelled_tasks:
                raise exc.TaskCancelledError(task_hex)
            fn = self.function_manager.fetch(spec["fn_key"])
            _td0 = time.time()
            args, kwargs = serialization.deserialize(spec["args"])
            args = [self._resolve_arg(a) for a in args]
            kwargs = {k: self._resolve_arg(v) for k, v in kwargs.items()}
            # arg deserialization + dependency resolution: the
            # "deserialize" phase of the synthesized task trace
            _deser_s = round(time.time() - _td0, 6)
            result = fn(*args, **kwargs)
            _ship_t0 = time.time()  # result shipping = "transfer" phase
            num_returns = spec["num_returns"]
            if num_returns == 1:
                values = [result]
            elif num_returns == 0:
                values = []
            else:
                values = list(result)
                if len(values) != num_returns:
                    raise ValueError(
                        f"task declared num_returns={num_returns} but "
                        f"returned {len(values)} values")
            for i, v in enumerate(values):
                oid = ObjectID.for_return(self.current_task_id, i)
                ser = serialization.serialize(v)
                returns.append(self._ship_return(oid, ser))
        except BaseException as e:  # noqa: BLE001
            logger.debug("task %s raised: %s", spec["fn_name"],
                         traceback.format_exc())
            app_error = True
            err = exc.TaskError.capture(spec["fn_name"], e) \
                if not isinstance(e, exc.RayTpuError) else e
            _task_err = f"{type(e).__name__}: {e}"
            ser = serialization.serialize_error(err)
            for i in range(max(1, spec["num_returns"])):
                oid = ObjectID.for_return(self.current_task_id, i)
                returns.append({"object_id": oid.hex(),
                                "inline": ser.to_bytes()})
        finally:
            self.current_task_id = None
            self.task_context.trace = None
            _timeline.record_task(spec.get("fn_name", "task"), _t0,
                                  time.time(), pid=os.getpid(),
                                  failed=app_error,
                                  trace_ctx=spec.get("trace_ctx"))
            tev.emit(task_hex,
                     tev.FAILED if app_error else tev.FINISHED,
                     name=spec.get("fn_name"), job_id=spec.get("job_id"),
                     node_id=self.node_id, worker_pid=os.getpid(),
                     attempt=spec.get("attempt"), error=_task_err,
                     deser_s=_deser_s,
                     ship_s=(round(time.time() - _ship_t0, 6)
                             if _ship_t0 is not None else None))
        if reply is not None:
            # leased task: the RPC reply carries the result (no owner
            # notify, no task_done — the lease holds the resources)
            result = {"task_id": task_hex, "returns": returns,
                      "app_error": app_error}
            if reply == DIRECT_REPLY:
                # direct lane: the caller (direct.py's one-thread
                # recv→execute→reply loop) frames and sends this itself
                return result
            loop, fut = reply
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(result))
            return
        # Deliver the result BEFORE task_done: for TPU tasks the raylet
        # retires (kills) this worker as soon as task_done arrives, so a
        # fire-and-forget result here races worker death and the owner would
        # wait out its full timeout (flaky PG tests, round 3). A drained
        # notify is on the wire even if we die right after.
        async def _deliver():
            conn = await self._peer(owner)
            await conn.notify("task_result", {
                "task_id": task_hex, "returns": returns,
                "app_error": app_error})
        try:
            self.io.run(_deliver(), timeout=30)
        except Exception:
            logger.warning("result delivery for %s failed", task_hex,
                           exc_info=True)
        if self.raylet is not None:
            # notify, not call: the raylet never replies with anything —
            # a request would cost an extra send + seq bookkeeping per task
            self.io.run_async(self.raylet.notify("task_done",
                                                 {"task_id": task_hex}))

    def _ship_return(self, oid: ObjectID, ser) -> Dict[str, Any]:
        if ser.total_size <= self.config.max_inline_object_size:
            return {"object_id": oid.hex(), "inline": ser.to_bytes()}
        buf = self._plasma_create_with_spill(oid, ser.total_size)
        ser.write_into(buf)
        buf.release()
        self.plasma.seal(oid)
        if self.raylet is not None:
            try:
                self.call_sync(self.raylet, "pin_object",
                               {"object_id": oid.hex()})
            except Exception:
                pass
        return {"object_id": oid.hex(), "plasma": True,
                "node_id": self.node_id}

    def _resolve_arg(self, value):
        if isinstance(value, ObjectRef):
            # bounded: a lost/freed arg object must surface as a task
            # error, not wedge the executor thread forever
            deadline = time.monotonic() + self.config.arg_fetch_timeout_s
            return self._get_one(value, deadline=deadline)
        return value

    # -------------------------------------------------------------- actor side

    async def _h_become_actor(self, payload, conn):
        spec = payload["create_spec"]
        self.gpu_ids = payload.get("gpu_ids") or []
        loop = asyncio.get_running_loop()
        err = await loop.run_in_executor(None, self._init_actor, spec)
        if err is not None:
            raise protocol.RpcError(err)
        return {}

    def _init_actor(self, spec) -> Optional[str]:
        try:
            cls = self.function_manager.fetch(spec["class_key"])
            args, kwargs = serialization.deserialize(spec["init_args"])
            args = [self._resolve_arg(a) for a in args]
            kwargs = {k: self._resolve_arg(v) for k, v in kwargs.items()}
            self.current_actor_id = ActorID(bytes.fromhex(spec["actor_id"]))
            self.current_task_id = TaskID.for_actor_task(
                self.current_actor_id, 0)
            max_concurrency = spec.get("max_concurrency") or 1
            self._actor_threads = ThreadPoolExecutor(
                max_workers=max_concurrency,
                thread_name_prefix="actor-exec")
            # concurrency groups (reference: actor concurrency groups,
            # core_worker/transport/concurrency_group_manager): named
            # executors so e.g. "io" calls never starve "compute" calls
            self._actor_group_threads = {
                name: ThreadPoolExecutor(
                    max_workers=int(n),
                    thread_name_prefix=f"actor-{name}")
                for name, n in (spec.get("concurrency_groups")
                                or {}).items()}
            self._actor_instance = cls(*args, **kwargs)
            self.mode = MODE_WORKER
            return None
        except BaseException as e:  # noqa: BLE001
            logger.error("actor init failed: %s", traceback.format_exc())
            return f"{type(e).__name__}: {e}"

    def _executor_for(self, method) -> ThreadPoolExecutor:
        group = getattr(method, "__rtpu_method_opts__",
                        {}).get("concurrency_group")
        if group:
            groups = getattr(self, "_actor_group_threads", {})
            ex = groups.get(group)
            if ex is None:
                # silently landing on the default executor would recreate
                # exactly the starvation the group was meant to prevent
                raise ValueError(
                    f"method declares concurrency_group={group!r} but the "
                    f"actor defined groups {sorted(groups)}")
            return ex
        return self._actor_threads

    def enqueue_actor_call(self, actor_id_hex: str, payload: Dict[str, Any],
                           coro_factory) -> int:
        """Stamp ``payload`` with the next per-(process, actor) sequence
        number and enqueue its send coroutine — ATOMICALLY. All handles
        share the counter (__reduce__-recreated handles must not restart
        the numbering), and because run_coroutine_threadsafe preserves
        enqueue order, holding the lock across both steps means frames
        leave in seq order on the cached fast path; out-of-order
        delivery then only happens on cold starts and retries, where the
        receiver's parking backstop absorbs it."""
        with self._actor_send_lock:
            n = self._actor_send_seq.get(actor_id_hex, 0) + 1
            self._actor_send_seq[actor_id_hex] = n
            payload["seq"] = n
            payload["processed_up_to"] = \
                self._actor_processed_upto.get(actor_id_hex, 0)
            self.io.run_async(coro_factory())
            return n

    def mark_actor_seq_done(self, actor_id_hex: str, seq: int):
        """A call completed (result or error): advance the contiguous
        processed prefix that future calls advertise."""
        with self._actor_send_lock:
            done = self._actor_done_seqs.setdefault(actor_id_hex, set())
            done.add(seq)
            upto = self._actor_processed_upto.get(actor_id_hex, 0)
            while upto + 1 in done:
                upto += 1
                done.discard(upto)
            self._actor_processed_upto[actor_id_hex] = upto

    async def _order_actor_call(self, caller: str, seq: int,
                                processed_up_to: int = 0):
        """Park until every lower seq from this caller has been
        dispatched (per-caller ordering — without it the async send
        tasks race and e.g. train() can reach the actor before
        create()). A timeout keeps a gap from wedging the queue: a
        predecessor that died before sending (send-side failure) or a
        counter carried across an actor restart both resolve by
        skipping forward — best-effort beats deadlock. 30 s errs toward
        ordering: under a saturated host a predecessor's send can lag
        seconds, and skipping early re-creates the reorder bug."""
        if not caller or not seq:
            return
        loop = asyncio.get_running_loop()
        waiting = self._actor_waiting.setdefault(caller, {})
        if processed_up_to > self._actor_seq.get(caller, 0):
            # the caller says everything ≤ processed_up_to already
            # completed (possibly against a previous incarnation of this
            # actor): fast-forward instead of waiting on phantom gaps
            self._actor_seq[caller] = processed_up_to
            self._release_actor_call(caller, processed_up_to)
        while seq > self._actor_seq.get(caller, 0) + 1:
            fut = loop.create_future()
            waiting[seq] = fut
            try:
                await asyncio.wait_for(fut, timeout=30.0)
            except asyncio.TimeoutError:
                break
            finally:
                waiting.pop(seq, None)
        if seq > self._actor_seq.get(caller, 0):
            self._actor_seq[caller] = seq

    def _release_actor_call(self, caller: str, seq: int):
        if not caller or not seq:
            return
        nxt = self._actor_waiting.get(caller, {}).get(seq + 1)
        if nxt is not None and not nxt.done():
            nxt.set_result(None)

    def _actor_task_events_on(self) -> bool:
        """RTT_ACTOR_TASK_EVENTS=1 extends the task-event pipeline to
        actor method calls (the direct-call fast lane skips the normal
        execute path). Off by default: steady-state actor chatter
        (health probes, long-polls) would crowd the bounded task table;
        the game-day harness turns it on for its cluster so the state
        engine can be reconciled per request against client ledgers."""
        on = getattr(self, "_actor_tev_on", None)
        if on is None:
            on = bool(os.environ.get("RTT_ACTOR_TASK_EVENTS"))
            self._actor_tev_on = on
        return on

    async def _h_actor_call(self, payload, conn):
        loop = asyncio.get_running_loop()
        method_name = payload["method"]
        # ordering FIRST: every error path below must still consume this
        # seq (and release its successor), or calls pipelined behind a
        # bad one stall on a phantom gap until the parking timeout
        await self._order_actor_call(payload.get("caller"),
                                     payload.get("seq") or 0,
                                     payload.get("processed_up_to") or 0)
        inst = self._actor_instance
        method = getattr(inst, method_name, None) \
            if inst is not None else None
        if inst is None or method is None:
            self._release_actor_call(payload.get("caller"),
                                     payload.get("seq") or 0)
            raise protocol.RpcError(
                "not an actor worker" if inst is None else
                f"{type(inst).__name__} has no method {method_name}")

        emit_tev = self._actor_task_events_on()
        fn_label = f"{type(inst).__name__}.{method_name}"

        def _run():
            seq = TaskID(bytes.fromhex(payload["task_id"]))
            if emit_tev:
                tev.emit(payload["task_id"], tev.RUNNING, name=fn_label,
                         node_id=self.node_id, worker_pid=os.getpid(),
                         trace_ctx=payload.get("trace_ctx"))
            # adopt the caller's propagated span (nested-parent fix):
            # without this, a task submitted from inside an actor
            # method — including every serve replica's user code —
            # parented to this worker's _root_trace instead of its
            # caller, severing the trace tree at the actor boundary.
            # Saved/restored, not cleared: actor executor threads are
            # pooled and a replica may have installed a serve span.
            prev_trace = getattr(self.task_context, "trace", None)
            self.task_context.trace = payload.get("trace_ctx")
            try:
                args, kwargs = serialization.deserialize(payload["args"])
                args = [self._resolve_arg(a) for a in args]
                kwargs = {k: self._resolve_arg(v) for k, v in kwargs.items()}
                result = method(*args, **kwargs)
                if asyncio.iscoroutine(result):
                    result = asyncio.run(result)
                ser = serialization.serialize(result)
                oid = ObjectID.for_return(seq, 0)
                if emit_tev:
                    tev.emit(payload["task_id"], tev.FINISHED,
                             name=fn_label, node_id=self.node_id,
                             worker_pid=os.getpid())
                return self._ship_return(oid, ser)
            except BaseException as e:  # noqa: BLE001
                if emit_tev:
                    tev.emit(payload["task_id"], tev.FAILED,
                             name=fn_label, node_id=self.node_id,
                             worker_pid=os.getpid(),
                             error=f"{type(e).__name__}: {e}"[:200])
                err = exc.ActorError.capture(
                    f"{type(inst).__name__}.{method_name}", e)
                ser = serialization.serialize_error(err)
                oid = ObjectID.for_return(seq, 0)
                return {"object_id": oid.hex(), "inline": ser.to_bytes(),
                        "app_error": True}
            finally:
                self.task_context.trace = prev_trace

        try:
            executor = self._executor_for(method)
        except ValueError as e:
            self._release_actor_call(payload.get("caller"),
                                     payload.get("seq") or 0)
            # surface as an application error on the return object, not a
            # transport failure (which would look like an actor death)
            err = exc.ActorError.capture(
                f"{type(inst).__name__}.{method_name}", e)
            ser = serialization.serialize_error(err)
            oid = ObjectID.for_return(
                TaskID(bytes.fromhex(payload["task_id"])), 0)
            return {"object_id": oid.hex(), "inline": ser.to_bytes(),
                    "app_error": True}
        # enqueue BEFORE releasing the successor: the executor's FIFO
        # queue then preserves seq order within each concurrency group
        fut = loop.run_in_executor(executor, _run)
        self._release_actor_call(payload.get("caller"),
                                 payload.get("seq") or 0)
        return await fut


class _PlasmaIndirect:
    """Marker stored in a memory store slot: the value is in plasma."""

    def __init__(self, node_id: str):
        self.node_id = node_id


def _release_plasma(plasma: PlasmaxStore, oid: ObjectID, buf):
    try:
        buf.release()
        plasma.release(oid)
    except Exception:
        pass


# --------------------------------------------------------------------------
# Module-level convenience used by the public API

def get(ref_or_refs, *, timeout: Optional[float] = None):
    w = global_worker()
    if isinstance(ref_or_refs, ObjectRef):
        return w.get_objects([ref_or_refs], timeout)[0]
    if isinstance(ref_or_refs, list):
        return w.get_objects(ref_or_refs, timeout)
    raise TypeError("get() expects an ObjectRef or a list of ObjectRefs")
