"""Compiled actor DAGs: static graphs executed over pre-wired channels.

``node.compile()`` turns a ``.bind()``-built graph of actor methods into
a :class:`CompiledDAG`: actors are created (or reused) once, every
actor's address is resolved once, persistent peer-to-peer channels are
opened between consecutive stages (ray_tpu_torch/dag/channel.py), and each
``execute()`` is a single trigger frame — intermediate results flow
stage-to-stage without returning to the driver, skipping the
owner→raylet→worker dispatch pipeline entirely.

Compilability (everything else transparently degrades to the dynamic
``.execute()`` path):

* every stage is an actor method (``ClassMethodNode``); plain-function
  nodes have no persistent process to pre-wire;
* each stage consumes exactly ONE upstream value (the ``InputNode`` or
  another stage); remaining bound args/kwargs are constants;
* actor constructors take constants only;
* every stage worker negotiated wire schema >= 1.5 (``__hello__``).

Failure model: a stage worker death tears the compiled graph down — the
raylet notices the dead worker and notifies the compiling owner
(``dag_peer_down``), in-flight invocations re-run on the dynamic path
(each invocation returns exactly one result), and the next ``execute()``
re-compiles against fresh actors. See docs/COMPILED_DAGS.md.

Copied from the JAX package's ``ray_tpu/dag/compiled_dag.py``. Differences:

* a trigger payload over the inline limit rides a ring of the driver's
  own (stage id -1) to every entry stage on this host, as a stage's
  output does (JAX sends every trigger inline);
* the degrade is visible: ``CompiledDAG.stats()`` says whether the graph
  is compiled, whether it was found uncompilable, how many compiles
  failed, and how many executions ran compiled, ran dynamic, or were
  triggered compiled and re-ran on the dynamic path.
"""

from __future__ import annotations

import logging
import os
import threading
import weakref
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import protocol, serialization, tracing
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.dag import channel as dagch
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                                  InputNode, MultiOutputNode)
from ray_tpu_torch import exceptions as exc

logger = logging.getLogger(__name__)

_MIN_PEER_VERSION = (1, 5)  # dag channel frames joined the schema in 1.5

# dag_id -> weakref(CompiledDAG): routes dag_peer_down / dag_stage_error
# control-plane notifies (worker.py handlers) to the owning instance
_REGISTRY: Dict[str, "weakref.ref[CompiledDAG]"] = {}


class CompileError(Exception):
    """The graph cannot be compiled; callers fall back to dynamic."""


def on_peer_down(payload: Dict[str, Any]):
    ref = _REGISTRY.get(payload.get("dag_id") or "")
    cd = ref() if ref is not None else None
    if cd is not None:
        cd._on_channel_failure(
            f"stage worker {payload.get('worker_id', '?')} died")


def on_stage_error(payload: Dict[str, Any]):
    ref = _REGISTRY.get(payload.get("dag_id") or "")
    cd = ref() if ref is not None else None
    if cd is not None:
        cd._on_channel_failure(
            f"stage {payload.get('stage_id')} forward failed: "
            f"{payload.get('reason', '')}", seq=payload.get("seq"))


class _Invocation:
    """Driver-side state of one in-flight compiled execution."""

    __slots__ = ("event", "values", "error", "failed", "n_outputs",
                 "lock", "done", "_cb", "trace_span")

    def __init__(self, n_outputs: int):
        self.event = threading.Event()
        self.values: Dict[int, Any] = {}
        self.error: Optional[BaseException] = None
        self.failed: Optional[str] = None
        self.n_outputs = n_outputs
        self.lock = threading.Lock()
        self.done = False
        self._cb = None
        self.trace_span = None  # root span of this execution (1.6)

    # channel thread: decode one terminal output and maybe complete
    def deliver(self, index: int, payload: Dict[str, Any], plasma):
        try:
            value = dagch.decode_value(plasma, payload)
        except BaseException as e:  # noqa: BLE001 — app error envelope
            with self.lock:
                if self.done:
                    return
                self.error = e
                self.done = True
            self._complete()
            return
        with self.lock:
            if self.done:
                return
            self.values[index] = value
            if len(self.values) < self.n_outputs:
                return
            self.done = True
        self._complete()

    def fail(self, reason: str):
        with self.lock:
            if self.done:
                return  # result already arrived; late failure is noise
            self.failed = reason
            self.done = True
        self._complete()

    def _complete(self):
        self.event.set()
        cb, self._cb = self._cb, None
        if cb is not None:
            cb()

    def set_done_callback(self, cb):
        fire = False
        with self.lock:
            if self.done:
                fire = True
            else:
                self._cb = cb
        if fire:
            cb()


class _Watchdog:
    """One daemon thread arming timeouts for async invocations (a Timer
    per invocation would cost a thread each on the pipelined path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: List[Any] = []  # (deadline, inv)
        self._thread: Optional[threading.Thread] = None

    def arm(self, inv: _Invocation, timeout: float):
        import time as _time
        with self._lock:
            self._armed.append((_time.monotonic() + timeout, inv))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="rtt-dag-timeo")
                self._thread.start()

    def _run(self):
        import time as _time
        while True:
            _time.sleep(0.05)
            now = _time.monotonic()
            with self._lock:
                due = [x for x in self._armed if x[0] <= now or x[1].done]
                self._armed = [x for x in self._armed
                               if x[0] > now and not x[1].done]
            for _, inv in due:
                if not inv.done:
                    inv.fail("execute timed out")
            with self._lock:
                if not self._armed:
                    self._thread = None
                    return


_WATCHDOG = _Watchdog()


def _watchdog() -> _Watchdog:
    return _WATCHDOG


class _Stage:
    __slots__ = ("node", "stage_id", "upstream", "consumers", "out_index",
                 "actor", "address", "channel_address",
                 "channel_tcp_address", "trigger")

    def __init__(self, node: ClassMethodNode, stage_id: int):
        self.node = node
        self.stage_id = stage_id
        self.upstream: Optional[int] = None  # None = InputNode (entry)
        self.consumers: List[int] = []
        self.out_index: Optional[int] = None  # set on terminal stages
        self.actor = None
        self.address: Optional[str] = None
        self.channel_address: Optional[str] = None
        self.channel_tcp_address: str = ""  # 1.8: host:port twin
        self.trigger: Optional[dagch.FrameSocket] = None


class CompiledDAG:
    """A pre-wired execution graph. Create via ``DAGNode.compile()``.

    ``execute(x)`` returns the VALUE of the output node (a list for
    ``MultiOutputNode`` roots) — unlike dynamic ``.execute()``, which
    returns ObjectRefs: a compiled graph's results never become owned
    objects, they ride the channel straight back to the caller.
    """

    def __init__(self, root: DAGNode, *, ring_slots: int = 2,
                 buffer_size_bytes: int = 1 << 20,
                 execute_timeout_s: float = 30.0):
        self._root = root
        self._ring_slots = max(1, int(ring_slots))
        self._buffer_size = int(buffer_size_bytes)
        self._timeout_s = float(execute_timeout_s)
        self._base_id = os.urandom(8).hex()
        self._gen = 0
        self.dag_id = ""
        self._stages: List[_Stage] = []
        self._outputs: List[ClassMethodNode] = []
        self._compiled = False
        self._fallback_only = False
        self._seq = 0
        self._lock = threading.Lock()
        # in-flight window <= ring slots: a slot is only recycled once
        # the invocation that wrote it completed end-to-end, so capping
        # concurrency at the ring depth makes reuse race-free
        self._window = threading.BoundedSemaphore(self._ring_slots)
        self._compile_fail_at = 0.0
        self._trace_peers = False  # every stage peer negotiated >= 1.6
        self._input_ring: Optional[dagch.BufferRing] = None
        # what stats() reports (the degrade must be visible)
        self._counts = {"compiles": 0, "compile_failures": 0,
                        "compiled_executions": 0, "dynamic_executions": 0,
                        "dynamic_reruns": 0}
        self.uncompilable_reason = ""
        try:
            self._analyze()
        except CompileError as e:
            # structurally uncompilable (function nodes, multi-upstream
            # stages, …): permanently dynamic — never retried
            logger.info("dag not compilable, running dynamic: %s", e)
            self._fallback_only = True
            self.uncompilable_reason = str(e)
            return
        try:
            self._compile()
        except CompileError as e:
            # environmental (legacy peer, dead actor, channel refused):
            # run dynamic now, retry compilation later with backoff
            logger.info("dag compile degraded to dynamic execution: %s", e)
            self._note_compile_failure()

    def stats(self) -> Dict[str, Any]:
        """Whether the graph runs compiled and how its executions went:
        ``compiled``, ``fallback_only`` (structurally uncompilable,
        ``uncompilable_reason``), ``compiles``, ``compile_failures``,
        ``compiled_executions``, ``dynamic_executions`` (all executions
        that ran on the dynamic path) and ``dynamic_reruns`` (those of
        them that were triggered compiled and re-ran after a channel
        failure)."""
        with self._lock:
            return {"compiled": self._compiled,
                    "fallback_only": self._fallback_only,
                    "uncompilable_reason": self.uncompilable_reason,
                    **self._counts}

    # ------------------------------------------------------------ analysis

    def _analyze(self):
        if isinstance(self._root, MultiOutputNode):
            outputs = list(self._root._bound_args)
        elif isinstance(self._root, ClassMethodNode):
            outputs = [self._root]
        else:
            raise CompileError(
                "only actor-method graphs compile (root must be a "
                "ClassMethodNode or MultiOutputNode)")
        for o in outputs:
            if not isinstance(o, ClassMethodNode):
                raise CompileError(
                    f"output {type(o).__name__} is not an actor method")
        self._outputs = outputs

        order: List[ClassMethodNode] = []
        seen: Dict[int, _Stage] = {}

        def visit(node: ClassMethodNode):
            if id(node) in seen:
                return
            seen[id(node)] = None  # placeholder: cycle-safe
            up = self._upstream_of(node)
            if isinstance(up, ClassMethodNode):
                visit(up)
            order.append(node)

        for o in outputs:
            visit(o)
        stages = [_Stage(n, i) for i, n in enumerate(order)]
        by_node = {id(s.node): s for s in stages}
        for s in stages:
            up = self._upstream_of(s.node)
            if isinstance(up, ClassMethodNode):
                s.upstream = by_node[id(up)].stage_id
                by_node[id(up)].consumers.append(s.stage_id)
        for i, o in enumerate(outputs):
            st = by_node[id(o)]
            if st.out_index is not None:
                raise CompileError(
                    "the same stage appears twice in MultiOutputNode")
            st.out_index = i
        self._stages = stages

    @staticmethod
    def _upstream_of(node: ClassMethodNode) -> DAGNode:
        """The single data input of a stage (InputNode or upstream
        stage); everything else bound must be a constant."""
        ups = [a for a in node._bound_args if isinstance(a, DAGNode)]
        if any(isinstance(v, DAGNode) for v in node._bound_kwargs.values()):
            raise CompileError("DAG-valued kwargs are not compilable")
        if len(ups) != 1:
            raise CompileError(
                f"stage {node._method_name} must consume exactly one "
                f"upstream value, got {len(ups)}")
        up = ups[0]
        if not isinstance(up, (InputNode, ClassMethodNode)):
            raise CompileError(
                f"unsupported upstream node {type(up).__name__}")
        if isinstance(node._class_node, ClassNode) and \
                node._class_node._children():
            raise CompileError(
                "actor constructors must take constants only")
        return up

    # ------------------------------------------------------------- compile

    def _compile(self):
        w = global_worker()
        self._gen += 1
        self.dag_id = f"{self._base_id}.g{self._gen}"
        # one actor per ClassNode per CompiledDAG lifetime (the node
        # caches its handle; dead actors are invalidated + recreated).
        # The dead-check runs FIRST: a cached handle to a dead actor
        # still carries its stale worker address and would only fail at
        # channel open.
        cache: Dict[int, Any] = {}
        for s in self._stages:
            s.node._class_node._invalidate_if_dead()
        for s in self._stages:
            try:
                s.actor = s.node._class_node._execute_cached(cache, None)
                s.address = s.actor._resolve_address()
            except exc.ActorDiedError:
                s.node._class_node._invalidate_actor()
                s.actor = s.node._class_node._execute_cached({}, None)
                s.address = s.actor._resolve_address()

        ep = dagch.get_endpoint(w)
        opened: List[_Stage] = []
        min_peer: Optional[Tuple[int, int]] = None
        try:
            # open downstream-first so each stage learns its consumers'
            # channel addresses at open time
            for s in reversed(self._stages):
                downstream = []
                for c in s.consumers:
                    downstream.append({
                        "stage_id": c,
                        "address": self._stages[c].channel_address,
                        "tcp_address": self._stages[c].channel_tcp_address})
                if s.out_index is not None:
                    downstream.append({"address": ep.address, "sink": True,
                                       "tcp_address": ep.tcp_address,
                                       "index": s.out_index})
                payload = {
                    "dag_id": self.dag_id,
                    "stage_id": s.stage_id,
                    "method": s.node._method_name,
                    "args_tpl": self._args_template(s.node),
                    "kwargs_tpl": {
                        k: serialization.serialize(v).to_bytes()
                        for k, v in s.node._bound_kwargs.items()},
                    "downstream": downstream,
                    "owner_address": w.address,
                    "ring": {"slots": self._ring_slots,
                             "slot_bytes": self._buffer_size},
                }
                conn = w.io.run(w._peer(s.address))
                ver = self._negotiate(w, conn, s.address)
                if min_peer is None or tuple(ver) < min_peer:
                    min_peer = tuple(ver)
                try:
                    r = w.call_sync(conn, "dag_channel_open", payload,
                                    timeout=30)
                except protocol.RpcError as e:
                    raise CompileError(
                        f"channel open refused by {s.address}: {e}")
                s.channel_address = r["channel_address"]
                # 1.7-or-older stages omit the field: absent ⇒ unix-only
                s.channel_tcp_address = r.get("channel_tcp_address") or ""
                opened.append(s)
            # pre-dial the trigger sockets to every entry stage (unix
            # on-box, the 1.8 host:port endpoint across nodes)
            for s in self._stages:
                if s.upstream is None:
                    from ray_tpu_torch._private import netx
                    s.trigger = dagch.FrameSocket.dial(netx.pick(
                        s.channel_address, s.channel_tcp_address))
        except CompileError:
            for s in opened:
                self._close_stage(w, s)
            raise
        except Exception as e:  # noqa: BLE001 — any setup failure degrades
            for s in opened:
                self._close_stage(w, s)
            raise CompileError(f"{type(e).__name__}: {e}")
        self._input_ring = dagch.BufferRing(
            w.plasma, self.dag_id, -1, nslots=self._ring_slots,
            slot_bytes=self._buffer_size)
        _REGISTRY[self.dag_id] = weakref.ref(self)
        self._counts["compiles"] += 1
        # trace contexts on trigger/forward frames are 1.6 fields:
        # only send them when EVERY stage peer negotiated >= 1.6 — a
        # legacy stage runs the graph untraced instead of choking on a
        # frame shape it never declared (docs/TRACING.md)
        self._trace_peers = min_peer is not None and min_peer >= (1, 6)
        self._compiled = True

    @staticmethod
    def _negotiate(w, conn, address: str) -> Tuple[int, int]:
        """Version-gate the channel open (the PR-4 pattern: features ride
        the peer's declared minor). A pre-1.5 peer cannot host a dag
        stage — degrade to dynamic instead of failing mid-graph.
        Returns the peer's negotiated version (feature gates above 1.5
        — the 1.6 trace contexts — key off it)."""
        ver = conn.meta.get("peer_protocol_version")
        if ver is None:
            from ray_tpu_torch._private import schema
            try:
                reply = w.call_sync(conn, "__hello__",
                                    schema.hello_payload(), timeout=10)
                ver = tuple(int(v) for v in reply["protocol_version"])
            except protocol.RpcError:
                ver = (1, 0)  # pre-hello peer
            except Exception as e:  # noqa: BLE001
                raise CompileError(f"negotiation with {address} failed: {e}")
            conn.meta["peer_protocol_version"] = ver
        if tuple(ver) < _MIN_PEER_VERSION:
            raise CompileError(
                f"peer {address} negotiated wire schema "
                f"{ver[0]}.{ver[1]} < "
                f"{_MIN_PEER_VERSION[0]}.{_MIN_PEER_VERSION[1]} — "
                "compiled channels need 1.5")
        return tuple(ver)

    @staticmethod
    def _args_template(node: ClassMethodNode) -> List[List[Any]]:
        tpl: List[List[Any]] = []
        for a in node._bound_args:
            if isinstance(a, InputNode):
                tpl.append(["in"])
            elif isinstance(a, DAGNode):
                tpl.append(["up"])
            else:
                tpl.append(["c", serialization.serialize(a).to_bytes()])
        return tpl

    def _close_stage(self, w, s: _Stage):
        # fire-and-forget: this runs on teardown paths that may be ON
        # the io-loop thread (dag_peer_down / dag_stage_error handlers),
        # where a blocking RPC would deadlock the loop; a worker that is
        # already gone tears down implicitly anyway
        try:
            w.try_notify(s.address, "dag_channel_close",
                         {"dag_id": self.dag_id, "stage_id": s.stage_id})
        except Exception:
            pass

    # ------------------------------------------------------------- execute

    def execute(self, input_value: Any = None,
                timeout: Optional[float] = None) -> Any:
        """Run the graph once; returns the output value(s). Transparently
        falls back to the dynamic path on channel failure (the failed
        invocation re-runs dynamically, the next call re-compiles)."""
        timeout = self._timeout_s if timeout is None else timeout
        trig = self._trigger(input_value)
        if trig is None:
            return self._execute_dynamic(input_value)
        dag_id, seq, inv = trig
        inv.event.wait(timeout)
        return self._resolve(dag_id, seq, inv, input_value)

    def execute_async(self, input_value: Any = None,
                      timeout: Optional[float] = None) -> Future:
        """Pipelined trigger: returns a Future completed on the channel
        thread. In-flight invocations are capped at ``ring_slots``
        (slot-reuse safety) — that cap IS the pipeline depth."""
        timeout = self._timeout_s if timeout is None else timeout
        fut: Future = Future()
        trig = self._trigger(input_value)
        if trig is None:
            try:
                fut.set_result(self._execute_dynamic(input_value))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
            return fut
        dag_id, seq, inv = trig

        def _done():
            # channel thread (deliver/fail): resolve inline; the rare
            # dynamic fallback must not block result delivery for other
            # invocations, so it moves to its own thread
            if inv.failed is not None and inv.error is None:
                def _fb():
                    try:
                        fut.set_result(
                            self._resolve(dag_id, seq, inv, input_value))
                    except BaseException as e:  # noqa: BLE001
                        fut.set_exception(e)
                threading.Thread(target=_fb, daemon=True,
                                 name="rtt-dag-fallback").start()
                return
            try:
                fut.set_result(self._resolve(dag_id, seq, inv,
                                             input_value))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        _watchdog().arm(inv, timeout)
        inv.set_done_callback(_done)
        return fut

    def _trigger(self, input_value):
        """Send one trigger frame per entry stage; returns
        (dag_id, seq, inv) or None when the graph is running
        dynamic-only."""
        if self._fallback_only or not self._compiled:
            self._maybe_recompile()
        if self._fallback_only or not self._compiled:
            return None
        self._window.acquire()
        with self._lock:
            self._seq += 1
            seq = self._seq
            dag_id = self.dag_id  # pin: a recompile renames mid-flight
        w = global_worker()
        ep = dagch.get_endpoint(w)
        inv = _Invocation(n_outputs=len(self._outputs))
        tc = None
        cur = w._current_trace() if self._trace_peers \
            and tracing.enabled() else None
        if cur is not None and tracing.sampled(cur["trace_id"]):
            # root span of this execution, parented under the caller's
            # current trace (a dag executed inside a task/serve request
            # nests there); stages chain hop spans off the "tc" field.
            # Head-sampled out ⇒ no tc ⇒ stages do zero tracing work.
            inv.trace_span = tracing.Span(
                cur["trace_id"], f"dag.execute:{self.dag_id[:12]}",
                parent_span_id=(None if cur.get("span_id") == "root"
                                else cur.get("span_id")),
                kind="dag.execute", phase="transfer",
                attrs={"dag_id": self.dag_id, "seq": seq})
            tc = inv.trace_span.child_ctx()
        ep.inbox[(dag_id, seq)] = inv
        try:
            ser = serialization.serialize(input_value)
            inline_max = w.config.max_inline_object_size
            ring_desc = inline_desc = None
            for s in self._stages:
                if s.upstream is None:
                    # one ring write serves every entry stage on this
                    # host; one on another host gets the bytes inline
                    if s.trigger.peer.startswith("unix:"):
                        if ring_desc is None:
                            ring_desc = dagch.encode_value(
                                ser, self._input_ring, inline_max)
                        desc = ring_desc
                    else:
                        if inline_desc is None:
                            inline_desc = dagch.encode_value(
                                ser, None, inline_max)
                        desc = inline_desc
                    frame = {"d": dag_id, "t": s.stage_id,
                             "s": seq, **desc}
                    if tc is not None:
                        frame["tc"] = tc
                    s.trigger.send(dagch.DAG_EXEC, frame)
        except Exception as e:  # noqa: BLE001 — send failure = channel down
            inv.fail(f"trigger send failed: {e}")
        return dag_id, seq, inv

    def _resolve(self, dag_id: str, seq: int, inv: _Invocation,
                 input_value) -> Any:
        """Turn a finished (or timed-out) invocation into its value; a
        channel failure re-runs the invocation on the dynamic path —
        each execute() yields exactly one result either way."""
        try:
            w = global_worker()
            ep = getattr(w, "_dag_endpoint", None)
            if ep is not None:
                ep.inbox.pop((dag_id, seq), None)
            if not inv.done:
                inv.fail("execute timed out")  # no-op if just delivered
            if inv.trace_span is not None:
                inv.trace_span.finish(
                    "error" if inv.error is not None
                    or inv.failed is not None else "ok")
            if inv.error is not None:
                with self._lock:
                    self._counts["compiled_executions"] += 1
                raise inv.error
            if inv.failed is not None:
                self._mark_broken(inv.failed)
                with self._lock:
                    self._counts["dynamic_reruns"] += 1
                return self._execute_dynamic(input_value,
                                             reset_dead=True)
            with self._lock:
                self._counts["compiled_executions"] += 1
            out = [inv.values[i] for i in range(inv.n_outputs)]
            return out if isinstance(self._root, MultiOutputNode) \
                else out[0]
        finally:
            self._window.release()

    def _note_compile_failure(self):
        import time as _time
        self._compile_fail_at = _time.monotonic()
        self._counts["compile_failures"] += 1

    _COMPILE_RETRY_S = 1.0

    def _maybe_recompile(self):
        import time as _time
        with self._lock:
            if self._compiled or self._fallback_only:
                return
            if _time.monotonic() - self._compile_fail_at \
                    < self._COMPILE_RETRY_S:
                return  # recent failure: stay dynamic, retry later
            try:
                self._compile()
            except CompileError as e:
                logger.info("dag re-compile failed, staying dynamic "
                            "for now: %s", e)
                self._note_compile_failure()

    def _execute_dynamic(self, input_value, reset_dead: bool = False
                         ) -> Any:
        """The uncompiled path: classic ``.execute()`` + get. Arriving
        here via a channel failure (``reset_dead``), dead cached actors
        are invalidated FIRST so the re-run creates replacements instead
        of submitting to corpses. Each execute() yields exactly one
        result, and the break's DOWNSTREAM stages see the invocation
        exactly once (their compiled copy never fired); stages upstream
        of the break re-run — the same at-least-once contract as task
        retries."""
        from ray_tpu_torch._private.worker import get as _get
        with self._lock:
            self._counts["dynamic_executions"] += 1
        if reset_dead:
            for s in self._stages:
                s.node._class_node._invalidate_if_dead()
        for attempt in (0, 1):
            res = self._root.execute(input_value)
            refs = res if isinstance(res, list) else [res]
            try:
                vals = _get(refs, timeout=max(self._timeout_s, 60.0))
            except (exc.ActorDiedError, exc.ActorUnavailableError,
                    exc.ActorError) as e:
                # raced a death mid-re-run: invalidate and retry once.
                # A death downstream surfaces WRAPPED (the sink fails
                # resolving its upstream arg and reports an ActorError),
                # so match the message for the wrapped forms too.
                died = not isinstance(e, exc.ActorError) or \
                    "ActorDiedError" in str(e) or \
                    "ActorUnavailableError" in str(e)
                if attempt or not died:
                    raise
                for s in self._stages:
                    s.node._class_node._invalidate_if_dead()
                continue
            return vals if isinstance(self._root, MultiOutputNode) \
                else vals[0]

    # -------------------------------------------------------- failure path

    def _on_channel_failure(self, reason: str, seq: Optional[int] = None):
        """A peer died or a stage forward broke (raylet dag_peer_down /
        stage dag_stage_error notify, routed via worker.py)."""
        self._mark_broken(reason)
        w = global_worker()
        ep = getattr(w, "_dag_endpoint", None)
        if ep is None:
            return
        for (did, s), inv in list(ep.inbox.items()):
            if did == self.dag_id and (seq is None or s == seq):
                inv.fail(reason)

    def _mark_broken(self, reason: str):
        with self._lock:
            if not self._compiled:
                return
            self._compiled = False
        logger.warning("compiled dag %s torn down (%s); falling back to "
                       "dynamic dispatch, will re-compile on next call",
                       self.dag_id, reason)
        self._teardown_channels()

    def _teardown_channels(self):
        _REGISTRY.pop(self.dag_id, None)
        w = None
        try:
            w = global_worker()
        except RuntimeError:
            pass
        ring, self._input_ring = self._input_ring, None
        if ring is not None and w is not None:
            ring.free()
        for s in self._stages:
            if s.trigger is not None:
                s.trigger.close()
                s.trigger = None
            if w is not None and s.channel_address is not None:
                self._close_stage(w, s)
            s.channel_address = None

    def teardown(self):
        """Release channels, rings, and sockets. The graph object stays
        usable — the next execute() re-compiles."""
        with self._lock:
            self._compiled = False
        self._teardown_channels()

    def __del__(self):
        try:
            for s in self._stages:
                if s.trigger is not None:
                    s.trigger.close()
            _REGISTRY.pop(self.dag_id, None)
        except Exception:
            pass
