"""Pre-wired peer-to-peer channels for compiled actor DAGs.

The dynamic ``.execute()`` path pays the full dispatch pipeline per hop:
owner bookkeeping, two thread handoffs inside each worker
(io-loop → exec thread → io-loop), and a driver round trip between
stages — PERF.md puts the residual at ~420 µs/hop. For a *static* graph
all of that is re-derivable, so ``dag.compile()`` pays it once:

* every process (driver and stage workers) opens ONE dag listener — a
  plain blocking unix socket served by ordinary threads, deliberately
  outside the asyncio control plane;
* compile-time ``dag_channel_open`` RPCs (control plane, schema 1.5)
  hand each stage its spec and the downstream channel addresses; the
  stage dials its peers once and keeps the sockets;
* an invocation is a single ``dag_exec`` trigger frame; each stage's
  channel thread does recv → run the actor method inline → forward to
  the downstream peer socket. No owner, no raylet, no lease, no event
  loop on the forward path;
* payloads above the inline threshold ride reusable plasmax ring slots
  (``PlasmaxStore.ring_*``: seal/unseal cycling, zero allocator churn)
  when writer and reader share the segment, else inline bytes.

Frames reuse the protocol.py msgpack framing (``[NOTIFY, nil, method,
payload]``) so a channel is wire-inspectable with the same tooling —
see docs/WIRE_PROTOCOL.md §1.5 for the frame schemas and
docs/COMPILED_DAGS.md for the execution model.

Reference analogue: accelerated/compiled DAG execution in the reference
(python/ray/dag compiled graphs over shared-memory channels); the
channel-over-socket design here matches this runtime's plasmax +
msgpack substrate instead of the reference's mutable-plasma channels.

Copied from the JAX package's ``ray_tpu/dag/channel.py``. Differences:

* a ring slot lives in the writer's node store, and its descriptor names
  that store (``"p"``): a reader on another raylet of the same host maps
  the writer's segment (``foreign_store``) and reads the slot there. The
  JAX reader looks only in its own node's store, so a payload over the
  inline limit between two raylets fails with ``ChannelClosed("ring slot
  ... vanished")``. A peer on another host (reached over TCP) gets the
  payload inline;
* the driver writes trigger payloads over the inline limit into a ring
  of its own (``compiled_dag``), where JAX always sends them inline;
* every process counts its ring traffic (``ring_counts``), so a test or
  the card's smoke run can tell a ring hop from an inline one.
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import chaos, netx, protocol, serialization, tracing
from ray_tpu_torch.common.ids import ObjectID

logger = logging.getLogger(__name__)

# dag-channel frame methods (declared in schema.py; these flow over the
# dedicated channel sockets, not the control-plane Server)
DAG_EXEC = "dag_exec"          # trigger / stage→stage forward
DAG_RESULT = "dag_result"      # terminal stage → driver

# this process's channel traffic: payloads written to ring slots, payloads
# over the inline limit that went inline all the same (a full slot, a
# peer on another host), payloads read from ring slots and, of those,
# the ones read from another raylet's store
_COUNTS = {"ring_writes": 0, "ring_fallbacks": 0, "ring_reads": 0,
           "foreign_ring_reads": 0}
_COUNTS_LOCK = threading.Lock()


def _count(key: str):
    with _COUNTS_LOCK:
        _COUNTS[key] += 1


def ring_counts() -> Dict[str, int]:
    """A copy of this process's ring counters."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)



def pack_dag_frame(method: str, payload: Dict[str, Any]) -> bytes:
    return protocol.pack_frame([protocol.NOTIFY, None, method, payload])


class ChannelClosed(ConnectionError):
    pass


class FrameSocket:
    """A persistent blocking channel socket with the msgpack framing.

    Send is locked (stages can fan out to one peer from several threads);
    recv is single-reader (each accepted connection gets one thread).
    Chaos site ``dag.channel`` fires here on both directions.
    """

    def __init__(self, sock: socket.socket, peer: str = ""):
        self._sock = sock
        self._lock = threading.Lock()
        self._closed = False
        self.peer = peer
        self.peer_host = netx.host_of(peer)  # '' for unix/accepted conns

    @classmethod
    def dial(cls, address: str) -> "FrameSocket":
        """Dial a channel endpoint: ``unix:<path>`` on-box,
        ``host:port`` (1.8) across nodes."""
        if address.startswith("unix:"):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(address[5:])
            return cls(s, peer=address)
        host, sep, port = address.rpartition(":")
        if not sep:
            raise ChannelClosed(f"bad dag channel address: {address}")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.connect((host, int(port)))
        except OSError as e:
            s.close()
            raise ChannelClosed(str(e)) from e
        return cls(s, peer=address)

    def send(self, method: str, payload: Dict[str, Any]):
        if self.peer_host and netx.partitioned(self.peer_host):
            # one-direction sever: the frame is lost AND the socket dies
            # (an unplugged cable) — the stage reports over the control
            # plane and the driver falls back to dynamic dispatch
            self.close()
            raise ChannelClosed("chaos: network partition")
        act = chaos.hit("dag.channel", method)
        if act is not None:
            op = act["op"]
            if op == "drop":
                return
            if op == "delay":
                import time as _time
                _time.sleep(float(act.get("delay_s", 0.05)))
            elif op == "reset":
                self.close()
                raise ChannelClosed("chaos: dag channel reset (send)")
        data = pack_dag_frame(method, payload)
        with self._lock:
            if self._closed:
                raise ChannelClosed("channel closed")
            try:
                self._sock.sendall(data)
            except OSError as e:
                self._closed = True
                raise ChannelClosed(str(e)) from e

    def recv(self):
        """Blocking read of one [mtype, seq, method, payload] frame."""
        try:
            frame = protocol.read_frame_sync(self._sock)
        except (OSError, ConnectionError) as e:
            raise ChannelClosed(str(e)) from e
        act = chaos.hit("dag.channel", frame[2])
        if act is not None:
            op = act["op"]
            if op == "drop":
                return None  # caller loops
            if op == "delay":
                import time as _time
                _time.sleep(float(act.get("delay_s", 0.05)))
            elif op == "reset":
                self.close()
                raise ChannelClosed("chaos: dag channel reset (recv)")
        return frame

    def close(self):
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class DagListener:
    """Per-process dag channel endpoint: one listening unix socket, an
    accept thread, and one reader thread per accepted connection. The
    handler runs ON the reader thread — that thread *is* the stage
    executor on workers (recv → exec → forward with no handoff)."""

    def __init__(self, path: str,
                 handler: Callable[[str, Dict[str, Any]], None],
                 tcp_host: Optional[str] = None):
        self.path = path
        self.address = f"unix:{path}"
        self.handler = handler
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(path)
        except OSError:
            pass
        self._sock.bind(path)
        self._sock.listen(64)
        self._closed = False
        self._conns: List[FrameSocket] = []
        # 1.8: host:port twin of the endpoint — same frames, same reader
        # threads, so a stage on another node forwards identically
        self.tcp_address = ""
        self._tcp_sock: Optional[socket.socket] = None
        if tcp_host:
            try:
                ts = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                ts.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                ts.bind((tcp_host, 0))
                ts.listen(64)
                self._tcp_sock = ts
                self.tcp_address = f"{tcp_host}:{ts.getsockname()[1]}"
            except OSError:
                logger.warning("dag listener: TCP endpoint on %s failed; "
                               "channels stay unix-only", tcp_host)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, args=(self._sock,),
            name="rtt-dag-accept", daemon=True)
        self._accept_thread.start()
        if self._tcp_sock is not None:
            threading.Thread(
                target=self._accept_loop, args=(self._tcp_sock,),
                name="rtt-dag-accept-tcp", daemon=True).start()

    def _accept_loop(self, lsock: socket.socket):
        while not self._closed:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            if conn.family == socket.AF_INET:
                try:
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            fs = FrameSocket(conn)
            self._conns.append(fs)
            threading.Thread(target=self._reader_loop, args=(fs,),
                             name="rtt-dag-chan", daemon=True).start()

    def _reader_loop(self, fs: FrameSocket):
        while not self._closed:
            try:
                frame = fs.recv()
            except ChannelClosed:
                return
            if frame is None:
                continue  # chaos drop
            try:
                self.handler(frame[2], frame[3])
            except Exception:
                logger.exception("dag channel handler failed")

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        if self._tcp_sock is not None:
            try:
                self._tcp_sock.close()
            except OSError:
                pass
        for fs in self._conns:
            fs.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


# --------------------------------------------------------------------------
# payload encoding: inline bytes vs plasmax ring slot


def ring_slot_id(dag_id: str, stage_id: int, slot: int) -> ObjectID:
    digest = hashlib.sha256(
        f"dagring:{dag_id}:{stage_id}:{slot}".encode()).digest()
    return ObjectID(digest[:ObjectID.SIZE])


class BufferRing:
    """The writer side of one stage's output ring: N fixed-size plasmax
    slots cycled seal→unseal→refill→seal (see PlasmaxStore.ring_*).
    Slots are created lazily on the first payload that exceeds the
    inline threshold and freed at teardown."""

    def __init__(self, plasma, dag_id: str, stage_id: int,
                 nslots: int = 2, slot_bytes: int = 1 << 20):
        self.plasma = plasma
        self.dag_id = dag_id
        self.stage_id = stage_id
        self.nslots = max(1, int(nslots))
        self.slot_bytes = int(slot_bytes)
        self._created: Dict[int, ObjectID] = {}
        self._seq = 0

    def write(self, ser) -> Optional[Dict[str, Any]]:
        """Write a SerializedObject into the next slot; returns the frame
        descriptor {"o": hex, "n": size} or None (caller sends inline)."""
        size = ser.total_size
        if size > self.slot_bytes:
            return None
        slot = self._seq % self.nslots
        self._seq += 1
        oid = self._created.get(slot)
        try:
            if oid is None:
                oid = ring_slot_id(self.dag_id, self.stage_id, slot)
                buf = self.plasma.ring_create(oid, self.slot_bytes)
                self._created[slot] = oid
            else:
                buf = self.plasma.ring_recycle(oid)
                if buf is None:
                    return None  # reader wedged/evicted: inline this one
                buf = buf[:self.slot_bytes]
        except Exception:
            return None  # store pressure etc.: inline is always correct
        ser.write_into(buf[:size])
        buf.release()
        self.plasma.ring_seal(oid)
        _count("ring_writes")
        return {"o": oid.hex(), "n": size, "p": self.plasma.path}

    def free(self):
        for oid in self._created.values():
            try:
                self.plasma.ring_free(oid)
            except Exception:
                pass
        self._created.clear()


def encode_value(ser, ring: Optional[BufferRing],
                 inline_max: int) -> Dict[str, Any]:
    """Frame fields for one serialized payload: ring slot when it pays,
    inline bytes otherwise (``ring`` None: the reader cannot map the
    writer's store)."""
    if ser.total_size > inline_max:
        desc = ring.write(ser) if ring is not None else None
        if desc is not None:
            return desc
        _count("ring_fallbacks")
    return {"b": ser.to_bytes()}


_FOREIGN: Dict[str, Any] = {}
_FOREIGN_LOCK = threading.Lock()


def foreign_store(plasma, path: Optional[str]):
    """The store holding a ring slot: this node's, or another raylet's
    segment on this host, mapped once per process and kept."""
    if not path or path == plasma.path:
        return plasma
    with _FOREIGN_LOCK:
        store = _FOREIGN.get(path)
        if store is None:
            from ray_tpu_torch._private.object_store import PlasmaxStore
            try:
                store = PlasmaxStore(path)
            except Exception as e:  # noqa: BLE001 — segment gone
                raise ChannelClosed(
                    f"ring store {path} cannot be mapped: {e}") from e
            _FOREIGN[path] = store
    return store


def decode_value(plasma, payload: Dict[str, Any]) -> Any:
    """Decode a dag frame payload into a Python value. Ring-slot reads
    copy out of shared memory before deserializing so the slot can be
    recycled immediately (one copy — the price of reuse; zero-copy
    views would pin the slot across invocations).

    Error envelopes re-raise here (serialization.deserialize contract),
    so callers see stage application errors as exceptions."""
    if payload.get("o") is not None:
        oid = ObjectID.from_hex(payload["o"])
        store = foreign_store(plasma, payload.get("p"))
        buf = store.get_buffer(oid)
        if buf is None:
            raise ChannelClosed(f"ring slot {payload['o'][:12]} vanished")
        try:
            data = bytes(buf[:payload["n"]])
        finally:
            buf.release()
            store.release(oid)
        _count("ring_reads")
        if store is not plasma:
            _count("foreign_ring_reads")
        return serialization.deserialize(data)
    return serialization.deserialize(payload["b"])


# --------------------------------------------------------------------------
# worker-side stage runtime


class StageRuntime:
    """One compiled stage living in an actor worker: the bound method,
    the arg template, and the pre-dialed downstream channel sockets.

    ``run()`` is invoked on the dag reader thread with the upstream
    value; it executes the actor method INLINE (bypassing the
    io-loop→exec-thread→io-loop round trip the dynamic actor_call path
    pays) and pushes the result straight to the downstream sockets.
    """

    def __init__(self, worker, payload: Dict[str, Any]):
        self.worker = worker
        self.dag_id = payload["dag_id"]
        self.stage_id = int(payload["stage_id"])
        self.owner = payload["owner_address"]
        inst = worker._actor_instance
        if inst is None:
            raise protocol.RpcError("dag_channel_open: not an actor worker")
        self.method = getattr(inst, payload["method"], None)
        if self.method is None:
            raise protocol.RpcError(
                f"{type(inst).__name__} has no method {payload['method']}")
        # arg template: [["in"], ["up"], ["c", <serialized bytes>]] per
        # positional arg; kwargs are constants only
        self.args_tpl = [
            (t[0], serialization.deserialize(t[1]) if t[0] == "c" else None)
            for t in payload["args_tpl"]]
        self.kwargs = {k: serialization.deserialize(v)
                       for k, v in (payload.get("kwargs_tpl") or {}).items()}
        ring_cfg = payload.get("ring") or {}
        self.ring = BufferRing(
            worker.plasma, self.dag_id, self.stage_id,
            nslots=int(ring_cfg.get("slots", 2)),
            slot_bytes=int(ring_cfg.get("slot_bytes", 1 << 20)))
        self.inline_max = worker.config.max_inline_object_size
        # downstream peers: [{"stage_id", "address", "tcp_address",
        # "sink", "index"}] — dial now, keep forever (sink = the
        # driver's result endpoint); unix on-box, host:port off-box
        self.downstream: List[Dict[str, Any]] = []
        for peer in payload["downstream"]:
            addr = netx.pick(peer.get("address"), peer.get("tcp_address"))
            fs = FrameSocket.dial(addr)
            self.downstream.append({"sock": fs, "sink": peer.get("sink"),
                                    "stage_id": int(peer.get("stage_id",
                                                             -1)),
                                    "index": int(peer.get("index", 0))})
        # a peer dialed over TCP is on another host and cannot map this
        # node's store: its payloads go inline
        self.ring_ok = all(p["sock"].peer.startswith("unix:")
                           for p in self.downstream)

    # -- forward path (dag reader thread) --

    def run(self, seq: int, payload: Dict[str, Any]):
        if chaos._ENGINE is not None:
            # chaos injection point: targeted stage faults — the method
            # filter is the stage id, so a schedule can SIGKILL exactly
            # the N-th execution of one mid-graph stage (the generic
            # dag.channel site can't tell stages apart)
            chaos.hit("dag.stage", str(self.stage_id))
        # hop span (1.6): frames from a >=1.6 driver carry "tc"; this
        # stage's span chains under the upstream hop (or the execute
        # root) and its own ctx rides the forwarded frame — the trace
        # tree follows the data through the pipe. Legacy frames have no
        # "tc" and the graph runs untraced.
        tc = payload.get("tc")
        span = None
        if tc and tracing.enabled():
            span = tracing.Span(
                tc["trace_id"],
                f"dag.stage:{self.method.__name__}",
                parent_span_id=tc.get("span_id"), kind="dag.hop",
                phase="execute",
                attrs={"dag_id": self.dag_id,
                       "stage_id": self.stage_id, "seq": seq})
        fwd_tc = span.child_ctx() if span is not None else None
        try:
            value = decode_value(self.worker.plasma, payload)
        except BaseException as e:  # noqa: BLE001 — upstream app error
            # an upstream stage error travels the pipe as an error
            # envelope; terminal stages surface it to the driver, middle
            # stages just pass it on without running user code
            self._forward_error(seq, e, tc=fwd_tc)
            if span is not None:
                span.finish("error")
            return
        args = [value if t[0] in ("in", "up") else t[1]
                for t in self.args_tpl]
        prev_trace = None
        if span is not None:
            # nested submits from stage user code parent under this hop
            prev_trace = getattr(self.worker.task_context, "trace", None)
            self.worker.task_context.trace = span.trace_ctx()
        try:
            result = self.method(*args, **self.kwargs)
        except BaseException as e:  # noqa: BLE001 — user code
            from ray_tpu_torch import exceptions as exc
            err = exc.ActorError.capture(
                f"{type(self.worker._actor_instance).__name__}."
                f"{self.method.__name__}", e)
            self._forward_error(seq, err, tc=fwd_tc)
            if span is not None:
                span.finish("error")
            return
        finally:
            if span is not None:
                self.worker.task_context.trace = prev_trace
        ser = serialization.serialize(result)
        desc = encode_value(ser, self.ring if self.ring_ok else None,
                            self.inline_max)
        t_fwd = time.time()
        self._forward(seq, desc, app_error=False, tc=fwd_tc)
        if span is not None:
            end = time.time()
            if end - t_fwd > 1e-4:
                tracing.record_span(
                    span.trace_id, tracing.new_span_id(),
                    f"dag.forward:{self.stage_id}",
                    parent_span_id=span.span_id, kind="dag.hop",
                    phase="transfer", start_ts=t_fwd, end_ts=end)
            span.finish(end_ts=end)

    def _forward_error(self, seq: int, e: BaseException,
                       tc: Optional[Dict[str, str]] = None):
        ser = serialization.serialize_error(e)
        self._forward(seq, {"b": ser.to_bytes()}, app_error=True, tc=tc)

    def _forward(self, seq: int, desc: Dict[str, Any], app_error: bool,
                 tc: Optional[Dict[str, str]] = None):
        for peer in self.downstream:
            frame = {"d": self.dag_id, "s": seq, **desc}
            if tc is not None:
                frame["tc"] = tc
            try:
                if peer["sink"]:
                    peer["sock"].send(DAG_RESULT,
                                      {**frame, "i": peer["index"],
                                       "ae": app_error})
                else:
                    peer["sock"].send(DAG_EXEC,
                                      {**frame, "t": peer["stage_id"]})
            except ChannelClosed as e:
                # downstream died: tell the driver over the CONTROL plane
                # (this channel may have no direct driver socket) so it
                # can fall back without waiting out its exec timeout
                self._notify_driver_error(seq, str(e))

    def _notify_driver_error(self, seq: int, reason: str):
        self.worker.try_notify(self.owner, "dag_stage_error",
                               {"dag_id": self.dag_id,
                                "stage_id": self.stage_id,
                                "seq": seq, "reason": reason})

    def close(self):
        for peer in self.downstream:
            peer["sock"].close()
        self.ring.free()


# --------------------------------------------------------------------------
# per-process endpoint wiring (driver and workers share this)


_ENDPOINT_LOCK = threading.Lock()


def get_endpoint(worker) -> "DagEndpoint":
    ep = getattr(worker, "_dag_endpoint", None)
    if ep is None:
        with _ENDPOINT_LOCK:
            ep = getattr(worker, "_dag_endpoint", None)
            if ep is None:
                ep = DagEndpoint(worker)
                worker._dag_endpoint = ep
    return ep


class DagEndpoint:
    """Everything dag-channel in one process: the listener, the stage
    registry (workers), and the driver inbox (compiling processes)."""

    def __init__(self, worker):
        self.worker = worker
        path = os.path.join(
            worker.session_dir or "/tmp",
            f"dagch_{worker.worker_id.hex()[:12]}.sock")
        self.listener = DagListener(
            path, self._on_frame,
            tcp_host=netx.node_ip() if netx.enabled() else None)
        self.address = self.listener.address
        self.tcp_address = self.listener.tcp_address
        self.stages: Dict[tuple, StageRuntime] = {}
        # driver side: (dag_id, seq) -> _Invocation
        self.inbox: Dict[tuple, Any] = {}
        self._lock = threading.Lock()

    # channel-thread entry: trigger/forward frames run the stage right
    # here; result frames complete driver invocations
    def _on_frame(self, method: str, payload: Dict[str, Any]):
        if method == DAG_EXEC:
            stage = self.stages.get((payload["d"], int(payload["t"])))
            if stage is None:
                logger.warning("dag_exec for unknown stage %s/%s",
                               payload.get("d"), payload.get("t"))
                return
            stage.run(payload["s"], payload)
        elif method == DAG_RESULT:
            inv = self.inbox.get((payload["d"], payload["s"]))
            if inv is not None:
                inv.deliver(int(payload.get("i", 0)), payload,
                            self.worker.plasma)

    # -- worker side --

    def open_stage(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        rt = StageRuntime(self.worker, payload)
        key = (rt.dag_id, rt.stage_id)
        with self._lock:
            old = self.stages.pop(key, None)
            self.stages[key] = rt
        if old is not None:
            old.close()
        return {"channel_address": self.address,
                "channel_tcp_address": self.tcp_address}

    def close_stage(self, dag_id: str, stage_id: Optional[int] = None):
        with self._lock:
            keys = [k for k in self.stages
                    if k[0] == dag_id
                    and (stage_id is None or k[1] == stage_id)]
            rts = [self.stages.pop(k) for k in keys]
        for rt in rts:
            rt.close()

    def close(self):
        with self._lock:
            stages = {id(s): s for s in self.stages.values()}
            self.stages.clear()
        for s in stages.values():
            s.close()
        self.listener.close()
