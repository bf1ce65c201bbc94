"""The process-wide netx client: pooled cross-node frame connections.

ONE native pump + one IO thread per process serves every off-box (and
forced-TCP) fast-path consumer — raylet object pulls, actor calls on
the direct lane, keepalives.  Requests can be issued from any thread
(``request``) or from an asyncio coroutine (``call_async``); replies
are routed back by ``(cid, seq)``.  ``px_chunk`` notifies bypass the
request table entirely: each carries a stream id that resolves to a
sink writing straight into a plasma create buffer ON the IO thread —
no asyncio hop, no staging copy.

Connection hygiene is the tentpole's pool contract: ``ping``
keepalives on quiet connections (kill after 3 missed windows), idle
reaping after ``RTT_NET_IDLE_S``, an ``RTT_NET_POOL_MAX`` cap
evicting LRU-idle peers, and exponential-backoff redial starting at
``RTT_NET_RECONNECT_S`` so a flapping peer can't melt the dialer.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch._private import chaos, protocol, rpccore
from ray_tpu_torch._private.netx import endpoints

logger = logging.getLogger(__name__)

_REQUEST, _REPLY, _ERROR, _NOTIFY = (protocol.REQUEST, protocol.REPLY,
                                     protocol.ERROR, protocol.NOTIFY)

_BACKOFF_CAP_S = 5.0


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def keepalive_s() -> float:
    return _env_f("RTT_NET_KEEPALIVE_S", 10.0)


def idle_s() -> float:
    return _env_f("RTT_NET_IDLE_S", 60.0)


def reconnect_s() -> float:
    return _env_f("RTT_NET_RECONNECT_S", 0.2)


def pool_max() -> int:
    return int(_env_f("RTT_NET_POOL_MAX", 16))


def stall_s() -> float:
    return _env_f("RTT_NET_STALL_S", 10.0)


def _pack(body) -> bytes:
    return msgpack.packb(body, use_bin_type=True)


def chaos_send(pump: rpccore.Pump, cid: int, method: str, data: bytes,
               peer_host: str = "") -> bool:
    """One frame through BOTH outbound fault gates: the net.partition
    site (drop + sever — an unplugged cable, not a polite reset) and
    the protocol.send frame faults, with the same drop/delay/dup/reset
    semantics as the asyncio Connection and the direct lane.  Returns
    False when the connection is gone."""
    if peer_host and endpoints.partitioned(peer_host):
        pump.close_conn(cid)
        return False
    eng = chaos._ENGINE
    if eng is not None:
        act = eng.hit("protocol.send", method)
        if act is not None:
            op = act["op"]
            if op == "drop":
                return True  # lost on the wire; peer never sees it
            if op == "delay":
                time.sleep(float(act.get("delay_s", eng.delay_s)))
            elif op == "reset":
                pump.close_conn(cid)
                return False
            elif op == "dup":
                pump.send(cid, data)
    return pump.send(cid, data)


class PullBusy(Exception):
    """Server at its serve-concurrency cap — retry later (maps onto the
    raylet's tree-broadcast busy/backoff discipline)."""


class PullNotFound(Exception):
    """The replica no longer holds the object (evicted/raced)."""


class _Conn:
    __slots__ = ("addr", "cid", "peer_host", "last_used", "last_heard",
                 "ping_sent", "inflight")

    def __init__(self, addr: str, cid: int, peer_host: str):
        now = time.monotonic()
        self.addr = addr
        self.cid = cid
        self.peer_host = peer_host
        self.last_used = now
        self.last_heard = now
        self.ping_sent: Optional[float] = None
        self.inflight = 0


class _Sink:
    """One in-flight pull stream: chunk frames land here (on the IO
    thread) and are written offset-addressed into the destination
    buffer, so duplicated frames are idempotent and resume-after-
    reconnect is just 'continue from .got'."""

    __slots__ = ("stream", "cid", "buf", "got", "total", "event", "error",
                 "last_progress")

    def __init__(self, stream: int, buf, got: int, total: int):
        self.stream = stream
        self.cid = -1
        self.buf = buf
        self.got = got
        self.total = total
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.last_progress = time.monotonic()

    def fail(self, err: BaseException):
        if self.error is None:
            self.error = err
        self.event.set()

    def finish(self):
        self.event.set()


class NetxClient:
    """See module docstring. One instance per process (``get_client``)."""

    def __init__(self):
        self._pump = rpccore.Pump()
        self._lock = threading.Lock()
        self._dial_cv = threading.Condition(self._lock)
        self._conns: Dict[str, _Conn] = {}
        self._by_cid: Dict[int, _Conn] = {}
        self._dialing: set = set()
        self._backoff: Dict[str, Tuple[float, float]] = {}
        self._pending: Dict[Tuple[int, int],
                            Callable[[bool, Any], None]] = {}
        self._streams: Dict[int, _Sink] = {}
        self._seq = itertools.count(1)
        self._sids = itertools.count(1)
        self._closed = False
        self._last_tend = 0.0
        self.stats = {"requests": 0, "chunks_in": 0, "bytes_in": 0,
                      "redials": 0, "reaped": 0, "pings": 0}
        self._thread = threading.Thread(
            target=self._run, name="rtpu-netx-io", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ dialing

    def _conn_for(self, address: str) -> _Conn:
        """Pooled connection to ``address`` (dial on miss). Backoff gate
        fails fast so callers fall back to their slow path instead of
        hammering a dead peer."""
        deadline = time.monotonic() + 10.0
        with self._lock:
            while True:
                if self._closed:
                    raise ConnectionError("netx client closed")
                conn = self._conns.get(address)
                if conn is not None:
                    conn.last_used = time.monotonic()
                    return conn
                gate = self._backoff.get(address)
                if gate is not None and time.monotonic() < gate[0]:
                    raise ConnectionError(
                        f"netx: {address} in reconnect backoff")
                if address not in self._dialing:
                    self._dialing.add(address)
                    break
                # another thread is dialing this peer: wait for it
                if not self._dial_cv.wait(
                        timeout=max(0.0, deadline - time.monotonic())):
                    raise ConnectionError(
                        f"netx: timed out waiting for dial of {address}")
        try:
            cid = self._pump.dial(address)
        except Exception:
            with self._lock:
                delay = self._backoff.get(address, (0.0, reconnect_s()))[1]
                self._backoff[address] = (time.monotonic() + delay,
                                          min(delay * 2, _BACKOFF_CAP_S))
                self._dialing.discard(address)
                self._dial_cv.notify_all()
            raise
        conn = _Conn(address, cid, endpoints.host_of(address))
        with self._lock:
            if self._backoff.pop(address, None) is not None:
                self.stats["redials"] += 1
            self._conns[address] = conn
            self._by_cid[cid] = conn
            self._dialing.discard(address)
            self._dial_cv.notify_all()
        return conn

    # ----------------------------------------------------------- requests

    def _start_request(self, address: str, method: str, payload: Any,
                       done: Callable[[bool, Any], None]
                       ) -> Optional[Tuple[int, int]]:
        """Register + send one REQUEST; ``done(ok, payload_or_exc)``
        fires exactly once, from the IO thread (or inline on immediate
        failure). Returns the pending key for timeout cleanup."""
        try:
            conn = self._conn_for(address)
        except Exception as e:
            done(False, e)
            return None
        seq = next(self._seq)
        key = (conn.cid, seq)
        with self._lock:
            self._pending[key] = done
            conn.inflight += 1
            conn.last_used = time.monotonic()
            self.stats["requests"] += 1
        data = _pack([_REQUEST, seq, method, payload])
        if not chaos_send(self._pump, conn.cid, method, data,
                          conn.peer_host):
            # the conn died between pooling and send (or a fault severed
            # it): close_conn's KIND_CLOSED normally fails the pending,
            # but if the close already drained we must fail it here
            self._pump.close_conn(conn.cid)
            with self._lock:
                cb = self._pending.pop(key, None)
            if cb is not None:
                cb(False, ConnectionError(
                    f"netx: send to {address} failed"))
            return None
        return key

    def request(self, address: str, method: str, payload: Any,
                timeout: float = 30.0) -> Any:
        """Synchronous request from any thread."""
        slot: Dict[str, Any] = {}
        ev = threading.Event()

        def done(ok, r):
            slot["ok"] = ok
            slot["r"] = r
            ev.set()

        key = self._start_request(address, method, payload, done)
        if not ev.wait(timeout):
            if key is not None:
                with self._lock:
                    cb = self._pending.pop(key, None)
                    conn = self._by_cid.get(key[0])
                    if cb is not None and conn is not None:
                        conn.inflight = max(0, conn.inflight - 1)
            raise TimeoutError(f"netx: {method} to {address} timed out")
        if not slot["ok"]:
            r = slot["r"]
            raise r if isinstance(r, BaseException) \
                else protocol.RpcError(r)
        return slot["r"]

    def call_async(self, address: str, method: str, payload: Any
                   ) -> "asyncio.Future":
        """Issue a request from a running event loop. The send happens
        INLINE in this call, so per-peer wire order follows call order —
        exactly what the actor sequence lane needs."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def done(ok, r):
            def _set():
                if fut.cancelled():
                    return
                if ok:
                    fut.set_result(r)
                else:
                    fut.set_exception(
                        r if isinstance(r, BaseException)
                        else protocol.RpcError(r))
            try:
                loop.call_soon_threadsafe(_set)
            except RuntimeError:
                pass  # loop gone (shutdown)

        self._start_request(address, method, payload, done)
        return fut

    def _notify(self, cid: int, method: str, payload: Any,
                peer_host: str = ""):
        data = _pack([_NOTIFY, None, method, payload])
        chaos_send(self._pump, cid, method, data, peer_host)

    # -------------------------------------------------------- pull streams

    def get_header(self, address: str, object_id_hex: str,
                   timeout: float = 30.0) -> Dict[str, Any]:
        """``px_get``: does the peer hold the object, how big, or busy."""
        return self.request(address, "px_get",
                            {"object_id": object_id_hex}, timeout)

    def pull_into(self, address: str, object_id_hex: str, buf, total: int,
                  offset: int = 0, attempts: int = 5,
                  stall_timeout: Optional[float] = None) -> int:
        """Stream the object's bytes into ``buf`` (a plasma create
        buffer) via windowed ``px_chunk`` frames. Transport failures
        resume from the high-water mark on a fresh connection; data
        failures (crc, server error) raise so the caller treats the
        replica as bad. Returns the byte count written."""
        if stall_timeout is None:
            stall_timeout = stall_s()
        mv = memoryview(buf)
        got = offset
        last_err: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt:
                time.sleep(min(reconnect_s() * (2 ** (attempt - 1)), 1.0))
            sid = next(self._sids)
            sink = _Sink(sid, mv, got, total)
            try:
                conn = self._conn_for(address)
            except Exception as e:
                last_err = e
                continue
            sink.cid = conn.cid
            with self._lock:
                self._streams[sid] = sink
            try:
                r = self.request(
                    address, "px_pull",
                    {"object_id": object_id_hex, "offset": got,
                     "stream": sid, "from_host": endpoints.node_ip()},
                    timeout=max(stall_timeout, 30.0))
            except Exception as e:
                with self._lock:
                    self._streams.pop(sid, None)
                last_err = e
                if isinstance(e, (ConnectionError, TimeoutError)):
                    continue
                raise
            if r.get("busy"):
                with self._lock:
                    self._streams.pop(sid, None)
                raise PullBusy(address)
            if not r.get("found", True):
                with self._lock:
                    self._streams.pop(sid, None)
                raise PullNotFound(object_id_hex)
            while not sink.event.wait(timeout=0.5):
                if time.monotonic() - sink.last_progress > stall_timeout:
                    with self._lock:
                        self._streams.pop(sid, None)
                    self._notify(sink.cid, "px_ack",
                                 {"stream": sid, "got": -1},
                                 conn.peer_host)
                    sink.fail(TimeoutError(
                        f"netx: pull of {object_id_hex[:8]} from "
                        f"{address} stalled at {sink.got}/{total}"))
                    break
            if sink.error is None:
                return sink.got - offset
            last_err = sink.error
            got = max(got, sink.got)  # resume, never re-transfer
            if not isinstance(sink.error, (ConnectionError, TimeoutError)):
                raise sink.error
        raise last_err if last_err is not None else ConnectionError(
            f"netx: pull from {address} failed")

    # ------------------------------------------------------------- IO loop

    def _run(self):
        while not self._closed:
            try:
                evs = self._pump.next_batch(250)
            except Exception:
                return  # pump destroyed under us
            if evs is None:
                return  # shutdown
            for cid, kind, body in evs:
                if kind == rpccore.KIND_CLOSED:
                    self._on_closed(cid)
                elif kind == rpccore.KIND_FRAME:
                    try:
                        self._on_frame(cid, body)
                    except Exception:
                        logger.exception("netx client: frame failed")
            self._tend()

    def _on_closed(self, cid: int):
        with self._lock:
            conn = self._by_cid.pop(cid, None)
            if conn is not None and self._conns.get(conn.addr) is conn:
                del self._conns[conn.addr]
                # arm backoff so the NEXT dial of a flapping peer waits
                if conn.addr not in self._backoff:
                    self._backoff[conn.addr] = (
                        time.monotonic() + reconnect_s(),
                        min(reconnect_s() * 2, _BACKOFF_CAP_S))
            dead = [k for k in self._pending if k[0] == cid]
            cbs = [self._pending.pop(k) for k in dead]
            sinks = [s for s in self._streams.values() if s.cid == cid]
            for s in sinks:
                self._streams.pop(s.stream, None)
        err = ConnectionError("netx: connection closed")
        for cb in cbs:
            cb(False, err)
        for s in sinks:
            s.fail(err)

    def _on_frame(self, cid: int, body: bytes):
        try:
            mtype, seq, method, payload = msgpack.unpackb(body, raw=False)
        except Exception:
            self._pump.close_conn(cid)
            return
        eng = chaos._ENGINE
        if eng is not None and mtype in (_REQUEST, _NOTIFY):
            # inbound frame-fault site, same semantics as the asyncio
            # reader and the direct lane (replies exempt: reply loss is
            # modeled sender-side)
            act = eng.hit("protocol.recv", method)
            if act is not None:
                op = act["op"]
                if op == "drop":
                    return
                if op == "delay":
                    time.sleep(float(act.get("delay_s", eng.delay_s)))
                elif op == "reset":
                    self._pump.close_conn(cid)
                    return
                elif op == "dup" and method == "px_chunk":
                    self._on_chunk(cid, payload)  # idempotent write
        conn = self._by_cid.get(cid)
        if conn is not None:
            conn.last_heard = time.monotonic()
            conn.ping_sent = None
        if mtype in (_REPLY, _ERROR):
            with self._lock:
                cb = self._pending.pop((cid, seq), None)
                if conn is not None and cb is not None:
                    conn.inflight = max(0, conn.inflight - 1)
            if cb is not None:
                if mtype == _REPLY:
                    cb(True, payload)
                else:
                    cb(False, protocol.RpcError(payload))
        elif mtype == _NOTIFY and method == "px_chunk":
            self._on_chunk(cid, payload)

    def _on_chunk(self, cid: int, payload: Dict[str, Any]):
        sid = payload.get("stream")
        with self._lock:
            sink = self._streams.get(sid)
        if sink is None or sink.cid != cid:
            return  # cancelled/stale stream: ignore the straggler
        off = int(payload["offset"])
        data = payload["data"]
        crc = payload.get("crc")
        if crc is not None and (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            with self._lock:
                self._streams.pop(sid, None)
            peer = self._by_cid.get(cid)
            self._notify(cid, "px_ack", {"stream": sid, "got": -1},
                         peer.peer_host if peer else "")
            sink.fail(IOError(
                f"netx: chunk crc mismatch at offset {off}"))
            return
        end = off + len(data)
        if end > sink.total:
            with self._lock:
                self._streams.pop(sid, None)
            sink.fail(IOError("netx: chunk overruns object size"))
            return
        sink.buf[off:end] = data  # straight into plasma memory
        # .got is the CONTIGUOUS high-water mark: a dropped frame leaves
        # a gap that later chunks must not paper over — the stream then
        # stalls at the gap and resume re-requests from .got, so a hole
        # can never be sealed into the store
        if off <= sink.got < end:
            sink.got = end
        sink.last_progress = time.monotonic()
        self.stats["chunks_in"] += 1
        self.stats["bytes_in"] += len(data)
        peer = self._by_cid.get(cid)
        self._notify(cid, "px_ack", {"stream": sid, "got": sink.got},
                     peer.peer_host if peer else "")
        if sink.got >= sink.total:
            with self._lock:
                self._streams.pop(sid, None)
            sink.finish()

    # ------------------------------------------------------- pool hygiene

    def _tend(self):
        now = time.monotonic()
        if now - self._last_tend < 1.0:
            return
        self._last_tend = now
        ka, idle, cap = keepalive_s(), idle_s(), pool_max()
        to_close, to_ping = [], []
        with self._lock:
            streaming = {s.cid for s in self._streams.values()}
            conns = list(self._conns.values())
            for c in conns:
                busy = c.inflight > 0 or c.cid in streaming
                if not busy and now - c.last_used > idle:
                    to_close.append(c)
                    continue
                if busy:
                    # a peer executing our request may not pong for the
                    # duration (single-lane servers, GIL-holding TPU
                    # init): the inflight call is the liveness signal,
                    # process death still arrives as KIND_CLOSED, and
                    # streams carry their own stall timer
                    c.ping_sent = None
                    continue
                if c.ping_sent is not None \
                        and now - c.ping_sent > max(3 * ka, 5.0):
                    to_close.append(c)  # peer unresponsive: declare dead
                    continue
                if now - c.last_heard > ka and c.ping_sent is None:
                    to_ping.append(c)
            if len(conns) - len(to_close) > cap:
                idlers = sorted(
                    (c for c in conns
                     if c.inflight == 0 and c.cid not in streaming
                     and c not in to_close),
                    key=lambda c: c.last_used)
                to_close.extend(
                    idlers[:len(conns) - len(to_close) - cap])
        for c in to_close:
            self.stats["reaped"] += 1
            self._pump.close_conn(c.cid)
        for c in to_ping:
            c.ping_sent = now
            seq = next(self._seq)
            with self._lock:
                self._pending[(c.cid, seq)] = lambda ok, r: None
            self.stats["pings"] += 1
            if not chaos_send(self._pump, c.cid, "ping",
                              _pack([_REQUEST, seq, "ping", {}]),
                              c.peer_host):
                self._pump.close_conn(c.cid)

    # ------------------------------------------------------------ lifecycle

    def close(self):
        self._closed = True
        self._pump.shutdown()
        self._thread.join(timeout=2.0)
        self._pump.destroy()
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            sinks = list(self._streams.values())
            self._streams.clear()
            self._conns.clear()
            self._by_cid.clear()
        err = ConnectionError("netx client closed")
        for cb in pending:
            cb(False, err)
        for s in sinks:
            s.fail(err)


# ------------------------------------------------------------- module API

_CLIENT: Optional[NetxClient] = None
_CLIENT_FAILED = False
_CLIENT_LOCK = threading.Lock()


def get_client() -> Optional[NetxClient]:
    """The process-wide client, created on first use. None when the
    plane is gated off (RTT_NETX=0) or the native pump is unavailable
    — callers then stay on their unix/asyncio paths."""
    global _CLIENT, _CLIENT_FAILED
    if _CLIENT is not None:
        return _CLIENT
    if _CLIENT_FAILED:
        return None
    with _CLIENT_LOCK:
        if _CLIENT is None and not _CLIENT_FAILED:
            if not endpoints.enabled() or not rpccore.available():
                _CLIENT_FAILED = True
                return None
            try:
                _CLIENT = NetxClient()
            except Exception:
                logger.warning("netx client unavailable", exc_info=True)
                _CLIENT_FAILED = True
    return _CLIENT


def reset_client_for_tests():
    global _CLIENT, _CLIENT_FAILED
    with _CLIENT_LOCK:
        if _CLIENT is not None:
            try:
                _CLIENT.close()
            except Exception:
                pass
        _CLIENT = None
        _CLIENT_FAILED = False
