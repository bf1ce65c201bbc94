"""Control-plane RPC: msgpack-framed messages over unix/TCP sockets.

Role-equivalent to the reference's gRPC plumbing (reference: src/ray/rpc/ —
client_call.h, grpc_server.cc) redesigned lighter: the control plane here is a
msgpack-over-socket protocol with request/reply correlation and one-way
notifications. Bulk data never rides this plane — large payloads go through
the plasmax shared-memory store (intra-node) or the chunked object-transfer
path (inter-node), exactly like the reference splits control (gRPC) from data
(plasma/object_manager).

Frame: [uint32 length][msgpack body]
Body:  [msg_type, seq, method, payload]
  msg_type: 0 = request (expects reply), 1 = reply, 2 = error reply,
            3 = one-way notification
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct
import threading
from typing import Any, Awaitable, Callable, Dict, Optional

import msgpack

from ray_tpu_torch._private import chaos

REQUEST, REPLY, ERROR, NOTIFY = 0, 1, 2, 3

_MAX_FRAME = 256 * 1024 * 1024


def pack_frame(body) -> bytes:
    data = msgpack.packb(body, use_bin_type=True)
    return struct.pack("<I", len(data)) + data


async def read_frame(reader: asyncio.StreamReader):
    hdr = await reader.readexactly(4)
    (n,) = struct.unpack("<I", hdr)
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame too large: {n}")
    data = await reader.readexactly(n)
    return msgpack.unpackb(data, raw=False)


def read_frame_sync(sock) -> Any:
    """Blocking-socket twin of read_frame — same framing, no event loop.
    The compiled-DAG channel threads (ray_tpu_torch/dag/channel.py) speak the
    wire protocol over dedicated sockets owned by plain threads, so the
    forward path never touches an asyncio loop."""
    hdr = _recv_exact(sock, 4)
    (n,) = struct.unpack("<I", hdr)
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame too large: {n}")
    return msgpack.unpackb(_recv_exact(sock, n), raw=False)


def _recv_exact(sock, n: int) -> bytes:
    parts = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionError("peer closed")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts) if len(parts) != 1 else parts[0]


class RpcError(Exception):
    pass


_BG_TASKS: set = set()


def spawn(coro) -> "asyncio.Task":
    """``create_task`` with a strong reference held until completion.
    The loop only weak-refs tasks; a discarded handle lets the GC close
    the coroutine mid-await (GeneratorExit) — fire-and-forget work must
    go through here (or EventLoopThread.run_async, which does the
    same)."""
    task = asyncio.get_running_loop().create_task(coro)
    _BG_TASKS.add(task)
    task.add_done_callback(_BG_TASKS.discard)
    return task


class Connection:
    """A bidirectional RPC connection. Either side can issue requests."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 handler: Optional[Callable[[str, Any, "Connection"],
                                            Awaitable[Any]]] = None,
                 on_close: Optional[Callable[["Connection"], None]] = None):
        self.reader = reader
        self.writer = writer
        self.handler = handler
        self.on_close = on_close
        self._seq = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._closed = False
        self._send_lock = asyncio.Lock()
        self._task = asyncio.get_running_loop().create_task(self._read_loop())
        # opaque per-connection state the server attaches (e.g. worker id)
        self.meta: Dict[str, Any] = {}
        # remote IP for TCP links ('' = unix/unknown): keys the
        # net.partition chaos site in _send — see netx.endpoints
        self.peer_host: str = ""

    async def _read_loop(self):
        try:
            while True:
                frame = await read_frame(self.reader)
                mtype, seq, method, payload = frame
                eng = chaos._ENGINE
                if eng is not None and mtype in (REQUEST, NOTIFY):
                    # chaos injection point (inbound): drop/delay/dup a
                    # frame or reset the link — restricted to
                    # request/notify frames (swallowing a reply wedges
                    # the peer's pending future; model that by dropping
                    # the reply on ITS send side instead)
                    act = eng.hit("protocol.recv", method)
                    if act is not None:
                        op = act["op"]
                        if op == "drop":
                            continue
                        if op == "delay":
                            await asyncio.sleep(
                                float(act.get("delay_s", eng.delay_s)))
                        elif op == "reset":
                            raise ConnectionError("chaos: reset (recv)")
                        elif op == "dup":
                            spawn(self._dispatch(
                                seq if mtype == REQUEST else None,
                                method, payload))
                if mtype == REQUEST:
                    spawn(self._dispatch(seq, method, payload))
                elif mtype == NOTIFY:
                    spawn(self._dispatch(None, method, payload))
                elif mtype in (REPLY, ERROR):
                    fut = self._pending.pop(seq, None)
                    if fut is not None and not fut.done():
                        if mtype == REPLY:
                            fut.set_result(payload)
                        else:
                            fut.set_exception(RpcError(payload))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._closed = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("connection closed"))
            self._pending.clear()
            try:
                self.writer.close()
            except Exception:
                pass
            if self.on_close:
                self.on_close(self)

    async def _dispatch(self, seq, method, payload):
        try:
            result = await self.handler(method, payload, self)
            if seq is not None:
                await self._send([REPLY, seq, method, result])
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            if seq is not None:
                try:
                    await self._send([ERROR, seq, method,
                                      f"{type(e).__name__}: {e}"])
                except Exception:
                    pass

    async def _send(self, body):
        dup = False
        eng = chaos._ENGINE
        if eng is not None and self.peer_host:
            # one-direction partition: every frame toward the severed
            # host is lost and the link dies (an unplugged cable, not a
            # polite FIN) — lazy import, netx.client imports this module
            from ray_tpu_torch._private.netx import endpoints as _nx
            if _nx.partitioned(self.peer_host):
                self.close()
                raise ConnectionError("chaos: network partition")
        if eng is not None:
            # chaos injection point (outbound): body[2] is the method
            act = eng.hit("protocol.send", body[2])
            if act is not None:
                op = act["op"]
                if op == "drop":
                    return
                if op == "delay":
                    await asyncio.sleep(
                        float(act.get("delay_s", eng.delay_s)))
                elif op == "reset":
                    self.close()
                    raise ConnectionError("chaos: reset (send)")
                elif op == "dup":
                    dup = True
        async with self._send_lock:
            self.writer.write(pack_frame(body))
            if dup:
                self.writer.write(pack_frame(body))
            await self.writer.drain()

    async def call(self, method: str, payload: Any = None,
                   timeout: Optional[float] = None) -> Any:
        if self._closed:
            raise ConnectionError("connection closed")
        seq = next(self._seq)
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        await self._send([REQUEST, seq, method, payload])
        if timeout is not None:
            return await asyncio.wait_for(fut, timeout)
        return await fut

    async def notify(self, method: str, payload: Any = None):
        if self._closed:
            raise ConnectionError("connection closed")
        await self._send([NOTIFY, None, method, payload])

    def close(self):
        self._closed = True
        try:
            self.writer.close()
        except Exception:
            pass
        # Cancel the read loop so the task isn't abandoned pending — an
        # un-cancelled _read_loop is GC'd later as "Task was destroyed
        # but it is pending!", masking real errors in every log.
        task = self._task
        if task is not None and not task.done():
            loop = task.get_loop()
            if loop.is_running():
                loop.call_soon_threadsafe(task.cancel)
            else:
                task.cancel()

    async def aclose(self):
        """Close and wait for the read loop to finish unwinding."""
        self.close()
        task = self._task
        if task is not None:
            try:
                await task
            except asyncio.CancelledError:
                cur = asyncio.current_task()
                # Task.cancelling() is 3.11+; on 3.10 there is no way to
                # tell "our cancellation" from the read loop's — swallow,
                # matching pre-3.11 semantics (the read loop's cancel is
                # the overwhelmingly common case here)
                if cur is not None and \
                        getattr(cur, "cancelling", lambda: 0)():
                    raise  # OUR cancellation, not the read loop's
            except Exception:  # noqa: BLE001 — read-loop teardown errors
                pass


class Server:
    """Accepts connections; dispatches to a method-name handler table."""

    def __init__(self, handlers: Dict[str, Callable]):
        self.handlers = handlers
        self.connections: set[Connection] = set()
        self._server: Optional[asyncio.base_events.Server] = None

    async def _on_connect(self, reader, writer):
        conn = Connection(reader, writer, handler=self._handle,
                          on_close=self._on_close)
        peer = writer.get_extra_info("peername")
        if isinstance(peer, tuple) and peer:
            conn.peer_host = str(peer[0])
        self.connections.add(conn)
        if "_on_connect" in self.handlers:
            await self.handlers["_on_connect"](conn)

    def _on_close(self, conn):
        self.connections.discard(conn)
        cb = self.handlers.get("_on_disconnect")
        if cb is not None:
            spawn(cb(conn))

    async def _handle(self, method, payload, conn):
        if chaos._ENGINE is not None:
            # chaos injection point: "kill" at the N-th served request
            # (executed inside the engine — SIGKILL, no cleanup)
            chaos.hit("rpc.request", method)
        if method == "__hello__":
            # version negotiation (schema.py — the protobuf-package
            # role): reply with our version + schema hash; reject
            # incompatible majors so drift fails at connect, not mid-RPC
            from ray_tpu_torch._private import schema
            ver = (payload or {}).get("protocol_version")
            if conn is not None and isinstance(ver, (list, tuple)) \
                    and len(ver) == 2:
                try:
                    # remember what the peer negotiated: handlers gate
                    # minor-version features (e.g. batched dispatch
                    # statuses) on this instead of assuming the newest.
                    # conn is None for in-process dispatch (tests);
                    # there is no peer to remember then
                    conn.meta["peer_protocol_version"] = (
                        int(ver[0]), int(ver[1]))
                except (TypeError, ValueError):
                    pass
            err = schema.check_hello(payload or {})
            if err:
                raise RpcError(f"protocol negotiation failed: {err}")
            return schema.hello_payload()
        fn = self.handlers.get(method)
        if fn is None:
            raise RpcError(f"no such method: {method}")
        from ray_tpu_torch._private import schema
        if schema.validation_enabled():
            errors = schema.validate(method, payload)
            if errors:
                raise RpcError("wire schema violation: "
                               + "; ".join(errors))
        return await fn(payload, conn)

    async def start_unix(self, path: str):
        self._server = await asyncio.start_unix_server(self._on_connect, path=path)

    async def start_tcp(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._on_connect, host, port)
        return self._server.sockets[0].getsockname()[1]

    def close(self):
        srv = self._server
        if srv is not None:
            loop = srv.get_loop()
            try:
                on_loop = asyncio.get_running_loop() is loop
            except RuntimeError:
                on_loop = False
            if loop.is_running() and not on_loop:
                # asyncio.Server is not thread-safe: closed from another
                # thread it races the loop's own _detach -> _wakeup of a
                # connection that ends at the same moment, and the second
                # _wakeup raises TypeError (waiters already None) before
                # any connection below is closed, abandoning their read
                # loops ("Task was destroyed but it is pending!")
                loop.call_soon_threadsafe(srv.close)
            else:
                srv.close()
        for c in list(self.connections):
            c.close()


async def single_flight_connect(cache: Dict[str, "Connection"],
                                pending: Dict[str, "asyncio.Future"],
                                address: str,
                                dial: Callable[[str], Awaitable["Connection"]]
                                ) -> "Connection":
    """Cached, single-flight dialing: concurrent callers of the same
    address share one in-flight dial instead of racing N parallel
    connects where every Connection but the last-stored leaks an open
    read loop (GC'd later as "Task was destroyed but it is pending!").

    Must be called from the loop that owns `cache`/`pending`.  A failed
    leader dial wakes the waiters, and one of them retries as leader;
    a caller's own cancellation propagates (it is never confused with
    the leader's failure — leader cancellation is translated to
    ConnectionError on the shared future)."""
    while True:
        conn = cache.get(address)
        if conn is not None and not conn._closed:
            return conn
        fut = pending.get(address)
        if fut is not None:
            try:
                return await asyncio.shield(fut)
            except asyncio.CancelledError:
                raise  # our own cancellation — the shared fut is never
                # cancelled and leader cancellation arrives as
                # ConnectionError below
            except Exception:
                continue  # leader's dial failed — retry as leader
        fut = asyncio.get_running_loop().create_future()
        pending[address] = fut
        try:
            conn = await dial(address)
        except BaseException as e:
            pending.pop(address, None)
            if isinstance(e, asyncio.CancelledError):
                fut.set_exception(ConnectionError("dial cancelled"))
            else:
                fut.set_exception(e)
            fut.exception()  # consumed here: waiters retry via the loop
            raise
        cache[address] = conn
        pending.pop(address, None)
        fut.set_result(conn)
        return conn


async def connect(address: str,
                  handler: Optional[Callable] = None,
                  on_close: Optional[Callable] = None) -> Connection:
    """address: 'unix:/path' or 'host:port'."""
    peer_host = ""
    if address.startswith("unix:"):
        reader, writer = await asyncio.open_unix_connection(address[5:])
    else:
        host, port = address.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        peer_host = host
    if handler is None:
        async def handler(method, payload, conn):  # noqa: ARG001
            raise RpcError(f"unexpected request {method}")
    conn = Connection(reader, writer, handler=handler, on_close=on_close)
    conn.peer_host = peer_host
    return conn


class ReconnectingConnection:
    """A Connection facade that transparently re-dials on failure.

    Used for links to the GCS so a GCS restart (fault tolerance, reference:
    gcs_rpc_client.h retry semantics) is invisible to raylets and workers:
    calls made while the GCS is down retry with backoff until
    `reconnect_timeout_s` elapses; `on_reconnect` (e.g. node re-registration,
    pubsub re-subscription) runs after each successful re-dial.
    """

    def __init__(self, address: str, handler=None,
                 on_reconnect=None, reconnect_timeout_s: float = 30.0):
        self.address = address
        self.handler = handler
        self.on_reconnect = on_reconnect
        self.reconnect_timeout_s = reconnect_timeout_s
        self._conn: Optional[Connection] = None
        self._lock: Optional[asyncio.Lock] = None
        self.meta: Dict[str, Any] = {}

    async def _ensure(self) -> Connection:
        if self._conn is not None and not self._conn._closed:
            return self._conn
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            if self._conn is not None and not self._conn._closed:
                return self._conn
            deadline = (asyncio.get_running_loop().time()
                        + self.reconnect_timeout_s)
            delay = 0.05
            first = self._conn is None
            while True:
                try:
                    self._conn = await connect(self.address,
                                               handler=self.handler)
                    break
                except OSError:
                    if asyncio.get_running_loop().time() >= deadline:
                        raise ConnectionError(
                            f"cannot reach {self.address}")
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 1.0)
            # version negotiation on the long-lived links (schema.py):
            # an incompatible MAJOR fails here, at connect time. A peer
            # predating __hello__ replies "no such method" — compatible.
            try:
                from ray_tpu_torch._private import schema
                await self._conn.call("__hello__",
                                      schema.hello_payload(),
                                      timeout=10)
            except RpcError as e:
                if "negotiation failed" in str(e):
                    self._conn.close()
                    self._conn = None
                    raise ConnectionError(
                        f"protocol negotiation with {self.address} "
                        f"failed: {e}")
            except Exception:
                pass  # hello is best-effort beyond the version check
            if not first and self.on_reconnect is not None:
                await self.on_reconnect(self._conn)
            return self._conn

    async def call(self, method: str, payload: Any = None,
                   timeout: Optional[float] = None) -> Any:
        # Retrying after a mid-call connection loss re-executes the RPC on
        # the restarted peer, so GCS handlers are written to be idempotent
        # keyed on caller-supplied unique IDs (actor_id, pg_id, kv key) —
        # the same contract the reference's gcs_rpc_client retry layer
        # assumes.
        attempts = 2
        for i in range(attempts):
            conn = await self._ensure()
            try:
                return await conn.call(method, payload, timeout=timeout)
            except ConnectionError:
                if i == attempts - 1:
                    raise
                # peer went away mid-call: reconnect and retry once
                continue

    async def notify(self, method: str, payload: Any = None):
        conn = await self._ensure()
        await conn.notify(method, payload)

    def close(self):
        if self._conn is not None:
            self._conn.close()


class EventLoopThread:
    """A dedicated asyncio loop on a background thread.

    Every process (driver, worker, raylet, GCS) runs exactly one of these for
    its control-plane IO — the analogue of the reference's per-process
    instrumented_io_context (reference: src/ray/common/asio/). Blocking user
    threads interact via run()/run_async().
    """

    def __init__(self, name: str = "rtpu-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = threading.Event()
        self._stop_called = False
        self._inflight: set = set()  # strong refs to fire-and-forget tasks
        # stall detector (reference: the asio event-loop instrumentation
        # in common/asio/ + the debug loop-lag monitors): a heartbeat
        # callback stamps the clock; a watchdog thread flags the loop as
        # stalled — with the loop thread's live stack — when the stamp
        # goes stale. Enabled via RTT_LOOP_STALL_S (seconds; 0 = off).
        self._hb = 0.0
        self.stalls_detected = 0
        import os as _os
        try:
            self._stall_s = float(
                _os.environ.get("RTT_LOOP_STALL_S", "0") or 0)
        except ValueError:
            # a typo in an optional debug knob must not kill every
            # process at startup
            logging.getLogger(__name__).warning(
                "ignoring malformed RTT_LOOP_STALL_S=%r",
                _os.environ.get("RTT_LOOP_STALL_S"))
            self._stall_s = 0.0
        self._thread.start()
        self._started.wait()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        import os as _os
        prof_dir = _os.environ.get("RTT_CPROFILE_DIR")
        prof = None
        if prof_dir and "loop" not in _os.environ.get(
                "RTT_CPROFILE_PROCS", "loop"):
            prof_dir = None
        if prof_dir:
            # perf-debug aid: profile THIS loop thread (cProfile is
            # per-thread; the main-thread profilers can't see handler
            # work running here)
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
        self.loop.call_soon(self._started.set)
        if self._stall_s > 0:
            self._start_stall_detector()
        self.loop.run_forever()
        if prof is not None:
            prof.disable()
            prof.dump_stats(_os.path.join(
                prof_dir,
                f"loop_{_os.getpid()}_{self._thread.name}.pstats"))

    def _start_stall_detector(self):
        import sys
        import time as _time
        import traceback as _tb
        period = self._stall_s / 2

        def beat():
            self._hb = _time.monotonic()
            self.loop.call_later(period, beat)
        self.loop.call_soon(beat)
        loop_tid = threading.get_ident()

        def watch():
            warned_hb = -1.0
            while self.loop.is_running() or self._hb == 0.0:
                _time.sleep(period)
                stale = _time.monotonic() - self._hb
                if self._hb and stale > self._stall_s \
                        and self._hb != warned_hb:
                    # one count + one stack per DISTINCT stall: during
                    # an ongoing stall the heartbeat stamp is frozen,
                    # so remembering it both dedups the log and keeps
                    # stalls_detected an event count
                    warned_hb = self._hb
                    self.stalls_detected += 1
                    frame = sys._current_frames().get(loop_tid)
                    stack = "".join(_tb.format_stack(frame)) \
                        if frame else "<no frame>"
                    logging.getLogger(__name__).warning(
                        "event loop %s stalled %.1fs (a blocking call "
                        "on the IO loop starves ALL control-plane "
                        "RPCs):\n%s", self._thread.name, stale, stack)

        threading.Thread(target=watch, daemon=True,
                         name=f"{self._thread.name}-stallwatch").start()

    def run(self, coro, timeout: Optional[float] = None):
        """Run coroutine on the IO loop, block until done, return result."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def call_soon(self, fn, *args):
        """Schedule a plain callback on the loop from any thread.  Much
        lighter than run_coroutine_threadsafe (~no Future chaining) —
        the submit hot path uses this to wake the flusher."""
        self.loop.call_soon_threadsafe(fn, *args)

    def run_async(self, coro):
        """Fire-and-forget — but with a STRONG reference held until
        completion: the event loop only weak-refs its tasks, so a
        discarded future lets the GC close the coroutine mid-await
        (observed as GeneratorExit killing in-flight actor-call sends
        under allocation pressure)."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        self._inflight.add(fut)
        fut.add_done_callback(self._inflight.discard)
        return fut

    def stop(self):
        """Drain-and-stop: cancel every pending task on the loop, await
        the unwinds, then stop and close the loop.  Skipping the drain
        leaves tasks to be GC'd pending ("Task was destroyed!") and
        callbacks to fire on a closed loop ("Event loop is closed").

        Idempotent: a second call must not schedule a drain onto a loop
        that already stopped (the coroutine would never be awaited) —
        it only finishes the close if the first call's join timed out."""
        if self._stop_called:
            if not self._thread.is_alive() and not self.loop.is_closed():
                self.loop.close()
            return
        self._stop_called = True

        async def _drain():
            me = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not me]
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            self.loop.stop()

        coro = _drain()
        if not self._thread.is_alive():
            # the loop thread already exited (loop crashed or stopped):
            # scheduling the drain would park the coroutine forever on a
            # dead loop — never awaited, flagged at GC. Close it unrun
            # and finish the loop teardown directly.
            coro.close()
            if not self.loop.is_closed():
                self.loop.close()
            return
        try:
            asyncio.run_coroutine_threadsafe(coro, self.loop)
        except RuntimeError:
            # loop stopped/closed between the aliveness check and the
            # schedule: close the never-started coroutine so the
            # conftest leak gate stays clean
            coro.close()
            self._thread.join(timeout=5)
            if not self._thread.is_alive() and not self.loop.is_closed():
                self.loop.close()
            return
        self._thread.join(timeout=5)
        if not self._thread.is_alive() and not self.loop.is_closed():
            self.loop.close()
