"""The raylet's netx transfer server: objects out, at wire speed.

A native pump with a TCP listener plus one serve thread.  Headers
(``px_get``) and stream admission (``px_pull``) are resolved ON the
raylet's asyncio loop (``run_coroutine_threadsafe``) so they share the
exact store discipline of ``handle_pull_object`` — the chaos
``object.pull`` site, spill restore, and the tree-broadcast
serve-concurrency cap in ``_serving_pulls``.  The bytes themselves
never touch the loop: the serve thread reads chunks straight out of
the pinned plasma buffer, crc32s them, and pushes ``px_chunk``
NOTIFYs through the pump.

Flow control is receiver-driven: the client acks its contiguous
high-water mark (``px_ack``) and the server sends at most
``window_chunks`` ahead of it, bounding pump out-buffer memory per
stream no matter how large the object.  Multiple streams interleave
round-robin so one giant transfer can't starve its siblings — the
fairness a broadcast tree needs while every generation serves.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch._private import chaos, protocol, rpccore, schema
from ray_tpu_torch._private.netx import endpoints
from ray_tpu_torch.common.ids import ObjectID

logger = logging.getLogger(__name__)

_REQUEST, _REPLY, _ERROR, _NOTIFY = (protocol.REQUEST, protocol.REPLY,
                                     protocol.ERROR, protocol.NOTIFY)

CHUNK = 4 * 1024 * 1024        # matches the raylet pull chunk
WINDOW_CHUNKS = 8              # unacked chunks in flight per stream


def _pack(body) -> bytes:
    return msgpack.packb(body, use_bin_type=True)


class _Stream:
    __slots__ = ("cid", "sid", "oid", "buf", "total", "start", "sent",
                 "acked", "peer_host", "corrupt", "key", "capped",
                 "last_ack_t")

    def __init__(self, cid: int, sid: int, oid: ObjectID, buf, total: int,
                 start: int, peer_host: str, corrupt: bool,
                 key, capped: bool):
        self.cid = cid
        self.sid = sid
        self.oid = oid
        self.buf = buf
        self.total = total
        self.start = start
        self.sent = start
        self.acked = start
        self.peer_host = peer_host
        self.corrupt = corrupt
        self.key = key
        self.capped = capped
        self.last_ack_t = time.monotonic()


class NetxServer:
    """See module docstring. Owned by the raylet; one per node."""

    def __init__(self, raylet, host: str, loop: asyncio.AbstractEventLoop,
                 chunk: int = CHUNK, window_chunks: int = WINDOW_CHUNKS):
        self.raylet = raylet
        self.loop = loop
        self.chunk = chunk
        self.window = window_chunks * chunk
        self.pump = rpccore.Pump()
        port = self.pump.listen_tcp(host, 0)
        self.address = f"{host}:{port}"
        self._streams: Dict[Tuple[int, int], _Stream] = {}
        self._rr = 0
        self._last_refresh = time.monotonic()
        self.stats = {"streams": 0, "chunks_out": 0, "bytes_out": 0}
        self._thread = threading.Thread(
            target=self._serve, name="rtpu-netx-serve", daemon=True)
        self._thread.start()

    def close(self):
        self.pump.shutdown()
        self._thread.join(timeout=2.0)
        self.pump.destroy()

    # ----------------------------------------------------------- serve loop

    def _serve(self):
        while True:
            can_send = any(
                st.sent < st.total and st.sent - st.acked < self.window
                for st in self._streams.values())
            timeout = 0 if can_send else (50 if self._streams else 250)
            try:
                evs = self.pump.next_batch(timeout)
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
                        logger.exception("netx server: frame failed")
            self._pump_streams()
            self._refresh()

    def _on_closed(self, cid: int):
        for key in [k for k in self._streams if k[0] == cid]:
            self._finish_stream(self._streams[key])

    def _on_frame(self, cid: int, body: bytes):
        try:
            mtype, seq, method, payload = msgpack.unpackb(body, raw=False)
        except Exception:
            self.pump.close_conn(cid)
            return
        eng = chaos._ENGINE
        if eng is not None and mtype in (_REQUEST, _NOTIFY):
            act = eng.hit("protocol.recv", method)
            if act is not None:
                op = act["op"]
                if op == "drop":
                    return
                if op == "delay":
                    time.sleep(float(act.get("delay_s", eng.delay_s)))
                elif op == "reset":
                    self.pump.close_conn(cid)
                    return
                # dup of an ack/pull request is naturally idempotent
        if mtype == _REQUEST:
            self._on_request(cid, seq, method, payload or {})
        elif mtype == _NOTIFY and method == "px_ack":
            self._on_ack(cid, payload or {})

    def _reply(self, cid: int, seq, payload: Any, peer_host: str = "",
               error: bool = False):
        from ray_tpu_torch._private.netx.client import chaos_send
        mtype = _ERROR if error else _REPLY
        chaos_send(self.pump, cid,
                   "px_reply", _pack([mtype, seq, None, payload]),
                   peer_host)

    def _on_request(self, cid: int, seq, method: str,
                    payload: Dict[str, Any]):
        if method == "__hello__":
            err = schema.check_hello(payload)
            if err is not None:
                self._reply(cid, seq, err, error=True)
                self.pump.close_conn(cid)
            else:
                self._reply(cid, seq, schema.hello_payload())
            return
        if method == "ping":
            self._reply(cid, seq, {"server": "netx",
                                   "node_id": self.raylet.node_id})
            return
        if method not in ("px_get", "px_pull"):
            self._reply(cid, seq, f"netx: no such method {method}",
                        error=True)
            return
        oid_hex = payload.get("object_id", "")
        peer_host = payload.get("from_host", "")
        want_stream = method == "px_pull"
        offset = int(payload.get("offset", 0))
        sid = int(payload.get("stream", 0))
        token = f"netx{sid}:{cid}"
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._open(oid_hex, offset, token, want_stream), self.loop)
            r = fut.result(timeout=30.0)
        except Exception as e:
            self._reply(cid, seq, f"netx: open failed: {e!r}",
                        peer_host, error=True)
            return
        buf = r.pop("_buf", None)
        corrupt = r.pop("_corrupt", False)
        key = r.pop("_key", None)
        capped = r.pop("_capped", False)
        if want_stream and buf is not None:
            st = _Stream(cid, sid, ObjectID.from_hex(oid_hex), buf,
                         r["total_size"], offset, peer_host, corrupt,
                         key, capped)
            self._streams[(cid, sid)] = st
            self.stats["streams"] += 1
        self._reply(cid, seq, r, peer_host)

    def _on_ack(self, cid: int, payload: Dict[str, Any]):
        st = self._streams.get((cid, int(payload.get("stream", -1))))
        if st is None:
            return
        got = int(payload.get("got", 0))
        if got < 0:
            self._finish_stream(st)  # client cancelled (crc/stall)
            return
        if got > st.acked:
            st.acked = got
            st.last_ack_t = time.monotonic()

    # --------------------------------------------- loop-side store access

    async def _open(self, oid_hex: str, offset: int, token: str,
                    want_stream: bool) -> Dict[str, Any]:
        """Header + admission on the raylet loop: identical store
        discipline to handle_pull_object (chaos site, spill restore,
        serve-concurrency cap), returning a PINNED buffer for the serve
        thread when a stream is admitted."""
        r = self.raylet
        oid = ObjectID.from_hex(oid_hex)
        corrupt = False
        if chaos._ENGINE is not None:
            act = chaos.hit("object.pull", oid_hex)
            if act is not None:
                if act.get("op") == "evict":
                    await r._chaos_evict(oid)
                    return {"found": False}
                corrupt = act.get("op") == "corrupt"
        buf = r.store.get_buffer(oid)
        if buf is None and oid_hex in r.spilled:
            await r._restore_spilled(oid)
            buf = r.store.get_buffer(oid)
        if buf is None:
            return {"found": False}
        total = len(buf)
        if not want_stream:
            buf.release()
            r.store.release(oid)
            return {"found": True, "total_size": total}
        key = (oid_hex, token)
        capped = total >= r.config.object_serve_tree_min_bytes
        if capped and offset == 0:
            now = time.monotonic()
            for k, ts in list(r._serving_pulls.items()):
                if now - ts > 10.0:  # reader abandoned mid-pull
                    r._serving_pulls.pop(k, None)
            if key not in r._serving_pulls and \
                    len(r._serving_pulls) >= \
                    r.config.object_serve_concurrency:
                buf.release()
                r.store.release(oid)
                return {"found": True, "busy": True}
        if capped:
            r._serving_pulls[key] = time.monotonic()
        return {"found": True, "total_size": total, "_buf": buf,
                "_corrupt": corrupt, "_key": key, "_capped": capped}

    def _finish_stream(self, st: _Stream):
        self._streams.pop((st.cid, st.sid), None)
        raylet = self.raylet

        def _release():
            if st.capped:
                raylet._serving_pulls.pop(st.key, None)
            try:
                st.buf.release()
            except Exception:
                pass
            try:
                raylet.store.release(st.oid)
            except Exception:
                pass

        try:
            self.loop.call_soon_threadsafe(_release)
        except RuntimeError:
            pass  # loop already gone at shutdown

    # ---------------------------------------------------------- chunk pump

    def _pump_streams(self):
        if not self._streams:
            return
        sts = list(self._streams.values())
        self._rr = (self._rr + 1) % len(sts)
        for st in sts[self._rr:] + sts[:self._rr]:
            sent_any = 0
            # a couple of chunks per visit: round-robin interleave so
            # concurrent streams share the wire fairly
            while sent_any < 2 and st.sent < st.total \
                    and st.sent - st.acked < self.window:
                if not self._send_chunk(st):
                    break
                sent_any += 1
            if st.sent >= st.total:
                # all bytes are in the pump's out-buffer: the buffer
                # pin is no longer needed (resume re-opens it)
                self._finish_stream(st)
            elif time.monotonic() - st.last_ack_t > 60.0:
                self._finish_stream(st)  # reader abandoned mid-stream

    def _send_chunk(self, st: _Stream) -> bool:
        n = min(self.chunk, st.total - st.sent)
        data = bytes(st.buf[st.sent:st.sent + n])
        # crc over the CLEAN bytes, then tear: a chaos 'corrupt' must
        # be caught by the receiver's check, same as handle_pull_object
        crc = zlib.crc32(data) & 0xFFFFFFFF
        if st.corrupt and st.sent == st.start:
            torn = bytearray(data)
            torn[0] ^= 0xFF
            torn[-1] ^= 0xFF
            data = bytes(torn)
        payload = {"stream": st.sid, "offset": st.sent, "data": data,
                   "crc": crc, "total_size": st.total,
                   "last": st.sent + n >= st.total}
        if st.peer_host and endpoints.partitioned(st.peer_host):
            self.pump.close_conn(st.cid)  # KIND_CLOSED reaps the stream
            return False
        body = _pack([_NOTIFY, None, "px_chunk", payload])
        eng = chaos._ENGINE
        if eng is not None:
            act = eng.hit("protocol.send", "px_chunk")
            if act is not None:
                op = act["op"]
                if op == "drop":
                    st.sent += n  # lost in flight; the ack gap heals it
                    return True
                if op == "delay":
                    time.sleep(float(act.get("delay_s", eng.delay_s)))
                elif op == "reset":
                    self.pump.close_conn(st.cid)
                    return False
                elif op == "dup":
                    self.pump.send(st.cid, body)
        if not self.pump.send(st.cid, body):
            return False
        st.sent += n
        self.stats["chunks_out"] += 1
        self.stats["bytes_out"] += n
        return True

    def _refresh(self):
        """Keep _serving_pulls timestamps fresh for active capped
        streams so the 10 s abandoned-reader reap never fires on a
        long, healthy transfer."""
        now = time.monotonic()
        if now - self._last_refresh < 2.0:
            return
        self._last_refresh = now
        keys = [st.key for st in self._streams.values() if st.capped]
        if not keys:
            return
        raylet = self.raylet

        def _touch():
            ts = time.monotonic()
            for k in keys:
                if k in raylet._serving_pulls:
                    raylet._serving_pulls[k] = ts

        try:
            self.loop.call_soon_threadsafe(_touch)
        except RuntimeError:
            pass
