"""Loader + thin wrapper for the native RPC frame pump (``csrc/rpcx.cc``).

Copied from the JAX package's ``ray_tpu/_private/rpccore.py``; the library
is built from the port's copy of the source (``native.py``). The JAX
package's switch that forces the Python path is not carried over: the
port takes that path only when the library does not build or load.

Same ctypes pattern as the plasmax store (object_store.py) and the
dispatch ledger (sched.py): the shared library is built from source on
first use (atomic temp-file rename so racing processes don't corrupt
each other), and EVERY failure mode — missing compiler, build error,
load error, ABI mismatch — degrades to the pure-Python asyncio path in
``_private/protocol.py``; the wire bytes are identical either way
(docs/WIRE_PROTOCOL.md "Implementations").
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import List, Optional, Tuple

from ray_tpu_torch._private import native

logger = logging.getLogger(__name__)

_ABI = 4  # must match rpcx_abi_version() in csrc/rpcx.cc

_LIB = None
_LIB_FAILED = False
_LIB_LOCK = threading.Lock()

# event kinds (rpcx.cc)
KIND_FRAME = 1
KIND_CLOSED = 2
KIND_WAKE = 3

_BATCH = 32  # events per rpcx_next_batch call


def available() -> bool:
    """True when the library builds and loads."""
    return _lib() is not None


def _lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            src, path = native.paths("rpcx.cc", "librpcx.so")
            if native.stale(src, path):
                _build(src, path)
            lib = ctypes.CDLL(path)
            lib.rpcx_abi_version.restype = ctypes.c_int
            if lib.rpcx_abi_version() != _ABI:
                # stale binary from an older source tree (mtime can lie
                # across checkouts): rebuild once, then give up
                _build(src, path)
                lib = ctypes.CDLL(path)
                if lib.rpcx_abi_version() != _ABI:
                    raise RuntimeError(
                        f"librpcx ABI {lib.rpcx_abi_version()} != {_ABI}")
            lib.rpcx_create.restype = ctypes.c_void_p
            lib.rpcx_listen.restype = ctypes.c_int
            lib.rpcx_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rpcx_dial.restype = ctypes.c_long
            lib.rpcx_dial.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rpcx_listen_tcp.restype = ctypes.c_int
            lib.rpcx_listen_tcp.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.rpcx_dial_tcp.restype = ctypes.c_long
            lib.rpcx_dial_tcp.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.rpcx_next_batch.restype = ctypes.c_int
            lib.rpcx_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int, ctypes.c_int]
            lib.rpcx_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
            lib.rpcx_send.restype = ctypes.c_int
            lib.rpcx_send.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_char_p, ctypes.c_uint32]
            lib.rpcx_close_conn.restype = ctypes.c_int
            lib.rpcx_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.rpcx_wake.argtypes = [ctypes.c_void_p]
            lib.rpcx_shutdown.argtypes = [ctypes.c_void_p]
            lib.rpcx_destroy.argtypes = [ctypes.c_void_p]
            lib.rpcx_stats.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint64)]
            _LIB = lib
        except Exception:
            logger.warning("native RPC pump unavailable; using the "
                           "Python asyncio path", exc_info=True)
            _LIB_FAILED = True
            _LIB = None
    return _LIB


def _build(src: str, out_path: str):
    native.build(src, out_path, ["-lpthread"])


def is_tcp_address(address: str) -> bool:
    """``host:port`` (optionally ``tcp:``-prefixed) vs a unix socket
    path / ``unix:`` address. Mirrors protocol.connect's split."""
    if address.startswith("unix:") or address.startswith("/"):
        return False
    if address.startswith("tcp:"):
        return True
    host, sep, port = address.rpartition(":")
    return bool(sep) and bool(host) and port.isdigit()


def _reset_for_tests():
    """Drop the cached load state so a test can exercise load failure."""
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        _LIB = None
        _LIB_FAILED = False


class Pump:
    """One native reactor: a listening socket and/or dialed peers.

    ``next_batch`` runs the reactor in the CALLING thread (GIL released
    inside the C call) — the owner thread is the event loop. ``send``/
    ``close_conn`` are safe from any thread."""

    def __init__(self):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native RPC pump unavailable")
        self._lib = lib
        self._p = lib.rpcx_create()
        self._destroyed = False
        self._destroy_lock = threading.Lock()
        # reusable out-param arrays (one lane thread drives next_batch)
        self._cids = (ctypes.c_long * _BATCH)()
        self._kinds = (ctypes.c_int * _BATCH)()
        self._datas = (ctypes.POINTER(ctypes.c_ubyte) * _BATCH)()
        self._lens = (ctypes.c_uint32 * _BATCH)()

    def listen(self, path: str):
        if self._lib.rpcx_listen(self._p, path.encode()) != 0:
            raise OSError(f"rpcx: cannot listen on {path}")

    def listen_tcp(self, host: str, port: int = 0) -> int:
        """Bind a TCP listener on the same reactor; returns the bound
        port (``port=0`` = ephemeral). Accepted connections speak the
        identical frame format as the unix path."""
        bound = self._lib.rpcx_listen_tcp(self._p, host.encode(), port)
        if bound < 0:
            raise OSError(f"rpcx: cannot listen on {host}:{port}")
        return bound

    def dial(self, address: str) -> int:
        """Dial either a unix socket path or a ``host:port`` TCP
        endpoint (``unix:`` / ``tcp:`` prefixes accepted)."""
        if address.startswith("unix:"):
            address = address[5:]
        elif address.startswith("tcp:"):
            address = address[4:]
        if is_tcp_address(address):
            host, _, port = address.rpartition(":")
            return self.dial_tcp(host, int(port))
        cid = self._lib.rpcx_dial(self._p, address.encode())
        if cid < 0:
            raise ConnectionError(f"rpcx: cannot dial {address}")
        return cid

    def dial_tcp(self, host: str, port: int) -> int:
        cid = self._lib.rpcx_dial_tcp(self._p, host.encode(), int(port))
        if cid < 0:
            raise ConnectionError(f"rpcx: cannot dial {host}:{port}")
        return cid

    def next_batch(self, timeout_ms: int = 200
                   ) -> Optional[List[Tuple[int, int, Optional[bytes]]]]:
        """Returns [(cid, kind, body)] — body is None for KIND_CLOSED —
        an empty list on timeout, or None after shutdown()."""
        n = self._lib.rpcx_next_batch(
            self._p, self._cids, self._kinds, self._datas, self._lens,
            _BATCH, timeout_ms)
        if n < 0:
            return None
        out = []
        for i in range(n):
            kind = self._kinds[i]
            body = None
            if kind == KIND_FRAME:
                body = ctypes.string_at(self._datas[i], self._lens[i])
                self._lib.rpcx_free(self._datas[i])
            out.append((self._cids[i], kind, body))
        return out

    def send(self, cid: int, body: bytes) -> bool:
        """Frame + write ``body`` (msgpack bytes). False = conn dead."""
        return self._lib.rpcx_send(self._p, cid, body, len(body)) == 0

    def close_conn(self, cid: int):
        self._lib.rpcx_close_conn(self._p, cid)

    def wake(self):
        """Bounce the thread inside next_batch out of its epoll wait."""
        self._lib.rpcx_wake(self._p)

    def shutdown(self):
        """Wake the lane thread out of next_batch permanently."""
        self._lib.rpcx_shutdown(self._p)

    def destroy(self):
        """Free the native pump. Only after the lane thread exited."""
        with self._destroy_lock:
            if self._destroyed:
                return
            self._destroyed = True
        self._lib.rpcx_destroy(self._p)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 6)()
        self._lib.rpcx_stats(self._p, out)
        return {"frames_in": out[0], "frames_out": out[1],
                "bytes_in": out[2], "bytes_out": out[3],
                "read_calls": out[4], "write_calls": out[5]}
