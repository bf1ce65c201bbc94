"""Python client for the plasmax shared-memory object store.

Copied from the JAX package's ``ray_tpu/_private/object_store.py``; the
library is built from the port's copy of ``store.cc`` into
``ray_tpu_torch/core/libplasmax.so`` (``native.py``).

Role-equivalent to the reference's plasma client
(reference: src/ray/object_manager/plasma/client.cc and
core_worker/store_provider/plasma_store_provider.cc), plus the in-process
memory store for small objects
(reference: core_worker/store_provider/memory_store/memory_store.cc).

The store is a single mmap'd segment in /dev/shm created by the node process;
every worker attaches by path. Reads are zero-copy: ``get_buffer`` returns a
memoryview straight into shared memory.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from typing import Dict, Optional

from ray_tpu_torch._private import native
from ray_tpu_torch.common.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        src, path = native.paths("store.cc", "libplasmax.so")
        if native.stale(src, path):
            native.build(src, path, ["-lpthread"])
        lib = ctypes.CDLL(path)
        lib.px_segment_size.restype = ctypes.c_uint64
        lib.px_segment_size.argtypes = [ctypes.c_uint64, ctypes.c_uint32]
        lib.px_init.restype = ctypes.c_int
        lib.px_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.px_attach_check.restype = ctypes.c_int
        lib.px_attach_check.argtypes = [ctypes.c_void_p]
        for name in ("px_create", "px_get"):
            getattr(lib, name).restype = ctypes.c_int
        lib.px_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_uint64)]
        lib.px_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_uint64),
                               ctypes.POINTER(ctypes.c_uint64)]
        lib.px_debug_lock.restype = ctypes.c_int
        lib.px_debug_lock.argtypes = [ctypes.c_void_p]
        for name in ("px_seal", "px_abort", "px_release", "px_delete",
                     "px_contains", "px_pin", "px_refcount"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.px_unseal.restype = ctypes.c_int
        lib.px_unseal.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_uint64)]
        for name in ("px_used_bytes", "px_capacity", "px_num_objects",
                     "px_num_evicted"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        lib.px_stats.restype = None
        lib.px_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        _LIB = lib
    return _LIB


DEFAULT_NSLOTS = 1 << 16


class PlasmaxStore:
    """Handle to one shared-memory segment (create or attach by path).

    ``fallback_path`` names a second, disk-backed segment used when the
    shm segment cannot satisfy an allocation even after spilling
    (reference: plasma fallback allocation,
    object_manager/plasma/create_request_queue.cc +
    plasma_allocator.cc mmapping under /tmp when /dev/shm is
    exhausted). The raylet creates it eagerly as a SPARSE file (no
    disk used until pages are written); workers attach lazily on first
    need, so the common path never touches it."""

    def __init__(self, path: str, capacity: int = 0, create: bool = False,
                 nslots: int = DEFAULT_NSLOTS,
                 fallback_path: Optional[str] = None,
                 fallback_capacity: int = 0):
        self.path = path
        self._lib = _lib()
        self.fallback_path = fallback_path
        self._fallback: Optional["PlasmaxStore"] = None
        # oids created-but-not-yet-sealed in the fallback segment: routes
        # the seal/abort that follows a create to the right segment
        self._fb_creating: set = set()
        if create:
            seg_size = self._lib.px_segment_size(capacity, nslots)
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, seg_size)
                self._mm = mmap.mmap(fd, seg_size)
            finally:
                os.close(fd)
            self._base = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
            rc = self._lib.px_init(self._base, seg_size, nslots)
            if rc != 0:
                raise RuntimeError(f"px_init failed: {rc}")
            if fallback_path:
                self._fallback = PlasmaxStore(
                    fallback_path,
                    capacity=fallback_capacity or capacity,
                    create=True)
                # sidecar makes the pair self-describing: attachers
                # (workers, drivers) discover the overflow segment from
                # the shm path alone — no plumbing through connect()
                with open(path + ".fbpath", "w") as f:
                    f.write(fallback_path)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                seg_size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, seg_size)
            finally:
                os.close(fd)
            self._base = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
            if self._lib.px_attach_check(self._base) != 0:
                raise RuntimeError(f"not a plasmax segment: {path}")
            if self.fallback_path is None:
                try:
                    with open(path + ".fbpath") as f:
                        self.fallback_path = f.read().strip() or None
                except OSError:
                    pass
        self._size = seg_size

    def _fb(self) -> Optional["PlasmaxStore"]:
        """The fallback segment, attaching lazily (readers)."""
        if self._fallback is None and self.fallback_path and \
                os.path.exists(self.fallback_path):
            try:
                self._fallback = PlasmaxStore(self.fallback_path)
            except (OSError, RuntimeError):
                self.fallback_path = None
        return self._fallback

    # -- write path --

    def create(self, oid: ObjectID, size: int,
               allow_fallback: bool = False) -> memoryview:
        """Allocate and return a writable view; caller must seal().

        ``allow_fallback`` is the last-resort switch: reference plasma
        only fallback-allocates AFTER spilling failed to make room
        (create_request_queue.cc), so callers opt in once their
        spill-and-retry path is exhausted."""
        if self._fallback is not None and self._fallback.contains(oid):
            raise ValueError(f"object {oid} already exists")
        off = ctypes.c_uint64()
        rc = self._lib.px_create(self._base, oid.binary(), size, ctypes.byref(off))
        if rc == -1:
            raise ValueError(f"object {oid} already exists")
        if rc in (-2, -3):
            fb = self._fb() if allow_fallback else None
            if fb is not None:
                buf = fb.create(oid, size)  # disk-backed overflow
                self._fb_creating.add(oid.binary())
                return buf
            raise ObjectStoreFullError(
                "object index full" if rc == -3 else
                f"cannot allocate {size} bytes (capacity {self.capacity()},"
                f" used {self.used_bytes()})")
        return memoryview(self._mm)[off.value:off.value + size]

    def seal(self, oid: ObjectID):
        if oid.binary() in self._fb_creating:
            self._fb_creating.discard(oid.binary())
            self._fallback.seal(oid)
            return
        rc = self._lib.px_seal(self._base, oid.binary())
        if rc != 0:
            raise ValueError(f"seal failed for {oid}: {rc}")
        # creator's implicit ref is dropped; raylet pins primaries separately
        self._lib.px_release(self._base, oid.binary())

    def put_bytes(self, oid: ObjectID, data,
                  allow_fallback: bool = False) -> None:
        buf = self.create(oid, len(data), allow_fallback=allow_fallback)
        buf[:] = data
        self.seal(oid)

    def abort(self, oid: ObjectID):
        if oid.binary() in self._fb_creating:
            self._fb_creating.discard(oid.binary())
            self._fallback.abort(oid)
            return
        self._lib.px_abort(self._base, oid.binary())

    # -- read path --

    def get_buffer(self, oid: ObjectID) -> Optional[memoryview]:
        """Zero-copy read view, or None if absent. Caller should release()."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.px_get(self._base, oid.binary(), ctypes.byref(off),
                              ctypes.byref(size))
        if rc != 0:
            fb = self._fb()
            return fb.get_buffer(oid) if fb is not None else None
        return memoryview(self._mm)[off.value:off.value + size.value]

    def release(self, oid: ObjectID):
        if self._lib.px_release(self._base, oid.binary()) != 0:
            fb = self._fb()
            if fb is not None:
                fb.release(oid)

    def delete(self, oid: ObjectID) -> bool:
        if self._lib.px_delete(self._base, oid.binary()) == 0:
            return True
        fb = self._fb()
        return fb.delete(oid) if fb is not None else False

    def contains(self, oid: ObjectID) -> bool:
        if self._lib.px_contains(self._base, oid.binary()):
            return True
        fb = self._fb()
        return fb.contains(oid) if fb is not None else False

    def refcount(self, oid: ObjectID) -> int:
        """Debug: shared refcount of the slot, -1 if absent."""
        rc = int(self._lib.px_refcount(self._base, oid.binary()))
        if rc < 0:
            fb = self._fb()
            if fb is not None:
                return fb.refcount(oid)
        return rc

    def pin(self, oid: ObjectID) -> bool:
        if self._lib.px_pin(self._base, oid.binary()) == 0:
            return True
        fb = self._fb()
        return fb.pin(oid) if fb is not None else False

    # -- ring buffers (compiled-DAG channels) --
    #
    # A ring slot is a plasmax object the WRITER owns for the lifetime of a
    # compiled graph: created once (keeping the creator's pin so LRU eviction
    # can never reclaim it), then cycled seal→unseal→refill→seal per
    # invocation instead of create-per-object. px_unseal rewrites in place —
    # no allocator traffic, so used_bytes/num_created stay flat across
    # repeated graph executions (the property tests/test_compiled_dag.py
    # gates). Readers use the normal get_buffer/release pair; unseal refuses
    # (-2) while any reader still holds a ref and the writer retries.

    def ring_create(self, oid: ObjectID, size: int) -> memoryview:
        """Allocate a reusable slot; the creator pin is KEPT across seal."""
        off = ctypes.c_uint64()
        rc = self._lib.px_create(self._base, oid.binary(), size,
                                 ctypes.byref(off))
        if rc == -1:
            raise ValueError(f"ring slot {oid} already exists")
        if rc in (-2, -3):
            raise ObjectStoreFullError(
                f"cannot allocate {size}-byte ring slot")
        return memoryview(self._mm)[off.value:off.value + size]

    def ring_seal(self, oid: ObjectID):
        """Seal WITHOUT dropping the creator pin (unlike seal())."""
        rc = self._lib.px_seal(self._base, oid.binary())
        if rc != 0:
            raise ValueError(f"ring seal failed for {oid}: {rc}")

    def ring_recycle(self, oid: ObjectID,
                     timeout: float = 5.0) -> Optional[memoryview]:
        """Unseal a slot for rewrite; blocks until readers release (or
        timeout → None, caller falls back to an inline send)."""
        import time as _time
        off = ctypes.c_uint64()
        deadline = _time.monotonic() + timeout
        while True:
            rc = self._lib.px_unseal(self._base, oid.binary(),
                                     ctypes.byref(off))
            if rc == 0:
                # slot size is fixed at ring_create; callers slice the view
                # to the size they tracked
                return memoryview(self._mm)[off.value:]
            if rc == -1:
                return None  # gone (evicted segment teardown) — inline
            if _time.monotonic() >= deadline:
                return None  # reader wedged: skip the slot this round
            _time.sleep(0.0002)

    def ring_free(self, oid: ObjectID):
        """Teardown: drop the creator pin; delete if no readers remain
        (otherwise the slot becomes ordinary evictable garbage)."""
        self._lib.px_release(self._base, oid.binary())
        self._lib.px_delete(self._base, oid.binary())

    # -- stats --

    def used_bytes(self) -> int:
        return self._lib.px_used_bytes(self._base)

    def capacity(self) -> int:
        return self._lib.px_capacity(self._base)

    def num_objects(self) -> int:
        return self._lib.px_num_objects(self._base)

    def stats(self) -> Dict[str, int]:
        arr = (ctypes.c_uint64 * 6)()
        self._lib.px_stats(self._base, arr)
        keys = ("used_bytes", "capacity", "num_objects", "num_created",
                "num_evicted", "bytes_evicted")
        out = dict(zip(keys, arr))
        # shm-segment numbers stay primary-only (the raylet's spill
        # thresholds act on shm health); disk overflow reports separately
        fb = self._fb()
        if fb is not None:
            fbs = fb.stats()
            out["fallback_used_bytes"] = fbs["used_bytes"]
            out["fallback_capacity"] = fbs["capacity"]
            out["fallback_objects"] = fbs["num_objects"]
        return out

    def close(self):
        # Views into the mmap must be gone before closing; callers own that.
        self._base = None

    def unlink(self):
        for p in (self.path, self.path + ".fbpath",
                  self.fallback_path or ""):
            if p:
                try:
                    os.unlink(p)
                except OSError:
                    pass


class MemoryStore:
    """In-process store for small/inlined objects.

    Reference analogue: CoreWorkerMemoryStore
    (core_worker/store_provider/memory_store/memory_store.cc) — small results
    skip shared memory and travel inline through the control plane.
    """

    def __init__(self):
        self._store: Dict[ObjectID, bytes] = {}
        self._lock = threading.Lock()
        self._waiters: Dict[ObjectID, threading.Event] = {}

    def put(self, oid: ObjectID, payload: bytes):
        with self._lock:
            self._store[oid] = payload
            ev = self._waiters.pop(oid, None)
        if ev is not None:
            ev.set()

    def get(self, oid: ObjectID) -> Optional[bytes]:
        with self._lock:
            return self._store.get(oid)

    def wait_for(self, oid: ObjectID, timeout: Optional[float]) -> Optional[bytes]:
        with self._lock:
            if oid in self._store:
                return self._store[oid]
            ev = self._waiters.setdefault(oid, threading.Event())
        if not ev.wait(timeout):
            return None
        return self.get(oid)

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._store

    def delete(self, oid: ObjectID):
        with self._lock:
            self._store.pop(oid, None)
