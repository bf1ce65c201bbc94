"""Mock doubles of the framework's internal interfaces.

Reference analogue: ``src/mock/ray/raylet_client/raylet_client.h`` and
friends (gmock), plus ``mock_worker.cc`` — scriptable stand-ins so unit
tests exercise one component's logic in isolation.

Copied from the JAX package's ``ray_tpu/_private/testing/mocks.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.common.ids import ObjectID


class MockConnection:
    """Scriptable double of ``protocol.Connection`` /
    ``ReconnectingConnection``.

    ``replies`` maps method name → canned reply, or a callable
    ``(payload) -> reply`` (which may raise to script failures). Every
    call is recorded in ``calls`` for assertions.
    """

    def __init__(self, replies: Optional[Dict[str, Any]] = None):
        self.replies = replies or {}
        self.calls: List[Tuple[str, Any]] = []
        self.notifications: List[Tuple[str, Any]] = []
        self._closed = False
        self.meta: Dict[str, Any] = {}

    def _reply_for(self, method: str, payload: Any) -> Any:
        r = self.replies.get(method, {})
        return r(payload) if callable(r) else r

    async def call(self, method: str, payload: Any = None,
                   timeout: Optional[float] = None) -> Any:
        self.calls.append((method, payload))
        return self._reply_for(method, payload)

    async def notify(self, method: str, payload: Any = None):
        self.notifications.append((method, payload))

    def close(self):
        self._closed = True

    def calls_to(self, method: str) -> List[Any]:
        return [p for m, p in self.calls if m == method]


class MockStore:
    """In-memory double of the plasmax ``PlasmaxStore`` surface
    (create/seal/get_buffer/pin/release/delete/contains/stats)."""

    def __init__(self, capacity: int = 64 * 1024 * 1024):
        self._capacity = capacity
        self._objects: Dict[bytes, bytearray] = {}
        self._sealed: Dict[bytes, bool] = {}
        self._refs: Dict[bytes, int] = {}
        self.num_created = 0

    def _used(self) -> int:
        return sum(len(b) for b in self._objects.values())

    def create(self, oid: ObjectID, size: int,
               allow_fallback: bool = False) -> memoryview:
        from ray_tpu_torch.exceptions import ObjectStoreFullError
        key = oid.binary()
        if key in self._objects:
            raise ValueError(f"object {oid} already exists")
        if self._used() + size > self._capacity:
            raise ObjectStoreFullError(f"mock store full ({size} bytes)")
        buf = bytearray(size)
        self._objects[key] = buf
        self._sealed[key] = False
        self._refs[key] = 1
        self.num_created += 1
        return memoryview(buf)

    def seal(self, oid: ObjectID):
        self._sealed[oid.binary()] = True
        self._refs[oid.binary()] -= 1

    def abort(self, oid: ObjectID):
        key = oid.binary()
        if not self._sealed.get(key):
            self._objects.pop(key, None)
            self._sealed.pop(key, None)
            self._refs.pop(key, None)

    def put_bytes(self, oid: ObjectID, data,
                  allow_fallback: bool = False):
        buf = self.create(oid, len(data))
        buf[:] = data
        self.seal(oid)

    def get_buffer(self, oid: ObjectID) -> Optional[memoryview]:
        key = oid.binary()
        if not self._sealed.get(key):
            return None
        self._refs[key] += 1
        return memoryview(self._objects[key])

    def release(self, oid: ObjectID):
        key = oid.binary()
        if key in self._refs:
            self._refs[key] -= 1

    def pin(self, oid: ObjectID) -> bool:
        key = oid.binary()
        if not self._sealed.get(key):
            return False
        self._refs[key] += 1
        return True

    def delete(self, oid: ObjectID) -> bool:
        key = oid.binary()
        if self._refs.get(key, 0) > 0:
            return False
        self._objects.pop(key, None)
        self._sealed.pop(key, None)
        self._refs.pop(key, None)
        return True

    def contains(self, oid: ObjectID) -> bool:
        return bool(self._sealed.get(oid.binary()))

    def capacity(self) -> int:
        return self._capacity

    def used_bytes(self) -> int:
        return self._used()

    def stats(self) -> Dict[str, int]:
        return {"used_bytes": self._used(), "capacity": self._capacity,
                "num_objects": len(self._objects),
                "num_created": self.num_created,
                "num_evicted": 0, "bytes_evicted": 0}


def make_bare(cls, **attrs):
    """Instantiate ``cls`` WITHOUT running ``__init__`` and set just
    the attributes a unit test needs — the mock-worker pattern for
    components whose constructors bind sockets/shm (Raylet, Worker,
    GcsServer)."""
    obj = object.__new__(cls)
    for k, v in attrs.items():
        setattr(obj, k, v)
    return obj
