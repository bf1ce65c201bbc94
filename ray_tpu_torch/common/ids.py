"""Binary unique identifiers for tasks, objects, actors, nodes, jobs.

Design follows the reference's ID specification (reference:
src/ray/design_docs/id_specification.md and src/ray/common/id.h) in *semantics*
— ObjectIDs are derived from the creating TaskID plus a return/put index so
lineage can be recomputed — but the layout is simplified for this runtime:

  JobID      : 4 bytes
  ActorID    : 12 bytes  (8 random + 4 job)
  TaskID     : 16 bytes  (8 random/derived + 8 parent info)
  ObjectID   : 24 bytes  (16 task + 4 index + 4 flags)
  NodeID     : 16 bytes  (random)
  WorkerID   : 16 bytes  (random)
  PlacementGroupID : 12 bytes

All IDs are immutable, hashable, and hex-serializable.
"""

from __future__ import annotations

import os
import struct


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = bytes(binary)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, value: int):
        return cls(struct.pack("<I", value))

    def int(self) -> int:
        return struct.unpack("<I", self._bytes)[0]


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID):
        return cls(os.urandom(8) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[8:])


class PlacementGroupID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID):
        return cls(os.urandom(8) + job_id.binary())


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def for_driver(cls, job_id: JobID):
        return cls(b"\xff" * 8 + b"\x00" * 4 + job_id.binary())

    @classmethod
    def for_task(cls, parent: "TaskID"):
        return cls(os.urandom(8) + parent.binary()[:8])

    @classmethod
    def for_actor_task(cls, actor_id: ActorID, seq_no: int):
        return cls(actor_id.binary()[:8] + struct.pack("<q", seq_no))


class ObjectID(BaseID):
    SIZE = 24
    MAX_INDEX = 2**31

    # flags
    _PUT = 1
    _RETURN = 0

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        return cls(task_id.binary() + struct.pack("<iI", put_index, cls._PUT))

    @classmethod
    def for_return(cls, task_id: TaskID, return_index: int):
        return cls(task_id.binary() + struct.pack("<iI", return_index, cls._RETURN))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:16])

    def index(self) -> int:
        return struct.unpack("<i", self._bytes[16:20])[0]

    def is_put(self) -> bool:
        return struct.unpack("<I", self._bytes[20:24])[0] == self._PUT


ObjectRefID = ObjectID  # alias
