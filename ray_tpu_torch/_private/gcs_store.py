"""GCS persistence backends.

Role-equivalent to the reference's pluggable GCS storage
(reference: src/ray/gcs/store_client/ — in_memory_store_client.cc,
redis_store_client.cc) and the restart rebuild path
(gcs/gcs_server/gcs_init_data.cc LoadActorData/LoadJobData/...).

Design: managers keep their live state in plain dicts (the hot path stays
allocation-free), but every mutation is written through a StoreClient. On
startup the GCS replays the store into the dicts, so killing and restarting
the GCS process preserves actors, placement groups, jobs, KV (including
exported function blobs) and named actors.

The file backend is a msgpack write-ahead log with snapshot compaction —
crash-safe without an external Redis: each record is
``(table, key, value | None)``; None is a tombstone. On load, the snapshot
is read first, then the WAL replayed; when the WAL grows past a threshold
it is folded into a new snapshot (write-to-temp + rename).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import msgpack


class StoreClient:
    """Persistence seam: tables of key -> msgpack-able value."""

    def put(self, table: str, key: str, value: Any) -> None:
        raise NotImplementedError

    def delete(self, table: str, key: str) -> None:
        raise NotImplementedError

    def load_all(self) -> Iterator[Tuple[str, str, Any]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    def __init__(self):
        self.tables: Dict[str, Dict[str, Any]] = {}

    def put(self, table: str, key: str, value: Any) -> None:
        self.tables.setdefault(table, {})[key] = value

    def delete(self, table: str, key: str) -> None:
        self.tables.get(table, {}).pop(key, None)

    def load_all(self):
        for t, kv in self.tables.items():
            for k, v in kv.items():
                yield (t, k, v)


class FileStoreClient(StoreClient):
    """Snapshot + WAL on the local filesystem."""

    WAL_COMPACT_BYTES = 8 * 1024 * 1024

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.snap_path = os.path.join(dir_path, "snapshot.msgpack")
        self.wal_path = os.path.join(dir_path, "wal.msgpack")
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[str, Any]] = {}
        self._load_into_memory()
        self._wal = open(self.wal_path, "ab")

    # -- internal --------------------------------------------------------

    def _load_into_memory(self):
        for path in (self.snap_path, self.wal_path):
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                unpacker = msgpack.Unpacker(f, raw=False)
                try:
                    for rec in unpacker:
                        table, key, value = rec
                        if value is None:
                            self._tables.get(table, {}).pop(key, None)
                        else:
                            self._tables.setdefault(table, {})[key] = value
                # torn tail write after a crash: keep what replayed;
                # expected on every recovery, so nothing to report
                except Exception:  # rtpulint: ignore[RTPU007]
                    pass

    def _append(self, rec) -> None:
        # flush (not fsync) per record: the GCS runs _append inside async
        # handlers, and a per-mutation fsync would stall the whole control
        # plane. A GCS *process* crash loses nothing (page cache survives);
        # only a host power loss can drop the un-synced tail — the same
        # trade Redis makes with appendfsync everysec.
        data = msgpack.packb(rec, use_bin_type=True)
        self._wal.write(data)
        self._wal.flush()
        if self._wal.tell() > self.WAL_COMPACT_BYTES:
            self._compact()

    def _compact(self):
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            for t, kv in self._tables.items():
                for k, v in kv.items():
                    f.write(msgpack.packb((t, k, v), use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        self._wal.close()
        self._wal = open(self.wal_path, "wb")

    # -- StoreClient -----------------------------------------------------

    def put(self, table: str, key: str, value: Any) -> None:
        with self._lock:
            self._tables.setdefault(table, {})[key] = value
            self._append((table, key, value))

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            if self._tables.get(table, {}).pop(key, None) is not None:
                self._append((table, key, None))

    def load_all(self):
        with self._lock:
            for t, kv in self._tables.items():
                for k, v in list(kv.items()):
                    yield (t, k, v)

    def close(self):
        with self._lock:
            try:
                self._wal.close()
            except Exception:
                pass


def make_store(path: Optional[str]) -> StoreClient:
    if path:
        return FileStoreClient(path)
    return InMemoryStoreClient()
