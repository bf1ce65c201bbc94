"""Pluggable external storage for object spilling.

Reference analogue: python/ray/_private/external_storage.py —
ExternalStorage ABC (:72), FileSystemStorage (:233), the smart_open
S3/URI backend (:293), and ExternalStorageRayStorageImpl (:368) riding
the cluster storage root. The raylet spills primary copies through one
of these; which one comes from SystemConfig.object_spilling_config
(JSON, the reference's `object_spilling_config` system-config knob).

URIs are self-describing ("file://...", "mem://...", "s3://..."), so a
restarted raylet can restore objects spilled by its predecessor from
the recorded URI alone.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple


class ExternalStorage:
    """Spill target. Implementations must be safe for concurrent calls
    from the raylet's executor threads."""

    def spill(self, key: str, data: bytes) -> str:
        """Persist ``data`` under ``key``; returns a restore URI."""
        raise NotImplementedError

    def restore(self, uri: str) -> bytes:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class FileSystemStorage(ExternalStorage):
    """Local-disk spilling (the default; reference :233)."""

    def __init__(self, directory: str):
        self.dir = directory

    def spill(self, key: str, data: bytes) -> str:
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return f"file://{path}"

    def restore(self, uri: str) -> bytes:
        with open(uri[len("file://"):], "rb") as f:
            return f.read()

    def delete(self, uri: str) -> None:
        try:
            os.unlink(uri[len("file://"):])
        except OSError:
            pass


class MemoryStorage(ExternalStorage):
    """In-process dict-backed storage — the test double for the plugin
    seam (URIs survive only as long as the raylet process)."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}

    def spill(self, key: str, data: bytes) -> str:
        self._blobs[key] = bytes(data)
        return f"mem://{key}"

    def restore(self, uri: str) -> bytes:
        return self._blobs[uri[len("mem://"):]]

    def delete(self, uri: str) -> None:
        self._blobs.pop(uri[len("mem://"):], None)


class SmartOpenStorage(ExternalStorage):
    """S3/GCS/arbitrary-URI spilling via smart_open (reference :293).
    Gated: constructing it without the library raises ImportError with
    the pip hint, exactly like the reference."""

    def __init__(self, uri_prefix: str):
        try:
            from smart_open import open as _so_open  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "smart_open is required for URI spilling: "
                "pip install smart_open[s3]") from e
        self._open = _so_open
        self.prefix = uri_prefix.rstrip("/")

    def spill(self, key: str, data: bytes) -> str:
        uri = f"{self.prefix}/{key}"
        with self._open(uri, "wb") as f:
            f.write(data)
        return uri

    def restore(self, uri: str) -> bytes:
        with self._open(uri, "rb") as f:
            return f.read()

    def delete(self, uri: str) -> None:
        # S3 deletes need boto3; best-effort like the reference
        try:
            import boto3  # noqa: F401
            from urllib.parse import urlparse
            p = urlparse(uri)
            boto3.client("s3").delete_object(Bucket=p.netloc,
                                             Key=p.path.lstrip("/"))
        except Exception:
            pass


class RayStorageImpl(ExternalStorage):
    """Spill into the cluster storage root configured by
    ``ray_tpu_torch.init(storage=...)`` (reference:
    ExternalStorageRayStorageImpl :368) — one namespace for workflow
    state, checkpoints, AND spilled objects."""

    def __init__(self, storage_root: str, node_id: str):
        self.inner = FileSystemStorage(
            os.path.join(storage_root, "spilled_objects", node_id[:12]))

    def spill(self, key: str, data: bytes) -> str:
        return self.inner.spill(key, data)

    def restore(self, uri: str) -> bytes:
        return self.inner.restore(uri)

    def delete(self, uri: str) -> None:
        self.inner.delete(uri)


def storage_from_config(spec: Any, default_dir: str,
                        node_id: str = "",
                        storage_root: Optional[str] = None
                        ) -> ExternalStorage:
    """Build the spill backend from the object_spilling_config knob:
    a JSON string or dict {"type": ..., "params": {...}}."""
    if not spec:
        return FileSystemStorage(default_dir)
    if isinstance(spec, str):
        spec = json.loads(spec)
    typ = spec.get("type", "filesystem")
    params = spec.get("params") or {}
    if typ == "filesystem":
        return FileSystemStorage(params.get("directory_path",
                                            default_dir))
    if typ == "memory":
        return MemoryStorage()
    if typ == "smart_open":
        return SmartOpenStorage(params["uri_prefix"])
    if typ == "ray_storage":
        root = params.get("root") or storage_root
        if not root:
            raise ValueError("ray_storage spilling needs a cluster "
                             "storage root (ray_tpu_torch.init(storage=...))")
        return RayStorageImpl(root, node_id)
    raise ValueError(f"unknown object spilling type {typ!r}")
