"""Cluster-wide storage root (reference: python/ray/_private/storage.py).

``ray_tpu_torch.init(storage="/mnt/shared")`` pins the root; on a running
cluster it is published through the GCS KV so every worker resolves the
same path. ``get_filesystem()`` hands back (root, exists-helpers) for
components needing durable shared storage (workflows default here).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

_KV_KEY = "@storage/root"


def _publish(root: str):
    try:
        from ray_tpu_torch._private import worker as wm
        w = wm._global_worker
        if w is not None and w.connected:
            w.call_sync(w.gcs, "kv_put",
                        {"key": _KV_KEY, "value": root.encode(),
                         "overwrite": True}, timeout=10)
    except Exception as e:
        # remote workers resolve the root from the GCS KV: a dropped
        # publish means they silently fall back to local defaults
        logger.warning("failed to publish storage root to the GCS "
                       "(remote workers won't see it): %s", e)


def _strip_scheme(root: str) -> str:
    return root[len("file://"):] if root.startswith("file://") else root


def get_storage_root() -> Optional[str]:
    env = os.environ.get("RTT_STORAGE")
    if env:
        return _strip_scheme(env)
    try:
        from ray_tpu_torch._private import worker as wm
        w = wm._global_worker
        if w is not None and w.connected:
            r = w.call_sync(w.gcs, "kv_get", {"key": _KV_KEY},
                            timeout=10)
            v = r.get("value")
            if v:
                return _strip_scheme(
                    v.decode() if isinstance(v, bytes) else str(v))
    except Exception:
        pass
    return None


def storage_path(*parts: str) -> str:
    """Join under the configured root (creates directories)."""
    root = get_storage_root()
    if root is None:
        raise RuntimeError(
            "no storage configured — pass ray_tpu_torch.init(storage=...)")
    p = os.path.join(root, *parts)
    os.makedirs(os.path.dirname(p) or p, exist_ok=True)
    return p
