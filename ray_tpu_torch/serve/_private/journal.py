"""Serve control-plane journal — durable controller state in the GCS.

Copy of ``ray_tpu/serve/_private/journal.py``. Reference analogue:
serve's KVStore-backed checkpoints
(serve/_private/storage/kv_store.py + ServeController checkpoint
writes in deployment_state.py): the controller journals its target
state (deployment configs, versions, replica membership) to the GCS KV
table on every mutation, so a controller restarted by the GCS actor
state machine (``max_restarts=-1``) rebuilds ``_deployments`` from the
journal and re-adopts the live detached ``SERVE_REPLICA::*`` actors
instead of restarting the data plane.

Layout (all under one prefix so teardown is a single prefix delete):

    @serve/meta            -> {"replica_seq": int, "namespace": str}
    @serve/dep/<name>      -> {"config", "version", "target_replicas",
                               "replicas": [{"name", "id", "version",
                                             "draining"}], ...}

Values are cloudpickle blobs: deployment configs carry cloudpickled
callables and ``DeploymentHandle``/``ActorHandle`` init args, which the
msgpack wire cannot represent directly. The GCS persists the KV table
write-through (gcs_store), so the journal survives GCS restarts too
when the cluster runs a file-backed store.

Every writer is best-effort-with-logging: a journal write failure must
degrade durability, never availability (the in-memory state is still
authoritative for the running controller).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import cloudpickle

logger = logging.getLogger("ray_tpu_torch.serve.journal")

PREFIX = "@serve/"
META_KEY = PREFIX + "meta"
DEP_PREFIX = PREFIX + "dep/"


def _gcs_call(method: str, payload: Dict[str, Any], timeout: float = 10.0):
    from ray_tpu_torch._private.worker import global_worker
    w = global_worker()
    return w.call_sync(w.gcs, method, payload, timeout=timeout)


def put_deployment(name: str, record: Dict[str, Any]) -> None:
    _gcs_call("kv_put", {"key": DEP_PREFIX + name,
                         "value": cloudpickle.dumps(record)})


def delete_deployment(name: str) -> None:
    _gcs_call("kv_del", {"key": DEP_PREFIX + name})


def put_meta(meta: Dict[str, Any]) -> None:
    _gcs_call("kv_put", {"key": META_KEY,
                         "value": cloudpickle.dumps(meta)})


def load_all() -> Tuple[Optional[Dict[str, Any]], Dict[str, Dict[str, Any]]]:
    """One bulk read of the whole journal: (meta | None, {name: record}).

    Corrupt/unpicklable entries are skipped with a warning — a torn
    record for one deployment must not block recovery of the others.
    """
    reply = _gcs_call("kv_get_prefix", {"prefix": PREFIX}, timeout=30.0)
    meta: Optional[Dict[str, Any]] = None
    deps: Dict[str, Dict[str, Any]] = {}
    for key, value in reply.get("items") or []:
        try:
            obj = cloudpickle.loads(value)
        except Exception:
            logger.warning("serve journal: skipping corrupt entry %r", key,
                           exc_info=True)
            continue
        if key == META_KEY:
            meta = obj
        elif key.startswith(DEP_PREFIX):
            deps[key[len(DEP_PREFIX):]] = obj
    return meta, deps


def clear() -> None:
    """Drop the whole journal (serve.shutdown teardown) so the next
    controller starts from a clean slate instead of resurrecting it."""
    _gcs_call("kv_del", {"key": PREFIX, "prefix": True})
