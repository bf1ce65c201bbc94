"""Game-day state in the GCS KV: the last published report and the
per-replica request ledgers that gracefully-stopped replicas flush so
a rolling update cannot erase the server-side half of the
reconciliation join (serve/_private/replica.py flushes on
``prepare_for_shutdown``).

Copy of ``ray_tpu/gameday/store.py``, the one module of the game day
that serving needs (the replica's ledger flush and the LLM server's
token-ledger flush call it).

Layout::

    @gameday/report                 -> JSON SLO report (no raw ledger)
    @gameday/ledger/<replica_name>  -> {"deployment", "replica",
                                        "records": [[rid, outcome,
                                                     dt_s], ...]}

Reads and writes are best-effort exactly like the serve journal: a KV
outage degrades observability, never the data plane.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger("ray_tpu_torch.gameday.store")

PREFIX = "@gameday/"
REPORT_KEY = PREFIX + "report"
LEDGER_PREFIX = PREFIX + "ledger/"
LLM_LEDGER_PREFIX = PREFIX + "llm-ledger/"


def _gcs_call(method: str, payload: Dict[str, Any], timeout: float = 10.0):
    from ray_tpu_torch._private.worker import global_worker
    w = global_worker()
    return w.call_sync(w.gcs, method, payload, timeout=timeout)


def publish_report(report: Dict[str, Any]) -> bool:
    """Persist the latest game-day report (JSON — the dashboard actor
    and Prometheus exposition read it from another process)."""
    try:
        _gcs_call("kv_put", {"key": REPORT_KEY,
                             "value": json.dumps(report).encode()})
        return True
    except Exception:
        logger.warning("gameday: report publish failed", exc_info=True)
        return False


def load_report() -> Optional[Dict[str, Any]]:
    try:
        reply = _gcs_call("kv_get", {"key": REPORT_KEY})
        value = reply.get("value") if isinstance(reply, dict) else None
        if not value:
            return None
        if isinstance(value, str):
            value = value.encode()
        return json.loads(value)
    except Exception:
        return None


def flush_replica_ledger(replica_name: str, deployment: str,
                         records: List[Any],
                         truncated: bool = False) -> bool:
    """Called by a replica on graceful shutdown: persist its request
    ledger so reconciliation still sees requests served by replicas a
    rolling update has since retired."""
    if not records:
        return True
    try:
        _gcs_call("kv_put", {
            "key": LEDGER_PREFIX + replica_name,
            "value": json.dumps({
                "deployment": deployment,
                "replica": replica_name,
                "records": records,
                "truncated": bool(truncated),
            }).encode()})
        return True
    except Exception:
        logger.warning("gameday: ledger flush failed for %r",
                       replica_name, exc_info=True)
        return False


def load_flushed_ledgers() -> List[Dict[str, Any]]:
    """Every ledger flushed by retired replicas (reconciliation input)."""
    try:
        reply = _gcs_call("kv_get_prefix", {"prefix": LEDGER_PREFIX},
                          timeout=30.0)
    except Exception:
        return []
    out = []
    for _key, value in reply.get("items") or []:
        try:
            if isinstance(value, str):
                value = value.encode()
            out.append(json.loads(value))
        except Exception:
            continue
    return out


def flush_llm_ledger(replica_name: str, records: List[Any]) -> bool:
    """serve/llm: a replica retired by a rolling update flushes its
    per-request token ledger ((request_id, n_tokens, finish_reason)
    rows) so the per-token reconciliation join survives the drain."""
    if not records:
        return True
    try:
        _gcs_call("kv_put", {
            "key": LLM_LEDGER_PREFIX + replica_name,
            "value": json.dumps({"replica": replica_name,
                                 "records": records}).encode()})
        return True
    except Exception:
        logger.warning("gameday: llm ledger flush failed for %r",
                       replica_name, exc_info=True)
        return False


def load_flushed_llm_ledgers() -> List[Dict[str, Any]]:
    try:
        reply = _gcs_call("kv_get_prefix",
                          {"prefix": LLM_LEDGER_PREFIX}, timeout=30.0)
    except Exception:
        return []
    out = []
    for _key, value in reply.get("items") or []:
        try:
            if isinstance(value, str):
                value = value.encode()
            out.append(json.loads(value))
        except Exception:
            continue
    return out


def clear_ledgers() -> None:
    """Scenario start: drop stale ledgers so one game day never joins
    against another's records."""
    for prefix in (LEDGER_PREFIX, LLM_LEDGER_PREFIX):
        try:
            _gcs_call("kv_del", {"key": prefix, "prefix": True})
        except Exception:
            pass
