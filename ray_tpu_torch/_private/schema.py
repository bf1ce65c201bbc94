"""Versioned wire schema for the control-plane RPC surface.

Role-equivalent to the reference's ``src/ray/protobuf/`` (21 ``.proto``
files: gcs_service.proto 43 rpcs, node_manager.proto 23,
core_worker.proto 20, …). The transport here is msgpack, so the schema
is declarative Python instead of protoc codegen — but it serves the
same two contracts:

1. **Versioning.** ``PROTOCOL_VERSION`` plus a content hash of the
   schema table ride the ``__hello__`` negotiation (protocol.py). A
   peer from a different major version is rejected at connect time
   instead of failing obscurely mid-RPC.
2. **Message shape.** Every field of the core RPC payloads is declared
   with a type and requiredness. ``validate()`` enforces the table;
   servers run it on every inbound request when
   ``RTT_VALIDATE_WIRE=1`` (tests enable this so schema drift is
   caught the moment a handler grows an undeclared field).

Unknown fields are ALLOWED (forward compatibility — new minor versions
add fields; old peers ignore them), exactly the proto3 rule.
"""

from __future__ import annotations

import hashlib
import numbers
import os
from typing import Any, Dict, List, Optional, Tuple

# Major bumps = incompatible framing/semantics; minor bumps = added
# methods/fields (compatible both ways).
# 1.1: leases (lease_worker/release_lease/revoke_lease/leased_task),
#      coalesced dispatch statuses, task_stats, profile_worker(s),
#      worker-lifecycle methods joined the schema table.
#      task_dispatch_status_batch is gated on the peer having negotiated
#      >= 1.1 via __hello__; legacy peers get per-task statuses.
# 1.2: preemption drain (preempt/preempt_node/node_draining/
#      node_drained/preemption_notice), release_lease.inflight
#      revoke-drain ack, per-chunk crc on pull_object replies.
# 1.3: kv_get_prefix (bulk journal recovery reads — serve control-plane
#      HA), drain_deadline_unix in get_nodes replies.
# 1.4: state engine — task_events batches, list_tasks/list_objects/
#      summarize/summarize_tasks GCS methods, raylet-side list_objects,
#      cursor pagination fields (paged/limit/continuation_token/filters)
#      on every list_* method (legacy non-paged replies retained).
# 1.5: compiled-DAG channels — dag_channel_open/dag_channel_close on
#      workers, dag_register/dag_unregister on raylets, dag_stage_error/
#      dag_peer_down owner notifies, and the dag_exec/dag_result frames
#      that ride the dedicated channel sockets. Channel opens are gated
#      on the peer having negotiated >= 1.5 via __hello__ (a legacy peer
#      degrades the whole graph to dynamic dispatch — docs/
#      COMPILED_DAGS.md).
# 1.6: distributed tracing — trace_spans batches + get_trace/list_traces
#      GCS methods, trace_ctx on actor_call, the optional "tc" trace
#      context on dag_exec/dag_result channel frames (only sent when
#      every stage peer negotiated >= 1.6 via __hello__ — a legacy peer
#      runs the graph untraced, never broken), trace_table_max on
#      configure_state — docs/TRACING.md.
# 1.7: native direct-execution lane — optional direct_address on
#      worker_register and lease_worker replies (the worker's second
#      listening socket served by the native frame pump; leased tasks
#      pushed there run recv→decode→execute→reply on one thread). All
#      frames on the direct socket are standard 1.x frames; an owner or
#      worker without the native library simply never sees/sends the
#      field and everything rides the asyncio path —
#      docs/WIRE_PROTOCOL.md "Implementations".
# 1.8: netx cross-node transport plane — endpoints become real
#      host:port pairs: netx_address on register_node/get_nodes/
#      get_object_locations (the raylet's transfer server),
#      direct_tcp_address on worker_register/lease_worker/
#      create_actor_worker (the direct lane's TCP twin),
#      channel_tcp_address on dag_channel_open replies, and the px_*
#      object-transfer methods (px_get/px_pull + px_chunk/px_ack
#      notifies) served by the netx transfer server. Same-host peers
#      keep dialing the unix endpoints; a pre-1.8 peer never sees the
#      new fields and rides the asyncio pull path —
#      docs/WIRE_PROTOCOL.md "1.8: host:port endpoint advertisement".
PROTOCOL_VERSION = (1, 8)

# Methods introduced after 1.0 (method -> first schema minor carrying
# it). Callers gate on the peer's negotiated minor from ``__hello__``
# before sending these to a long-lived connection; an unknown method
# on an old peer is an RpcError mid-flight instead of a clean
# downgrade. Kept next to SCHEMAS so a new method can't land without a
# version row (the conformance vectors iterate this).
METHOD_VERSIONS: Dict[str, Tuple[int, int]] = {
    "lease_worker": (1, 1), "release_lease": (1, 1),
    "revoke_lease": (1, 1), "leased_task": (1, 1),
    "task_dispatch_status_batch": (1, 1), "task_stats": (1, 1),
    "profile_worker": (1, 1), "profile_workers": (1, 1),
    "preempt": (1, 2), "preempt_node": (1, 2),
    "node_draining": (1, 2), "node_drained": (1, 2),
    "preemption_notice": (1, 2),
    "kv_get_prefix": (1, 3),
    "task_events": (1, 4), "list_tasks": (1, 4),
    "list_objects": (1, 4), "summarize": (1, 4),
    "summarize_tasks": (1, 4), "configure_state": (1, 4),
    "dag_channel_open": (1, 5), "dag_channel_close": (1, 5),
    "dag_register": (1, 5), "dag_unregister": (1, 5),
    "dag_stage_error": (1, 5), "dag_peer_down": (1, 5),
    "dag_exec": (1, 5), "dag_result": (1, 5),
    "trace_spans": (1, 6), "get_trace": (1, 6), "list_traces": (1, 6),
    "px_get": (1, 8), "px_pull": (1, 8),
    "px_chunk": (1, 8), "px_ack": (1, 8),
}

# Fields added to PRE-EXISTING methods after 1.0 — the compat-critical
# map: a peer that negotiated an older minor never sends these, so
# reading one takes either an absence-tolerant ``.get()`` or a
# negotiated-version guard (rtpulint RTPU006 enforces exactly this,
# keyed off this table). (method, field) -> minor introduced. Fields
# born with their method (METHOD_VERSIONS above) need no row — method
# existence already gates them.
FIELD_VERSIONS: Dict[Tuple[str, str], Tuple[int, int]] = {
    # 1.2: revoke-drain ack + per-chunk pull integrity (reply side)
    ("release_lease", "inflight"): (1, 2),
    ("pull_object", "crc"): (1, 2),
    # 1.3: drain deadlines surfaced in node-table reads (reply side)
    ("get_nodes", "drain_deadline_unix"): (1, 3),
    # 1.6: trace contexts ride task/actor/channel frames
    ("submit_task", "trace_ctx"): (1, 6),
    ("actor_call", "trace_ctx"): (1, 6),
    ("dag_exec", "tc"): (1, 6),
    ("dag_result", "tc"): (1, 6),
    ("configure_state", "trace_table_max"): (1, 6),
    # 1.7: the native direct-call lane address (worker_register
    # request + lease_worker reply)
    ("worker_register", "direct_address"): (1, 7),
    ("lease_worker", "direct_address"): (1, 7),
    # 1.8: netx endpoint advertisement (host:port twins of the unix
    # endpoints; '' or absent = unix-only peer)
    ("register_node", "netx_address"): (1, 8),
    ("get_nodes", "netx_address"): (1, 8),
    ("get_object_locations", "netx_address"): (1, 8),
    ("worker_register", "direct_tcp_address"): (1, 8),
    ("lease_worker", "direct_tcp_address"): (1, 8),
    ("create_actor_worker", "direct_address"): (1, 8),
    ("create_actor_worker", "direct_tcp_address"): (1, 8),
    ("dag_channel_open", "channel_tcp_address"): (1, 8),
}

_str = str
_num = numbers.Number
_int = numbers.Integral
_bool = (bool, numbers.Integral)
_dict = dict
_list = (list, tuple)
_bytes = (bytes, bytearray, memoryview)
_any = object

# method -> {field: (type, required)}. Covers the compat-critical
# surface: node lifecycle + sync stream, scheduling, task/actor
# submission, the object plane, KV, and pubsub. Handler-local or
# purely-internal methods may be absent — validate() passes unknown
# methods through (the proto3 unknown-message stance).
SCHEMAS: Dict[str, Dict[str, Tuple[Any, bool]]] = {
    # ---- GCS: node lifecycle + versioned sync (ray_syncer.proto role)
    "register_node": {
        "node_id": (_str, True),
        "raylet_address": (_str, True),
        # 1.8: the node's netx transfer server ("" = asyncio-only)
        "netx_address": (_str, False),
        "object_store_path": (_str, True),
        "resources": (_dict, True),
        "labels": (_dict, False),
        "hostname": (_str, False),
        "is_head": (_bool, False),
        "objects": (_list, False),
        "sync_epoch": (_num, False),
        "sync_version": (_int, False),
    },
    "resource_report": {
        "node_id": (_str, True),
        "available": (_dict, True),
        "total": (_dict, False),
        "sync_epoch": (_num, False),
        "sync_version": (_int, False),
        "known_view": (_int, False),
    },
    "drain_node": {"node_id": (_str, True)},
    # preemption drain (1.2): notice delivery + node-table state
    "preempt_node": {"node_id": (_str, True), "grace_s": (_num, False),
                     "reason": (_str, False)},
    "preempt": {"grace_s": (_num, False), "reason": (_str, False)},
    "node_draining": {"node_id": (_str, True), "grace_s": (_num, False),
                      "deadline_unix": (_num, False),
                      "reason": (_str, False)},
    "node_drained": {"node_id": (_str, True), "reason": (_str, False)},
    "preemption_notice": {"deadline_unix": (_num, False),
                          "grace_s": (_num, False)},
    "get_node_stats": {"node_id": (_str, False)},
    "profile_stacks": {"node_id": (_str, False),
                       "worker_id": (_str, False)},
    # ---- GCS: scheduling (gcs_service.proto scheduling rpcs role)
    "schedule": {
        "demand": (_dict, True),
        "scheduling": (_dict, False),
        "deps": (_list, False),
    },
    # ---- GCS: actors (gcs_service.proto ActorInfoGcsService role)
    "register_actor": {
        "actor_id": (_str, True),
        "class_name": (_str, False),
        "demand": (_dict, False),
        "name": (_str, False),
        "namespace": (_str, False),
        "lifetime": (_str, False),
        "max_restarts": (_int, False),
        "owner": (_str, False),
        "runtime_env": (_dict, False),
        "scheduling": (_dict, False),
        "max_concurrency": (_int, False),
        "concurrency_groups": (_dict, False),
    },
    "get_actor": {"actor_id": (_str, True)},
    "wait_actor_alive": {"actor_id": (_str, True),
                         "timeout": (_num, False)},
    "kill_actor": {"actor_id": (_str, True),
                   "no_restart": (_bool, False)},
    # ---- GCS: placement groups (node_manager.proto 2-phase rpcs role)
    "create_placement_group": {
        "pg_id": (_str, True),
        "bundles": (_list, True),
        "strategy": (_str, False),
        "name": (_str, False),
        "owner": (_str, False),
    },
    "remove_placement_group": {"pg_id": (_str, True)},
    # ---- GCS: KV + pubsub (gcs_kv_manager / pubsub.proto role)
    "kv_put": {"key": (_any, True), "value": (_any, True),
               "overwrite": (_bool, False)},
    "kv_get": {"key": (_any, True)},
    "kv_get_prefix": {"prefix": (_any, False)},
    "kv_del": {"key": (_any, True)},
    "kv_keys": {"prefix": (_any, False)},
    "kv_exists": {"key": (_any, True)},
    "subscribe": {"channels": (_list, True)},
    "unsubscribe": {"channels": (_list, True)},
    "publish": {"channel": (_str, True), "message": (_any, True)},
    # ---- GCS: object directory (object_manager.proto role)
    "add_object_location": {"object_id": (_str, True),
                            "node_id": (_str, True),
                            "owner": (_str, False)},
    "remove_object_location": {"object_id": (_str, True),
                               "node_id": (_str, True)},
    "get_object_locations": {"object_id": (_str, True)},
    # ---- raylet: task submission (node_manager.proto role)
    "submit_task": {
        "task_id": (_str, True),
        "fn_name": (_str, False),
        "args": (_bytes, False),
        "demand": (_dict, False),
        "num_returns": (_int, False),
        "max_retries": (_int, False),
        "retry_exceptions": (_bool, False),
        "runtime_env": (_dict, False),
        "scheduling": (_dict, False),
        "plasma_deps": (_list, False),
        "arg_refs": (_list, False),
        "spilled_from": (_str, False),
        "owner": (_str, False),
        "job_id": (_str, False),
        "trace_ctx": (_dict, False),
    },
    "submit_task_batch": {"specs": (_list, True)},
    "task_dispatch_status_batch": {"statuses": (_list, True)},
    "task_dispatch_status": {"task_id": (_str, True)},
    "task_done": {"task_id": (_str, True)},
    "lease_worker": {"resources": (_dict, False)},
    # inflight (1.2): 0 acks a revoke-drain — the raylet defers
    # re-idling the leased worker until this arrives
    "release_lease": {"lease_id": (_str, True),
                      "inflight": (_int, False)},
    "revoke_lease": {"lease_id": (_str, True)},
    "task_stats": {"executed": (_int, True)},
    "leased_task": {"spec": (_dict, True)},
    "cancel_task": {"task_id": (_str, True)},
    "request_spill": {"bytes_needed": (_int, False)},
    # ---- raylet: object plane (object_manager.proto role)
    "pull_object": {"object_id": (_str, True), "offset": (_int, True),
                    "length": (_int, True)},
    # ---- netx transfer plane (1.8): chunk-pipelined object pulls on
    # the raylet's dedicated transfer server (push_manager.cc role,
    # served by the native pump — _private/netx/server.py)
    "px_get": {"object_id": (_str, True)},
    "px_pull": {"object_id": (_str, True), "offset": (_int, True),
                "stream": (_int, True),
                # the puller's advertised host: keys the one-direction
                # net.partition chaos site on server→client chunk sends
                "from_host": (_str, False)},
    # notify: one windowed chunk of an object stream (server → puller)
    "px_chunk": {"stream": (_int, True), "offset": (_int, True),
                 "data": (_bytes, True), "crc": (_int, False),
                 "total_size": (_int, False), "last": (_bool, False)},
    # notify: puller's contiguous high-water ack (-1 = cancel stream)
    "px_ack": {"stream": (_int, True), "got": (_int, True)},
    "receive_push": {"object_id": (_str, True), "offset": (_int, True),
                     "total_size": (_int, True), "data": (_bytes, True)},
    "fetch_object": {"object_id": (_str, True)},
    "pin_object": {"object_id": (_str, True), "owner": (_str, False)},
    "contains_object": {"object_id": (_str, True)},
    "free_objects": {"object_ids": (_list, True)},
    # ---- worker: direct actor transport (core_worker.proto role)
    "actor_call": {
        "task_id": (_str, True),
        "method": (_str, True),
        "args": (_bytes, False),
        "seq": (_int, False),
        "processed_up_to": (_int, False),
        "caller": (_str, False),
        # 1.6: the caller's span context — tasks submitted from inside
        # the method parent under the call instead of a fresh root
        "trace_ctx": (_dict, False),
    },
    # ---- compiled-DAG channels (1.5; docs/COMPILED_DAGS.md). The
    # control-plane trio (open/close/register) rides the normal RPC
    # surface; dag_exec/dag_result are declared here for the conformance
    # vectors but flow over the dedicated channel sockets.
    "dag_channel_open": {
        "dag_id": (_str, True),
        "stage_id": (_int, True),
        "method": (_str, True),
        "args_tpl": (_list, True),
        "kwargs_tpl": (_dict, False),
        "downstream": (_list, True),
        "owner_address": (_str, True),
        "ring": (_dict, False),
    },
    "dag_channel_close": {"dag_id": (_str, True),
                          "stage_id": (_int, False)},
    "dag_register": {"dag_id": (_str, True),
                     "owner_address": (_str, False)},
    "dag_unregister": {"dag_id": (_str, True)},
    "dag_stage_error": {"dag_id": (_str, True), "stage_id": (_int, False),
                        "seq": (_int, False), "reason": (_str, False)},
    "dag_peer_down": {"dag_id": (_str, True),
                      "worker_id": (_str, False)},
    "dag_exec": {"d": (_str, True), "t": (_int, True), "s": (_int, True),
                 "b": (_bytes, False), "o": (_str, False),
                 "n": (_int, False),
                 # the writer's store segment, for a reader on another
                 # raylet of the same host (dag/channel.py)
                 "p": (_str, False),
                 # 1.6: {"trace_id","span_id"} — stages record hop
                 # spans chained under it; absent on pre-1.6 graphs
                 "tc": (_dict, False)},
    "dag_result": {"d": (_str, True), "s": (_int, True), "i": (_int, True),
                   "ae": (_bool, False), "b": (_bytes, False),
                   "o": (_str, False), "n": (_int, False),
                   "p": (_str, False), "tc": (_dict, False)},
    # ---- worker lifecycle (the second-language worker surface —
    # docs/WIRE_PROTOCOL.md declares this table normative for it)
    "worker_register": {"worker_id": (_str, True),
                        "address": (_str, True),
                        # 1.7: native direct-call lane socket ("" when
                        # the pump is disabled)
                        "direct_address": (_str, False),
                        # 1.8: the lane's host:port twin for off-box
                        # owners ("" when netx is off)
                        "direct_tcp_address": (_str, False)},
    "push_task": {"spec": (_dict, True), "gpu_ids": (_list, False)},
    "task_result": {"task_id": (_str, True), "returns": (_list, True),
                    "app_error": (_bool, False)},
    "ping": {},
    "exit_worker": {},
    "dump_stacks": {},
    "node_stats": {},
    "dump_worker_stacks": {"worker_id": (_str, False)},
    "profile_worker": {"duration_s": (_num, False),
                       "interval_s": (_num, False)},
    "profile_workers": {"worker_id": (_str, False),
                        "duration_s": (_num, False),
                        "interval_s": (_num, False)},
    # ---- state engine (gcs_task_manager / state aggregator role).
    # The pagination trio (paged/limit/continuation_token/filters) also
    # rides the legacy list_* methods as unknown-but-allowed fields.
    "task_events": {"events": (_list, True), "dropped": (_int, False)},
    "list_tasks": {"paged": (_bool, False), "limit": (_int, False),
                   "continuation_token": (_any, False),
                   "filters": (_dict, False)},
    "list_objects": {"paged": (_bool, False), "limit": (_int, False),
                     "continuation_token": (_any, False),
                     "filters": (_dict, False),
                     "node_id": (_any, False)},
    "summarize": {},
    "summarize_tasks": {},
    "configure_state": {"task_table_max": (_int, False),
                        "trace_table_max": (_int, False)},
    # ---- distributed tracing (1.6; docs/TRACING.md)
    "trace_spans": {"spans": (_list, True), "dropped": (_int, False)},
    "get_trace": {"trace_id": (_str, True)},
    "list_traces": {"paged": (_bool, False), "limit": (_int, False),
                    "continuation_token": (_any, False),
                    "filters": (_dict, False)},
}


def schema_hash() -> str:
    """Content hash of the schema table (drift detector for hello)."""
    items = []
    for method in sorted(SCHEMAS):
        for field in sorted(SCHEMAS[method]):
            t, req = SCHEMAS[method][field]
            items.append(f"{method}.{field}:{t}:{req}")
    return hashlib.sha1("|".join(items).encode()).hexdigest()[:16]


def hello_payload() -> Dict[str, Any]:
    return {"protocol_version": list(PROTOCOL_VERSION),
            "schema_hash": schema_hash()}


def check_hello(peer: Dict[str, Any]) -> Optional[str]:
    """None if compatible, else a reason string. Major must match;
    minor skew and schema-hash skew are compatible (unknown fields are
    ignored) but the hash is surfaced for diagnostics."""
    ver = peer.get("protocol_version")
    if not isinstance(ver, (list, tuple)) or len(ver) != 2:
        return f"malformed protocol_version: {ver!r}"
    if int(ver[0]) != PROTOCOL_VERSION[0]:
        return (f"incompatible protocol major version {ver[0]} "
                f"(ours: {PROTOCOL_VERSION[0]})")
    return None


def validate(method: str, payload: Any) -> List[str]:
    """Field errors for ``payload`` against ``method``'s schema;
    empty list = valid (or method not in the table)."""
    spec = SCHEMAS.get(method)
    if spec is None:
        return []
    if payload is None:
        payload = {}
    if not isinstance(payload, dict):
        return [f"{method}: payload must be a map, got "
                f"{type(payload).__name__}"]
    errors = []
    for field, (ftype, required) in spec.items():
        if field not in payload:
            if required:
                errors.append(f"{method}.{field}: required field missing")
            continue
        value = payload[field]
        if value is None and not required:
            continue
        if ftype is _any:
            continue
        if not isinstance(value, ftype):
            errors.append(
                f"{method}.{field}: expected "
                f"{getattr(ftype, '__name__', ftype)}, got "
                f"{type(value).__name__}")
    return errors


def validation_enabled() -> bool:
    return os.environ.get("RTT_VALIDATE_WIRE", "") not in ("", "0")
