"""Prefill/decode disaggregation: ship prompt KV pages between replicas.

Counterpart of ``ray_tpu/serve/llm/disagg.py``, inline lane only.

Long prefills steal decode steps: a replica mid-way through a long
prompt cannot emit tokens for its in-flight streams. Disaggregation
splits the fleet — *prefill* replicas run prompt + first token,
*decode* replicas run everything after — so decode inter-token latency
stops depending on the prompt-length tail. The server runs the two-hop
admission (``__llm_prefill__`` on a prefill replica, ``__llm_adopt__``
on a decode replica), and this module moves the KV snapshot between
them.

The frame rides inline, as bytes inside the handoff descriptor, whatever
its size: the JAX package does the same whenever no object store is
connected. A 768-token GPT-2-small prompt's KV in bf16 is ~28 MB.
Every handoff carries a CRC, so a torn or corrupted frame is *detected*
and downgraded to a decode-side re-prefill — greedy decode is
deterministic, so the fallback gives the same tokens at the same
batching, just slower.

Not ported yet: the JAX package's plasmax ring lane (a ring of sealed
shared-memory slots per prefill replica) and the ``llm.kv_ship`` chaos
site; both need the runtime's object store and chaos plane
(ROADMAP.md Queue A, A7b and A1).
"""

from __future__ import annotations

import logging
import pickle
import zlib
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class KVShipError(Exception):
    """The handoff frame was lost or torn mid-flight; the caller
    re-prefills on the decode replica (output-identical fallback)."""


class KVShipper:
    """One prefill replica's outbound KV lane (and any replica's
    inbound decoder).

    ``ship`` serializes a handoff payload (prompt KV tensors + enough
    metadata to re-prefill; pickle protocol 5, torch CPU tensors
    allowed) into inline bytes and returns a frame descriptor;
    ``receive`` reverses it, with CRC verification. Descriptors are
    plain dicts.
    """

    # ---- prefill side ----

    def ship(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Serialize ``payload`` for the decode replica. Returns
        ``{"lane": "inline", "crc", "n", "b"}``."""
        data = pickle.dumps(payload, protocol=5)
        return {"lane": "inline", "crc": zlib.crc32(data) & 0xFFFFFFFF,
                "n": len(data), "b": data}

    # ---- decode side ----

    def receive(self, desc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Verify + decode a handoff frame. Returns the payload dict, or
        ``None`` when the frame is missing, has the wrong length or
        fails its CRC (the caller re-prefills); raises ``KVShipError``
        for a lane this side cannot fetch (the object-store ring)."""
        lane = desc.get("lane", "inline")
        if lane != "inline":
            raise KVShipError(f"kv ship: lane {lane!r} needs the object "
                              "store, which the port does not have yet")
        data = desc.get("b")
        if data is None:
            return None
        data = bytes(data)
        if len(data) != desc.get("n"):
            logger.warning("kv ship: frame of %d bytes, expected %s "
                           "(falling back to re-prefill)", len(data),
                           desc.get("n"))
            return None
        if (zlib.crc32(data) & 0xFFFFFFFF) != desc.get("crc"):
            logger.warning("kv ship: CRC mismatch on handoff frame "
                           "(falling back to re-prefill)")
            return None
        try:
            return pickle.loads(data)
        except Exception:
            logger.warning("kv ship: undecodable handoff frame",
                           exc_info=True)
            return None
