"""Prefill/decode disaggregation: ship prompt KV pages between replicas.

Copy of ``ray_tpu/serve/llm/disagg.py`` on the port's object store and
chaos plane. The frame holds torch CPU tensors, pickled by the
runtime's serializer (their bytes out of band).

Long prefills steal decode steps: a replica mid-way through a 2k-token
prompt cannot emit tokens for its in-flight streams.  Disaggregation
splits the fleet — *prefill* replicas run prompt + first token,
*decode* replicas run everything after — so decode inter-token latency
stops depending on the prompt-length tail.  The controller assigns
roles over a deployment's replicas (``llm_roles`` in
``serve.deployment``), the router runs the two-hop admission
(``__llm_prefill__`` on a prefill replica, ``__llm_adopt__`` on a
decode replica), and this module moves the KV snapshot between them.

Transport: each prefill replica owns a small ring of fixed-size
plasmax slots (sealed shared-memory frames, one copy out on the reader
side), with
inline bytes as the always-correct fallback when the store is absent
(a server outside the runtime), the snapshot outgrows a slot (a
768-token GPT-2-small prompt's KV in bf16 is ~28 MB, past the 8 MB
slots), or the ring is wedged.
Every handoff carries a CRC so a torn or corrupted frame is *detected*
and downgraded to a decode-side re-prefill — greedy decode is
deterministic, so the fallback is output-identical, just slower.

Chaos site ``llm.kv_ship`` (drop / delay / reset / corrupt) fires on
the receive side, mid-handoff: ``receive`` returns ``None`` (drop,
corrupt → CRC mismatch) or raises ``KVShipError`` (reset), and the
deployment falls back to re-prefill with no leaked pages — the blob is
plain bytes at this point; no allocator state is in flight.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
import zlib
from typing import Any, Dict, Optional

from ray_tpu_torch._private import chaos, serialization
from ray_tpu_torch.common.ids import ObjectID

logger = logging.getLogger(__name__)

CHAOS_SITE = "llm.kv_ship"
_INLINE_MAX = 64 * 1024        # below this, shared memory doesn't pay


class KVShipError(Exception):
    """The handoff frame was lost or torn mid-flight; the caller
    re-prefills on the decode replica (output-identical fallback)."""


def _ring_slot_id(tag: str, slot: int) -> ObjectID:
    digest = hashlib.sha256(f"llmkv:{tag}:{slot}".encode()).digest()
    return ObjectID(digest[:ObjectID.SIZE])


def _plasma():
    try:
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod._global_worker
        if w is not None and w.connected:
            return w.plasma
    except Exception:
        pass
    return None


class KVShipper:
    """One prefill replica's outbound KV lane (and any replica's
    inbound decoder).

    ``ship`` serializes a handoff payload (prompt KV arrays + enough
    metadata to re-prefill) into a plasmax ring slot — or inline bytes
    — and returns a frame descriptor; ``receive`` reverses it, with
    CRC verification and the ``llm.kv_ship`` chaos site in the middle.
    Frame descriptors are plain dicts so they ride the existing actor
    RPC path.
    """

    def __init__(self, tag: str, nslots: int = 4,
                 slot_bytes: int = 8 << 20):
        self.tag = tag
        self.nslots = max(1, int(nslots))
        self.slot_bytes = int(slot_bytes)
        self._created: Dict[int, ObjectID] = {}
        self._seq = 0
        self._lock = threading.Lock()

    # ---- prefill side ----

    def ship(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Serialize ``payload`` and stage it for the decode replica.
        Returns ``{"lane", "crc", "n", "o"|"b"}``."""
        ser = serialization.serialize(payload)
        data = ser.to_bytes()
        crc = zlib.crc32(data) & 0xFFFFFFFF
        desc: Dict[str, Any] = {"crc": crc, "n": len(data)}
        plasma = _plasma()
        if plasma is not None and len(data) > _INLINE_MAX \
                and len(data) <= self.slot_bytes:
            oid = self._write_ring(plasma, data)
            if oid is not None:
                desc["lane"] = "plasmax"
                desc["o"] = oid.hex()
                return desc
        desc["lane"] = "inline"
        desc["b"] = data
        return desc

    def _write_ring(self, plasma, data: bytes) -> Optional[ObjectID]:
        with self._lock:
            slot = self._seq % self.nslots
            self._seq += 1
            oid = self._created.get(slot)
            try:
                if oid is None:
                    oid = _ring_slot_id(self.tag, slot)
                    buf = plasma.ring_create(oid, self.slot_bytes)
                    self._created[slot] = oid
                else:
                    buf = plasma.ring_recycle(oid)
                    if buf is None:
                        return None   # reader wedged: inline this one
                    buf = buf[:self.slot_bytes]
            except Exception:
                return None   # store pressure etc.: inline is correct
            buf[:len(data)] = data
            buf.release()
            plasma.ring_seal(oid)
            return oid

    # ---- decode side ----

    def receive(self, desc: Dict[str, Any],
                method: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Fetch + verify a handoff frame.  Returns the payload dict,
        or ``None`` when the frame was dropped or failed its CRC
        (caller re-prefills); raises ``KVShipError`` on reset."""
        data = self._fetch(desc)
        action = chaos.hit(CHAOS_SITE, method=method)
        if action is not None:
            op = action.get("op")
            if op == "drop":
                logger.warning("llm.kv_ship: chaos dropped a handoff "
                               "frame (falling back to re-prefill)")
                return None
            if op == "delay":
                time.sleep(float(action.get("delay_s", 0.05)))
            elif op == "reset":
                raise KVShipError("llm.kv_ship: chaos reset mid-handoff")
            elif op == "corrupt" and data:
                data = bytearray(data)
                data[len(data) // 2] ^= 0xFF
                data = bytes(data)
        if data is None:
            return None
        if len(data) != desc.get("n"):
            logger.warning("llm.kv_ship: frame of %d bytes, expected %s "
                           "(falling back to re-prefill)", len(data),
                           desc.get("n"))
            return None
        if (zlib.crc32(data) & 0xFFFFFFFF) != desc.get("crc"):
            logger.warning("llm.kv_ship: CRC mismatch on handoff frame "
                           "(falling back to re-prefill)")
            return None
        try:
            return serialization.deserialize(data)
        except Exception:
            logger.warning("llm.kv_ship: undecodable handoff frame",
                           exc_info=True)
            return None

    def _fetch(self, desc: Dict[str, Any]) -> Optional[bytes]:
        if desc.get("o") is not None:
            plasma = _plasma()
            if plasma is None:
                return None
            oid = ObjectID.from_hex(desc["o"])
            buf = plasma.get_buffer(oid)
            if buf is None:
                return None   # slot vanished (ring freed/evicted)
            try:
                # copy out so the slot recycles immediately
                return bytes(buf[:desc["n"]])
            finally:
                buf.release()
                plasma.release(oid)
        b = desc.get("b")
        return bytes(b) if b is not None else None

    def free(self):
        plasma = _plasma()
        with self._lock:
            if plasma is not None:
                for oid in self._created.values():
                    try:
                        plasma.ring_free(oid)
                    except Exception:
                        logger.debug("llm.kv_ship: ring_free of %s "
                                     "failed (ring torn down first?)",
                                     oid, exc_info=True)
            self._created.clear()
