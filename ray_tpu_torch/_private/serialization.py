"""Two-layer wire format: msgpack envelope + pickle5 out-of-band buffers.

Reference semantics: python/ray/_private/serialization.py — a msgpack envelope
for cheap primitives with an embedded cloudpickle payload whose pickle-protocol-5
out-of-band buffers enable zero-copy reads of numpy data straight out of
shared memory (SURVEY.md §8.4).

Copied from the JAX package's ``ray_tpu/_private/serialization.py``, with a
reducer for ``torch.Tensor`` (and ``nn.Parameter``), used only when torch
is already imported by the serializing process (the GCS and the raylet
never import it). Without it cloudpickle would carry a tensor's storage
in-band as ``torch.save`` bytes: a full extra copy of every byte inside
the pickle stream. With it:

  - a dense tensor's bytes cross as one out-of-band buffer, as a numpy
    array's do (any dtype, bf16 included: the bytes are viewed as uint8;
    a non-contiguous tensor is made contiguous first);
  - a CUDA tensor is copied to the host when it is serialized, and is
    rebuilt on the reader's current CUDA device; a reader that sees no
    GPU raises a ``RuntimeError`` naming the device, rather than being
    handed a CPU tensor;
  - the tensor a reader gets is always a COPY of the stored bytes, never a
    view into the object store: an in-place write to it cannot corrupt the
    stored object or another reader's value.

Wire layout:
    [uint32 header_len][msgpack header][buffer 0][buffer 1]...
header = {
    "inline": optional msgpack-native value (fast path, no pickle)
    "pickle": offset/len of the cloudpickle payload within the buffer region
    "buffers": list of (offset, len) for out-of-band buffers, 64-byte aligned
    "error": optional — marks the payload as a serialized exception
    "refs": list of serialized ObjectRefs contained in the value (for the
            borrower protocol: the deserializing process registers as a
            borrower with each ref's owner)
}
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import sys
import warnings
from typing import Any, List, Optional, Tuple

import cloudpickle
import msgpack

_ALIGN = 64

# msgpack-native types that skip pickle entirely
_INLINE_TYPES = (type(None), bool, int, float, str, bytes)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _reduce_tensor(t):
    """Pickle reducer for a dense ``torch.Tensor`` / ``nn.Parameter``:
    its bytes as one ``PickleBuffer`` (out of band when large), its dtype,
    shape and device kind in the stream."""
    import torch
    if t.layout != torch.strided or t.is_quantized or t.is_nested \
            or t.device.type not in ("cpu", "cuda"):
        return t.__reduce_ex__(pickle.HIGHEST_PROTOCOL)
    is_param = isinstance(t, torch.nn.Parameter)
    requires_grad = t.requires_grad
    data = t.detach()
    device = data.device.type
    if device == "cuda":
        data = data.cpu()
    data = data.contiguous().reshape(-1).view(torch.uint8).numpy()
    return _rebuild_tensor, (str(t.dtype).rpartition(".")[2],
                             tuple(t.shape), device,
                             pickle.PickleBuffer(data), requires_grad,
                             is_param)


def _rebuild_tensor(dtype: str, shape, device: str, buf, requires_grad,
                    is_param):
    import numpy as np
    import torch
    raw = np.frombuffer(buf, dtype=np.uint8)
    target = "cpu"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the object holds a tensor that was on a CUDA device, and "
                "this process sees no GPU (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); request one "
                "with num_gpus, or move the tensor to the CPU before put")
        target = torch.cuda.current_device()
    t = torch.empty(shape, dtype=getattr(torch, dtype), device=target)
    if raw.size:
        with warnings.catch_warnings():
            # the source is read-only shared memory, only read by the copy
            warnings.simplefilter("ignore", UserWarning)
            t.view(-1).view(torch.uint8).copy_(torch.from_numpy(raw))
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


_torch_pickler = None


def _pickler_class():
    """cloudpickle's Pickler, with the tensor reducer once torch is
    loaded in this process (never imports torch itself)."""
    global _torch_pickler
    torch = sys.modules.get("torch")
    if torch is None or not hasattr(torch, "nn"):
        return cloudpickle.Pickler
    if _torch_pickler is None:
        from collections import ChainMap
        table = {torch.Tensor: _reduce_tensor,
                 torch.nn.Parameter: _reduce_tensor}

        class _TorchPickler(cloudpickle.Pickler):
            dispatch_table = ChainMap(table, cloudpickle.Pickler.dispatch_table)
        _torch_pickler = _TorchPickler
    return _torch_pickler


class SerializedObject:
    """A serialization result: header bytes + list of payload buffers."""

    __slots__ = ("header", "buffers", "total_size", "contained_refs")

    def __init__(self, header: bytes, buffers: List, total_size: int,
                 contained_refs: List):
        self.header = header
        self.buffers = buffers
        self.total_size = total_size
        self.contained_refs = contained_refs

    def to_bytes(self) -> bytes:
        if not self.buffers:
            # inline fast path (scalars, small replies): one concat
            # instead of bytearray + memoryview + write_into
            hdr = self.header
            return (struct.pack("<I", len(hdr)) + hdr
                    + b"\x00" * (self.total_size - 4 - len(hdr)))
        out = bytearray(self.total_size)
        self.write_into(memoryview(out))
        return bytes(out)

    def write_into(self, dest: memoryview):
        hlen = len(self.header)
        struct.pack_into("<I", dest, 0, hlen)
        dest[4:4 + hlen] = self.header
        off = _aligned(4 + hlen)
        for buf in self.buffers:
            b = memoryview(buf)
            if b.format != "B":
                b = b.cast("B")
            n = b.nbytes
            dest[off:off + n] = b
            off = _aligned(off + n)


def serialize(value: Any, is_error: bool = False) -> SerializedObject:
    contained_refs: List = []
    if not is_error and type(value) in _INLINE_TYPES:
        header = msgpack.packb({"inline": value, "v": 1},
                               use_bin_type=True)
        hlen = len(header)
        return SerializedObject(header, [], _aligned(4 + hlen), [])

    oob: List[pickle.PickleBuffer] = []

    def buffer_cb(pb: pickle.PickleBuffer) -> bool:
        raw = pb.raw()
        if raw.nbytes < 1024:
            return True  # tiny buffers: keep in-band
        oob.append(pb)
        return False

    from ray_tpu_torch._private import ref_serialization
    with ref_serialization.collecting_refs(contained_refs):
        out = io.BytesIO()
        _pickler_class()(out, protocol=5, buffer_callback=buffer_cb).dump(value)
        payload = out.getvalue()

    # layout: [pickle payload][oob buffers...]; offsets relative to the start
    # of the buffer region (which begins at aligned(4 + header_len))
    metas: List[Tuple[int, int]] = []
    off = _aligned(len(payload))
    raws = []
    for pb in oob:
        raw = pb.raw()
        if raw.format != "B":
            raw = raw.cast("B")
        metas.append((off, raw.nbytes))
        raws.append(raw)
        off = _aligned(off + raw.nbytes)
    header = msgpack.packb({
        "pickle": len(payload),
        "buffers": metas,
        "error": is_error,
        "refs": [r for r in contained_refs],
        "v": 1,
    }, use_bin_type=True)
    hlen = len(header)
    total = _aligned(4 + hlen) + off
    return SerializedObject(header, [payload] + raws, total, contained_refs)


def deserialize(data, out_of_band_ok: bool = True) -> Any:
    """Deserialize from bytes or a (shared-memory) memoryview.

    When ``data`` is a memoryview into the object store and the payload holds
    aligned numpy buffers, the arrays returned are zero-copy views; callers
    that outlive the view must copy (worker task args are copied by default
    only when the object may be evicted mid-task — primaries are pinned for
    the task's duration by the raylet, so views are safe there).
    """
    view = memoryview(data)
    hlen = struct.unpack_from("<I", view, 0)[0]
    header = msgpack.unpackb(bytes(view[4:4 + hlen]), raw=False)
    if "inline" in header:
        return header["inline"]
    region = view[_aligned(4 + hlen):]
    plen = header["pickle"]
    payload = region[:plen]
    buffers = [region[off:off + n] for off, n in header["buffers"]]
    value = pickle.loads(payload, buffers=buffers)
    if header.get("error"):
        raise value
    return value


def peek_is_error(data) -> bool:
    view = memoryview(data)
    hlen = struct.unpack_from("<I", view, 0)[0]
    header = msgpack.unpackb(bytes(view[4:4 + hlen]), raw=False)
    return bool(header.get("error"))


def serialize_error(exc: BaseException) -> SerializedObject:
    try:
        return serialize(exc, is_error=True)
    except Exception:
        from ray_tpu_torch.exceptions import TaskError
        return serialize(TaskError("<unserializable>", None, repr(exc)),
                         is_error=True)
