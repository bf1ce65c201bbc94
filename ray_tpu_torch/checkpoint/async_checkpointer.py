"""AsyncCheckpointer: snapshot the train state to host, write in background.

Counterpart of ``ray_tpu/checkpoint/async_checkpointer.py``. The train
step blocks only for the host snapshot (a device→host copy of the blocks
this process *owns*); serialization, checksumming, fsync and commit
happen on a single background writer thread. One save may be in flight
at a time — a second ``save()`` blocks until the first lands
(backpressure, counted in the save's ``blocked_ms``) so checkpoints can
never consume unbounded host memory or reorder on disk. The JAX
package's ``RTPU_CKPT_ASYNC`` knob is the keyword ``async_`` here
(``False``: write inline on the calling thread, the sync baseline).

What is written (``snapshot_to_host``) follows the JAX package's
dedup of replicated state and its on-disk format (file names,
``manifest.json``), from the port's own walk of the state:

  - a trainer state of ``train.spmd`` (``{"model", "opt", "step",
    "mesh_state"}``): every param as this rank's ``_MeshState`` block,
    indexed by its global slices (from the placements that shard it;
    a pipeline stage's blocks stacked on a new leading axis, one row per
    pp rank), written only where the rank's coordinate is 0 on every
    axis that neither shards it nor holds a piece of it (JAX's
    ``replica_id == 0``); the model's buffers (batch-norm statistics)
    whole, the same way; the optimizer's per-block state under
    ``opt/<param>/<key>`` (moments sharded as their block, scalars such
    as AdamW's ``step`` as host values); ``step`` as a host value;
  - any other tree (dicts, in sorted key order as JAX flattens them,
    lists, tuples) of numpy arrays, torch tensors and Python or numpy
    scalars: every leaf a host value, written by process 0 only.

bfloat16 has no numpy dtype without ml_dtypes: its leaves are written
as the JAX package writes them (a ``.npy`` of ``descr '<V2'`` holding
the raw 2-byte values, ``"dtype": "bfloat16"`` in the manifest) and
read back bit for bit.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.checkpoint.manager import (CheckpointManager,
                                              PendingCheckpoint)

logger = logging.getLogger(__name__)

BF16 = "bfloat16"


def sanitize_key(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) or "leaf"


@dataclass
class SaveStats:
    """Per-save accounting. ``blocked_ms`` is the time the *training*
    thread spent inside save() — backpressure wait + host snapshot;
    write/commit happen off-thread (or inline in sync mode, where they
    count toward blocked_ms too)."""

    step: int
    snapshot_ms: float = 0.0
    backpressure_ms: float = 0.0
    blocked_ms: float = 0.0
    write_ms: float = 0.0
    commit_ms: float = 0.0
    bytes: int = 0
    files: int = 0
    committed: bool = False
    error: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in (
            "step", "snapshot_ms", "backpressure_ms", "blocked_ms",
            "write_ms", "commit_ms", "bytes", "files", "committed",
            "error")}


# ------------------------------------------------------------ the walk


def json_to_index(idx_json):
    return tuple(slice(a, b, c) for a, b, c in idx_json)


def dtype_name(x) -> str:
    """The manifest's dtype: numpy's name (``float32``, ``bfloat16``)."""
    if torch.is_tensor(x):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's memory as numpy (bfloat16 as its uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_host(x, staging: Optional[Dict[str, torch.Tensor]] = None,
            key: str = "") -> np.ndarray:
    """A host copy of a tensor, array or scalar that never aliases it
    (AdamW steps its params and moments in place; ``Tensor.numpy()`` of
    a CPU tensor is a view). bfloat16 comes back as its raw uint16
    bits. A CUDA tensor is copied synchronously, or, given ``staging``
    (a dict the caller keeps across snapshots), into a pinned buffer
    kept there under ``key`` without waiting: the caller synchronizes
    before reading it (``snapshot_to_host``)."""
    if not torch.is_tensor(x):
        return np.array(x, copy=True)
    x = x.detach()
    if staging is None or not x.is_cuda:
        return _numpy(x.to("cpu", copy=True))
    buf = staging.get(key)
    if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
        buf = staging[key] = torch.empty(x.shape, dtype=x.dtype,
                                         pin_memory=True)
    buf.copy_(x, non_blocking=True)
    return _numpy(buf)


def is_trainer_state(state) -> bool:
    """A ``train.spmd`` trainer's state (``{"model", "opt", "step",
    "mesh_state"}``)."""
    return (isinstance(state, dict) and "opt" in state and "model" in state
            and hasattr(state.get("mesh_state"), "shards"))


def block_layout(ms, name: str, block_shape):
    """Param ``name``'s block on this rank of ``_MeshState`` ``ms``: the
    global shape, its slices in it (JSON: ``[start, stop, None]`` per
    dim, ``[None, None, None]`` where whole) and whether this rank
    writes it (coordinate 0 on every axis that neither shards it nor
    holds a piece of it)."""
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    mesh = ms.mesh
    dims = ms.sharded.get(name, {})
    pieces = ms.pieces.get(name, ())
    shape = list(block_shape)
    index = [[None, None, None] for _ in shape]
    for axis, d in dims.items():
        i, b = mesh.index(axis), shape[d]
        shape[d] = b * mesh.size(axis)
        index[d] = [i * b, (i + 1) * b, None]
    for axis in pieces:     # the pieces stacked on new leading axes
        i = mesh.index(axis)
        shape.insert(0, mesh.size(axis))
        index.insert(0, [i, i + 1, None])
    owner = all(mesh.index(a) == 0 for a in AXIS_ORDER
                if a not in dims and a not in pieces)
    return shape, index, owner


def persistent_buffers(model) -> Dict[str, torch.Tensor]:
    """The module's buffers that its state_dict holds."""
    keys = set(model.state_dict(keep_vars=True))
    return {n: b for n, b in model.named_buffers() if n in keys}


def trainer_leaves(state):
    """(key, tensor or value, global shape, index or None, writes)
    of every leaf of a trainer state, on this rank."""
    ms = state["mesh_state"]
    for n, block in ms.shards.items():
        shape, index, owner = block_layout(ms, n, block.shape)
        yield f"model/{n}", block, shape, index, owner
    first = not any(ms.mesh.coordinate)    # rank 0 of the mesh
    for n, buf in persistent_buffers(state["model"]).items():
        yield (f"model/{n}", buf, list(buf.shape),
               [[None, None, None]] * buf.ndim, first)
    opt = state["opt"]
    for n, block in ms.shards.items():
        shape, index, owner = block_layout(ms, n, block.shape)
        for k, v in sorted(opt.state.get(block, {}).items()):
            if torch.is_tensor(v) and v.ndim and v.shape == block.shape:
                yield f"opt/{n}/{k}", v, shape, index, owner
            else:
                yield f"opt/{n}/{k}", v, None, None, first
    yield "step", state["step"], None, None, first


def tree_leaves(tree, path=()):
    """(path, leaf) of a tree of dicts (sorted keys, as JAX flattens),
    lists and tuples; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def path_key(path) -> str:
    return "/".join(str(p) for p in path)


def snapshot_to_host(state, process_index: int = 0,
                     staging: Optional[Dict[str, torch.Tensor]] = None
                     ) -> List[Dict[str, Any]]:
    """The entries this process writes of ``state`` (module docstring),
    copied to host memory: ``{key, data, index, shape, dtype}``, the
    on-disk per-process manifest's shape. Copies (never aliases) so an
    in-place step can't corrupt an in-flight save. With ``staging`` a
    trainer state's CUDA tensors go to pinned buffers kept there, all
    copies queued before one wait; the buffers are reused by the next
    snapshot, so the entries must be written before it
    (``AsyncCheckpointer``'s one save in flight)."""
    entries: List[Dict[str, Any]] = []
    if is_trainer_state(state):
        for key, leaf, shape, index, owner in trainer_leaves(state):
            if not owner:
                continue    # a replica another rank writes
            data = to_host(leaf, staging, key)
            entries.append({"key": key, "data": data, "index": index,
                            "shape": list(data.shape) if shape is None
                            else list(shape), "dtype": dtype_name(leaf)})
        if staging and torch.cuda.is_available():
            torch.cuda.synchronize()
        return entries
    if process_index != 0:
        return entries      # host values: only process 0 writes
    for path, leaf in tree_leaves(state):
        data = to_host(leaf)
        entries.append({"key": path_key(path), "data": data, "index": None,
                        "shape": list(data.shape), "dtype": dtype_name(leaf)})
    return entries


def save_npy(path: str, data: np.ndarray, dtype: str):
    """``np.save``, except that bfloat16 (``data``: its uint16 bits) is
    written with ``descr '<V2'``, byte for byte what numpy writes for
    ml_dtypes' bfloat16."""
    if dtype != BF16:
        np.save(path, data)
        return
    data = np.ascontiguousarray(data)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(data.shape)})
        f.write(data.tobytes())


def load_npy(path: str, dtype: str) -> np.ndarray:
    """``np.load``; bfloat16 comes back as its uint16 bits."""
    data = np.load(path)
    return data.view(np.uint16) if dtype == BF16 else data


def write_host_snapshot(pdir: str, entries: List[Dict[str, Any]]) -> int:
    """Write snapshot entries into one process dir with deterministic
    ``key__shard<i>.npy`` names + a per-process manifest.json (the schema
    ShardedCheckpoint.restore reassembles from). Returns bytes written."""
    # this process owns pdir exclusively: clear debris a previous attempt
    # at the same step may have left (restart after a mid-save death)
    if os.path.isdir(pdir):
        shutil.rmtree(pdir)
    os.makedirs(pdir, exist_ok=True)
    manifest = []
    shard_counts: Dict[str, int] = {}
    nbytes = 0
    for e in entries:
        san = sanitize_key(e["key"])
        i = shard_counts.get(san, 0)
        shard_counts[san] = i + 1
        fname = f"{san}__shard{i}.npy" if e["index"] is not None \
            else f"{san}__full.npy"
        if e["index"] is None and i:
            fname = f"{san}__full{i}.npy"  # sanitization collision
        save_npy(os.path.join(pdir, fname), e["data"], e["dtype"])
        nbytes += e["data"].nbytes
        manifest.append({"key": e["key"], "file": fname,
                         "index": e["index"], "shape": e["shape"],
                         "dtype": e["dtype"]})
    part = os.path.join(pdir, ".manifest.json.part")
    with open(part, "w") as f:
        json.dump(manifest, f)
    os.replace(part, os.path.join(pdir, "manifest.json"))
    return nbytes


class AsyncCheckpointer:
    """Background sharded saver bound to one CheckpointManager.

    commit semantics:
      - ``commit="auto"`` (default): the writer thread commits iff this is
        a single-process save (process_count == 1). A gang leaves the
        commit to one process after a barrier
        (``train.spmd.commit_gang_step``).
      - ``commit=True`` / ``commit=False`` force it.

    ``async_=False`` writes inline on the calling thread. A trainer
    state's CUDA tensors are snapshot into pinned host buffers that the
    checkpointer keeps and reuses (the copy runs at the link's pinned
    rate; a save waits for the previous write before it snapshots).
    """

    def __init__(self, manager: CheckpointManager, *,
                 process_index: int = 0, process_count: int = 1,
                 commit: Any = "auto", async_: bool = True):
        self.manager = manager
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if commit == "auto":
            commit = process_count == 1
        self._commit = bool(commit)
        self.async_ = bool(async_)
        self._stats: List[SaveStats] = []
        self._cond = threading.Condition()
        self._inflight: Optional[tuple] = None  # (step, entries, stats)
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._staging: Dict[str, torch.Tensor] = {}

    # ---------------------------------------------------------------- save

    def save(self, step: int, state,
             metadata: Optional[Dict[str, Any]] = None) -> PendingCheckpoint:
        """Snapshot ``state`` to host and hand off to the writer. Blocks
        only for (a) a previous save still in flight and (b) the host
        snapshot itself. Raises if the previous save failed."""
        t0 = time.perf_counter()
        stats = SaveStats(step=step)
        with self._cond:
            while self._inflight is not None and self._error is None:
                self._cond.wait(timeout=0.5)
            self._raise_on_error()
        stats.backpressure_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        entries = snapshot_to_host(state, self.process_index,
                                   self._staging)
        stats.snapshot_ms = (time.perf_counter() - t1) * 1e3
        if self.async_:
            with self._cond:
                self._ensure_thread()
                self._inflight = (step, entries, metadata, stats)
                self._cond.notify_all()
            stats.blocked_ms = (time.perf_counter() - t0) * 1e3
        else:
            self._write_one(step, entries, metadata, stats)
            stats.blocked_ms = (time.perf_counter() - t0) * 1e3
            self._raise_on_error()
        self._stats.append(stats)
        return PendingCheckpoint(step)

    def in_flight(self) -> bool:
        """Whether a save is still being written."""
        with self._cond:
            return self._inflight is not None

    def wait(self):
        """Barrier: block until the in-flight save (if any) fully landed;
        re-raise a writer failure."""
        with self._cond:
            while self._inflight is not None and self._error is None:
                self._cond.wait(timeout=0.5)
            self._raise_on_error()

    def finalize(self):
        """wait() + stop the writer thread. The checkpointer is reusable
        afterwards (a new save restarts the thread)."""
        self.wait()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._stop = False

    # --------------------------------------------------------------- stats

    @property
    def stats(self) -> List[SaveStats]:
        return list(self._stats)

    def stats_summary(self) -> Dict[str, Any]:
        done = [s for s in self._stats if s.error is None]
        if not done:
            return {"saves": 0}
        return {
            "saves": len(done),
            "blocked_ms_mean": sum(s.blocked_ms for s in done) / len(done),
            "snapshot_ms_mean": sum(s.snapshot_ms for s in done) / len(done),
            "write_ms_mean": sum(s.write_ms for s in done) / len(done),
            "bytes_total": sum(s.bytes for s in done),
        }

    # -------------------------------------------------------------- writer

    def _raise_on_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save failed: {err!r}") from err

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name=f"ckpt-writer-p{self.process_index}")
            self._thread.start()

    def _writer_loop(self):
        while True:
            with self._cond:
                while self._inflight is None and not self._stop:
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    return
                step, entries, metadata, stats = self._inflight
            try:
                self._write_one(step, entries, metadata, stats)
            finally:
                with self._cond:
                    self._inflight = None
                    self._cond.notify_all()

    def _write_one(self, step, entries, metadata, stats: SaveStats):
        try:
            t0 = time.perf_counter()
            tmp = self.manager.begin_step(step)
            pdir = os.path.join(tmp, f"process_{self.process_index}")
            stats.bytes = write_host_snapshot(pdir, entries)
            stats.files = len(entries)
            stats.write_ms = (time.perf_counter() - t0) * 1e3
            if self._commit:
                t1 = time.perf_counter()
                self.manager.commit_step(step, metadata=metadata)
                stats.commit_ms = (time.perf_counter() - t1) * 1e3
                stats.committed = True
        except BaseException as e:  # surfaced on the next save()/wait()
            stats.error = repr(e)
            with self._cond:
                self._error = e
            logger.warning("checkpoint step %d write failed: %r", step, e)
