"""AIR Checkpoint: one object, a dict or a directory.

Reference semantics: python/ray/air/checkpoint.py:60. The port's copy of
``ray_tpu/air/checkpoint.py``: a Checkpoint is interconvertible between
dict and local directory (``to_directory`` is crash-safe), and
``ShardedCheckpoint`` writes and restores a train state by blocks, one
subdir per process, indexed by global slices so that a state restores
on another mesh. The object-ref form puts the checkpoint in the port
runtime's object store (``ray_tpu_torch.put`` / ``get``; a directory
checkpoint goes as its dict, so the object is self-contained).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Optional

class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None):
        if (data is None) == (directory is None):
            raise ValueError("provide exactly one of data dict / directory")
        self._data = data
        self._dir = directory

    # ------------------------------------------------------------- creators

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=path)

    @classmethod
    def from_object_ref(cls, ref) -> "Checkpoint":
        import ray_tpu_torch
        return ray_tpu_torch.get(ref)

    # ------------------------------------------------------------ converters

    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        blob = os.path.join(self._dir, "checkpoint.pkl")
        if os.path.exists(blob):
            with open(blob, "rb") as f:
                return pickle.load(f)
        # raw-file checkpoint: walk recursively so sharded layouts
        # (process_<i>/ subdirs) flatten to relative-path keys
        out: Dict[str, Any] = {}
        for dirpath, _dirnames, filenames in os.walk(self._dir):
            for name in filenames:
                fpath = os.path.join(dirpath, name)
                with open(fpath, "rb") as f:
                    out[os.path.relpath(fpath, self._dir)] = f.read()
        return out

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize into ``path`` crash-safely: content is written to a
        staging dir next to the target and swapped in with an atomic
        rename, so a failure mid-write leaves either the old directory or
        nothing — never a half-materialized checkpoint."""
        if path is None:
            path = os.path.join(tempfile.gettempdir(), "rtt_ckpt",
                                uuid.uuid4().hex)
        path = os.path.abspath(path)
        if self._dir is not None and os.path.abspath(self._dir) == path:
            return path
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        staging = tempfile.mkdtemp(
            prefix=f".{os.path.basename(path)}.part-", dir=parent)
        try:
            if self._dir is not None:
                shutil.copytree(self._dir, staging, dirs_exist_ok=True)
            else:
                with open(os.path.join(staging, "checkpoint.pkl"),
                          "wb") as f:
                    pickle.dump(self._data, f, protocol=5)
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.rename(staging, path)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        return path

    def to_object_ref(self):
        import ray_tpu_torch
        if self._dir is not None:
            # materialize as dict so the object is self-contained
            return ray_tpu_torch.put(Checkpoint.from_dict(self.to_dict()))
        return ray_tpu_torch.put(self)

    # -------------------------------------------------------- preprocessor

    _PREPROCESSOR_KEY = "_preprocessor"

    def with_preprocessor(self, preprocessor) -> "Checkpoint":
        """Attach a fitted preprocessor so inference applies the exact
        training-time transform (the preprocessor rides the checkpoint,
        cloudpickled as in the JAX package, so a ``BatchMapper`` over a
        lambda or a script's function travels too; pickle reads it)."""
        import cloudpickle
        data = self.to_dict()
        data[self._PREPROCESSOR_KEY] = cloudpickle.dumps(preprocessor)
        return Checkpoint.from_dict(data)

    def get_preprocessor(self):
        blob = self.to_dict().get(self._PREPROCESSOR_KEY)
        return pickle.loads(blob) if blob is not None else None

    def get(self, key: str, default=None):
        return self.to_dict().get(key, default)

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._dir}"
        return f"Checkpoint({kind})"


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class ShardedCheckpoint:
    """A train state's checkpoint by blocks: every process writes what it
    owns under ``root/process_<i>/`` (``checkpoint.async_checkpointer``'s
    walk and format, the JAX package's), and ``restore`` rebuilds each
    leaf whole on the host from its global index slices, then takes the
    target's block. So a state restores onto another process count or
    mesh than the one that saved it."""

    def __init__(self, root: str):
        self.root = root

    def save(self, state, process_index: Optional[int] = None) -> str:
        """Write this process's blocks (``process_index``: default the
        process group's rank, else 0). Replicas other ranks write, and
        host values on processes other than 0, are skipped, so each
        block is written exactly once across the gang."""
        from ray_tpu_torch.checkpoint.async_checkpointer import (
            snapshot_to_host, write_host_snapshot)
        idx = _process_index() if process_index is None else process_index
        pdir = os.path.join(self.root, f"process_{idx}")
        write_host_snapshot(pdir, snapshot_to_host(state, idx))
        return self.root

    def _entries(self) -> Dict[str, list]:
        import json
        entries: Dict[str, list] = {}
        for pname in sorted(os.listdir(self.root)):
            pdir = os.path.join(self.root, pname)
            mf = os.path.join(pdir, "manifest.json")
            if not os.path.exists(mf):
                continue
            with open(mf) as f:
                for e in json.load(f):
                    e["dir"] = pdir
                    entries.setdefault(e["key"], []).append(e)
        return entries

    def restore(self, target_state):
        """Restore onto ``target_state``. A trainer state of
        ``train.spmd`` is loaded in place (each param block, the
        model's buffers, the optimizer's per-block state through its
        ``load_state_dict``, ``step``) and returned. Any other tree comes
        back as a new tree of its structure: torch leaves as tensors on
        their device, others as numpy arrays, each in the checkpoint's
        dtype (bfloat16 as a torch tensor: numpy has none)."""
        from ray_tpu_torch.checkpoint.async_checkpointer import (
            is_trainer_state, path_key, tree_leaves)
        entries = self._entries()
        if is_trainer_state(target_state):
            return _restore_trainer(target_state, entries)
        leaves = [(path, leaf, _assemble(entries, path_key(path)))
                  for path, leaf in tree_leaves(target_state)]
        out = iter([_like(leaf, full) for _, leaf, full in leaves])
        return _rebuild(target_state, out)


def _assemble(entries, key: str):
    """(the leaf ``key`` whole as numpy, its dtype name) from its
    entries: a host value's one file, or every block at its slices."""
    import numpy as np

    from ray_tpu_torch.checkpoint.async_checkpointer import (
        BF16, json_to_index, load_npy)
    shards = entries.get(key)
    if not shards:
        raise KeyError(f"checkpoint missing {key}")
    dtype = shards[0]["dtype"]
    full = np.zeros(shards[0]["shape"],
                    np.uint16 if dtype == BF16 else np.dtype(dtype))
    for e in shards:
        data = load_npy(os.path.join(e["dir"], e["file"]), dtype)
        if e["index"] is None:
            full = data
        else:
            full[json_to_index(e["index"])] = data
    return full, dtype


def _tensor(full, dtype: str):
    import numpy as np
    import torch

    from ray_tpu_torch.checkpoint.async_checkpointer import BF16
    if not full.flags.c_contiguous:     # a block's slices
        full = full.copy()
    if dtype == BF16:
        return torch.from_numpy(full.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(full)


def _like(leaf, assembled):
    import torch
    full, dtype = assembled
    if torch.is_tensor(leaf) or dtype == "bfloat16":
        dev = leaf.device if torch.is_tensor(leaf) else "cpu"
        return _tensor(full, dtype).to(dev)
    return full


def _rebuild(tree, leaves):
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], leaves)
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _restore_trainer(state, entries):
    """Load a trainer state's params, buffers, optimizer state and step
    in place from the checkpoint's ``entries``, on any mesh."""
    import torch

    from ray_tpu_torch.checkpoint.async_checkpointer import (
        block_layout, json_to_index, persistent_buffers)
    ms = state["mesh_state"]

    def block(key, name, like):
        full, dtype = _assemble(entries, key)
        _shape, index, _owner = block_layout(ms, name, like.shape)
        return _tensor(full[json_to_index(index)], dtype).reshape(like.shape)

    with torch.no_grad():
        for n, b in ms.shards.items():
            b.copy_(block(f"model/{n}", n, b))
        for n, buf in persistent_buffers(state["model"]).items():
            full, dtype = _assemble(entries, f"model/{n}")
            buf.copy_(_tensor(full, dtype))
    opt = state["opt"]
    names = {id(b): n for n, b in ms.shards.items()}
    sd = opt.state_dict()
    per_param = {}
    i = 0
    for group in opt.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            prefix = f"opt/{n}/"
            st = {}
            for key in entries:
                if not key.startswith(prefix):
                    continue
                k = key[len(prefix):]
                if entries[key][0]["index"] is None:
                    full, dtype = _assemble(entries, key)
                    st[k] = _tensor(full, dtype)
                else:
                    st[k] = block(key, n, p)
            if st:
                per_param[i] = st
            i += 1
    # the optimizer's own loader places each value (moments on the
    # param's device and dtype; AdamW's step where it keeps it)
    opt.load_state_dict({"state": per_param,
                         "param_groups": sd["param_groups"]})
    full, _ = _assemble(entries, "step")
    state["step"] = int(full)
    return state
