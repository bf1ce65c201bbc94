"""CheckpointManager: a step-numbered checkpoint root with atomic commit.

Counterpart of ``ray_tpu/checkpoint/manager.py`` (no JAX there either),
with its two environment knobs turned into keyword arguments:
``fsync=True`` (skip the fsyncs with ``False``: tests and benchmarks on
tmpfs) and ``verify=False`` (``True``: re-verify every file's checksum
when resolving ``latest_committed()`` and in ``load()``).

Layout (one directory per training run)::

    root/
      step_00000003/          committed step: COMMIT marker present
        MANIFEST.json         {relpath: {bytes, crc32}} for every file
        COMMIT                written last — presence == durably committed
        checkpoint.pkl        (dict checkpoints)
        process_0/            (sharded saves: one subdir per process)
          key__shard0.npy ...
          manifest.json       per-process shard manifest
      tmp_step_00000004/      in-flight or abandoned save — never restored

Commit protocol (``commit_step``): checksum + fsync every file under the
tmp dir, write MANIFEST.json, fsync it and the tmp dir, ``os.rename`` the
tmp dir to ``step_N/`` (atomic on POSIX), then write + fsync the COMMIT
marker and fsync the root. A crash at any point leaves either the previous
committed step intact and a garbage ``tmp_step_N/``, or a ``step_N/``
without COMMIT — both are skipped by ``latest_committed()`` and reaped by
retention. Restore therefore never sees a torn checkpoint.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
COMMIT_MARKER = "COMMIT"
_STEP_PREFIX = "step_"
_TMP_PREFIX = "tmp_step_"


def fsync_path(path: str):
    """fsync a file or a directory."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


class PendingCheckpoint:
    """Marker for a step staged under the manager but not yet committed.

    What a gang's workers hand to whoever seals the step with
    ``CheckpointManager.commit_step`` (rank 0 after a barrier, until the
    train session exists). Tiny and picklable by design.
    """

    __slots__ = ("step",)

    def __init__(self, step: int):
        self.step = int(step)

    def __repr__(self):
        return f"PendingCheckpoint(step={self.step})"


class CheckpointManager:
    """Owns one checkpoint root: staging, atomic commit, retention,
    committed-step resolution. Safe for many writer processes on a shared
    filesystem as long as a single process calls ``commit_step`` (rank
    0). ``checkpoint_config`` is duck-typed: its ``num_to_keep`` and
    ``keep_every_k`` override the keywords."""

    def __init__(self, root: str, *, num_to_keep: Optional[int] = None,
                 keep_every_k: int = 0, checkpoint_config=None,
                 fsync: bool = True, verify: bool = False):
        if checkpoint_config is not None:
            num_to_keep = checkpoint_config.num_to_keep
            keep_every_k = getattr(checkpoint_config, "keep_every_k", 0) or 0
        self.root = os.path.abspath(os.path.expanduser(root))
        self.num_to_keep = num_to_keep
        self.keep_every_k = int(keep_every_k or 0)
        self.fsync = bool(fsync)
        self.verify = bool(verify)
        os.makedirs(self.root, exist_ok=True)

    def _fsync(self, path: str):
        if self.fsync:
            fsync_path(path)

    # --------------------------------------------------------------- naming

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"{_STEP_PREFIX}{step:08d}")

    def tmp_dir(self, step: int) -> str:
        return os.path.join(self.root, f"{_TMP_PREFIX}{step:08d}")

    @staticmethod
    def _parse_step(name: str, prefix: str = _STEP_PREFIX) -> Optional[int]:
        if not name.startswith(prefix):
            return None
        try:
            return int(name[len(prefix):])
        except ValueError:
            return None

    # -------------------------------------------------------------- staging

    def begin_step(self, step: int) -> str:
        """Create (or join) the in-flight dir for ``step``. Every writer
        process of a gang calls this and drops its files underneath."""
        tmp = self.tmp_dir(step)
        os.makedirs(tmp, exist_ok=True)
        return tmp

    def stage(self, step: int, checkpoint) -> str:
        """Materialize an ``air.Checkpoint`` payload into the in-flight
        dir. Dict checkpoints become ``checkpoint.pkl`` (written via a
        temp file so a torn write can't masquerade as a payload);
        directory checkpoints are copied in wholesale."""
        tmp = self.begin_step(step)
        data = getattr(checkpoint, "_data", None)
        src = getattr(checkpoint, "_dir", None)
        if data is not None:
            part = os.path.join(tmp, ".checkpoint.pkl.part")
            with open(part, "wb") as f:
                pickle.dump(data, f, protocol=5)
            os.replace(part, os.path.join(tmp, "checkpoint.pkl"))
        elif src is not None:
            shutil.copytree(src, tmp, dirs_exist_ok=True)
        else:
            raise TypeError(f"cannot stage {checkpoint!r}: "
                            "not an air.Checkpoint")
        return tmp

    # --------------------------------------------------------------- commit

    def commit_step(self, step: int,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
        """Seal ``step``: checksum + fsync everything staged under the tmp
        dir, write the manifest, atomically rename, mark committed, then
        apply retention. Returns the committed directory."""
        tmp = self.tmp_dir(step)
        if not os.path.isdir(tmp):
            raise FileNotFoundError(
                f"no staged checkpoint for step {step} at {tmp}")
        files: Dict[str, Dict[str, Any]] = {}
        for dirpath, _dirnames, filenames in os.walk(tmp):
            for fname in filenames:
                fpath = os.path.join(dirpath, fname)
                rel = os.path.relpath(fpath, tmp)
                files[rel] = {"bytes": os.path.getsize(fpath),
                              "crc32": crc32_file(fpath)}
                self._fsync(fpath)
        manifest = {"format": 1, "step": step, "files": files,
                    "committed_unix": time.time(),
                    "meta": dict(metadata or {})}
        mpath = os.path.join(tmp, MANIFEST_NAME)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
        self._fsync(mpath)
        self._fsync(tmp)
        final = self.step_dir(step)
        if os.path.exists(final):
            # a prior attempt died between rename and COMMIT — reclaim
            shutil.rmtree(final)
        os.rename(tmp, final)
        marker = os.path.join(final, COMMIT_MARKER)
        with open(marker, "w") as f:
            json.dump({"step": step, "unix": time.time()}, f)
        self._fsync(marker)
        self._fsync(final)
        self._fsync(self.root)
        self._apply_retention()
        return final

    def is_committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self.step_dir(step),
                                           COMMIT_MARKER))

    # ------------------------------------------------------------ resolution

    def committed_steps(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for name in names:
            step = self._parse_step(name)
            if step is not None and self.is_committed(step):
                out.append(step)
        return sorted(out)

    def latest_committed(self, verify: Optional[bool] = None
                         ) -> Optional[int]:
        """Newest committed step, skipping partial (no COMMIT) and — when
        verification is on (``verify``, else the manager's) — corrupt
        (checksum-mismatch) steps."""
        if verify is None:
            verify = self.verify
        for step in reversed(self.committed_steps()):
            if not verify or self.verify_step(step):
                return step
        return None

    def verify_step(self, step: int) -> bool:
        """Check every manifest entry exists with matching size + crc32."""
        sdir = self.step_dir(step)
        mpath = os.path.join(sdir, MANIFEST_NAME)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            for rel, ent in manifest.get("files", {}).items():
                fpath = os.path.join(sdir, rel)
                if os.path.getsize(fpath) != ent["bytes"]:
                    logger.warning("checkpoint step %d: size mismatch on %s",
                                   step, rel)
                    return False
                if crc32_file(fpath) != ent["crc32"]:
                    logger.warning("checkpoint step %d: crc mismatch on %s",
                                   step, rel)
                    return False
            return True
        except (OSError, ValueError, KeyError) as e:
            logger.warning("checkpoint step %d unreadable: %s", step, e)
            return False

    def load(self, step: Optional[int] = None):
        """A directory-backed ``air.Checkpoint`` for a committed step
        (default: latest). Raises FileNotFoundError when nothing committed
        or the requested step is partial/corrupt."""
        from ray_tpu_torch.air.checkpoint import Checkpoint
        if step is None:
            step = self.latest_committed()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.root}")
        if not self.is_committed(step):
            raise FileNotFoundError(
                f"step {step} is not committed under {self.root}")
        if self.verify and not self.verify_step(step):
            raise FileNotFoundError(
                f"step {step} failed checksum verification")
        return Checkpoint.from_directory(self.step_dir(step))

    def restore_state(self, target_state, step: Optional[int] = None):
        """Reassemble a sharded train state onto ``target_state``'s
        layout — works across a different process count / mesh than the
        one that saved (shards are indexed by global slices, not ranks)."""
        from ray_tpu_torch.air.checkpoint import ShardedCheckpoint
        ckpt = self.load(step)
        return ShardedCheckpoint(ckpt._dir).restore(target_state)

    # ------------------------------------------------------------- retention

    def delete_step(self, step: int):
        sdir = self.step_dir(step)
        # drop the COMMIT marker first so a crash mid-rmtree leaves an
        # uncommitted (ignored) dir, not a corrupt "committed" one
        try:
            os.unlink(os.path.join(sdir, COMMIT_MARKER))
        except FileNotFoundError:
            pass
        shutil.rmtree(sdir, ignore_errors=True)

    def _apply_retention(self):
        steps = self.committed_steps()
        if not steps:
            return
        latest = steps[-1]
        keep = set()
        keep.add(latest)
        if self.num_to_keep is not None:
            keep.update(steps[-max(int(self.num_to_keep), 1):])
        else:
            keep.update(steps)
        if self.keep_every_k > 0:
            keep.update(s for s in steps if s % self.keep_every_k == 0)
        for s in steps:
            if s not in keep:
                self.delete_step(s)
        self._reap_dangling(latest)

    def _reap_dangling(self, latest_committed_step: int):
        """Remove abandoned tmp dirs and uncommitted step dirs that a
        newer committed step supersedes. In-flight saves are always for
        steps newer than the latest committed, so this never races a live
        writer."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return
        for name in names:
            tstep = self._parse_step(name, _TMP_PREFIX)
            if tstep is not None and tstep <= latest_committed_step:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
                continue
            sstep = self._parse_step(name)
            if (sstep is not None and sstep < latest_committed_step
                    and not self.is_committed(sstep)):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def __repr__(self):
        return (f"CheckpointManager(root={self.root!r}, "
                f"num_to_keep={self.num_to_keep}, "
                f"keep_every_k={self.keep_every_k})")
