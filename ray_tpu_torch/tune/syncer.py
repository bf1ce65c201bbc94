"""Experiment-directory syncing to external storage.

Reference: tune/syncer.py (SyncConfig:88, Syncer:157, SyncerCallback:575).
Only local/file:// targets have a built-in backend in this image (no cloud
SDKs); the Syncer ABC is the seam for fsspec/cloud backends.

The port's copy of ``ray_tpu/tune/syncer.py``
(imports renamed to ``ray_tpu_torch``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import List, Optional

from ray_tpu_torch.tune.logger import Callback


@dataclasses.dataclass
class SyncConfig:
    upload_dir: Optional[str] = None  # file:// or plain path
    syncer: Optional["Syncer"] = None  # None = pick by upload_dir scheme
    sync_period: float = 300.0


class Syncer:
    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        raise NotImplementedError

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        raise NotImplementedError

    def delete(self, remote_dir: str) -> bool:
        raise NotImplementedError


def _strip_scheme(uri: str) -> str:
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if "://" in uri:
        raise ValueError(
            f"no built-in syncer for {uri!r} — pass SyncConfig(syncer=...) "
            "with a custom Syncer for cloud storage")
    return uri


class LocalSyncer(Syncer):
    """Recursive copy for local / file:// targets."""

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        dst = _strip_scheme(remote_dir)
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(local_dir, dst, dirs_exist_ok=True)
        return True

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        src = _strip_scheme(remote_dir)
        os.makedirs(local_dir, exist_ok=True)
        shutil.copytree(src, local_dir, dirs_exist_ok=True)
        return True

    def delete(self, remote_dir: str) -> bool:
        shutil.rmtree(_strip_scheme(remote_dir), ignore_errors=True)
        return True


def get_syncer(sync_config: Optional[SyncConfig]) -> Optional[Syncer]:
    if sync_config is None or sync_config.upload_dir is None:
        return None
    return sync_config.syncer or LocalSyncer()


class SyncerCallback(Callback):
    """Syncs the experiment dir to upload_dir: throttled on results, always
    on trial completion and experiment end."""

    def __init__(self, sync_config: SyncConfig):
        self._config = sync_config
        self._syncer = get_syncer(sync_config)
        self._experiment_dir: Optional[str] = None
        self._last_sync = 0.0

    def setup(self, experiment_dir: Optional[str] = None):
        self._experiment_dir = experiment_dir

    def _target(self) -> Optional[str]:
        if self._experiment_dir is None or self._syncer is None:
            return None
        name = os.path.basename(self._experiment_dir.rstrip("/"))
        base = self._config.upload_dir.rstrip("/")
        return f"{base}/{name}"

    def _sync(self, force: bool = False):
        target = self._target()
        if target is None:
            return
        now = time.time()
        if not force and now - self._last_sync < self._config.sync_period:
            return
        self._syncer.sync_up(self._experiment_dir, target)
        self._last_sync = now

    def on_trial_result(self, trial, result):
        self._sync(force=False)

    def on_trial_complete(self, trial):
        self._sync(force=True)

    def on_experiment_end(self, trials: List) -> None:
        self._sync(force=True)
