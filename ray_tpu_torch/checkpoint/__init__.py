"""ray_tpu_torch.checkpoint — the durable checkpoint engine.

The port of ``ray_tpu/checkpoint``: a step-numbered checkpoint root with
atomic commit (write to ``tmp_step_N/``, per-file checksums in the
manifest, fsync, rename + ``COMMIT`` marker), retention, and async
sharded saves that block the train step only for the host snapshot.
Every process writes only the blocks it owns; a single committer seals
the step.

Saving and restoring a trainer::

    from ray_tpu_torch.checkpoint import CheckpointManager
    from ray_tpu_torch.train import spmd

    mgr = CheckpointManager("/path/to/run", num_to_keep=2)
    ckpter = spmd.make_async_checkpointer(manager=mgr)
    ckpter.save(state["step"], state)      # blocks for the snapshot only
    ...
    ckpter.finalize()
    state = spmd.restore_spmd_state(trainer.init(), manager=mgr)
"""

from ray_tpu_torch.checkpoint.manager import (  # noqa: F401
    COMMIT_MARKER, MANIFEST_NAME, CheckpointManager, PendingCheckpoint)
from ray_tpu_torch.checkpoint.async_checkpointer import (  # noqa: F401
    AsyncCheckpointer, SaveStats, snapshot_to_host)

__all__ = [
    "CheckpointManager", "AsyncCheckpointer", "PendingCheckpoint",
    "SaveStats", "snapshot_to_host", "COMMIT_MARKER", "MANIFEST_NAME",
]
