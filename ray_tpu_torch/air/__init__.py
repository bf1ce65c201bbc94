"""ray_tpu_torch.air — AIR's Checkpoint (dict and directory forms) and
the sharded train-state checkpoint."""

from ray_tpu_torch.air.checkpoint import (Checkpoint,  # noqa: F401
                                          ShardedCheckpoint)
