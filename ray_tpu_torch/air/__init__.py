"""ray_tpu_torch.air — shared Train primitives: the Checkpoint (dict and
directory forms) and the sharded train-state checkpoint, the configs
and the worker-side session."""

from ray_tpu_torch.air.checkpoint import (Checkpoint,  # noqa: F401
                                          ShardedCheckpoint)
from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.air import session  # noqa: F401
from ray_tpu_torch.air.session import TrainingResult  # noqa: F401
