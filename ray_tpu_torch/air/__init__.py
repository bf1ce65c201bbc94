"""ray_tpu_torch.air — the dict form of AIR's Checkpoint (what the
class-API Trainable needs)."""

from ray_tpu_torch.air.checkpoint import Checkpoint  # noqa: F401
