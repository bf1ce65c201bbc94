"""AIR configs.

The port's copy of ``ray_tpu/air/config.py`` (reference analogue:
python/ray/air/config.py — ScalingConfig:79, FailureConfig:454,
CheckpointConfig:513, RunConfig:642). ``ScalingConfig.use_gpu`` asks for
one GPU per worker, granted by index through ``CUDA_VISIBLE_DEVICES``;
the JAX package's TPU fields (``use_tpu``, ``tpu_chips_per_worker``,
``tpu_topology``) have no counterpart. ``mesh`` names the
model-parallel axes inside the gang.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    # resources per gang worker
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # model-parallel axes inside the gang (dp fills the remainder)
    mesh: Optional[Dict[str, int]] = None
    trainer_resources: Optional[Dict[str, float]] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res

    @property
    def total_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        per = self.worker_resources()
        for k, v in per.items():
            out[k] = v * self.num_workers
        return out


@dataclass
class FailureConfig:
    max_failures: int = 0  # -1 = infinite; trial restarts from last ckpt
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None  # None = keep all
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False
    # consumed by ray_tpu_torch.checkpoint.CheckpointManager: steps
    # divisible by k survive num_to_keep eviction (milestone checkpoints
    # for post-hoc eval of a run on preemptible machines)
    keep_every_k: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # local experiment root (local_dir)
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    log_to_file: bool = False
    # driver-side experiment callbacks (None = default CSV/JSON/TB loggers)
    callbacks: Optional[list] = None
    sync_config: Optional[Any] = None  # tune.syncer.SyncConfig
