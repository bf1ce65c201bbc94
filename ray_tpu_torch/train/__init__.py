"""ray_tpu_torch.train — distributed training (reference: ray.train).

The train gang: ``DataParallelTrainer`` / ``TorchTrainer`` run a
train_func in each of ``ScalingConfig.num_workers`` actors (one GPU each
with ``use_gpu``), joined by a ``torch.distributed`` group
(``TorchConfig``); the ``session`` reports results, hands out dataset
shards and checkpoints. ``TransformersTrainer``, ``LightningTrainer``,
``SklearnTrainer``, the GBDT trainers and ``RLTrainer`` run their
framework's fit in that gang; each imports its framework only inside
the worker. The training steps themselves
(``spmd.make_causal_lm_trainer``, ``spmd.make_pipelined_lm_trainer``,
``spmd.make_image_classifier_trainer``) run on one device or a mesh.
"""

from ray_tpu_torch.train.data_parallel_trainer import (  # noqa: F401
    BaseTrainer, DataParallelTrainer, Result)
from ray_tpu_torch.train._internal.backend_executor import (  # noqa: F401
    BackendExecutor, TrainingFailedError)
from ray_tpu_torch.air import session  # noqa: F401
from ray_tpu_torch.air.session import (  # noqa: F401
    report, get_checkpoint, get_dataset_shard, get_world_rank,
    get_local_rank, get_node_rank, get_world_size, get_mesh)
from ray_tpu_torch.air.checkpoint import (  # noqa: F401
    Checkpoint, ShardedCheckpoint)
from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.checkpoint import (  # noqa: F401
    CheckpointManager, PendingCheckpoint)
from ray_tpu_torch.train.gbdt_trainer import (  # noqa: F401
    GBDTTrainer, LightGBMTrainer, SklearnGBDTTrainer, XGBoostTrainer)
from ray_tpu_torch.train.torch_trainer import (  # noqa: F401
    TorchConfig, TorchTrainer, prepare_data_loader, prepare_model)
from ray_tpu_torch.train.transformers_trainer import (  # noqa: F401
    HuggingFaceTrainer, TransformersTrainer)
from ray_tpu_torch.train.sklearn_trainer import SklearnTrainer  # noqa: F401
from ray_tpu_torch.train.lightning_trainer import (  # noqa: F401
    LightningTrainer)
from ray_tpu_torch.train.rl_trainer import RLTrainer  # noqa: F401


def __getattr__(name):
    # AsyncCheckpointer imports torch: loaded on first use, so a train
    # worker imports torch only when its train_func does
    if name == "AsyncCheckpointer":
        from ray_tpu_torch.checkpoint import AsyncCheckpointer
        return AsyncCheckpointer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
