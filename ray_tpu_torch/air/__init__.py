"""ray_tpu_torch.air — shared Train primitives: the Checkpoint (dict and
directory forms) and the sharded train-state checkpoint, the configs,
the worker-side session, the preprocessors and batch inference
(``BatchPredictor`` with a ``TorchPredictor``)."""

from ray_tpu_torch.air.checkpoint import (Checkpoint,  # noqa: F401
                                          ShardedCheckpoint)
from ray_tpu_torch.air.config import (  # noqa: F401
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.air import session  # noqa: F401
from ray_tpu_torch.air.session import TrainingResult  # noqa: F401
from ray_tpu_torch.air.preprocessor import (  # noqa: F401
    BatchMapper, Chain, Concatenator, LabelEncoder, MaxAbsScaler,
    MinMaxScaler, Normalizer, OneHotEncoder, OrdinalEncoder,
    Preprocessor, RobustScaler, SimpleImputer, StandardScaler)
from ray_tpu_torch.air.batch_predictor import (  # noqa: F401
    BatchPredictor, Predictor, TorchPredictor)
