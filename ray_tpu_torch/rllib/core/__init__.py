"""ray_tpu_torch.rllib.core — the RLModule/Learner stack (reference:
rllib/core/), local mode."""

from ray_tpu_torch.rllib.core.learner import (DEFAULT_MODULE_ID, Learner,
                                              PPOLearner)
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (MultiRLModule, RLModule,
                                                RLModuleSpec)

__all__ = ["RLModule", "RLModuleSpec", "MultiRLModule", "Learner",
           "PPOLearner", "LearnerGroup", "DEFAULT_MODULE_ID"]
