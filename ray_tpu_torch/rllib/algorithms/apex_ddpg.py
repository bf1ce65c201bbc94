"""Ape-X DDPG — distributed prioritized replay for continuous control.

Reference analogue: rllib/algorithms/apex_ddpg/apex_ddpg.py, which reuses
ApexDQN's training_step with the DDPG policy — the composition here via
ApexLoopMixin, as in ``ray_tpu/rllib/algorithms/apex_ddpg.py``. The
exploration ladder scales per-worker Gaussian action noise instead of
epsilon; priorities come from the critic's per-sample |TD| (the DDPG
critic's ``td_errors``); target networks polyak-update inside
learn_on_batch, so the mixin's hard sync is skipped.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.apex_dqn import (ApexLoopMixin,
                                                     exploration_ladder)
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig


class ApexDDPGConfig(DDPGConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ApexDDPG)
        self._config.update({
            "num_workers": 2,
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
            "exploration_noise": 0.4,  # ladder base, per-worker scaled
            "replay_prefetch": 2,
            "train_batch_size": 64,
            "rollout_fragment_length": 16,
            "learning_starts": 500,
            "max_sample_batches_per_iter": 8,
            "train_intensity_per_iter": 4,
        })


class ApexDDPG(ApexLoopMixin, DDPG):
    _default_config_cls = ApexDDPGConfig

    def _worker_exploration(self, i, n):
        # same geometric ladder as Ape-X epsilon, applied to noise scale
        return {"exploration_noise": exploration_ladder(
            self.config.get("exploration_noise", 0.4), i, n)}

    def setup(self, config):
        super().setup(config)
        self._apex_setup()
        # learner policy acts greedily (it never samples the env)
        self.workers.local_worker.policy.exploration_noise = 0.0
