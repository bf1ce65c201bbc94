"""APPO — asynchronous PPO (IMPALA architecture + clipped surrogate).

Reference analogue: rllib/algorithms/appo/ (appo.py, appo_torch_policy.py)
— the IMPALA actor-learner decoupling (async samplers, learner thread,
V-trace off-policy correction) with PPO's clipped surrogate objective on
the V-trace advantages instead of the plain policy-gradient term.
Counterpart of ``ray_tpu/rllib/algorithms/appo.py``; locally it runs
IMPALA's sync path.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.impala import (IMPALA, IMPALAConfig,
                                                   IMPALAPolicy)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class APPOPolicy(IMPALAPolicy):
    def loss(self, batch):
        dist_inputs, values, target_logp, vs, pg_adv = \
            self._vtrace_terms(batch)
        # PPO clip on the V-trace advantages (reference:
        # appo_torch_policy.py loss — the "is_ratio"/clipped surrogate)
        clip = self.config.get("clip_param", 0.3)
        ratio = torch.exp(target_logp - batch[SampleBatch.ACTION_LOGP])
        surrogate = torch.minimum(
            ratio * pg_adv,
            torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * pg_adv)
        total, stats = self._assemble_loss(
            -torch.mean(surrogate), dist_inputs, values, vs)
        stats["mean_is_ratio"] = torch.mean(ratio)
        return total, stats


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self._config.update({
            "clip_param": 0.3,
        })


class APPO(IMPALA):
    _policy_cls = APPOPolicy
    _default_config_cls = APPOConfig
