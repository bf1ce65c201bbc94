"""CRR — critic-regularized regression for offline RL.

Reference analogue: rllib/algorithms/crr/ (crr.py, torch/crr_torch_policy
.py; Wang et al. 2020). Counterpart of ``ray_tpu/rllib/algorithms/crr.py``:
the critic learns by TD on the dataset (the next action from the target
params' ``pi``, no entropy term); the actor is advantage-weighted
behaviour cloning — the log-prob of dataset actions weighted by f(A(s,
a)), the advantage measured against the mean min-Q over
``advantage_num_actions`` policy samples, f ``binary`` (A > 0) or
``exp`` (exp(A / temperature) clipped at ``max_weight``). SAC's nets and
Adam; ``log_alpha`` gets a zero gradient and stays. The update's draws
come in as ``noise`` (``next``, ``pi``). ``training_step`` also reports
``timers`` (host ms drawing minibatches and learning).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.sac import (SACConfig, SACPolicy,
                                                _dataset_action_logp,
                                                _squash)
from ray_tpu_torch.rllib.offline import (OfflineAlgorithmMixin,
                                         OfflineDataConfigMixin,
                                         learn_offline)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class CRRPolicy(SACPolicy):
    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        k = self.config.get("advantage_num_actions", 4)
        return {"next": self._randn(n, self.act_dim),
                "pi": self._randn(k, n, self.act_dim)}

    def loss(self, b, noise):
        cfg = self.config
        obs, acts = b[SampleBatch.OBS], b["raw_actions"]
        target_q = self._target_q(b, noise["next"], entropy=False)
        q1, q2 = self.model.q(obs, acts)
        critic_loss = torch.mean((q1 - target_q) ** 2
                                 + (q2 - target_q) ** 2)

        # advantage baseline: mean min-Q over n policy samples at s
        mean, log_std = self.model.pi(obs)
        with torch.no_grad():
            a, _ = _squash(mean, log_std, noise["pi"])
            v_est = torch.mean(torch.minimum(*self._q_many(obs, a)), dim=0)
            adv = torch.minimum(q1, q2) - v_est
            if cfg.get("weight_type", "exp") == "binary":
                w = (adv > 0).to(torch.float32)
            else:
                w = torch.clamp(torch.exp(adv / cfg.get("temperature", 1.0)),
                                max=cfg.get("max_weight", 20.0))

        actor_loss = -torch.mean(w * _dataset_action_logp(acts, mean, log_std))
        total = critic_loss + actor_loss
        return total, {"critic_loss": critic_loss,
                       "actor_loss": actor_loss,
                       "mean_weight": torch.mean(w),
                       "mean_advantage": torch.mean(adv),
                       "mean_q": torch.mean(q1)}


class CRRConfig(OfflineDataConfigMixin, SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CRR)
        self._config.update({
            "input_path": None,
            "weight_type": "exp",  # or "binary"
            "temperature": 1.0,
            "max_weight": 20.0,
            "advantage_num_actions": 4,
            "train_batch_size": 256,
            "num_iters_per_step": 10,
        })


class CRR(OfflineAlgorithmMixin, Algorithm):
    _policy_cls = CRRPolicy
    _default_config_cls = CRRConfig

    def setup(self, config):
        super().setup(config)
        self._load_offline_dataset()

    def training_step(self) -> Dict[str, Any]:
        stats, timers = learn_offline(self, self._offline_minibatch)
        return {"num_env_steps_sampled_this_iter": 0,
                **{f"learner/{k}": v for k, v in stats.items()},
                "timers": timers}
