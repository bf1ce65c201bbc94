"""CQL — conservative Q-learning for offline RL.

Reference analogue: rllib/algorithms/cql/ (cql.py, cql_torch_policy.py).
Counterpart of ``ray_tpu/rllib/algorithms/cql.py``: SAC's
actor/critic/alpha machinery plus a conservative penalty on the critic —
logsumexp over ``cql_num_actions`` uniform, policy and next-policy
actions (with their importance terms; the sampled actions carry no
gradient) minus the dataset Q — and a behaviour-cloning phase for the
actor (``bc_iters`` learn steps, the 0-d ``_bc_weight`` column: 1 during
it, 0 after). Trains from a JsonReader dataset only; the env serves
evaluation. The update's draws come in as ``noise`` (``draw_noise``:
``next``, ``uniform``, ``pi``, ``next_pi``, ``new``), so a test can
inject JAX's. The three sets of sampled actions go through the critics
as one batch. ``training_step`` also reports ``timers`` (host ms drawing
minibatches and learning).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.sac import (SACConfig, SACPolicy,
                                                _dataset_action_logp,
                                                _squash)
from ray_tpu_torch.rllib.offline import (OfflineAlgorithmMixin,
                                         OfflineDataConfigMixin,
                                         learn_offline)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class CQLPolicy(SACPolicy):
    loss_columns = SACPolicy.loss_columns + ("_bc_weight",)

    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        k, d = self.config.get("cql_num_actions", 4), self.act_dim
        uniform = torch.rand((k, n, d), generator=self._gen,
                             device=self.device) * 2.0 - 1.0
        return {"next": self._randn(n, d), "uniform": uniform,
                "pi": self._randn(k, n, d), "next_pi": self._randn(k, n, d),
                "new": self._randn(n, d)}

    def loss(self, b, noise):
        cfg = self.config
        n_samp = cfg.get("cql_num_actions", 4)
        obs, nobs = b[SampleBatch.OBS], b[SampleBatch.NEXT_OBS]
        acts = b["raw_actions"]
        target_q = self._target_q(b, noise["next"])
        q1, q2 = self.model.q(obs, acts)
        bellman = torch.mean((q1 - target_q) ** 2 + (q2 - target_q) ** 2)

        # conservative penalty (Kumar et al. Eq. 4 with importance
        # terms): the penalty trains the critic only, so the sampled
        # actions and their log-probs carry no gradient
        with torch.no_grad():
            pi_a, pi_logp = _squash(*self.model.pi(obs), noise["pi"])
            npi_a, npi_logp = _squash(*self.model.pi(nobs), noise["next_pi"])
        log_unif = -self.act_dim * math.log(2.0)  # density of U(-1,1)^d
        sampled = torch.cat([noise["uniform"], pi_a, npi_a])
        offsets = torch.cat([torch.full_like(pi_logp, log_unif), pi_logp,
                             npi_logp])
        log_n = math.log(3 * n_samp)
        penalty = 0.0
        for q_data, q_samp in zip((q1, q2), self._q_many(obs, sampled)):
            lse = torch.logsumexp(q_samp - offsets, dim=0) - log_n
            penalty = penalty + torch.mean(lse - q_data)
        critic_loss = bellman + cfg.get("cql_alpha", 1.0) * penalty

        # actor: BC warm-up cross-fading into the SAC objective
        mean, log_std, new_logp, min_q = self._actor_terms(obs, noise["new"])
        alpha = torch.exp(self.log_alpha.detach())
        sac_actor = torch.mean(alpha * new_logp - min_q)
        bc_actor = torch.mean(
            alpha * new_logp - _dataset_action_logp(acts, mean, log_std))
        bc_w = b["_bc_weight"]
        actor_loss = bc_w * bc_actor + (1.0 - bc_w) * sac_actor

        total = critic_loss + actor_loss + self._alpha_loss(new_logp)
        return total, {"critic_loss": critic_loss,
                       "bellman_loss": bellman,
                       "cql_penalty": penalty,
                       "actor_loss": actor_loss,
                       "alpha": torch.exp(self.log_alpha),
                       "mean_q": torch.mean(q1)}


class CQLConfig(OfflineDataConfigMixin, SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self._config.update({
            "input_path": None,
            "cql_alpha": 1.0,
            "cql_num_actions": 4,
            "bc_iters": 200,  # actor BC warmup learn-steps
            "train_batch_size": 256,
            "num_iters_per_step": 10,
        })


class CQL(OfflineAlgorithmMixin, Algorithm):
    _policy_cls = CQLPolicy
    _default_config_cls = CQLConfig

    def setup(self, config):
        super().setup(config)
        self._load_offline_dataset()
        self._learn_steps = 0

    def _bc_minibatch(self, bs: int) -> SampleBatch:
        mb = self._offline_minibatch(bs)
        mb["_bc_weight"] = np.full(
            (), 1.0 if self._learn_steps < self.config["bc_iters"] else 0.0,
            np.float32)
        self._learn_steps += 1
        return mb

    def training_step(self) -> Dict[str, Any]:
        stats, timers = learn_offline(self, self._bc_minibatch)
        return {"num_env_steps_sampled_this_iter": 0,
                "learn_steps_total": self._learn_steps,
                **{f"learner/{k}": v for k, v in stats.items()},
                "timers": timers}
