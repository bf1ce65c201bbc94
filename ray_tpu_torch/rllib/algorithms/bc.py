"""BC / MARWIL — offline imitation and advantage-weighted learning.

Reference analogue: rllib/algorithms/bc/ and rllib/algorithms/marwil/
(BC is MARWIL with beta=0). Counterpart of
``ray_tpu/rllib/algorithms/bc.py``: ``MARWILPolicy`` is a
``TorchPolicy`` (discrete or diagonal-Gaussian actions); the advantage
is the Monte Carlo return (computed once in ``MARWIL.setup``, as JAX's
row loop) minus the value, normalised with the std of ddof 0 and
clipped at ±5, and the weights exp(beta A) are clipped at 20. Trains
from JsonReader datasets: no env interaction for learning; an env may
still be configured for evaluation. ``training_step`` also reports
``timers`` (host ms drawing minibatches and learning).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.offline import (JsonReader, OfflineDataConfigMixin,
                                         draw_minibatch, learn_offline)
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class MARWILPolicy(TorchPolicy):
    loss_columns = (SampleBatch.OBS, SampleBatch.ACTIONS, "returns")

    def loss(self, batch):
        beta = self.config.get("beta", 1.0)
        dist_inputs, vf = self.model(batch[SampleBatch.OBS])
        logp = self.dist_logp(dist_inputs, batch[SampleBatch.ACTIONS])
        if beta > 0:
            # advantage = monte-carlo return - value prediction
            adv = batch["returns"] - vf
            vf_loss = torch.mean(adv ** 2)
            with torch.no_grad():
                norm_adv = torch.clamp(
                    (adv - adv.mean()) / (adv.std(correction=0) + 1e-8),
                    -5.0, 5.0)
                weights = torch.clamp(torch.exp(beta * norm_adv), max=20.0)
            imitation = -torch.mean(weights * logp)
            total = imitation + self.config.get("vf_coeff", 1.0) * vf_loss
            return total, {"imitation_loss": imitation,
                           "vf_loss": vf_loss,
                           "mean_weight": torch.mean(weights)}
        imitation = -torch.mean(logp)
        return imitation, {"imitation_loss": imitation}


class MARWILConfig(OfflineDataConfigMixin, AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self._config.update({
            "lr": 1e-4, "beta": 1.0, "vf_coeff": 1.0,
            "input_path": None, "train_batch_size": 256,
            "num_iters_per_step": 10,
        })


def monte_carlo_returns(rewards, dones, gamma: float) -> np.ndarray:
    """Per-row discounted returns, restarting after each done row (the
    JAX package's row loop in ``MARWIL.setup``)."""
    returns = np.zeros(len(rewards), np.float32)
    acc = 0.0
    rews = np.asarray(rewards, np.float32)
    dones = np.asarray(dones, bool)
    for t in range(len(rews) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = rews[t] + gamma * acc
        returns[t] = acc
    return returns


class MARWIL(Algorithm):
    _policy_cls = MARWILPolicy
    _default_config_cls = MARWILConfig

    def setup(self, config):
        super().setup(config)
        path = self.config.get("input_path")
        if not path:
            raise ValueError("MARWIL/BC needs config['input_path']")
        self._data = JsonReader(path).read_all()
        # per-row monte-carlo returns for the vf baseline
        self._data["returns"] = monte_carlo_returns(
            self._data[SampleBatch.REWARDS], self._data[SampleBatch.DONES],
            self.config.get("gamma", 0.99))
        self._rng = np.random.default_rng(self.config.get("seed"))

    def training_step(self) -> Dict[str, Any]:
        stats, timers = learn_offline(
            self, lambda bs: draw_minibatch(self._data, self._rng, bs))
        return {"num_env_steps_sampled_this_iter": 0,
                **{f"learner/{k}": v for k, v in stats.items()},
                "timers": timers}


class BCConfig(MARWILConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self._config["beta"] = 0.0  # pure imitation


class BC(MARWIL):
    _default_config_cls = BCConfig
