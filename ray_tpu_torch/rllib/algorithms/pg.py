"""PG (vanilla policy gradient / REINFORCE) and A2C.

Reference analogue: rllib/algorithms/pg/ and rllib/algorithms/a2c/.
Counterpart of ``ray_tpu/rllib/algorithms/pg.py``: both reuse the PPO
rollout machinery (GAE postprocessing on the host) with simpler losses:
PG uses full-return advantages, A2C the one-network actor-critic loss
without PPO clipping. Advantages are normalised by their population std
(ddof 0, as ``jnp.std``; ``torch.std`` defaults to ddof 1).

``training_step`` also reports ``timers`` (sample, postprocess, learn
host milliseconds), as PPO's does.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.postprocessing import compute_gae_for_sample_batch
from ray_tpu_torch.rllib.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def normalize(adv):
    """(adv - mean) / (population std + 1e-8)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


class PGPolicy(TorchPolicy):
    loss_columns = (SampleBatch.OBS, SampleBatch.ACTIONS,
                    SampleBatch.ADVANTAGES)

    def postprocess_trajectory(self, batch):
        # lambda=1 GAE == discounted-return advantages (REINFORCE w/
        # value baseline if vf present)
        return compute_gae_for_sample_batch(
            self, batch, self.config.get("gamma", 0.99), 1.0)

    def loss(self, batch):
        dist_inputs, _ = self.model(batch[SampleBatch.OBS])
        logp = self.dist_logp(dist_inputs, batch[SampleBatch.ACTIONS])
        pg_loss = -torch.mean(logp * normalize(
            batch[SampleBatch.ADVANTAGES]))
        return pg_loss, {"policy_loss": pg_loss,
                         "entropy": torch.mean(
                             self.dist_entropy(dist_inputs))}


class PGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PG)
        self._config.update({"lr": 4e-3, "train_batch_size": 500})


class PG(Algorithm):
    _policy_cls = PGPolicy
    _default_config_cls = PGConfig

    def training_step(self) -> Dict[str, Any]:
        lw = self.workers.local_worker
        post0 = lw.postprocess_s
        t0 = time.perf_counter()
        batch = synchronous_parallel_sample(
            self.workers, max_env_steps=self.config["train_batch_size"])
        t1 = time.perf_counter()
        self._timesteps_total += batch.count
        stats = lw.policy.learn_on_batch(batch)
        t2 = time.perf_counter()
        self.workers.sync_weights()
        post = lw.postprocess_s - post0
        return {"num_env_steps_sampled_this_iter": batch.count,
                **{f"learner/{k}": v for k, v in stats.items()},
                "timers": {"sample_time_ms": (t1 - t0 - post) * 1e3,
                           "postprocess_time_ms": post * 1e3,
                           "learn_time_ms": (t2 - t1) * 1e3}}


class A2CPolicy(TorchPolicy):
    loss_columns = (SampleBatch.OBS, SampleBatch.ACTIONS,
                    SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS)

    def postprocess_trajectory(self, batch):
        return compute_gae_for_sample_batch(
            self, batch, self.config.get("gamma", 0.99),
            self.config.get("lambda", 1.0))

    def loss(self, batch):
        cfg = self.config
        dist_inputs, vf = self.model(batch[SampleBatch.OBS])
        logp = self.dist_logp(dist_inputs, batch[SampleBatch.ACTIONS])
        pg_loss = -torch.mean(logp * normalize(
            batch[SampleBatch.ADVANTAGES]))
        vf_loss = torch.mean((vf - batch[SampleBatch.VALUE_TARGETS]) ** 2)
        entropy = torch.mean(self.dist_entropy(dist_inputs))
        total = (pg_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.01) * entropy)
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}


class A2CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A2C)
        self._config.update({
            "lr": 1e-3, "train_batch_size": 500,
            "vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
            "grad_clip": 40.0, "lambda": 1.0,
        })


class A2C(PG):
    _policy_cls = A2CPolicy
    _default_config_cls = A2CConfig
