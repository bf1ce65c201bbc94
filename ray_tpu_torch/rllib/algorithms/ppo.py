"""PPO — proximal policy optimization with a clipped-surrogate loss.

Reference analogue: rllib/algorithms/ppo/ppo.py:286 (training_step :311)
and ppo_torch_policy.py (loss). Counterpart of
``ray_tpu/rllib/algorithms/ppo.py`` with the same loss, defaults and
minibatch order (``np.random.default_rng(seed + iteration)`` through
``SampleBatch.minibatches``): every minibatch is one
loss -> backward -> clip -> Adam step on the policy's device. With a
multi-agent config the worker's ``MultiAgentBatch`` is trained policy by
policy (``policies_to_train``, or every policy; empty batches skipped),
each with its own minibatch order from ``seed + iteration``, as JAX's.

``training_step`` also reports ``timers``: the host seconds of one
iteration spent sampling (env steps, connectors, the policy's forwards),
postprocessing (cutting fragments, GAE with its bootstrap values) and
learning, as milliseconds.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rllib.sample_batch import MultiAgentBatch, SampleBatch


class PPOPolicy(TorchPolicy):
    loss_columns = (SampleBatch.OBS, SampleBatch.ACTIONS,
                    SampleBatch.ACTION_LOGP, SampleBatch.ADVANTAGES,
                    SampleBatch.VALUE_TARGETS, "_valid_mask")

    def postprocess_trajectory(self, batch):
        from ray_tpu_torch.rllib.postprocessing import \
            compute_gae_for_sample_batch
        return compute_gae_for_sample_batch(
            self, batch, self.config.get("gamma", 0.99),
            self.config.get("lambda", 0.95))

    def loss(self, batch):
        cfg = self.config
        # rows added by SampleBatch.pad_to carry zero weight
        mask = batch.get("_valid_mask")
        if mask is None:
            mask = torch.ones_like(batch[SampleBatch.ACTION_LOGP])
        denom = torch.clamp(mask.sum(), min=1.0)

        def mmean(x):
            return torch.sum(x * mask) / denom

        dist_inputs, vf = self.model(batch[SampleBatch.OBS])
        logp = self.dist_logp(dist_inputs, batch[SampleBatch.ACTIONS])
        old_logp = batch[SampleBatch.ACTION_LOGP]
        adv = batch[SampleBatch.ADVANTAGES]
        adv_mean = mmean(adv)
        adv_std = torch.sqrt(torch.clamp(mmean((adv - adv_mean) ** 2),
                                         min=0.0))
        adv = (adv - adv_mean) / (adv_std + 1e-8)
        ratio = torch.exp(logp - old_logp)
        clip = cfg.get("clip_param", 0.3)
        surrogate = torch.minimum(
            adv * ratio,
            adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip))
        # value clipping: squared error clamped at vf_clip_param, as the
        # reference torch policy does (ppo_torch_policy.py)
        vf_clip = cfg.get("vf_clip_param", 10.0)
        targets = batch[SampleBatch.VALUE_TARGETS]
        vf_err = torch.clamp((vf - targets) ** 2, 0.0, vf_clip)
        entropy = self.dist_entropy(dist_inputs)
        # approximate KL against the behavior logp for reporting/early stop
        kl = mmean(old_logp - logp)
        total = mmean(
            -surrogate
            + cfg.get("vf_loss_coeff", 1.0) * vf_err
            - cfg.get("entropy_coeff", 0.0) * entropy)
        return total, {
            "policy_loss": -mmean(surrogate),
            "vf_loss": mmean(vf_err),
            "entropy": mmean(entropy),
            "kl": kl,
        }


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self._config.update({
            "lr": 3e-4,
            "lambda": 0.95,
            "clip_param": 0.3,
            "vf_clip_param": 10.0,
            "vf_loss_coeff": 1.0,
            "entropy_coeff": 0.0,
            "num_sgd_iter": 10,
            "sgd_minibatch_size": 128,
            "train_batch_size": 4000,
            "grad_clip": None,
            "kl_target": 0.01,
        })


class PPO(Algorithm):
    _policy_cls = PPOPolicy
    _default_config_cls = PPOConfig

    def _sgd_epochs(self, policy, batch) -> Dict[str, float]:
        cfg = self.config
        rng = np.random.default_rng(cfg.get("seed", 0) + self._iteration)
        mb = cfg["sgd_minibatch_size"]
        if batch.count < mb:
            # padded rows carry _valid_mask=0 and are ignored by the loss
            batch = batch.pad_to(mb)
        stats: Dict[str, float] = {}
        for _ in range(cfg["num_sgd_iter"]):
            for minibatch in batch.minibatches(mb, rng=rng):
                stats = policy.learn_on_batch(minibatch)
        return stats

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        lw = self.workers.local_worker
        post0 = lw.postprocess_s
        t0 = time.perf_counter()
        # 1. sample (reference: ppo.py:318 synchronous_parallel_sample)
        train_batch = synchronous_parallel_sample(
            self.workers, max_env_steps=cfg["train_batch_size"])
        t1 = time.perf_counter()
        sampled_steps = train_batch.count
        self._timesteps_total += sampled_steps
        # 2. minibatch SGD epochs on the local (learner) policy/policies
        if isinstance(train_batch, MultiAgentBatch):
            to_train = lw.policies_to_train or list(lw.policy_map)
            learner_info: Dict[str, Dict[str, float]] = {}
            for pid in to_train:
                b = train_batch.policy_batches.get(pid)
                if b is None or b.count == 0:
                    continue
                learner_info[pid] = self._sgd_epochs(lw.policy_map[pid], b)
            flat = {f"learner/{pid}/{k}": v
                    for pid, st in learner_info.items()
                    for k, v in st.items()}
        else:
            stats = self._sgd_epochs(lw.policy, train_batch)
            learner_info = {"default_policy": stats}
            flat = {f"learner/{k}": v for k, v in stats.items()}
        t2 = time.perf_counter()
        # 3. broadcast new weights to rollout workers (ppo.py:345)
        self.workers.sync_weights()
        post = lw.postprocess_s - post0
        return {
            "num_env_steps_sampled_this_iter": sampled_steps,
            "info": {"learner": learner_info},
            **flat,
            "timers": {"sample_time_ms": (t1 - t0 - post) * 1e3,
                       "postprocess_time_ms": post * 1e3,
                       "learn_time_ms": (t2 - t1) * 1e3},
        }
