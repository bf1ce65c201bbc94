"""Advantage estimation (GAE) — reference: rllib/evaluation/postprocessing.py
compute_advantages/compute_gae_for_sample_batch.

Host-side numpy implementation operating per-trajectory fragment; the
learner-side losses consume the resulting ADVANTAGES/VALUE_TARGETS columns.
The port's copy of ``ray_tpu/rllib/postprocessing.py`` (no JAX), kept
whole.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.sample_batch import (
    ADVANTAGES, DONES, REWARDS, SampleBatch, TRUNCATEDS, VALUE_TARGETS,
    VF_PREDS)


def compute_advantages(batch: SampleBatch, last_value: float,
                       gamma: float = 0.99, lambda_: float = 1.0,
                       use_gae: bool = True,
                       standardize: bool = False) -> SampleBatch:
    """Append GAE advantages + value targets to a trajectory fragment.

    ``last_value`` bootstraps the value beyond the fragment (0 if the
    episode terminated).
    """
    rewards = np.asarray(batch[REWARDS], np.float32)
    n = len(rewards)
    if use_gae:
        vf = np.asarray(batch[VF_PREDS], np.float32)
        vf_next = np.concatenate([vf[1:], [np.float32(last_value)]])
        deltas = rewards + gamma * vf_next - vf
        adv = np.zeros(n, np.float32)
        acc = 0.0
        for t in range(n - 1, -1, -1):
            acc = deltas[t] + gamma * lambda_ * acc
            adv[t] = acc
        batch[ADVANTAGES] = adv
        batch[VALUE_TARGETS] = adv + vf
    else:
        returns = np.zeros(n, np.float32)
        acc = float(last_value)
        for t in range(n - 1, -1, -1):
            acc = rewards[t] + gamma * acc
            returns[t] = acc
        batch[ADVANTAGES] = returns
        batch[VALUE_TARGETS] = returns
    if standardize:
        a = batch[ADVANTAGES]
        batch[ADVANTAGES] = (a - a.mean()) / max(1e-4, a.std())
    return batch


def compute_gae_for_sample_batch(policy, batch: SampleBatch,
                                 gamma: float, lambda_: float
                                 ) -> SampleBatch:
    """Bootstrap from the policy's value function unless the fragment ended
    in a true terminal (reference: postprocessing.py:168)."""
    terminated = bool(batch[DONES][-1]) and not bool(
        batch.get(TRUNCATEDS, np.zeros(len(batch)))[-1])
    if terminated:
        last_value = 0.0
    else:
        last_value = float(policy.value(batch[SampleBatch.NEXT_OBS][-1:])[0])
    return compute_advantages(batch, last_value, gamma, lambda_)
