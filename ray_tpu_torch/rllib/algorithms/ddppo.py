"""DDPPO — decentralized distributed PPO.

Reference analogue: rllib/algorithms/ddppo/ddppo.py: rollout workers
compute AND apply the SGD updates locally (torch DDP allreduce between
workers); the driver only coordinates — sample batches and gradients
never ship through it. Counterpart of ``ray_tpu/rllib/algorithms/
ddppo.py``: each remote worker runs the PPO minibatch epochs on its own
samples (``worker.apply(_local_sgd)``, on its CPU policy), then the
driver sets the parameter average of the workers' weights on the
learner's policy and broadcasts it (``sync_weights``) — local-SGD
semantics (equal to a gradient allreduce when ``num_sgd_iter=1``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig


def _local_sgd(worker, num_sgd_iter, minibatch_size, seed):
    """Sample + full PPO minibatch-SGD epochs, all inside the worker;
    minibatches drawn by ``np.random.default_rng(seed)``."""
    batch = worker.sample()
    policy = worker.policy
    if batch.count < minibatch_size:
        batch = batch.pad_to(minibatch_size)
    rng = np.random.default_rng(seed)
    stats: Dict[str, float] = {}
    for _ in range(num_sgd_iter):
        for mb in batch.minibatches(minibatch_size, rng=rng):
            stats = policy.learn_on_batch(mb)
    return policy.get_weights(), stats, batch.count


def average_weights(weights):
    """The elementwise mean of weight trees (dicts of arrays, nested for
    a multi-agent worker)."""
    if isinstance(weights[0], dict):
        return {k: average_weights([w[k] for w in weights])
                for k in weights[0]}
    return np.mean(np.stack(weights), axis=0)


class DDPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPPO)
        self._config.update({
            "num_workers": 2,
            "num_sgd_iter": 5,
            "sgd_minibatch_size": 64,
            "rollout_fragment_length": 100,
        })


class DDPPO(PPO):
    _default_config_cls = DDPPOConfig

    def setup(self, config):
        super().setup(config)
        if not self.workers.remote_workers:
            raise ValueError("DDPPO requires num_workers >= 1 "
                             "(its point is decentralized learning)")

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        workers = self.workers.remote_workers
        seed = (cfg.get("seed") or 0) * 100_003 + self._iteration
        outs = ray_tpu_torch.get([
            w.apply.remote(_local_sgd, cfg["num_sgd_iter"],
                           cfg["sgd_minibatch_size"], seed + i)
            for i, w in enumerate(workers)])
        # average scalar stats across replicas so one diverging worker
        # (e.g. NaN loss) is visible in the report
        stats = {k: float(np.mean([o[1][k] for o in outs]))
                 for k in outs[0][1]}
        sampled = sum(o[2] for o in outs)
        self._timesteps_total += sampled
        # the "allreduce": parameter average across workers
        avg = average_weights([o[0] for o in outs])
        self.workers.local_worker.policy.set_weights(avg)
        self.workers.sync_weights()
        return {
            "num_env_steps_sampled_this_iter": sampled,
            "num_ddppo_workers": len(workers),
            **{f"learner/{k}": v for k, v in stats.items()},
        }
