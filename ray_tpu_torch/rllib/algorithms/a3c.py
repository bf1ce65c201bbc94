"""A3C — asynchronous advantage actor-critic.

Reference analogue: rllib/algorithms/a3c/a3c.py (training_step: async
grad requests — rollout workers compute gradients on their own samples
and the learner applies them HogWild-style as they arrive, pushing fresh
weights back to just the contributing worker; no global barrier).
Counterpart of ``ray_tpu/rllib/algorithms/a3c.py``, same decomposition:
``TorchPolicy.compute_gradients`` runs the loss and backward worker-side
and returns host grads, and the learner applies them with
``apply_gradients`` (the same clip and Adam as ``learn_on_batch``).

A3C needs remote workers: with ``num_workers=0`` ``setup`` raises
``ValueError`` as the JAX one does (use A2C). Each remote worker has one
``apply(_sample_and_grad)`` in flight; the driver waits for the first
grad, drains whatever else is ready (up to ``max_grads_per_step``),
applies each, and sends fresh weights to just the worker that sent it.
"""

from __future__ import annotations

from typing import Any, Dict

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.pg import A2CConfig, A2CPolicy


def _sample_and_grad(worker):
    """Runs inside a rollout worker via ``worker.apply``."""
    batch = worker.sample()
    grads, stats = worker.policy.compute_gradients(batch)
    return grads, stats, batch.count


class A3CConfig(A2CConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A3C)
        self._config.update({
            "num_workers": 2,
            "lr": 1e-3,
            "rollout_fragment_length": 50,
            "train_batch_size": 500,  # unused: updates are per-fragment
            # grad applications per training_step before reporting
            "max_grads_per_step": 8,
        })


class A3C(Algorithm):
    _policy_cls = A2CPolicy
    _default_config_cls = A3CConfig

    def setup(self, config):
        super().setup(config)
        if not self.workers.remote_workers:
            raise ValueError("A3C requires num_workers >= 1 "
                             "(use A2C for the synchronous variant)")
        self._grad_futs: Dict[Any, Any] = {}
        for w in self.workers.remote_workers:
            self._launch(w)

    def _launch(self, worker):
        self._grad_futs[worker.apply.remote(_sample_and_grad)] = worker

    def training_step(self) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        stats: Dict[str, float] = {}
        sampled = 0
        applied = 0
        budget = self.config.get("max_grads_per_step", 8)
        while applied < budget:
            # block for the first grad, then drain whatever else is ready
            timeout = 60.0 if applied == 0 else 0.0
            ready, _ = ray_tpu_torch.wait(list(self._grad_futs),
                                          num_returns=1, timeout=timeout)
            if not ready:
                break
            fut = ready[0]
            worker = self._grad_futs.pop(fut)
            grads, stats, count = ray_tpu_torch.get(fut)
            policy.apply_gradients(grads)
            sampled += count
            applied += 1
            # fresh weights to JUST this worker (the async part: other
            # workers keep sampling with slightly stale policies)
            worker.set_weights.remote(
                ray_tpu_torch.put(policy.get_weights()))
            self._launch(worker)
        self._timesteps_total += sampled
        return {
            "num_env_steps_sampled_this_iter": sampled,
            "num_grads_applied": applied,
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def cleanup(self):
        self._grad_futs.clear()
        super().cleanup()
