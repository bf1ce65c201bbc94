"""Ape-X DQN — distributed prioritized experience replay.

Reference analogue: rllib/algorithms/apex_dqn/apex_dqn.py (Horgan et al.):
many rollout workers with per-worker exploration epsilons feed a replay
ACTOR (not a driver-local buffer); the learner pulls prefetched training
batches from it asynchronously and pushes priority updates back.
Counterpart of ``ray_tpu/rllib/algorithms/apex_dqn.py`` on the port's
runtime: the replay shard is an actor over the port's
``PrioritizedReplayBuffer`` (numpy, on the host), sampling futures are
kept in flight for both the rollout workers (on the CPU) and the replay
shard, the learner's policy (on ``config["device"]``) acts greedily, and
the per-worker epsilon ladder follows the paper: eps_i = base^(1 + i/(N-1)
* 7).
"""

from __future__ import annotations

from typing import Any, Dict

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.replay_buffers import PrioritizedReplayBuffer
from ray_tpu_torch.rllib.rollout_worker import kill_actors
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class _ReplayShard:
    """Actor wrapping a PrioritizedReplayBuffer (reference:
    utils/actors.py create_colocated replay actors)."""

    def __init__(self, capacity: int, alpha: float, seed=None):
        self._buf = PrioritizedReplayBuffer(capacity, alpha=alpha,
                                            seed=seed)

    def add(self, batch: SampleBatch) -> int:
        self._buf.add(batch)
        return len(self._buf)

    def sample(self, n: int, beta: float) -> SampleBatch:
        if len(self._buf) < n:
            return SampleBatch({})
        return self._buf.sample(n, beta=beta)

    def update_priorities(self, idx, priorities) -> bool:
        self._buf.update_priorities(idx, priorities)
        return True

    def size(self) -> int:
        return len(self._buf)


ReplayShard = ray_tpu_torch.remote(_ReplayShard)


def exploration_ladder(base: float, i: int, n: int) -> float:
    """Worker ``i`` of ``n``'s exploration: ``base ** (1 + 7 i / (n - 1))``
    (Horgan et al.; one worker gets ``base``)."""
    return base ** (1 + 7 * i / max(1, n - 1))


class ApexLoopMixin:
    """The Ape-X orchestration, shared by ApexDQN and ApexDDPG
    (reference: apex_dqn.py and apex_ddpg.py share ApexDQN.training_step
    the same way). Subclasses provide ``_worker_exploration(i, n)`` —
    the per-worker exploration ladder — and a policy whose learn stats
    include per-sample ``td_errors``."""

    def _worker_exploration(self, i: int, n: int) -> Dict[str, Any]:
        raise NotImplementedError

    def _apex_setup(self):
        cfg = self.config
        if not self.workers.remote_workers:
            raise ValueError(
                f"{type(self).__name__} requires num_workers >= 1")
        self.replay_actor = ReplayShard.remote(
            cfg["replay_buffer_capacity"],
            cfg["prioritized_replay_alpha"], cfg.get("seed"))
        # fixed per-worker exploration ladder (no annealing — the ladder
        # IS the exploration schedule in Ape-X)
        n = len(self.workers.remote_workers)
        for i, w in enumerate(self.workers.remote_workers):
            w.set_exploration.remote(**self._worker_exploration(i, n))
        self._sample_futs: Dict[Any, Any] = {}  # sample fut -> worker
        self._replay_futs: list = []  # prefetched train-batch futures
        self._replay_size = 0
        self._steps_since_target_sync = 0
        self._learn_count = 0
        # the ReplayShard actor replaces the driver-local buffer the
        # DQN/DDPG base setup allocated — drop the dead state
        self.replay = None

    def _launch_sample(self, worker):
        self._sample_futs[worker.sample.remote()] = worker

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy = self.workers.local_worker.policy
        stats: Dict[str, float] = {}
        sampled = 0

        for w in self.workers.remote_workers:
            if w not in self._sample_futs.values():
                self._launch_sample(w)

        # 1) drain ready rollout batches into the replay actor
        reaped = 0
        add_futs = []
        while reaped < cfg.get("max_sample_batches_per_iter", 8):
            ready, _ = ray_tpu_torch.wait(list(self._sample_futs),
                                          num_returns=1, timeout=30.0)
            if not ready:
                break
            fut = ready[0]
            worker = self._sample_futs.pop(fut)
            batch = ray_tpu_torch.get(fut)
            sampled += batch.count
            # non-blocking adds; ALL are collected after the drain loop
            # (one blocking round per step, and an add failure still
            # surfaces instead of being dropped unawaited)
            add_futs.append(self.replay_actor.add.remote(batch))
            worker.set_weights.remote(
                ray_tpu_torch.put(policy.get_weights()))
            self._launch_sample(worker)
            reaped += 1
        if add_futs:
            self._replay_size = ray_tpu_torch.get(add_futs)[-1]
        self._timesteps_total += sampled

        # 2) learner: consume prefetched replay samples, refill pipeline
        if self._replay_size >= cfg["learning_starts"]:
            beta = cfg["prioritized_replay_beta"]
            bs = cfg["train_batch_size"]
            want = cfg.get("train_intensity_per_iter", 4)
            while len(self._replay_futs) < cfg.get("replay_prefetch", 2):
                self._replay_futs.append(
                    self.replay_actor.sample.remote(bs, beta))
            for _ in range(want):
                fut = self._replay_futs.pop(0)
                self._replay_futs.append(
                    self.replay_actor.sample.remote(bs, beta))
                train = ray_tpu_torch.get(fut)
                if train.count == 0:
                    continue
                stats = policy.learn_on_batch(train)
                self._learn_count += 1
                self.replay_actor.update_priorities.remote(
                    train["batch_indexes"], stats.pop("td_errors"))
                self._steps_since_target_sync += train.count
                # hard target sync by period (DQN); DDPG/TD3 polyak
                # inside learn_on_batch and have no update_target
                if (hasattr(policy, "update_target")
                        and self._steps_since_target_sync
                        >= cfg["target_network_update_freq"]):
                    policy.update_target()
                    self._steps_since_target_sync = 0
        stats.pop("td_errors", None)
        return {
            "num_env_steps_sampled_this_iter": sampled,
            "replay_size": self._replay_size,
            "num_learner_steps": self._learn_count,
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def cleanup(self):
        self._sample_futs.clear()
        self._replay_futs.clear()
        kill_actors([self.replay_actor])
        super().cleanup()


class ApexDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ApexDQN)
        self._config.update({
            "num_workers": 2,
            "prioritized_replay": True,
            "epsilon_base": 0.4,  # per-worker ladder: base^(1+7i/(N-1))
            "replay_prefetch": 2,  # sample futures kept in flight
            "train_batch_size": 64,
            "rollout_fragment_length": 16,
            "learning_starts": 500,
            "target_network_update_freq": 1000,
            "max_sample_batches_per_iter": 8,
            "train_intensity_per_iter": 4,
        })


class ApexDQN(ApexLoopMixin, DQN):
    """DQN with a replay actor between samplers and the learner."""

    _default_config_cls = ApexDQNConfig

    def _worker_exploration(self, i, n):
        return {"exploration_epsilon": exploration_ladder(
            self.config.get("epsilon_base", 0.4), i, n)}

    def setup(self, config):
        super().setup(config)
        self._apex_setup()
        self.workers.local_worker.policy.exploration_epsilon = 0.0
