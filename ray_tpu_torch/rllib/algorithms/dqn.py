"""DQN — deep Q-learning with target network, double-Q, and
(optionally prioritized) replay.

Reference analogue: rllib/algorithms/dqn/dqn.py + dqn_torch_policy.py.
Counterpart of ``ray_tpu/rllib/algorithms/dqn.py`` with the same loss,
defaults, epsilon schedule and numpy draws:

- the target network is a second module on the policy's device, a copy
  of the online one (``update_target`` loads the online state into it;
  nothing aliases);
- epsilon-greedy draws from ``np.random.default_rng(seed)`` in the JAX
  order, so with equal Q argmaxes the actions are equal;
- the replay buffers stay numpy on the host (``replay_buffers.py``); a
  sampled batch's loss columns go to the card, ``batch_indexes`` stays
  on the host for the priority update;
- the value head of the network is unused: its zero gradients step it
  by zero, as optax does.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent sampling, in the replay buffer (adding the fragment,
drawing the train batches) and learning (``learn_on_batch``, the
priority update, the target sync).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import (TorchPolicy, stats_to_host,
                                        to_device_batch)
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)
from ray_tpu_torch.rllib.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class DQNPolicy(TorchPolicy):
    """Q-network policy: logits head doubles as Q-values; epsilon-greedy
    exploration handled host-side via ``exploration_epsilon``."""

    loss_columns = (SampleBatch.OBS, SampleBatch.NEXT_OBS,
                    SampleBatch.ACTIONS, SampleBatch.REWARDS,
                    SampleBatch.DONES, "weights")

    def __init__(self, obs_space, action_space, config):
        super().__init__(obs_space, action_space, config)
        if not self.discrete:
            raise ValueError("DQN requires a discrete action space")
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.exploration_epsilon = config.get("initial_epsilon", 1.0)
        self._np_rng = np.random.default_rng(config.get("seed"))

    def compute_actions(self, obs, explore=True):
        actions, extras = super().compute_actions(obs, explore=False)
        if explore:
            n = len(actions)
            rand = self._np_rng.random(n)
            random_actions = self._np_rng.integers(self.action_space.n,
                                                   size=n)
            actions = np.where(rand < self.exploration_epsilon,
                               random_actions, actions)
        return actions, extras

    def loss(self, batch):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        q, _ = self.model(batch[SampleBatch.OBS])
        q_sel = torch.gather(
            q, -1, batch[SampleBatch.ACTIONS].long()[..., None])[..., 0]
        with torch.no_grad():
            q_next_target, _ = self.target_model(
                batch[SampleBatch.NEXT_OBS])
            if cfg.get("double_q", True):
                q_next_online, _ = self.model(batch[SampleBatch.NEXT_OBS])
                best = torch.argmax(q_next_online, dim=-1)
            else:
                best = torch.argmax(q_next_target, dim=-1)
            q_next = torch.gather(q_next_target, -1, best[..., None])[..., 0]
            not_done = 1.0 - batch[SampleBatch.DONES].to(torch.float32)
            target = batch[SampleBatch.REWARDS] + gamma * not_done * q_next
        td_error = q_sel - target
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones_like(td_error)
        loss = torch.mean(weights * torch.square(td_error))
        abs_td = torch.abs(td_error.detach())
        return loss, {"mean_q": torch.mean(q_sel.detach()),
                      "mean_td_error": torch.mean(abs_td),
                      "td_error_max": torch.max(abs_td),
                      # per-sample |TD| (array) for prioritized replay
                      "td_errors": abs_td}

    @torch.no_grad()
    def compute_td_errors(self, batch: SampleBatch) -> float:
        """Host-visible mean |TD| for priority updates."""
        _, stats = self.loss(to_device_batch(batch, self.device,
                                             self.loss_columns))
        return stats_to_host(stats)["mean_td_error"]

    def update_target(self):
        self.target_model.load_state_dict(self.model.state_dict())


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self._config.update({
            "lr": 5e-4,
            "replay_buffer_capacity": 50_000,
            "prioritized_replay": False,
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
            "learning_starts": 1000,
            "train_batch_size": 32,
            "rollout_fragment_length": 4,
            "target_network_update_freq": 500,
            "initial_epsilon": 1.0,
            "final_epsilon": 0.02,
            "epsilon_timesteps": 10_000,
            "double_q": True,
            "num_steps_sampled_before_learning": 1000,
            "training_intensity": 1,
        })


class DQN(Algorithm):
    _policy_cls = DQNPolicy
    _default_config_cls = DQNConfig

    def setup(self, config):
        super().setup(config)
        cfg = self.config
        if cfg.get("prioritized_replay"):
            self.replay = PrioritizedReplayBuffer(
                cfg["replay_buffer_capacity"],
                alpha=cfg["prioritized_replay_alpha"],
                seed=cfg.get("seed"))
        else:
            self.replay = ReplayBuffer(cfg["replay_buffer_capacity"],
                                       seed=cfg.get("seed"))
        self._steps_since_target_sync = 0
        self.num_target_updates = 0

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps_total
                   / max(1, cfg["epsilon_timesteps"]))
        return cfg["initial_epsilon"] + frac * (
            cfg["final_epsilon"] - cfg["initial_epsilon"])

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy = self.workers.local_worker.policy
        # epsilon must reach every sampling policy copy
        self.workers.set_exploration(
            exploration_epsilon=self._epsilon())
        t0 = time.perf_counter()
        batch = synchronous_parallel_sample(self.workers)
        t1 = time.perf_counter()
        self._timesteps_total += batch.count
        self.replay.add(batch)
        replay_s = time.perf_counter() - t1
        learn_s = 0.0
        stats: Dict[str, float] = {}
        if len(self.replay) >= cfg["learning_starts"]:
            for _ in range(max(1, cfg.get("training_intensity", 1))):
                t2 = time.perf_counter()
                if cfg.get("prioritized_replay"):
                    train = self.replay.sample(
                        cfg["train_batch_size"],
                        beta=cfg["prioritized_replay_beta"])
                else:
                    train = self.replay.sample(cfg["train_batch_size"])
                t3 = time.perf_counter()
                stats = policy.learn_on_batch(train)
                if cfg.get("prioritized_replay"):
                    self.replay.update_priorities(
                        train["batch_indexes"],
                        stats.pop("td_errors"))
                replay_s += t3 - t2
                learn_s += time.perf_counter() - t3
            t4 = time.perf_counter()
            self._steps_since_target_sync += batch.count
            if (self._steps_since_target_sync
                    >= cfg["target_network_update_freq"]):
                policy.update_target()
                self.num_target_updates += 1
                self._steps_since_target_sync = 0
            self.workers.sync_weights()
            learn_s += time.perf_counter() - t4
        stats.pop("td_errors", None)
        return {
            "num_env_steps_sampled_this_iter": batch.count,
            "epsilon": policy.exploration_epsilon,
            "replay_size": len(self.replay),
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": (t1 - t0) * 1e3,
                       "replay_time_ms": replay_s * 1e3,
                       "learn_time_ms": learn_s * 1e3},
        }
