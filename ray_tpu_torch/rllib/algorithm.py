"""Algorithm + AlgorithmConfig — the RL training driver.

Reference analogue: rllib/algorithms/algorithm.py:142 (step :706,
training_step :1284) and algorithm_config.py (fluent builder). Counterpart
of ``ray_tpu/rllib/algorithm.py``: Algorithm subclasses the port's
``tune.Trainable``; the policy lives on ``config["device"]`` (``"cuda"``
unless the caller asks for ``"cpu"``).

The port samples with the local worker only: remote rollout workers and
evaluation workers need the runtime (ROADMAP.md Queue A, A1) and raise.
``LocalAlgorithm`` (QMIX's and R2D2's own env loops) comes with those
algorithms.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.rollout_worker import (REMOTE_WORKERS_NEED_RUNTIME,
                                                WorkerSet)
from ray_tpu_torch.tune.trainable import Trainable


class AlgorithmConfig:
    """Fluent config builder (reference: algorithm_config.py)."""

    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class
        self._config: Dict[str, Any] = {
            "env": None,
            "env_config": {},
            "num_workers": 0,
            "num_envs_per_worker": 1,
            "num_cpus_per_worker": 1,
            "rollout_fragment_length": 200,
            "train_batch_size": 4000,
            "gamma": 0.99,
            "lr": 5e-5,
            "grad_clip": None,
            "seed": 0,
            "explore": True,
            "model": {},
            # where the policy runs: "cuda" unless the caller asks for
            # "cpu"
            "device": "cuda",
            "min_sample_timesteps_per_iteration": 0,
            # multi-agent (reference: algorithm_config.py multi_agent())
            "multiagent": {},
            # evaluation workers (reference: .evaluation())
            "evaluation_interval": None,
            "evaluation_num_episodes": 5,
            "evaluation_num_workers": 0,
        }

    # fluent sections, mirroring the reference's grouping
    def environment(self, env=None, *, env_config=None, **kw):
        if env is not None:
            self._config["env"] = env
        if env_config is not None:
            self._config["env_config"] = env_config
        self._config.update(kw)
        return self

    def rollouts(self, **kw):
        self._config.update(kw)
        return self

    def training(self, **kw):
        self._config.update(kw)
        return self

    def resources(self, **kw):
        self._config.update(kw)
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None,
                    policies_to_train=None, **kw):
        ma = self._config.setdefault("multiagent", {})
        if policies is not None:
            ma["policies"] = policies
        if policy_mapping_fn is not None:
            ma["policy_mapping_fn"] = policy_mapping_fn
        if policies_to_train is not None:
            ma["policies_to_train"] = policies_to_train
        ma.update(kw)
        return self

    def evaluation(self, **kw):
        self._config.update(kw)
        return self

    def debugging(self, *, seed=None, **kw):
        if seed is not None:
            self._config["seed"] = seed
        self._config.update(kw)
        return self

    def framework(self, *_a, **_kw):  # always torch here
        return self

    def update_from_dict(self, d: Dict[str, Any]):
        self._config.update(d)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._config)

    def __getitem__(self, k):
        return self._config[k]

    def get(self, k, default=None):
        return self._config.get(k, default)

    def build(self, env=None) -> "Algorithm":
        if env is not None:
            self._config["env"] = env
        assert self.algo_class is not None, "no algo_class bound"
        return self.algo_class(config=self.to_dict())


class Algorithm(Trainable):
    """Trainable RL algorithm: owns a WorkerSet, steps = sample + learn."""

    _policy_cls = None  # set by subclasses
    _default_config_cls = AlgorithmConfig

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return cls._default_config_cls(cls)

    def setup(self, config: Dict[str, Any]):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = base
        if self.config.get("env") is None:
            raise ValueError("config['env'] is required")
        self.workers = WorkerSet(self.config, self._policy_cls,
                                 self.config.get("num_workers", 0))
        # evaluation WorkerSet (reference: algorithm.py
        # evaluation_workers): remote workers, so it waits for the runtime
        if (self.config.get("evaluation_interval")
                and self.config.get("evaluation_num_workers", 0) > 0):
            raise NotImplementedError(
                "evaluation workers: " + REMOTE_WORKERS_NEED_RUNTIME)
        self._iteration = 0
        self._timesteps_total = 0
        self._episode_reward_window: list = []
        self._t_start = time.time()

    # ---- Trainable API ----

    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        results = self.training_step()
        self._iteration += 1
        metrics = self._collect_rollout_metrics()
        sps = results.get("num_env_steps_sampled_this_iter", 0) / max(
            1e-9, time.time() - t0)
        out = {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "num_env_steps_sampled": self._timesteps_total,
            "env_steps_per_sec": sps,
            "time_total_s": time.time() - self._t_start,
            **metrics,
            **results,
        }
        interval = self.config.get("evaluation_interval")
        if interval and self._iteration % interval == 0:
            out.update(self._run_evaluation())
        return out

    def _run_evaluation(self) -> Dict[str, Any]:
        return self.evaluate(
            num_episodes=self.config.get("evaluation_num_episodes", 5))

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _collect_rollout_metrics(self,
                                 window: int = 100) -> Dict[str, Any]:
        for m in self.workers.collect_metrics():
            self._episode_reward_window.extend(m["episode_rewards"])
        self._episode_reward_window = self._episode_reward_window[-window:]
        rw = self._episode_reward_window
        return {
            "episode_reward_mean": float(np.mean(rw)) if rw else np.nan,
            "episode_reward_max": float(np.max(rw)) if rw else np.nan,
            "episode_reward_min": float(np.min(rw)) if rw else np.nan,
            "episodes_total": len(rw),
        }

    def get_policy(self, policy_id: Optional[str] = None):
        if policy_id not in (None, "default_policy"):
            raise KeyError(f"no policy {policy_id!r}: the port's worker "
                           "holds one policy, 'default_policy'")
        return self.workers.local_worker.policy

    def compute_single_action(self, obs, explore: bool = False,
                              policy_id: Optional[str] = None):
        lw = self.workers.local_worker
        obs = np.asarray(obs)[None]
        conns = getattr(lw, "obs_connectors", None)
        if conns is not None and conns.connectors:
            # inference must see the same preprocessing as training
            obs = conns.transform(obs)
        actions, _ = self.get_policy(policy_id).compute_actions(
            obs, explore=explore)
        act_conns = getattr(lw, "action_connectors", None)
        if act_conns is not None and act_conns.connectors:
            actions = act_conns.transform(actions)
        return actions[0]

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        """Greedy evaluation rollouts — delegates to the local worker's
        evaluate_episodes so single/multi-agent and connector handling
        live in ONE place (rollout_worker.py)."""
        rewards = self.workers.local_worker.evaluate_episodes(num_episodes)
        return {"evaluation": {
            "episode_reward_mean": float(np.mean(rewards)),
            "episode_reward_min": float(np.min(rewards)),
            "episode_reward_max": float(np.max(rewards)),
        }}

    # ---- checkpointing (Trainable hooks) ----

    @staticmethod
    def _pickle_safe(v):
        """Drop callables at ANY depth (policy_mapping_fn lambdas inside
        config['multiagent'], connector instances, env builders) so the
        checkpoint always pickles."""
        if callable(v):
            return None
        if isinstance(v, dict):
            return {k: Algorithm._pickle_safe(x) for k, x in v.items()
                    if not callable(x)}
        if isinstance(v, (list, tuple)):
            return type(v)(Algorithm._pickle_safe(x) for x in v
                           if not callable(x))
        return v

    def save_checkpoint(self) -> Dict[str, Any]:
        lw = self.workers.local_worker
        return {
            "policy_state": lw.get_policy_state(),
            "connector_state": (lw.get_connector_state()
                                if hasattr(lw, "get_connector_state")
                                else None),
            "iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "config": self._pickle_safe(self.config),
        }

    def load_checkpoint(self, state: Dict[str, Any]):
        lw = self.workers.local_worker
        lw.set_policy_state(state["policy_state"])
        if state.get("connector_state") and \
                hasattr(lw, "set_connector_state"):
            lw.set_connector_state(state["connector_state"])
        self._iteration = state.get("iteration", 0)
        self._timesteps_total = state.get("timesteps_total", 0)
        self.workers.sync_weights()

    def cleanup(self):
        self.workers.stop()
