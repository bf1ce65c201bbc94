"""Algorithm + AlgorithmConfig — the RL training driver.

Reference analogue: rllib/algorithms/algorithm.py:142 (step :706,
training_step :1284) and algorithm_config.py (fluent builder). Counterpart
of ``ray_tpu/rllib/algorithm.py``: Algorithm subclasses the port's
``tune.Trainable``; the policy lives on ``config["device"]`` (``"cuda"``
unless the caller asks for ``"cpu"``).

The WorkerSet samples with remote rollout workers when ``num_workers >
0`` (actors of the port's runtime, on the CPU), else with the local
worker (a ``MultiAgentRolloutWorker`` for a multi-agent config). With
``evaluation_interval`` and ``evaluation_num_workers > 0`` a second,
greedy WorkerSet of remote workers runs the evaluation episodes.
``LocalAlgorithm`` is the base of the algorithms that run their own env
loop (R2D2, SlateQ, DT; QMIX's and MADDPG's ``_collect_joint``): its
net, target and Adam live on ``config["device"]``, its epsilon and
replay draws come from numpy in the JAX package's order.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env import MultiAgentEnv
from ray_tpu_torch.rllib.policy import host_copy, load_weights, weights_of
from ray_tpu_torch.rllib.rollout_worker import WorkerSet
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.tune.trainable import Trainable


def evaluation_result(rewards) -> Dict[str, Any]:
    """Greedy evaluation episodes' rewards -> ``evaluate``'s result."""
    return {"evaluation": {
        "episode_reward_mean": float(np.mean(rewards)),
        "episode_reward_min": float(np.min(rewards)),
        "episode_reward_max": float(np.max(rewards)),
    }}


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
        # evaluation WorkerSet: greedy policies, fresh envs (reference:
        # algorithm.py evaluation_workers + evaluation_config overrides)
        self.evaluation_workers = None
        if self.config.get("evaluation_interval"):
            n_eval = self.config.get("evaluation_num_workers", 0)
            if n_eval > 0:
                eval_cfg = dict(self.config)
                eval_cfg["explore"] = False
                eval_cfg["evaluation_interval"] = None
                self.evaluation_workers = WorkerSet(
                    eval_cfg, self._policy_cls, n_eval)
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
        n_eps = self.config.get("evaluation_num_episodes", 5)
        if self.evaluation_workers is None:
            return self.evaluate(num_episodes=n_eps)
        # current learner weights (and connector stats — normalization
        # must match training) onto the greedy eval policies
        lw = self.workers.local_worker
        ref = ray_tpu_torch.put(lw.get_weights())
        eval_workers = self.evaluation_workers.remote_workers
        ray_tpu_torch.get([w.set_weights.remote(ref) for w in eval_workers])
        cs = lw.get_connector_state()
        if any(cs.values()):
            ray_tpu_torch.get([w.set_connector_state.remote(cs)
                               for w in eval_workers])
        per = max(1, n_eps // len(eval_workers))
        rewards: list = []
        for rw in ray_tpu_torch.get([w.evaluate_episodes.remote(per)
                                     for w in eval_workers]):
            rewards.extend(rw)
        out = evaluation_result(rewards)
        out["evaluation"]["episodes_this_eval"] = len(rewards)
        return out

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _collect_rollout_metrics(self,
                                 window: int = 100) -> Dict[str, Any]:
        for m in self.workers.collect_metrics():
            self._episode_reward_window.extend(m["episode_rewards"])
        return self._window_metrics(window)

    def _window_metrics(self, window: int) -> Dict[str, Any]:
        """The last ``window`` episode rewards' summary (the window is
        cut to them)."""
        self._episode_reward_window = self._episode_reward_window[-window:]
        rw = self._episode_reward_window
        return {
            "episode_reward_mean": float(np.mean(rw)) if rw else np.nan,
            "episode_reward_max": float(np.max(rw)) if rw else np.nan,
            "episode_reward_min": float(np.min(rw)) if rw else np.nan,
            "episodes_total": len(rw),
        }

    def get_policy(self, policy_id: Optional[str] = None):
        """The local worker's policy, or ``policy_map[policy_id]`` (a
        single-agent worker's map holds its one policy as
        ``"default_policy"``)."""
        lw = self.workers.local_worker
        if policy_id is None:
            return lw.policy
        return getattr(lw, "policy_map",
                       {"default_policy": lw.policy})[policy_id]

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
        return evaluation_result(
            self.workers.local_worker.evaluate_episodes(num_episodes))

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
        if self.evaluation_workers is not None:
            self.evaluation_workers.stop()
        self.workers.stop()


class LocalAlgorithm(Algorithm):
    """Base for algorithms that own their env loop instead of sampling
    through a WorkerSet — QMIX's joint-transition collector, R2D2's
    recurrent-state collector. Provides the shared plumbing:
    counters, the epsilon schedule, periodic hard target sync, local
    episode metrics, and net/target/optimizer checkpointing.

    Counterpart of ``ray_tpu/rllib/algorithm.py``'s ``LocalAlgorithm``.
    Subclasses set, in setup(), ``self.model`` (an ``nn.Module`` on the
    device), ``self.target_model`` (its copy, or None where the method
    has no target: DT) and ``self.optimizer`` where the JAX algorithms
    set ``params``, ``target_params`` and ``opt_state``. Epsilon draws
    and replay draws stay numpy (``self._np_rng``), in JAX's order."""

    def _init_local_state(self):
        self.evaluation_workers = None  # Algorithm.step expects the attr
        self._np_rng = np.random.default_rng(self.config.get("seed"))
        self._iteration = 0
        self._timesteps_total = 0
        self._steps_since_target_sync = 0
        self._episode_reward_window: list = []
        self._t_start = time.time()

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps_total
                   / max(1, cfg["epsilon_timesteps"]))
        return cfg["initial_epsilon"] + frac * (
            cfg["final_epsilon"] - cfg["initial_epsilon"])

    def _maybe_sync_target(self, steps: int):
        self._steps_since_target_sync += steps
        if (self._steps_since_target_sync
                >= self.config["target_network_update_freq"]):
            self.target_model.load_state_dict(self.model.state_dict())
            self._steps_since_target_sync = 0

    def _collect_rollout_metrics(self, window: int = 100):
        # no workers: the algorithm's own collector fills the window
        return self._window_metrics(window)

    def _collect_joint(self, act_fn, num_steps: int) -> int:
        """Joint-transition collector shared by the cooperative
        multi-agent algorithms (QMIX, MADDPG). ``act_fn(obs_dict)``
        returns (env_action_dict, stored_action_array (n, ...)); rows
        carry the TEAM reward (mean over agents), terminal-only dones
        (TD bootstraps through time-limit truncation), and stacked
        per-agent obs. Appends one SampleBatch to ``self.replay``."""
        rows: Dict[str, list] = {k: [] for k in
                                 ("obs", "actions", "rewards", "dones",
                                  "next_obs")}
        for _ in range(num_steps):
            acts, stored = act_fn(self._obs)
            nobs, rews, terms, truncs, _ = self.env.step(acts)
            terminal = bool(terms.get("__all__"))
            done = terminal or bool(truncs.get("__all__"))
            team_r = float(np.mean([rews[a] for a in self.agent_ids]))
            rows["obs"].append(
                np.stack([self._obs[a] for a in self.agent_ids]))
            rows["actions"].append(stored)
            rows["rewards"].append(np.float32(team_r))
            rows["dones"].append(terminal)
            # on terminal, next obs may be missing for done agents:
            # fall back to the last obs (masked out by dones in the TD)
            rows["next_obs"].append(np.stack(
                [nobs.get(a, self._obs[a]) for a in self.agent_ids]))
            self._episode_reward += team_r
            if done:
                self._episode_reward_window.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nobs
        self.replay.add(SampleBatch(
            {k: np.stack(v) if np.asarray(v[0]).ndim
             else np.asarray(v) for k, v in rows.items()}))
        return num_steps

    def _eval_episodes(self, act_fn, num_episodes: int,
                       seed_base: int = 10_000,
                       on_reset=None) -> Dict[str, Any]:
        """Greedy evaluation loop shared by the self-contained
        algorithms. ``act_fn(obs)`` returns an action (or a joint
        action dict for a MultiAgentEnv); ``on_reset()`` clears
        per-episode acting state (LSTM carry, DT context window)."""
        multi = isinstance(self.env, MultiAgentEnv)
        rewards = []
        for ep in range(num_episodes):
            obs, _ = self.env.reset(seed=seed_base + ep)
            if on_reset is not None:
                on_reset()
            total, done = 0.0, False
            while not done:
                obs, rews, terms, truncs, _ = self.env.step(act_fn(obs))
                if multi:
                    total += float(np.mean(list(rews.values())))
                    done = bool(terms.get("__all__")
                                or truncs.get("__all__"))
                else:
                    total += float(rews)
                    done = bool(terms or truncs)
            rewards.append(total)
        return evaluation_result(rewards)

    def save_checkpoint(self) -> Dict[str, Any]:
        """Host copies: the online and target ``state_dict``s as numpy,
        the optimizer's ``state_dict`` and the counters."""
        return {
            "params": weights_of(self.model),
            "target_params": ({} if self.target_model is None
                              else weights_of(self.target_model)),
            "opt_state": host_copy(self.optimizer.state_dict()),
            "iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
        }

    def load_checkpoint(self, state: Dict[str, Any]):
        load_weights(self.model, state["params"])
        if self.target_model is not None:
            load_weights(self.target_model, state["target_params"])
        self.optimizer.load_state_dict(host_copy(state["opt_state"]))
        self._iteration = state.get("iteration", 0)
        self._timesteps_total = state.get("timesteps_total", 0)

    def cleanup(self):
        pass  # no worker actors to stop
