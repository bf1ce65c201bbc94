"""Contextual bandits — LinUCB and linear Thompson sampling.

Reference analogue: rllib/algorithms/bandit/ (bandit.py,
bandit_torch_policy.py backed by models/torch/modules/bandits — exact
ridge-regression per arm, no SGD) plus the example envs in
rllib/examples/env/bandit_envs_discrete.py. The per-arm sufficient
statistics (A = I + Σ x xᵀ, b = Σ r x) update exactly per observed
reward; exploration is the UCB bonus or a posterior sample. Host-side
numpy by design: these are tiny dense solves where an accelerator
round-trip would dominate.

The port's copy of ``ray_tpu/rllib/algorithms/bandit.py`` (numpy only),
kept whole: it runs through the port's WorkerSet and
``synchronous_parallel_sample`` and draws its contexts, noise and
posterior samples with the same numpy calls in the same order. It has
nothing to put on the card, so ``config["device"]`` is not read.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import Box, Discrete
from ray_tpu_torch.rllib.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class LinearDiscreteBanditEnv:
    """K-arm contextual bandit with hidden linear payoffs: context
    x ~ N(0, I_d), reward(a) = x·w_a + noise; 1-step episodes
    (reference: examples/env/bandit_envs_discrete.py)."""

    def __init__(self, config: Dict[str, Any] = None):
        config = config or {}
        d = config.get("feature_dim", 8)
        k = config.get("num_arms", 4)
        rng = np.random.default_rng(config.get("payoff_seed", 7))
        self._w = rng.normal(size=(k, d)).astype(np.float32)
        self._noise = config.get("noise_std", 0.1)
        self._rng = np.random.default_rng(config.get("seed"))
        self.observation_space = Box(-np.inf, np.inf, (d,))
        self.action_space = Discrete(k)
        self._x = None

    def best_expected_reward(self, x) -> float:
        return float(np.max(self._w @ x))

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._x = self._rng.normal(
            size=self._w.shape[1]).astype(np.float32)
        return self._x, {}

    def step(self, action):
        r = float(self._w[int(action)] @ self._x
                  + self._rng.normal(0, self._noise))
        obs = self._x
        self._x = None
        return obs, r, True, False, {}


class LinUCBPolicy:
    """Per-arm ridge regression + UCB bonus (Li et al. 2010)."""

    def __init__(self, obs_space, action_space, config: Dict[str, Any]):
        assert isinstance(action_space, Discrete), \
            "bandit policies need a Discrete arm space"
        self.observation_space = obs_space
        self.action_space = action_space
        self.config = config
        self.d = int(np.prod(obs_space.shape))
        self.k = action_space.n
        lam = config.get("ridge_lambda", 1.0)
        self.A = np.stack([np.eye(self.d, dtype=np.float64) * lam
                           for _ in range(self.k)])
        self.b = np.zeros((self.k, self.d), np.float64)
        self.alpha = config.get("ucb_alpha", 1.0)
        self._rng = np.random.default_rng(config.get("seed"))
        self.global_timestep = 0

    def _posterior(self):
        """Per-arm (A⁻¹, θ̂ = A⁻¹b) — shared by UCB and TS scoring."""
        inv = np.linalg.inv(self.A)            # (K, d, d)
        theta = np.einsum("kde,ke->kd", inv, self.b)
        return inv, theta

    # scoring, overridden by Thompson sampling
    def _scores(self, x: np.ndarray, explore: bool) -> np.ndarray:
        """x: (B, d) → (B, K) acquisition scores."""
        inv, theta = self._posterior()
        mean = x @ theta.T                     # (B, K)
        if not explore:
            return mean
        var = np.einsum("bd,kde,be->bk", x, inv, x)
        return mean + self.alpha * np.sqrt(np.maximum(var, 0.0))

    def compute_actions(self, obs, explore=True):
        x = np.asarray(obs, np.float64).reshape(len(obs), -1)
        actions = np.argmax(self._scores(x, explore), axis=-1)
        n = len(actions)
        extras = {
            SampleBatch.ACTION_LOGP: np.zeros(n, np.float32),
            SampleBatch.ACTION_DIST_INPUTS: np.zeros((n, self.k),
                                                     np.float32),
            SampleBatch.VF_PREDS: np.zeros(n, np.float32),
        }
        return actions.astype(np.int64), extras

    def postprocess_trajectory(self, batch):
        return batch

    def learn_on_batch(self, batch) -> Dict[str, float]:
        x = np.asarray(batch[SampleBatch.OBS],
                       np.float64).reshape(batch.count, -1)
        acts = np.asarray(batch[SampleBatch.ACTIONS], np.int64)
        rews = np.asarray(batch[SampleBatch.REWARDS], np.float64)
        for xi, ai, ri in zip(x, acts, rews):
            self.A[ai] += np.outer(xi, xi)
            self.b[ai] += ri * xi
        self.global_timestep += batch.count
        return {"mean_reward": float(rews.mean()),
                "arms_pulled": float(len(np.unique(acts)))}

    def value(self, obs):
        return np.zeros(len(obs), np.float32)

    def get_weights(self):
        return {"A": self.A.copy(), "b": self.b.copy()}

    def set_weights(self, weights):
        self.A = np.asarray(weights["A"], np.float64).copy()
        self.b = np.asarray(weights["b"], np.float64).copy()

    def get_state(self):
        return {"weights": self.get_weights(),
                "global_timestep": self.global_timestep}

    def set_state(self, state):
        self.set_weights(state["weights"])
        self.global_timestep = state.get("global_timestep", 0)


class LinTSPolicy(LinUCBPolicy):
    """Linear Thompson sampling: score by a posterior draw
    θ̃_k ~ N(A⁻¹b, v²A⁻¹) (reference: bandit_torch_model.py
    DiscreteLinearModelThompsonSampling)."""

    def _scores(self, x, explore):
        inv, theta = self._posterior()
        if not explore:
            return x @ theta.T
        v = self.config.get("ts_v", 0.5)
        draws = np.stack([
            self._rng.multivariate_normal(theta[k], v * v * inv[k])
            for k in range(self.k)])
        return x @ draws.T


class BanditLinUCBConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BanditLinUCB)
        self._config.update({
            "env": LinearDiscreteBanditEnv,
            "rollout_fragment_length": 32,
            "train_batch_size": 32,
            "ucb_alpha": 1.0,
            "ridge_lambda": 1.0,
        })


class BanditLinTSConfig(BanditLinUCBConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BanditLinTS)
        self._config.update({"ts_v": 0.5})


class BanditLinUCB(Algorithm):
    _policy_cls = LinUCBPolicy
    _default_config_cls = BanditLinUCBConfig

    def training_step(self) -> Dict[str, Any]:
        batch = synchronous_parallel_sample(
            self.workers, max_env_steps=self.config["train_batch_size"])
        self._timesteps_total += batch.count
        stats = self.workers.local_worker.policy.learn_on_batch(batch)
        self.workers.sync_weights()
        return {"num_env_steps_sampled_this_iter": batch.count,
                **{f"learner/{k}": v for k, v in stats.items()}}


class BanditLinTS(BanditLinUCB):
    _policy_cls = LinTSPolicy
    _default_config_cls = BanditLinTSConfig
