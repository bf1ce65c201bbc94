"""ES and ARS — evolution strategies (Salimans et al. 2017) and augmented
random search (Mania et al. 2018).

Reference analogue: rllib/algorithms/es/ (es.py, optimizers.py,
utils.py) and rllib/algorithms/ars/. Counterpart of
``ray_tpu/rllib/algorithms/es.py`` on the port's runtime: one shared
noise table put in the object store ONCE, antithetic perturbation
rollouts in remote ``PerturbationWorker`` actors (each a CPU copy of the
model: argmax actions for a discrete space, the clipped mean for a
continuous one), the gradient estimate on the driver (ES: centered-rank
weights; ARS: the top-k directions scaled by the elite set's reward
std), L2 decay, then Adam on the flat parameter vector (``adam_update``,
optax's ``adam`` law). Evaluation and checkpoints ride the normal
Algorithm path: the flat ``theta`` is loaded into the local policy's
model after every step.

``theta`` is laid out as the JAX package's ``ravel_pytree`` of the flax
params (``models.flat_params``: flax's keys in sorted order, Dense
kernels [in, out]), so a noise slice ``noise[idx:idx + dim]`` perturbs
the same weights on both sides.

As in the JAX package, the algorithm's gradient WorkerSet has no remote
workers (``num_workers`` is forced to 0 for it); ``num_workers`` counts
the perturbation workers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import Discrete, make_env
from ray_tpu_torch.rllib.models import (flat_params, load_flat_params,
                                        make_model)
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.rollout_worker import kill_actors, set_torch_threads


def create_shared_noise(size: int, seed: int = 123) -> np.ndarray:
    """One float32 noise pool shared by every worker (reference:
    es.py:43 create_shared_noise — 250M floats; default here is smaller
    and configurable via ``noise_table_size``)."""
    return np.random.default_rng(seed).standard_normal(
        size, dtype=np.float32)


def compute_centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: values → ranks in [-0.5, 0.5] (reference:
    es/utils.py compute_centered_ranks)."""
    ranks = np.empty(x.size, dtype=np.float32)
    ranks[x.ravel().argsort()] = np.arange(x.size, dtype=np.float32)
    return (ranks / max(1, x.size - 1) - 0.5).reshape(x.shape)


def adam_init(theta: np.ndarray) -> Dict[str, Any]:
    return {"count": 0, "mu": np.zeros_like(theta),
            "nu": np.zeros_like(theta)}


def adam_update(theta: np.ndarray, grad: np.ndarray, state: Dict[str, Any],
                lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> Tuple[np.ndarray, Dict[str, Any]]:
    """One step of ``optax.adam(lr)`` minimizing along ``grad``, in f32
    on the host: the moments, the bias corrections by the step count,
    ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr``. Returns the new
    theta and state."""
    f32 = np.float32
    g = np.asarray(grad, f32)
    mu = (f32(1 - b1) * g + f32(b1) * state["mu"]).astype(f32)
    nu = (f32(1 - b2) * (g * g) + f32(b2) * state["nu"]).astype(f32)
    count = state["count"] + 1
    mu_hat = mu / (f32(1) - f32(b1) ** f32(count))
    nu_hat = nu / (f32(1) - f32(b2) ** f32(count))
    update = f32(-lr) * (mu_hat / (np.sqrt(nu_hat) + f32(eps)))
    theta = (np.asarray(theta, f32) + update).astype(f32)
    return theta, {"count": count, "mu": mu, "nu": nu}


class _PerturbationWorker:
    """Holds env + shared noise + a CPU copy of the model; evaluates
    theta ± sigma·eps pairs."""

    def __init__(self, config: Dict[str, Any], noise: np.ndarray,
                 seed: int, num_threads: int = 1):
        self.num_threads = num_threads
        set_torch_threads(num_threads)
        self.config = config
        self.noise = noise
        self.env = make_env(config["env"], config.get("env_config"))
        self.model = make_model(self.env.observation_space,
                                self.env.action_space,
                                config.get("model"))
        self.discrete = isinstance(self.env.action_space, Discrete)
        self.dim = sum(p.numel() for p in self.model.parameters())
        self._rng = np.random.default_rng(seed)

    @torch.no_grad()
    def _act(self, obs):
        dist_inputs, _ = self.model(
            torch.as_tensor(np.asarray(obs, np.float32))[None])
        if self.discrete:
            return int(torch.argmax(dist_inputs[0]))
        mean = torch.chunk(dist_inputs[0], 2, dim=-1)[0].numpy()
        sp = self.env.action_space
        return np.clip(mean, sp.low, sp.high).astype(np.float32)

    def rollout(self, theta: np.ndarray,
                limit: int) -> Tuple[float, int]:
        load_flat_params(self.model, theta)
        obs, _ = self.env.reset(seed=int(self._rng.integers(2 ** 31)))
        total, steps = 0.0, 0
        while steps < limit:
            obs, r, term, trunc, _ = self.env.step(self._act(obs))
            total += float(r)
            steps += 1
            if term or trunc:
                break
        return total, steps

    def do_rollouts(self, theta: np.ndarray, num_pairs: int,
                    sigma: float, limit: int) -> List[Tuple]:
        """Antithetic pairs: [(noise_idx, r_plus, r_minus, steps)]."""
        set_torch_threads(self.num_threads)
        theta = np.asarray(theta, np.float32)
        out = []
        for _ in range(num_pairs):
            idx = int(self._rng.integers(0, self.noise.size - self.dim))
            eps = self.noise[idx:idx + self.dim]
            rp, sp = self.rollout(theta + sigma * eps, limit)
            rn, sn = self.rollout(theta - sigma * eps, limit)
            out.append((idx, rp, rn, sp + sn))
        return out

    def ping(self) -> str:
        return "ok"


PerturbationWorker = ray_tpu_torch.remote(_PerturbationWorker)


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ES)
        self._config.update({
            "num_workers": 2,
            "sigma": 0.05,          # perturbation std (es.py noise_stdev)
            "stepsize": 0.02,       # Adam lr on theta
            "rollouts_per_worker": 10,  # antithetic PAIRS per worker/iter
            "l2_coeff": 0.005,
            "episode_horizon": 500,
            "noise_table_size": 4_000_000,
            "noise_seed": 123,
        })


class ES(Algorithm):
    _policy_cls = TorchPolicy  # inference/checkpoint only; never .loss()
    _default_config_cls = ESConfig

    def setup(self, config):
        base = dict(config or {})
        self._es_num_workers = base.get(
            "num_workers", self._default_config_cls()["num_workers"])
        base["num_workers"] = 0  # no gradient rollout actors
        super().setup(base)
        cfg = self.config
        self.theta = flat_params(self.workers.local_worker.policy.model)
        self.dim = self.theta.size
        if cfg["noise_table_size"] <= self.dim:
            raise ValueError(
                f"noise_table_size ({cfg['noise_table_size']}) must "
                f"exceed the flat parameter count ({self.dim}); raise "
                "it or shrink the model")
        self.noise = create_shared_noise(cfg["noise_table_size"],
                                         cfg.get("noise_seed", 123))
        noise_ref = ray_tpu_torch.put(self.noise)
        seed = cfg.get("seed") or 0
        self._es_workers = [
            PerturbationWorker.remote(
                {k: cfg.get(k) for k in ("env", "env_config", "model")},
                noise_ref, seed * 1000 + i + 1)
            for i in range(max(1, self._es_num_workers))]
        self.opt_state = adam_init(self.theta)

    def _gradient(self, idxs, r_pos, r_neg) -> np.ndarray:
        # centered ranks over the FULL (pos|neg) return matrix
        ranks = compute_centered_ranks(
            np.stack([r_pos, r_neg], axis=1))
        w = ranks[:, 0] - ranks[:, 1]
        g = np.zeros(self.dim, np.float32)
        for wi, idx in zip(w, idxs):
            g += wi * self.noise[idx:idx + self.dim]
        return g / (len(idxs) * self.config["sigma"])

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        theta_ref = ray_tpu_torch.put(self.theta)
        results = ray_tpu_torch.get([
            w.do_rollouts.remote(theta_ref, cfg["rollouts_per_worker"],
                                 cfg["sigma"], cfg["episode_horizon"])
            for w in self._es_workers])
        flat = [t for worker_out in results for t in worker_out]
        idxs = [t[0] for t in flat]
        r_pos = np.array([t[1] for t in flat], np.float32)
        r_neg = np.array([t[2] for t in flat], np.float32)
        steps = int(sum(t[3] for t in flat))
        self._timesteps_total += steps

        g = self._gradient(idxs, r_pos, r_neg)
        g -= cfg["l2_coeff"] * self.theta  # weight decay toward 0
        # Adam minimizes: feed the negative of the ascent direction
        self.theta, self.opt_state = adam_update(
            self.theta, -g, self.opt_state, cfg["stepsize"])

        # reflect theta onto the eval/checkpoint policy
        load_flat_params(self.workers.local_worker.policy.model,
                         self.theta)
        all_r = np.concatenate([r_pos, r_neg])
        self._episode_reward_window.extend(all_r.tolist())
        return {
            "num_env_steps_sampled_this_iter": steps,
            "episodes_this_iter": all_r.size,
            "perturbation_reward_mean": float(all_r.mean()),
            "update_gnorm": float(np.linalg.norm(g)),
        }

    def save_checkpoint(self) -> Dict[str, Any]:
        state = super().save_checkpoint()
        state["theta"] = self.theta.copy()
        state["es_opt_state"] = {k: np.copy(v)
                                 for k, v in self.opt_state.items()}
        return state

    def load_checkpoint(self, state: Dict[str, Any]):
        super().load_checkpoint(state)
        if "theta" in state:
            self.theta = np.asarray(state["theta"], np.float32)
            self.opt_state = {k: np.copy(v)
                              for k, v in state["es_opt_state"].items()}
            self.opt_state["count"] = int(self.opt_state["count"])
        else:
            # pre-theta checkpoint: re-flatten the restored policy
            self.theta = flat_params(self.workers.local_worker.policy.model)

    def cleanup(self):
        kill_actors(self._es_workers)
        super().cleanup()


class ARSConfig(ESConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ARS)
        self._config.update({
            "sigma": 0.05,
            "stepsize": 0.02,
            "rollouts_per_worker": 8,
            # top directions kept for the update (ARS-V1t; Mania et al.)
            "num_top_directions": 8,
        })


class ARS(ES):
    """Augmented random search (reference: rllib/algorithms/ars/ars.py):
    same worker machinery as ES; the update keeps only the top-k
    directions by max(r+, r-) and scales by the reward std of that
    elite set instead of fitness shaping."""

    _default_config_cls = ARSConfig

    def _gradient(self, idxs, r_pos, r_neg) -> np.ndarray:
        k = min(self.config.get("num_top_directions", 8), len(idxs))
        order = np.argsort(-np.maximum(r_pos, r_neg))[:k]
        elite = np.concatenate([r_pos[order], r_neg[order]])
        sigma_r = float(elite.std()) + 1e-8
        g = np.zeros(self.dim, np.float32)
        for i in order:
            g += (r_pos[i] - r_neg[i]) * self.noise[
                idxs[i]:idxs[i] + self.dim]
        return g / (k * sigma_r)
