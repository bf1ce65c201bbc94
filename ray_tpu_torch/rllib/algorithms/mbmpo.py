"""MBMPO — model-based meta-policy optimization.

Reference analogue: rllib/algorithms/mbmpo/ (mbmpo.py,
model_ensemble.py; Clavera et al. 2018): learn an ENSEMBLE of dynamics
models from real transitions, then treat each ensemble member as a
MAML "task" — the policy is meta-trained so that one inner
policy-gradient step on imagined rollouts from any single model yields
a good policy, which makes the meta-policy robust to model bias.

Counterpart of ``ray_tpu/rllib/algorithms/mbmpo.py`` with the same
models, update and defaults, on ``config["device"]`` ("cuda" unless the
caller asks for "cpu"):

- ``_DynamicsModel``: the K members stacked as one ``models.StackedMLP``
  (concat(obs, act) -> 64 -> 64 -> the state delta; JAX's vmapped tree
  loads through ``models.stacked_params_from_flax``); one Adam over the
  whole stack on the mean over (K, N, obs_dim) of (pred - (next -
  obs))², each member on its own bootstrap draw
  ``integers(0, n, (K, min(n, 256)))`` of the real buffer;
- ``_imagine``: E episodes of T steps through ONE member under no grad
  (a Python loop over T: mean + 0.3 noise clipped to [-1, 1], the model
  step, the state clipped to [-2, 2], reward -‖next - goal‖ on the fixed
  task [1, 0]), then returns-to-go and the per-timestep baseline over
  E; the (T, E, act_dim) noise is an argument or the generator's;
- the policy, the surrogate, the inner adaptation, the second-order
  meta-update and the acting are MAML's (``maml.MetaPolicy``);
- ``_collect_real`` clips the action BEFORE storing it and keeps the
  last ``buffer_size`` rows.

The checkpoint is ``LocalAlgorithm``'s, as JAX's: the policy, a frozen
copy of the initial policy and the policy's Adam; the ensemble, its
Adam and the real buffer are not saved. ``training_step`` also reports
``timers``: the host milliseconds of one iteration spent sampling the
real env, fitting the models, imagining and adapting, and learning.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch
from torch.func import functional_call

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.algorithms.maml import (MetaPolicy, Params,
                                                 PointGoalEnv)
from ray_tpu_torch.rllib.algorithms.sac import noise_tensor
from ray_tpu_torch.rllib.models import StackedMLP
from ray_tpu_torch.rllib.policy import backward_grads


class _DynamicsModel(StackedMLP):
    """Predicts the state delta for (obs, act): K members stacked."""

    def __init__(self, members: int, obs_dim: int, act_dim: int,
                 hidden: int = 64):
        super().__init__(members, (obs_dim + act_dim, hidden, hidden,
                                   obs_dim))

    def delta(self, obs, act):
        """obs, act (K, N, ·) -> every member's delta (K, N, obs_dim)."""
        return self(torch.cat([obs, act], dim=-1))

    def member_delta(self, k: int, obs, act):
        return self.member(k, torch.cat([obs, act], dim=-1))


class MBMPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MBMPO)
        self._config.update({
            "env": "point_goal",
            "env_config": {},
            "ensemble_size": 4,
            "model_lr": 1e-3,
            "model_train_iters": 60,
            "real_episodes_per_iter": 16,
            "imagined_episodes": 16,
            "horizon": 20,
            "inner_lr": 0.1,
            "lr": 1e-3,              # meta (outer) lr
            "inner_adaptation_steps": 1,
            "hidden": 64,
            "buffer_size": 4000,
        })


class MBMPO(MetaPolicy, LocalAlgorithm):
    """Model-based MAML: ensemble members are the task distribution
    (reference: mbmpo.py training_step — fit models on real data,
    inner-adapt on imagined data per model, meta-update through the
    adaptation)."""

    _default_config_cls = MBMPOConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        if cfg["env"] != "point_goal":
            raise ValueError("MBMPO ships the point_goal dynamics family")
        env_cfg = dict(cfg.get("env_config") or {})
        env_cfg.setdefault("horizon", cfg["horizon"])
        self.env = PointGoalEnv(env_cfg)
        self.env.set_task(np.array([1.0, 0.0], np.float32))  # fixed task
        init_gen = self._init_policy(cfg)
        self.dynamics = _DynamicsModel(
            cfg["ensemble_size"], self.obs_dim, self.act_dim,
            cfg["hidden"]).init_weights(init_gen).to(self.device)
        self.model_opt = torch.optim.Adam(self.dynamics.parameters(),
                                          lr=cfg["model_lr"], eps=1e-8)
        self._buf_obs = np.zeros((0, self.obs_dim), np.float32)
        self._buf_act = np.zeros((0, self.act_dim), np.float32)
        self._buf_next = np.zeros((0, self.obs_dim), np.float32)
        self._goal = torch.as_tensor(self.env.goal, device=self.device)
        self._init_local_state()

    # ---- dynamics ensemble ----

    def _model_loss(self, dynamics, obs, act, nxt) -> torch.Tensor:
        """``dynamics``' mean over (K, N, obs_dim) of (pred - (next -
        obs))² on (K, N, ·) draws (numpy or tensors): each member sees
        its own rows."""
        obs, act, nxt = (torch.as_tensor(v, device=self.device)
                         for v in (obs, act, nxt))
        return torch.mean((dynamics.delta(obs, act) - (nxt - obs)) ** 2)

    def _model_update(self, obs, act, nxt) -> torch.Tensor:
        """One Adam step of the whole ensemble on (K, N, ·) bootstrap
        draws. Returns the loss on the device."""
        loss = self._model_loss(self.dynamics, obs, act, nxt)
        self.model_opt.zero_grad(set_to_none=True)
        backward_grads(list(self.dynamics.parameters()), loss)
        self.model_opt.step()
        return loss.detach()

    # ---- imagination ----

    @torch.no_grad()
    def _imagine(self, params: Params, k: int, noise=None):
        """E imagined episodes of length T under ensemble member ``k``.
        Returns a REINFORCE batch (obs/actions/advantages on the
        device) and the mean imagined return (a device scalar).
        ``noise``: the (T, E, act_dim) action draws, else the
        generator's."""
        cfg = self.config
        E, T = cfg["imagined_episodes"], cfg["horizon"]
        if noise is None:
            noise = torch.randn((T, E, self.act_dim), generator=self._gen,
                                device=self.device)
        noise = noise_tensor(noise, self.device)
        obs = torch.zeros((E, self.obs_dim), device=self.device)
        all_obs, all_act, all_rew = [], [], []
        for t in range(T):
            mean, logstd = functional_call(self.model, params, (obs,))
            act = torch.clamp(mean + torch.exp(logstd) * noise[t], -1.0, 1.0)
            delta = self.dynamics.member_delta(k, obs, act)
            nxt = torch.clamp(obs + delta, -2.0, 2.0)
            all_obs.append(obs)
            all_act.append(act)
            all_rew.append(-torch.linalg.vector_norm(
                nxt - self._goal[None], dim=-1))
            obs = nxt
        rew = torch.stack(all_rew)                            # (T, E)
        rtg = torch.flip(torch.cumsum(torch.flip(rew, (0,)), 0), (0,))
        adv = rtg - rtg.mean(dim=1, keepdim=True)             # per-t baseline
        return {"obs": torch.stack(all_obs).reshape(-1, self.obs_dim),
                "actions": torch.stack(all_act).reshape(-1, self.act_dim),
                "advantages": adv.reshape(-1)}, torch.mean(
                    torch.sum(rew, dim=0))

    # ---- real-env interaction ----

    def _collect_real(self, params: Params, episodes: int,
                      noise=None) -> float:
        """``episodes`` real episodes into the buffer (the last
        ``buffer_size`` rows kept); the mean episode reward. ``noise``:
        the (episodes, horizon, act_dim) action draws, else the
        generator's."""
        size = self.config["buffer_size"]
        rewards = []
        for ep in range(episodes):
            obs, _ = self.env.reset()
            total, done, t = 0.0, False, 0
            while not done:
                a = np.clip(self._act(params, obs, None if noise is None
                                      else noise[ep][t]), -1.0, 1.0)
                nobs, r, term, trunc, _ = self.env.step(a)
                self._buf_obs = np.concatenate(
                    [self._buf_obs, obs[None]])[-size:]
                self._buf_act = np.concatenate(
                    [self._buf_act, a[None]])[-size:]
                self._buf_next = np.concatenate(
                    [self._buf_next, nobs[None]])[-size:]
                total += r
                obs, done, t = nobs, (term or trunc), t + 1
            rewards.append(total)
        return float(np.mean(rewards))

    def _bootstrap(self):
        """Each member's rows of the buffer: ``integers(0, n, (K,
        min(n, 256)))`` from the algorithm's numpy RNG."""
        n = len(self._buf_obs)
        idx = self._np_rng.integers(
            0, n, size=(self.config["ensemble_size"], min(n, 256)))
        return self._buf_obs[idx], self._buf_act[idx], self._buf_next[idx]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        K = cfg["ensemble_size"]
        t0 = time.perf_counter()
        # the DEPLOYED policy is the adapted one (reference: MBMPO's
        # inner-adapted policies collect the next round of real data) —
        # adapt on imagination from one ensemble member once models exist
        deploy = self.params
        if len(self._buf_obs) > 0:
            pre0, _ = self._imagine(self.params, 0)
            deploy = self._adapt(self.params, pre0)
        real_reward = self._collect_real(deploy,
                                         cfg["real_episodes_per_iter"])
        t1 = time.perf_counter()
        # fit the ensemble on the buffer (bootstrap resample per member)
        model_loss = torch.zeros(())
        for _ in range(cfg["model_train_iters"]):
            model_loss = self._model_update(*self._bootstrap())
        t2 = time.perf_counter()
        # each ensemble member is one MAML task
        pre_batches, post_batches, imag_rewards = [], [], []
        for k in range(K):
            pre, _ = self._imagine(self.params, k)
            adapted = self._adapt(self.params, pre)
            post, im_rw = self._imagine(adapted, k)
            pre_batches.append(pre)
            post_batches.append(post)
            imag_rewards.append(im_rw)
        t3 = time.perf_counter()
        stats = self._meta_update(pre_batches, post_batches)
        host = torch.stack([model_loss.to(self.device),
                            torch.mean(torch.stack(imag_rewards)),
                            stats["meta_loss"], stats["grad_norm"]]).tolist()
        t4 = time.perf_counter()
        steps = cfg["real_episodes_per_iter"] * cfg["horizon"]
        self._timesteps_total += steps
        self._episode_reward_window.append(real_reward)
        return {
            "num_env_steps_sampled_this_iter": steps,
            "real_reward_mean": real_reward,
            "imagined_reward_mean": host[1],
            "model_loss": host[0],
            "learner/meta_loss": host[2],
            "learner/grad_norm": host[3],
            "timers": {"sample_time_ms": (t1 - t0) * 1e3,
                       "model_time_ms": (t2 - t1) * 1e3,
                       "imagine_time_ms": (t3 - t2) * 1e3,
                       "learn_time_ms": (t4 - t3) * 1e3},
        }
