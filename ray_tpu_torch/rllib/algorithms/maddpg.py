"""MADDPG — multi-agent DDPG with centralized critics (Lowe et al.
2017).

Reference analogue: rllib/algorithms/maddpg/ (maddpg.py,
maddpg_tf_policy.py): each agent i has a decentralized actor
π_i(o_i) and a CENTRALIZED critic Q_i(s, a_1..a_n) that observes the
global state and every agent's action during training; execution uses
only the local actors. Like QMIX, joint transitions don't fit the
per-policy rollout split, so the algorithm owns its env loop.

Counterpart of ``ray_tpu/rllib/algorithms/maddpg.py`` with the same env,
nets, update and defaults. Per-agent params stay STACKED on a leading
agent axis, as JAX's vmapped tree: ``_MADDPGNets`` holds the n actors
and the n critics as two ``models.StackedMLP``s (one batched product a
layer for all agents; ``models.stacked_params_from_flax`` loads the JAX
tree), on ``config["device"]`` ("cuda" unless the caller asks for
"cpu"):

- ``MultiAgentTarget1D`` (registered at import): agents on a line
  steering toward the origin, team reward -mean(x²);
- one update: the target joint action from every target actor, ``y =
  r + γ (1 - done) Q'_i`` (n, B); the critics regress it (mean over
  (n, B)); actor i puts its own action into the batch's joint action
  and is scored by critic i with the critic's params DETACHED (the
  negative mean over (n, B)); one backward of the sum, then
  ``clip_by_global_norm(10)`` jointly over all n actors and, apart,
  over all n critics, each followed by its own Adam (optax's
  ``multi_transform``); Polyak (tau) on both after every update;
- acting: while the replay holds fewer than ``learning_starts`` rows,
  ``uniform(-1, 1, (n, da))``; otherwise the actors' forward, then
  ``normal(0, noise)`` clipped to [-1, 1] (numpy, JAX's order). The raw
  tanh-space action is stored, the scaled one sent to the env.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent sampling, drawing train batches and learning.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.algorithms.sac import polyak_update
from ray_tpu_torch.rllib.env import Box, MultiAgentEnv, _BUILTIN_ENVS, make_env
from ray_tpu_torch.rllib.models import StackedMLP
from ray_tpu_torch.rllib.policy import (backward_grads, clip_by_global_norm,
                                        policy_device, stats_to_host,
                                        to_device_batch)
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer


class MultiAgentTarget1D(MultiAgentEnv):
    """N agents on a line steer (velocity action in [-1,1]) toward the
    origin; team reward = -mean(x_i^2) — a minimal smooth cooperative
    continuous-control env (reference analogue: the MPE spread task
    used by maddpg tests, reduced to 1D)."""

    HORIZON = 25

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.num_agents = int(config.get("num_agents", 2))
        self.agent_ids = [f"agent_{i}" for i in range(self.num_agents)]
        self._rng = np.random.default_rng(config.get("seed"))
        self.observation_space = Box(-np.inf, np.inf, (1,))
        self.action_space = Box(-1.0, 1.0, (1,))
        self._x: Optional[np.ndarray] = None
        self._t = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._x = self._rng.uniform(-2.0, 2.0, self.num_agents)
        self._t = 0
        obs = {a: np.array([self._x[i]], np.float32)
               for i, a in enumerate(self.agent_ids)}
        return obs, {a: {} for a in self.agent_ids}

    def step(self, action_dict):
        for i, a in enumerate(self.agent_ids):
            v = float(np.clip(np.asarray(action_dict[a]).ravel()[0],
                              -1.0, 1.0))
            self._x[i] += 0.2 * v
        self._t += 1
        team_r = float(-np.mean(self._x ** 2))
        done = self._t >= self.HORIZON
        obs = {a: np.array([self._x[i]], np.float32)
               for i, a in enumerate(self.agent_ids)}
        rews = {a: team_r for a in self.agent_ids}
        terms = {a: False for a in self.agent_ids}
        truncs = {a: done for a in self.agent_ids}
        terms["__all__"] = False
        truncs["__all__"] = done
        return obs, rews, terms, truncs, {a: {} for a in self.agent_ids}


_BUILTIN_ENVS["MultiAgentTarget1D"] = MultiAgentTarget1D


class _MADDPGNets(nn.Module):
    """The n actors (obs -> 64 -> 64 -> tanh act) and the n centralized
    critics (concat(state, joint_act) -> 64 -> 64 -> 1), each a
    ``StackedMLP`` over the agent axis: the JAX params tree's ``actor``
    and ``critic``."""

    def __init__(self, n: int, obs_dim: int, act_dim: int, hidden: int = 64):
        super().__init__()
        self.actor = StackedMLP(n, (obs_dim, hidden, hidden, act_dim),
                                out=torch.tanh)
        self.critic = StackedMLP(
            n, (n * obs_dim + n * act_dim, hidden, hidden, 1))

    def q(self, state, joint_act, detach: bool = False):
        """state (B, ds) and joint_act (B, dj), or both (n, B, ·) -> each
        critic's Q (n, B)."""
        return self.critic(torch.cat([state, joint_act], dim=-1),
                           detach)[..., 0]


class MADDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MADDPG)
        self._config.update({
            "env": "MultiAgentTarget1D",
            "actor_lr": 3e-4,
            "critic_lr": 1e-3,
            "tau": 0.01,
            "exploration_noise": 0.3,
            "replay_buffer_capacity": 50_000,
            "learning_starts": 500,
            "train_batch_size": 128,
            "rollout_fragment_length": 50,
            "training_intensity": 2,
            # targets polyak-update every learn step with `tau` (no
            # hard-sync period knob, unlike DQN/QMIX/R2D2)
        })


class MADDPG(LocalAlgorithm):
    _default_config_cls = MADDPGConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        self.env = make_env(cfg["env"], cfg.get("env_config"))
        if not isinstance(self.env, MultiAgentEnv):
            raise ValueError("MADDPG needs a MultiAgentEnv")
        if not isinstance(self.env.action_space, Box):
            raise ValueError("MADDPG is continuous-action only")
        self.agent_ids = list(self.env.agent_ids)
        self.n = len(self.agent_ids)
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.act_dim = int(np.prod(self.env.action_space.shape))
        self.low = np.asarray(self.env.action_space.low, np.float32)
        self.high = np.asarray(self.env.action_space.high, np.float32)

        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        nets = _MADDPGNets(self.n, self.obs_dim, self.act_dim)
        nets.actor.init_weights(init_gen)
        nets.critic.init_weights(init_gen)
        self.model = nets.to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        # slow actors against fast critics — the standard MADDPG
        # stabilization: each critic's target moves with the OTHER
        # agents' actors, so actor updates must trail critic fitting
        self.optimizer = torch.optim.Adam(
            [{"params": list(self.model.actor.parameters()),
              "lr": cfg["actor_lr"]},
             {"params": list(self.model.critic.parameters()),
              "lr": cfg["critic_lr"]}], eps=1e-8)

        self.replay = ReplayBuffer(cfg["replay_buffer_capacity"],
                                   seed=cfg.get("seed"))
        self._init_local_state()
        self._obs, _ = self.env.reset(seed=cfg.get("seed"))
        self._episode_reward = 0.0

    # ---- update ----

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        """One update on a replayed batch (numpy columns ``obs``,
        ``next_obs`` (B, n, do), ``actions`` (B, n, da) in tanh space,
        ``rewards``, ``dones`` (B,)), Polyak included. Returns the stats
        and the two clip norms (``actor_grad_norm``,
        ``critic_grad_norm``, before clipping) as tensors on the device;
        the clipped grads stay in the params' ``.grad``."""
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        nets, tnets = self.model, self.target_model
        b = to_device_batch(batch, self.device, (
            "obs", "next_obs", "actions", "rewards", "dones"))
        obs, nobs, acts = b["obs"], b["next_obs"], b["actions"]
        not_done = 1.0 - b["dones"].to(torch.float32)
        n_rows = obs.shape[0]
        state = obs.reshape(n_rows, -1)
        nstate = nobs.reshape(n_rows, -1)
        joint_act = acts.reshape(n_rows, -1)

        with torch.no_grad():
            # target joint action from all target actors: (B, n, da)
            next_a = tnets.actor(nobs.transpose(0, 1)).transpose(0, 1)
            tq = tnets.q(nstate, next_a.reshape(n_rows, -1))  # (n, B)
            y = b["rewards"][None, :] + gamma * not_done[None, :] * tq

        # critic: every agent's Q(s, a_all) regresses its target
        q = nets.q(state, joint_act)                          # (n, B)
        critic_loss = torch.mean((q - y) ** 2)
        # actor i: own action from π_i, the others from the batch
        own = nets.actor(obs.transpose(0, 1))                   # (n, B, da)
        eye = torch.eye(self.n, device=self.device)[:, None, :, None]
        mixed = acts[None] * (1.0 - eye) + own[:, :, None, :] * eye
        actor_q = nets.q(state.expand(self.n, *state.shape),
                         mixed.reshape(self.n, n_rows, -1), detach=True)
        actor_loss = -torch.mean(actor_q)
        total = critic_loss + actor_loss

        self.optimizer.zero_grad(set_to_none=True)
        actor_params = list(nets.actor.parameters())
        critic_params = list(nets.critic.parameters())
        grads = backward_grads(actor_params + critic_params, total)
        na = len(actor_params)
        # optax.multi_transform: one global norm over all n actors,
        # another over all n critics
        actor_norm = clip_by_global_norm(grads[:na], 10.0)
        critic_norm = clip_by_global_norm(grads[na:], 10.0)
        self.optimizer.step()
        polyak_update(tnets, nets, cfg.get("tau", 0.01))
        return {"critic_loss": critic_loss.detach(),
                "actor_loss": actor_loss.detach(),
                "mean_q": torch.mean(q.detach()),
                "loss": total.detach(),
                "actor_grad_norm": actor_norm,
                "critic_grad_norm": critic_norm}

    # ---- collection ----

    @torch.no_grad()
    def _joint_actions(self, obs_dict, noise: float,
                       uniform: bool = False):
        obs = np.stack([obs_dict[a] for a in self.agent_ids])
        if uniform:
            # pure-random warmup decorrelates the agents' actions so
            # each centralized critic can attribute per-slot effects
            # (without it, early actor drift saturates every action at
            # ±1 and the joint-action landscape is unlearnable)
            raw = self._np_rng.uniform(
                -1.0, 1.0, (self.n, self.act_dim)).astype(np.float32)
        else:
            x = torch.as_tensor(np.asarray(obs, np.float32)[:, None],
                                device=self.device)
            raw = self.model.actor(x)[:, 0].cpu().numpy()  # (n, da)
        if noise > 0 and not uniform:
            raw = np.clip(raw + self._np_rng.normal(
                0.0, noise, raw.shape).astype(np.float32), -1.0, 1.0)
        scaled = self.low + (raw + 1.0) * 0.5 * (self.high - self.low)
        return ({a: scaled[i] for i, a in enumerate(self.agent_ids)},
                raw)

    def _collect(self, num_steps: int, noise: float) -> int:
        warmup = len(self.replay) < self.config["learning_starts"]

        def act(obs_dict):
            return self._joint_actions(obs_dict, noise, uniform=warmup)

        return self._collect_joint(act, num_steps)

    # ---- Algorithm surface ----

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        n = self._collect(cfg["rollout_fragment_length"],
                          cfg["exploration_noise"])
        sample_s = time.perf_counter() - t0
        self._timesteps_total += n
        stats: Dict[str, float] = {}
        replay_s = learn_s = 0.0
        if len(self.replay) >= cfg["learning_starts"]:
            for _ in range(max(1, cfg.get("training_intensity", 1))):
                t1 = time.perf_counter()
                train = self.replay.sample(cfg["train_batch_size"])
                t2 = time.perf_counter()
                dev_stats = self._update(train)
                replay_s += t2 - t1
                learn_s += time.perf_counter() - t2
            t3 = time.perf_counter()
            stats = stats_to_host({k: v for k, v in dev_stats.items()
                                   if not k.endswith("_grad_norm")})
            learn_s += time.perf_counter() - t3
        return {
            "num_env_steps_sampled_this_iter": n,
            "replay_size": len(self.replay),
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": sample_s * 1e3,
                       "replay_time_ms": replay_s * 1e3,
                       "learn_time_ms": learn_s * 1e3},
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        out = self._eval_episodes(
            lambda obs: self._joint_actions(obs, noise=0.0)[0],
            num_episodes, seed_base=30_000)
        self._obs, _ = self.env.reset()
        self._episode_reward = 0.0
        return out
