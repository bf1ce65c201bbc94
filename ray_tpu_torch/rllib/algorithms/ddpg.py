"""DDPG + TD3 — deterministic-policy-gradient continuous control.

Reference analogue: rllib/algorithms/ddpg/ (ddpg.py, ddpg_torch_policy.py)
and rllib/algorithms/td3.py — TD3 is a DDPG preset (twin_q + delayed
policy updates + target policy smoothing). Counterpart of
``ray_tpu/rllib/algorithms/ddpg.py`` with the same nets, losses, order
of updates and draws:

- ``_DDPGNets``: ``pi_net`` (two ReLU layers, a tanh head), ``q1_net``
  and, with ``twin_q``, ``q2_net``, initialised as flax's ``Dense``;
- exploration noise is numpy's (``np.random.default_rng(seed)``, drawn
  after the forward, as JAX's), so whole DDPG steps match JAX's;
- the critic step: TD3's target smoothing takes its standard-normal
  draw as ``noise`` (the policy's generator where the caller gives
  none), the loss reads replay ``weights`` where present and returns the
  per-sample ``td_errors``; Polyak blending of every param follows it;
- the actor step (through the critic with its gradient stopped) runs
  every ``policy_delay`` learn steps, after the blend.

The JAX package steps both Adams over the whole param tree; each net's
gradient from the other's loss is zero, and Adam moves a leaf whose
gradient has always been zero by exactly zero, so here the critic's Adam
holds the Q nets and the actor's the pi net (held against JAX's
updates by the tests).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.sac import (init_dense_, mlp,
                                                noise_tensor, polyak_update,
                                                replay_training_step,
                                                run_mlp)
from ray_tpu_torch.rllib.env import Box
from ray_tpu_torch.rllib.policy import (backward_grads, host_copy,
                                        load_weights, policy_device,
                                        stats_to_host, to_device_batch,
                                        weights_of)
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class _DDPGNets(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, twin_q: bool,
                 hidden: int = 256):
        super().__init__()
        self.twin_q = twin_q
        self.pi_net = mlp(obs_dim, hidden, act_dim, tanh=True)
        self.q1_net = mlp(obs_dim + act_dim, hidden, 1)
        if twin_q:
            self.q2_net = mlp(obs_dim + act_dim, hidden, 1)

    def pi(self, obs):
        return self.pi_net(obs)

    def q(self, obs, act, frozen: bool = False):
        x = torch.cat([obs, act], dim=-1)
        q1 = run_mlp(self.q1_net, x, frozen)[..., 0]
        q2 = run_mlp(self.q2_net, x, frozen)[..., 0] if self.twin_q else q1
        return q1, q2


class DDPGPolicy:
    """Worker-facing API parity with TorchPolicy (compute_actions /
    postprocess_trajectory / learn_on_batch / get,set_weights)."""

    loss_columns = (SampleBatch.OBS, SampleBatch.NEXT_OBS, "raw_actions",
                    SampleBatch.REWARDS, SampleBatch.DONES, "weights")

    def __init__(self, obs_space, action_space, config: Dict[str, Any]):
        assert isinstance(action_space, Box), "DDPG is continuous-only"
        self.observation_space = obs_space
        self.action_space = action_space
        self.config = config
        self.device = policy_device(config)
        self.act_dim = int(np.prod(action_space.shape))
        self.low = np.asarray(action_space.low, np.float32)
        self.high = np.asarray(action_space.high, np.float32)
        obs_dim = (obs_space.shape or (1,))[-1]
        init_gen = torch.Generator().manual_seed(config.get("seed") or 0)
        self.model = init_dense_(
            _DDPGNets(obs_dim, self.act_dim, bool(config.get("twin_q", False))),
            init_gen).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self._gen = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=init_gen)))
        self._np_rng = np.random.default_rng(config.get("seed"))
        self.pi_optimizer = torch.optim.Adam(
            self.model.pi_net.parameters(),
            lr=config.get("actor_lr", 1e-3), eps=1e-8)
        self.q_optimizer = torch.optim.Adam(
            self._q_params(), lr=config.get("critic_lr", 1e-3), eps=1e-8)
        self.global_timestep = 0
        self._learn_steps = 0
        # host-side exploration noise scale, annealable via set_exploration
        self.exploration_noise = config.get("exploration_noise", 0.1)

    def _q_params(self):
        return [p for n, p in self.model.named_parameters()
                if not n.startswith("pi_net.")]

    # ---- inference ----

    @torch.no_grad()
    def compute_actions(self, obs, explore=True):
        obs = to_device_batch({"obs": obs}, self.device)["obs"]
        act = self.model.pi(obs).cpu().numpy()
        if explore:
            act = act + self._np_rng.normal(
                0.0, self.exploration_noise, act.shape).astype(np.float32)
            act = np.clip(act, -1.0, 1.0)
        scaled = self.low + (act + 1.0) * 0.5 * (self.high - self.low)
        n = len(scaled)
        return scaled.astype(np.float32), {
            SampleBatch.ACTION_LOGP: np.zeros(n, np.float32),
            SampleBatch.VF_PREDS: np.zeros(n, np.float32),
            "raw_actions": act.astype(np.float32),
        }

    def postprocess_trajectory(self, batch):
        return batch

    def value(self, obs):
        return np.zeros(len(obs), np.float32)

    def set_exploration(self, **attrs):
        for k, v in attrs.items():
            setattr(self, k, v)

    # ---- learning ----

    def critic_loss(self, b, noise=None):
        """(loss, stats) of the critic step; ``noise``: the standard
        normal draw that TD3's target smoothing scales and clips."""
        cfg = self.config
        obs, acts = b[SampleBatch.OBS], b["raw_actions"]
        nobs = b[SampleBatch.NEXT_OBS]
        with torch.no_grad():
            next_a = self.target_model.pi(nobs)
            if cfg.get("smooth_target_policy", False):
                clip = cfg.get("target_noise_clip", 0.5)
                smooth = torch.clamp(noise * cfg.get("target_noise", 0.2),
                                     -clip, clip)
                next_a = torch.clamp(next_a + smooth, -1.0, 1.0)
            tq1, tq2 = self.target_model.q(nobs, next_a)
            not_done = 1.0 - b[SampleBatch.DONES].to(torch.float32)
            target_q = (b[SampleBatch.REWARDS] + cfg.get("gamma", 0.99)
                        * not_done * torch.minimum(tq1, tq2))
        q1, q2 = self.model.q(obs, acts)
        # importance weights from prioritized replay (Ape-X DDPG)
        w = b.get("weights")
        if w is None:
            w = torch.ones_like(q1)
        loss = torch.mean(w * (q1 - target_q) ** 2)
        if cfg.get("twin_q", False):
            loss = loss + torch.mean(w * (q2 - target_q) ** 2)
        td = torch.abs(q1 - target_q).detach()
        return loss, {"mean_q": torch.mean(q1), "mean_td_error": torch.mean(td),
                      # per-sample |TD| for priority updates
                      "td_errors": td}

    def actor_loss(self, b):
        obs = b[SampleBatch.OBS]
        # the gradient flows through the action into Q but must not move
        # the critic weights (same separation as SAC's actor term)
        q1, _ = self.model.q(obs, self.model.pi(obs), frozen=True)
        return -torch.mean(q1)

    def _prepare(self, batch, noise):
        b = to_device_batch(batch, self.device, self.loss_columns)
        if self.config.get("smooth_target_policy", False):
            noise = (torch.randn((batch.count, self.act_dim),
                                 generator=self._gen, device=self.device)
                     if noise is None else noise_tensor(noise, self.device))
        return b, noise

    def learn_on_batch(self, batch, noise: Optional[Any] = None
                       ) -> Dict[str, float]:
        """The critic step (and Polyak blend), then the actor step on
        every ``policy_delay``-th call; ``noise`` replaces the smoothing
        draw."""
        b, noise = self._prepare(batch, noise)
        self.q_optimizer.zero_grad(set_to_none=True)
        loss, stats = self.critic_loss(b, noise)
        backward_grads(self._q_params(), loss)
        self.q_optimizer.step()
        polyak_update(self.target_model, self.model,
                      self.config.get("tau", 0.005))
        stats["critic_loss"] = loss
        self._learn_steps += 1
        if self._learn_steps % self.config.get("policy_delay", 1) == 0:
            self.pi_optimizer.zero_grad(set_to_none=True)
            actor_loss = self.actor_loss(b)
            backward_grads(list(self.model.pi_net.parameters()), actor_loss)
            self.pi_optimizer.step()
            stats["actor_loss"] = actor_loss
        self.global_timestep += batch.count
        return stats_to_host(stats)

    def compute_gradients(self, batch, noise=None):
        """({"critic": grads, "actor": grads}, stats) by param name, every
        param in each (zero where the loss does not reach it), of the
        critic and actor losses at the current params; nothing is
        stepped."""
        b, noise = self._prepare(batch, noise)
        params = dict(self.model.named_parameters())
        loss, stats = self.critic_loss(b, noise)
        stats["critic_loss"] = loss
        actor_loss = self.actor_loss(b)
        stats["actor_loss"] = actor_loss
        grads = {}
        for part, total in (("critic", loss), ("actor", actor_loss)):
            got = torch.autograd.grad(total, list(params.values()),
                                      allow_unused=True)
            grads[part] = {n: (np.zeros(tuple(p.shape), np.float32)
                               if g is None else g.detach().cpu().numpy())
                           for (n, p), g in zip(params.items(), got)}
        return grads, stats_to_host(stats)

    # ---- weights / state ----

    def get_weights(self):
        return weights_of(self.model)

    def set_weights(self, weights):
        load_weights(self.model, weights)

    def get_state(self):
        return {"weights": self.get_weights(),
                "target": weights_of(self.target_model),
                "pi_opt_state": host_copy(self.pi_optimizer.state_dict()),
                "q_opt_state": host_copy(self.q_optimizer.state_dict()),
                "global_timestep": self.global_timestep,
                "learn_steps": self._learn_steps}

    def set_state(self, state):
        self.set_weights(state["weights"])
        load_weights(self.target_model, state["target"])
        self.pi_optimizer.load_state_dict(host_copy(state["pi_opt_state"]))
        self.q_optimizer.load_state_dict(host_copy(state["q_opt_state"]))
        self.global_timestep = state.get("global_timestep", 0)
        self._learn_steps = state.get("learn_steps", 0)


class DDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        self._config.update({
            "actor_lr": 1e-3,
            "critic_lr": 1e-3,
            "tau": 0.005,
            "twin_q": False,
            "policy_delay": 1,
            "smooth_target_policy": False,
            "target_noise": 0.2,
            "target_noise_clip": 0.5,
            "exploration_noise": 0.1,
            "replay_buffer_capacity": 100_000,
            "learning_starts": 256,
            "train_batch_size": 256,
            "rollout_fragment_length": 1,
            "training_intensity": 1,
        })


class TD3Config(DDPGConfig):
    """TD3 = DDPG + twin critics + delayed actor + target smoothing
    (reference: rllib/algorithms/td3.py)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        self._config.update({
            "twin_q": True,
            "policy_delay": 2,
            "smooth_target_policy": True,
        })


class DDPG(Algorithm):
    _policy_cls = DDPGPolicy
    _default_config_cls = DDPGConfig

    def setup(self, config):
        super().setup(config)
        self.replay = ReplayBuffer(
            self.config["replay_buffer_capacity"],
            seed=self.config.get("seed"))

    def training_step(self) -> Dict[str, Any]:
        return replay_training_step(self)


class TD3(DDPG):
    _default_config_cls = TD3Config
