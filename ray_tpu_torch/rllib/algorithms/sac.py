"""SAC — soft actor-critic for continuous control.

Reference analogue: rllib/algorithms/sac/. Counterpart of
``ray_tpu/rllib/algorithms/sac.py`` with the same nets, loss, update and
defaults:

- ``_SACNets``: ``pi_net``, ``q1_net`` and ``q2_net``, each ``Linear``
  256 -> ReLU -> ``Linear`` 256 -> ReLU -> head, initialised as flax's
  ``Dense`` (lecun-normal kernels, zero biases) from the policy's
  ``torch.Generator``; ``pi`` clips ``log_std`` to [-20, 2], ``q`` reads
  the concatenated obs and action. The width is a constructor argument
  (256), as it is a field of the flax module.
- ``_squash`` and ``_dataset_action_logp`` are plain functions of
  tensors that take the Gaussian noise ``eps`` as an argument, so a
  test can inject JAX's draws; every update takes its draws as
  ``noise`` (``draw_noise`` makes them from the policy's generator
  where the caller gives none).
- The update: the target action comes from the TARGET params' ``pi``
  (upstream takes it from the current ``pi``); critic, actor and alpha
  losses are summed and stepped by ONE Adam over (params,
  ``log_alpha``) (upstream runs three); the actor term reads Q through
  the params with their gradient stopped; Polyak blending with ``tau``
  follows the step.
- The policy lives on ``config["device"]`` ("cuda" unless the caller
  asks for "cpu"); the replay buffer stays numpy on the host.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent sampling, in the replay buffer and learning.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import Box
from ray_tpu_torch.rllib.models import _lecun_normal_
from ray_tpu_torch.rllib.policy import (backward_grads, grads_to_host,
                                        host_copy, load_weights,
                                        policy_device, stats_to_host,
                                        to_device_batch, weights_of)
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rllib.sample_batch import SampleBatch

_LOG_2PI = math.log(2 * math.pi)


def mlp(in_dim: int, hidden: int, out_dim: int,
        tanh: bool = False) -> nn.Sequential:
    """flax's ``nn.Sequential([Dense(hidden), relu, Dense(hidden), relu,
    Dense(out)(, tanh)])``: the Linear layers sit at 0, 2 and 4, as
    flax's ``layers_0``, ``layers_2``, ``layers_4``."""
    layers = [nn.Linear(in_dim, hidden), nn.ReLU(),
              nn.Linear(hidden, hidden), nn.ReLU(),
              nn.Linear(hidden, out_dim)]
    return nn.Sequential(*layers, *([nn.Tanh()] if tanh else []))


def run_mlp(seq: nn.Sequential, x, frozen: bool = False):
    """``seq(x)``; with ``frozen`` through its params with their
    gradient stopped (``jax.lax.stop_gradient(params)``): the gradient
    reaches ``x`` but not the params."""
    if not frozen:
        return seq(x)
    for layer in seq:
        if isinstance(layer, nn.Linear):
            x = F.linear(x, layer.weight.detach(), layer.bias.detach())
        else:
            x = layer(x)
    return x


@torch.no_grad()
def init_dense_(module: nn.Module, generator: torch.Generator):
    """flax ``Dense``'s init on every ``nn.Linear``: lecun-normal
    kernels, zero biases."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, generator)
            mod.bias.zero_()
    return module


@torch.no_grad()
def polyak_update(target: nn.Module, online: nn.Module, tau: float):
    """target <- (1 - tau) target + tau online, over every param."""
    t = list(target.parameters())
    torch._foreach_mul_(t, 1 - tau)
    torch._foreach_add_(t, list(online.parameters()), alpha=tau)


def noise_tensor(v, device: torch.device) -> torch.Tensor:
    """An injected draw (a numpy array or a tensor) as f32 on ``device``."""
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.array(v, np.float32))
    return v.to(device=device, dtype=torch.float32)


class _SACNets(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256):
        super().__init__()
        self.act_dim = act_dim
        self.pi_net = mlp(obs_dim, hidden, 2 * act_dim)
        self.q1_net = mlp(obs_dim + act_dim, hidden, 1)
        self.q2_net = mlp(obs_dim + act_dim, hidden, 1)

    def pi(self, obs):
        mean, log_std = torch.chunk(self.pi_net(obs), 2, dim=-1)
        return mean, torch.clamp(log_std, -20.0, 2.0)

    def q(self, obs, act, frozen: bool = False):
        x = torch.cat([obs, act], dim=-1)
        return (run_mlp(self.q1_net, x, frozen)[..., 0],
                run_mlp(self.q2_net, x, frozen)[..., 0])


def _dataset_action_logp(acts, mean, log_std):
    """log π(a|s) of DATASET actions under a squashed Gaussian: invert
    the tanh, then apply the change-of-variables correction (shared by
    the offline algorithms CQL/CRR)."""
    pre = torch.atanh(torch.clamp(acts, -1.0 + 1e-6, 1.0 - 1e-6))
    std = torch.exp(log_std)
    return torch.sum(
        -0.5 * ((pre - mean) / std) ** 2 - log_std - 0.5 * _LOG_2PI
        - torch.log(1 - acts ** 2 + 1e-6), dim=-1)


def _squash(mean, log_std, eps):
    """tanh(mean + std * eps) and its log-prob with the tanh correction;
    ``eps`` may carry leading sample dims ([N, B, d] against [B, d])."""
    std = torch.exp(log_std)
    pre = mean + std * eps
    act = torch.tanh(pre)
    logp = torch.sum(
        -0.5 * (eps ** 2) - log_std - 0.5 * _LOG_2PI
        - torch.log(1 - act ** 2 + 1e-6), dim=-1)
    return act, logp


class SACPolicy:
    """Standalone policy (not a ``TorchPolicy``: twin critics, a target
    copy and ``log_alpha``). Presents the same worker-facing API:
    compute_actions / postprocess_trajectory / learn_on_batch /
    get,set_weights."""

    loss_columns = (SampleBatch.OBS, SampleBatch.NEXT_OBS, "raw_actions",
                    SampleBatch.REWARDS, SampleBatch.DONES)

    def __init__(self, obs_space, action_space, config: Dict[str, Any]):
        assert isinstance(action_space, Box), "SAC is continuous-only"
        self.observation_space = obs_space
        self.action_space = action_space
        self.config = config
        self.device = policy_device(config)
        self.act_dim = int(np.prod(action_space.shape))
        self.low = np.asarray(action_space.low, np.float32)
        self.high = np.asarray(action_space.high, np.float32)
        obs_dim = (obs_space.shape or (1,))[-1]
        init_gen = torch.Generator().manual_seed(config.get("seed") or 0)
        self.model = init_dense_(_SACNets(obs_dim, self.act_dim),
                                 init_gen).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.zeros((), device=self.device))
        self._gen = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=init_gen)))
        self.optimizer = torch.optim.Adam(
            [*self.model.parameters(), self.log_alpha],
            lr=config.get("lr", 3e-4), eps=1e-8)
        self.global_timestep = 0

    def _randn(self, *shape):
        return torch.randn(shape, generator=self._gen, device=self.device)

    # ---- inference ----

    @torch.no_grad()
    def compute_actions(self, obs, explore=True):
        obs = to_device_batch({"obs": obs}, self.device)["obs"]
        mean, log_std = self.model.pi(obs)
        if explore:
            act, _ = _squash(mean, log_std, self._randn(*mean.shape))
        else:
            act = torch.tanh(mean)
        act = act.cpu().numpy()
        scaled = self.low + (act + 1.0) * 0.5 * (self.high - self.low)
        n = len(scaled)
        return scaled, {
            SampleBatch.ACTION_LOGP: np.zeros(n, np.float32),
            SampleBatch.ACTION_DIST_INPUTS: np.zeros(
                (n, 2 * self.act_dim), np.float32),
            SampleBatch.VF_PREDS: np.zeros(n, np.float32),
            "raw_actions": act,
        }

    def postprocess_trajectory(self, batch):
        return batch  # off-policy: no advantage computation

    def value(self, obs):
        return np.zeros(len(obs), np.float32)

    # ---- learning ----

    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        """The update's standard-normal draws: ``next`` for the target
        action at new_obs, ``new`` for the actor's action at obs."""
        return {"next": self._randn(n, self.act_dim),
                "new": self._randn(n, self.act_dim)}

    @torch.no_grad()
    def _target_q(self, b, eps, entropy: bool = True):
        """rewards + gamma (1 - done) (min target Q(s', a') [- alpha
        logp(a')]), a' drawn from the target params' pi."""
        nobs = b[SampleBatch.NEXT_OBS]
        mean_n, log_std_n = self.target_model.pi(nobs)
        next_a, next_logp = _squash(mean_n, log_std_n, eps)
        tq1, tq2 = self.target_model.q(nobs, next_a)
        soft = torch.minimum(tq1, tq2)
        if entropy:
            soft = soft - torch.exp(self.log_alpha) * next_logp
        not_done = 1.0 - b[SampleBatch.DONES].to(torch.float32)
        return (b[SampleBatch.REWARDS]
                + self.config.get("gamma", 0.99) * not_done * soft)

    def _q_many(self, obs, acts):
        """Q(s, a_i) for N action samples: (N, B, d) -> two (N, B)."""
        n, b, d = acts.shape
        obs_rep = obs[None].expand(n, b, obs.shape[-1])
        q1, q2 = self.model.q(obs_rep.reshape(n * b, -1),
                              acts.reshape(n * b, d))
        return q1.reshape(n, b), q2.reshape(n, b)

    def _actor_terms(self, obs, eps):
        """(mean, log_std, the actor's new action's logp, min Q of it
        through frozen params)."""
        mean, log_std = self.model.pi(obs)
        new_a, new_logp = _squash(mean, log_std, eps)
        fq1, fq2 = self.model.q(obs, new_a, frozen=True)
        return mean, log_std, new_logp, torch.minimum(fq1, fq2)

    def _alpha_loss(self, new_logp):
        """-mean(log_alpha * stop_gradient(logp + target entropy)), the
        target entropy -act_dim."""
        target_entropy = -float(self.act_dim)
        return -torch.mean(self.log_alpha
                           * (new_logp + target_entropy).detach())

    def loss(self, b, noise):
        """(total, stats) on device tensors."""
        obs, acts = b[SampleBatch.OBS], b["raw_actions"]
        target_q = self._target_q(b, noise["next"])
        q1, q2 = self.model.q(obs, acts)
        critic_loss = torch.mean((q1 - target_q) ** 2
                                 + (q2 - target_q) ** 2)
        _, _, new_logp, min_q = self._actor_terms(obs, noise["new"])
        actor_loss = torch.mean(
            torch.exp(self.log_alpha.detach()) * new_logp - min_q)
        total = critic_loss + actor_loss + self._alpha_loss(new_logp)
        return total, {"critic_loss": critic_loss,
                       "actor_loss": actor_loss,
                       "alpha": torch.exp(self.log_alpha),
                       "mean_q": torch.mean(q1)}

    def _trainables(self):
        return [*self.model.parameters(), self.log_alpha]

    def _loss_and_grads(self, batch, noise):
        b = to_device_batch(batch, self.device, self.loss_columns)
        if noise is None:
            noise = self.draw_noise(batch.count)
        noise = {k: noise_tensor(v, self.device) for k, v in noise.items()}
        self.optimizer.zero_grad(set_to_none=True)
        total, stats = self.loss(b, noise)
        grads = backward_grads(self._trainables(), total)
        stats = dict(stats)
        stats["total_loss"] = total
        return grads, stats

    def learn_on_batch(self, batch, noise: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, float]:
        """One update; ``noise`` (as ``draw_noise`` makes it, arrays or
        tensors) replaces the policy's own draws."""
        _, stats = self._loss_and_grads(batch, noise)
        self.optimizer.step()
        polyak_update(self.target_model, self.model,
                      self.config.get("tau", 0.005))
        self.global_timestep += batch.count
        return stats_to_host(stats)

    def compute_gradients(self, batch, noise=None):
        """(host-numpy grads by param name and ``log_alpha``, stats) of
        one update's loss; nothing is stepped."""
        grads, stats = self._loss_and_grads(batch, noise)
        host = grads_to_host(self.model, grads[:-1])
        host["log_alpha"] = grads[-1].detach().cpu().numpy()
        self.optimizer.zero_grad(set_to_none=True)
        return host, stats_to_host(stats)

    # ---- weights / state ----

    def get_weights(self):
        return weights_of(self.model)

    def set_weights(self, weights):
        load_weights(self.model, weights)

    def get_state(self):
        return {"weights": self.get_weights(),
                "target": weights_of(self.target_model),
                "log_alpha": float(self.log_alpha.detach()),
                "opt_state": host_copy(self.optimizer.state_dict()),
                "global_timestep": self.global_timestep}

    def set_state(self, state):
        self.set_weights(state["weights"])
        load_weights(self.target_model, state["target"])
        with torch.no_grad():
            self.log_alpha.fill_(float(state["log_alpha"]))
        self.optimizer.load_state_dict(host_copy(state["opt_state"]))
        self.global_timestep = state.get("global_timestep", 0)


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self._config.update({
            "lr": 3e-4, "tau": 0.005,
            "replay_buffer_capacity": 100_000,
            "learning_starts": 256,
            "train_batch_size": 256,
            "rollout_fragment_length": 1,
            "training_intensity": 1,
        })


def replay_training_step(algo) -> Dict[str, Any]:
    """SAC's and DDPG's iteration: one sample, ``replay.add``, then
    ``training_intensity`` updates on uniform draws once the buffer
    holds ``learning_starts`` rows; ``timers`` splits its host time."""
    cfg = algo.config
    policy = algo.workers.local_worker.policy
    t0 = time.perf_counter()
    batch = synchronous_parallel_sample(algo.workers)
    t1 = time.perf_counter()
    algo._timesteps_total += batch.count
    algo.replay.add(batch)
    replay_s = time.perf_counter() - t1
    learn_s = 0.0
    stats: Dict[str, float] = {}
    if len(algo.replay) >= cfg["learning_starts"]:
        for _ in range(max(1, cfg.get("training_intensity", 1))):
            t2 = time.perf_counter()
            train = algo.replay.sample(cfg["train_batch_size"])
            t3 = time.perf_counter()
            stats = policy.learn_on_batch(train)
            replay_s += t3 - t2
            learn_s += time.perf_counter() - t3
        algo.workers.sync_weights()
    stats.pop("td_errors", None)
    return {"num_env_steps_sampled_this_iter": batch.count,
            "replay_size": len(algo.replay),
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": (t1 - t0) * 1e3,
                       "replay_time_ms": replay_s * 1e3,
                       "learn_time_ms": learn_s * 1e3}}


class SAC(Algorithm):
    _policy_cls = SACPolicy
    _default_config_cls = SACConfig

    def setup(self, config):
        super().setup(config)
        self.replay = ReplayBuffer(
            self.config["replay_buffer_capacity"],
            seed=self.config.get("seed"))

    def training_step(self) -> Dict[str, Any]:
        return replay_training_step(self)
