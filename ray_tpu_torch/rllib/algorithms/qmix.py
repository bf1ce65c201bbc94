"""QMIX — monotonic value-function factorisation for cooperative MARL.

Reference analogue: rllib/algorithms/qmix/ (qmix.py, qmix_policy.py,
model.py QMixer; Rashid et al. 2018): per-agent Q-networks (parameters
shared across agents) whose chosen-action values are mixed into a team
Q_tot by a hypernetwork-generated MONOTONIC mixing net conditioned on
the global state; trained end-to-end by TD on the team reward.

Counterpart of ``ray_tpu/rllib/algorithms/qmix.py`` with the same env,
nets, update and defaults:

- ``CooperativeCartPole`` (registered as ``"CoopCartPole"`` at import)
  ends the episode when any pole falls and gives every agent the team
  reward;
- ``_AgentQNet`` (``Dense_0``/``Dense_1`` 64 ReLU -> ``Dense_2``) and
  ``_QMixer`` (flax's names ``hyper_w1``, ``hyper_b1``, ``hyper_w2``,
  ``hyper_b2_h``, ``hyper_b2_out``; ELU with alpha 1) live in one
  ``_QMixNets`` (``agent``, ``mixer``: the JAX params tree's keys) on
  ``config["device"]`` ("cuda" unless the caller asks for "cpu"); the
  target is a copy, synced every ``target_network_update_freq`` steps;
- one update: the state is the agents' obs concatenated, the double-Q
  target (online argmax, the target's value) under no grad, the mean of
  td², ONE ``clip_by_global_norm(10)`` over agent and mixer together,
  then Adam;
- acting runs the forward, then draws ``integers(n_actions, n)`` and
  ``random(n)`` from the algorithm's numpy RNG, even at epsilon 0.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent sampling, drawing train batches and learning.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.algorithms.sac import init_dense_
from ray_tpu_torch.rllib.env import (Discrete, MultiAgentCartPole,
                                     MultiAgentEnv, _BUILTIN_ENVS, make_env)
from ray_tpu_torch.rllib.policy import (backward_grads, clip_and_step,
                                        policy_device, stats_to_host,
                                        to_device_batch)
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer


class CooperativeCartPole(MultiAgentCartPole):
    """Team CartPole: episode ends when ANY pole falls; every agent
    receives the TEAM reward (mean of alive rewards) — a minimal fully
    cooperative env for value-decomposition tests (reference analogue:
    the grouped TwoStepGame in rllib/examples/env/two_step_game.py).
    Construction/reset come from MultiAgentCartPole; only the
    cooperative step() differs."""

    def step(self, action_dict: Dict[Any, Any]):
        obs, rews, terms, truncs, infos = {}, {}, {}, {}, {}
        any_term, any_trunc, team_r = False, False, 0.0
        for aid, a in action_dict.items():
            o, r, term, trunc, info = self._envs[aid].step(a)
            obs[aid], infos[aid] = o, info
            team_r += float(r)
            any_term |= term
            any_trunc |= trunc
        team_r /= max(1, len(action_dict))
        for aid in action_dict:
            rews[aid] = team_r
            terms[aid] = any_term
            truncs[aid] = any_trunc
        terms["__all__"] = any_term
        truncs["__all__"] = any_trunc
        return obs, rews, terms, truncs, infos


_BUILTIN_ENVS["CoopCartPole"] = CooperativeCartPole


class _AgentQNet(nn.Module):
    """Shared per-agent Q-network."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(obs_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, num_actions)

    def forward(self, obs):
        x = F.relu(self.Dense_0(obs))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class _QMixer(nn.Module):
    """Monotonic mixer: state-conditioned hypernetworks emit
    NON-NEGATIVE (abs) weights so ∂Q_tot/∂Q_i ≥ 0 (reference:
    qmix/model.py QMixer)."""

    def __init__(self, n_agents: int, state_dim: int, embed: int = 32):
        super().__init__()
        self.n_agents, self.embed = n_agents, embed
        self.hyper_w1 = nn.Linear(state_dim, n_agents * embed)
        self.hyper_b1 = nn.Linear(state_dim, embed)
        self.hyper_w2 = nn.Linear(state_dim, embed)
        self.hyper_b2_h = nn.Linear(state_dim, embed)
        self.hyper_b2_out = nn.Linear(embed, 1)

    def forward(self, agent_qs, state):
        # agent_qs: (B, n), state: (B, ds)
        b = agent_qs.shape[0]
        w1 = torch.abs(self.hyper_w1(state)).reshape(b, self.n_agents,
                                                     self.embed)
        b1 = self.hyper_b1(state)
        hidden = F.elu(torch.einsum("bn,bne->be", agent_qs, w1) + b1)
        w2 = torch.abs(self.hyper_w2(state))
        b2 = self.hyper_b2_out(F.relu(self.hyper_b2_h(state)))
        return torch.sum(hidden * w2, dim=-1) + b2[..., 0]  # (B,)


class _QMixNets(nn.Module):
    """The agent net and the mixer: the JAX params tree's ``agent`` and
    ``mixer``."""

    def __init__(self, obs_dim: int, n_agents: int, n_actions: int,
                 agent_hidden: int = 64, mixer_embed: int = 32):
        super().__init__()
        self.n_actions = n_actions
        self.agent = _AgentQNet(obs_dim, n_actions, agent_hidden)
        self.mixer = _QMixer(n_agents, obs_dim * n_agents, mixer_embed)

    def q(self, obs):
        """obs (B, n, do) -> per-agent Q (B, n, A)."""
        b, n, do = obs.shape
        return self.agent(obs.reshape(b * n, do)).reshape(b, n,
                                                          self.n_actions)


class QMixConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or QMix)
        self._config.update({
            "env": "CoopCartPole",
            "lr": 5e-4,
            "mixer_embed": 32,
            "agent_hidden": 64,
            "double_q": True,
            "replay_buffer_capacity": 50_000,
            "learning_starts": 500,
            "train_batch_size": 64,
            "rollout_fragment_length": 64,
            "target_network_update_freq": 400,
            "initial_epsilon": 1.0,
            "final_epsilon": 0.05,
            "epsilon_timesteps": 8_000,
            "training_intensity": 2,
        })


class QMix(LocalAlgorithm):
    _default_config_cls = QMixConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        self.env = make_env(cfg["env"], cfg.get("env_config"))
        if not isinstance(self.env, MultiAgentEnv):
            raise ValueError("QMIX needs a cooperative MultiAgentEnv")
        if not isinstance(self.env.action_space, Discrete):
            raise ValueError("QMIX is discrete-action only")
        self.agent_ids = list(self.env.agent_ids)
        self.n_agents = len(self.agent_ids)
        self.n_actions = self.env.action_space.n
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.state_dim = self.obs_dim * self.n_agents  # concat of obs

        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        self.model = init_dense_(
            _QMixNets(self.obs_dim, self.n_agents, self.n_actions,
                      cfg["agent_hidden"], cfg["mixer_embed"]),
            init_gen).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg["lr"], eps=1e-8)

        self.replay = ReplayBuffer(cfg["replay_buffer_capacity"],
                                   seed=cfg.get("seed"))
        self._init_local_state()
        self._obs, _ = self.env.reset(seed=cfg.get("seed"))
        self._episode_reward = 0.0

    # ---- update ----

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on a replayed batch (numpy columns
        ``obs``, ``next_obs`` (B, n, do), ``actions`` (B, n),
        ``rewards``, ``dones`` (B,)). Returns the stats as tensors on the
        device; the clipped grads stay in the params' ``.grad``."""
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        b = to_device_batch(batch, self.device, (
            "obs", "next_obs", "actions", "rewards", "dones"))
        obs, nobs = b["obs"], b["next_obs"]
        acts = b["actions"].long()
        not_done = 1.0 - b["dones"].to(torch.float32)
        n = obs.shape[0]
        state = obs.reshape(n, -1)
        next_state = nobs.reshape(n, -1)

        with torch.no_grad():
            # per-agent best next Q (double-Q: the online argmax)
            tq_next = self.target_model.q(nobs)
            if cfg.get("double_q", True):
                best = torch.argmax(self.model.q(nobs), dim=-1)
            else:
                best = torch.argmax(tq_next, dim=-1)
            q_next = torch.gather(tq_next, -1, best[..., None])[..., 0]
            qtot_next = self.target_model.mixer(q_next, next_state)
            y = b["rewards"] + gamma * not_done * qtot_next

        q = self.model.q(obs)
        q_sel = torch.gather(q, -1, acts[..., None])[..., 0]  # (B, n)
        qtot = self.model.mixer(q_sel, state)
        td = qtot - y
        loss = torch.mean(td ** 2)
        self.optimizer.zero_grad(set_to_none=True)
        grads = backward_grads(list(self.model.parameters()), loss)
        clip_and_step(self.optimizer, grads, 10.0)
        td = td.detach()
        return {"mean_qtot": torch.mean(qtot.detach()),
                "mean_td_error": torch.mean(torch.abs(td)),
                "loss": loss.detach()}

    # ---- acting / collection ----

    @torch.no_grad()
    def _joint_actions(self, obs_dict, epsilon: float):
        obs = np.stack([obs_dict[a] for a in self.agent_ids])[None]
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        q = self.model.q(x)[0].cpu().numpy()  # (n, A)
        greedy = np.argmax(q, axis=-1)
        rand = self._np_rng.integers(self.n_actions, size=self.n_agents)
        pick = self._np_rng.random(self.n_agents) < epsilon
        acts = np.where(pick, rand, greedy)
        return {a: int(acts[i]) for i, a in enumerate(self.agent_ids)}

    def _collect(self, num_steps: int, epsilon: float) -> int:
        def act(obs_dict):
            acts = self._joint_actions(obs_dict, epsilon)
            stored = np.array([acts[a] for a in self.agent_ids],
                              np.int64)
            return acts, stored
        return self._collect_joint(act, num_steps)

    # ---- Trainable / Algorithm surface ----

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        t0 = time.perf_counter()
        n = self._collect(cfg["rollout_fragment_length"], eps)
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
            stats = stats_to_host(dev_stats)
            self._maybe_sync_target(n)
            learn_s += time.perf_counter() - t3
        return {
            "num_env_steps_sampled_this_iter": n,
            "epsilon": eps,
            "replay_size": len(self.replay),
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": sample_s * 1e3,
                       "replay_time_ms": replay_s * 1e3,
                       "learn_time_ms": learn_s * 1e3},
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        out = self._eval_episodes(
            lambda obs: self._joint_actions(obs, epsilon=0.0),
            num_episodes)
        # restore the training env stream; the interrupted episode's
        # partial reward must not leak into the next episode's metric
        self._obs, _ = self.env.reset()
        self._episode_reward = 0.0
        return out

    def compute_joint_actions(self, obs_dict):
        """Greedy joint action for deployment."""
        return self._joint_actions(obs_dict, epsilon=0.0)
