"""R2D2 — recurrent replay distributed DQN (Kapturowski et al. 2019).

Reference analogue: rllib/algorithms/r2d2/ (r2d2.py,
r2d2_torch_policy.py): an LSTM Q-network trained on replayed
SEQUENCES with burn-in — the first ``burn_in`` steps of each sampled
sequence only warm up the recurrent state (no gradient), the remainder
takes double-Q TD loss against a target network. This implementation
uses the paper's zero-start-state + burn-in strategy and stores whole
episodes in a sequence replay buffer.

Counterpart of ``ray_tpu/rllib/algorithms/r2d2.py`` with the same net,
loss, update and defaults:

- ``_RecurrentQNet``: ``enc`` (Dense, ReLU) -> ``cell`` -> ``head``;
  the cell is flax's ``OptimizedLSTMCell``: gates i, f, g, o; input
  kernels ``ii``/``if``/``ig``/``io`` without bias, hidden kernels
  ``hi``/``hf``/``hg``/``ho`` with bias; c' = f c + i g, h' = o tanh(c');
  the carry is (c, h). ``unroll`` projects the whole sequence's inputs
  at once, then loops over time (flax's ``scan``);
- the update: the burn-in mask, the target's and the double-Q argmax
  unrolls of ``next_obs`` from a zero carry with no gradient, the loss
  Σ(td² mask) / max(Σ mask, 1), optax's ``clip_by_global_norm(10)``
  (``clip_and_step``), then Adam;
- acting advances the carry before the epsilon draw, even on a random
  action; epsilon and the replay's draws are numpy, in JAX's order;
  episodes enter the replay only when they end;
- the net lives on ``config["device"]`` ("cuda" unless the caller asks
  for "cpu"); the carry stays there between env steps.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent sampling, drawing train sequences and learning.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.env import Discrete, make_env
from ray_tpu_torch.rllib.models import _lecun_normal_
from ray_tpu_torch.rllib.policy import (backward_grads, clip_and_step,
                                        policy_device, stats_to_host,
                                        to_device_batch)

Carry = Tuple[torch.Tensor, torch.Tensor]


class _LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` with its param names."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for g in self.GATES:
            self.add_module(f"i{g}", nn.Linear(in_features, features,
                                               bias=False))
            self.add_module(f"h{g}", nn.Linear(features, features))

    def input_proj(self, x):
        """x @ [ii | if | ig | io]: (..., 4 features)."""
        return F.linear(x, torch.cat(
            [self._modules[f"i{g}"].weight for g in self.GATES]))

    def hidden_params(self):
        return (torch.cat([self._modules[f"h{g}"].weight
                           for g in self.GATES]),
                torch.cat([self._modules[f"h{g}"].bias for g in self.GATES]))

    @staticmethod
    def step(carry: Carry, x_proj, w_h, b_h) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        i, f, g, o = torch.chunk(F.linear(h, w_h, b_h) + x_proj, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's laws: lecun-normal input kernels, orthogonal hidden
        kernels, zero biases."""
        for g in self.GATES:
            _lecun_normal_(self._modules[f"i{g}"].weight, generator)
            nn.init.orthogonal_(self._modules[f"h{g}"].weight,
                                generator=generator)
            self._modules[f"h{g}"].bias.zero_()
        return self


class _RecurrentQNet(nn.Module):
    """Dense → LSTM → Q-head; call modes: ``step`` (one env step with
    carry) and ``unroll`` (a loop over a (B, T) sequence)."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 lstm_size: int = 64):
        super().__init__()
        self.lstm_size = lstm_size
        self.enc = nn.Linear(obs_dim, hidden)
        self.cell = _LSTMCell(hidden, lstm_size)
        self.head = nn.Linear(lstm_size, num_actions)

    def step(self, carry: Carry, obs) -> Tuple[Carry, torch.Tensor]:
        x = self.cell.input_proj(F.relu(self.enc(obs)))
        carry, y = self.cell.step(carry, x, *self.cell.hidden_params())
        return carry, self.head(y)

    def unroll(self, carry: Carry, obs_seq) -> Tuple[Carry, torch.Tensor]:
        """obs_seq (B, T, do) → (carry, Q (B, T, A))."""
        x = self.cell.input_proj(F.relu(self.enc(obs_seq)))
        w_h, b_h = self.cell.hidden_params()
        ys = []
        for t in range(x.shape[1]):
            carry, y = self.cell.step(carry, x[:, t], w_h, b_h)
            ys.append(y)
        return carry, self.head(torch.stack(ys, dim=1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for lin in (self.enc, self.head):
            _lecun_normal_(lin.weight, generator)
            lin.bias.zero_()
        self.cell.init_weights(generator)
        return self


def zero_carry(batch: int, lstm_size: int, device="cpu") -> Carry:
    """LSTM (c, h) zero state — the paper's zero-start-state strategy;
    burn-in warms it up before the loss applies."""
    return (torch.zeros(batch, lstm_size, device=device),
            torch.zeros(batch, lstm_size, device=device))


class _SequenceReplay:
    """Episode store sampling fixed-length subsequences with a
    validity mask (short episodes are zero-padded). A numpy copy of the
    JAX package's: the same draws in the same order."""

    def __init__(self, capacity_episodes: int, seq_len: int, seed=None):
        self.capacity = capacity_episodes
        self.seq_len = seq_len
        self._episodes: List[Dict[str, np.ndarray]] = []
        self._rng = np.random.default_rng(seed)
        self.num_steps = 0

    def add_episode(self, ep: Dict[str, np.ndarray]):
        self._episodes.append(ep)
        self.num_steps += len(ep["rewards"])
        while len(self._episodes) > self.capacity:
            old = self._episodes.pop(0)
            self.num_steps -= len(old["rewards"])

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        T = self.seq_len
        out: Dict[str, list] = {k: [] for k in
                                ("obs", "actions", "rewards", "dones",
                                 "next_obs", "mask")}
        for _ in range(batch):
            ep = self._episodes[self._rng.integers(len(self._episodes))]
            n = len(ep["rewards"])
            start = int(self._rng.integers(0, max(1, n - T + 1)))
            end = min(start + T, n)
            pad = T - (end - start)

            def cut(key, feat_shape):
                seq = ep[key][start:end]
                if pad:
                    seq = np.concatenate(
                        [seq, np.zeros((pad, *feat_shape),
                                       seq.dtype)], axis=0)
                return seq

            do = ep["obs"].shape[1:]
            out["obs"].append(cut("obs", do))
            out["next_obs"].append(cut("next_obs", do))
            out["actions"].append(cut("actions", ()))
            out["rewards"].append(cut("rewards", ()))
            out["dones"].append(cut("dones", ()))
            m = np.zeros(T, np.float32)
            m[:end - start] = 1.0
            out["mask"].append(m)
        return {k: np.stack(v) for k, v in out.items()}


class R2D2Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or R2D2)
        self._config.update({
            "lr": 5e-4,
            "lstm_size": 64,
            "agent_hidden": 64,
            "double_q": True,
            "seq_len": 20,
            "burn_in": 4,
            "replay_capacity_episodes": 500,
            "learning_starts": 500,   # env steps
            "train_batch_size": 32,   # sequences per update
            "rollout_fragment_length": 64,
            "target_network_update_freq": 300,
            "initial_epsilon": 1.0,
            "final_epsilon": 0.05,
            "epsilon_timesteps": 5_000,
            "training_intensity": 4,
        })


class R2D2(LocalAlgorithm):
    _default_config_cls = R2D2Config

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        self.env = make_env(cfg["env"], cfg.get("env_config"))
        if not isinstance(self.env.action_space, Discrete):
            raise ValueError("R2D2 is discrete-action only")
        self.n_actions = self.env.action_space.n
        self.obs_dim = int(np.prod(self.env.observation_space.shape))

        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        self.model = _RecurrentQNet(
            self.obs_dim, self.n_actions, cfg["agent_hidden"],
            cfg["lstm_size"]).init_weights(init_gen).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg["lr"], eps=1e-8)

        self.replay = _SequenceReplay(cfg["replay_capacity_episodes"],
                                      cfg["seq_len"], cfg.get("seed"))
        self._init_local_state()
        self._reset_episode(seed=cfg.get("seed"))

    def _zero_carry(self, batch: int = 1) -> Carry:
        return zero_carry(batch, self.config["lstm_size"], self.device)

    def _reset_episode(self, seed=None):
        self._obs, _ = self.env.reset(seed=seed)
        self._carry = self._zero_carry()
        self._ep_rows: Dict[str, list] = {k: [] for k in
                                          ("obs", "actions", "rewards",
                                           "dones", "next_obs")}
        self._ep_reward = 0.0

    # ---- update ----

    def _update(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on sampled sequences (``_SequenceReplay
        .sample``'s columns). Returns the stats as tensors on the
        device; the clipped grads stay in the params' ``.grad``."""
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        burn = cfg["burn_in"]
        b = to_device_batch(batch, self.device)
        obs, nobs = b["obs"], b["next_obs"]      # (B, T, do)
        acts = b["actions"].long()
        not_done = 1.0 - b["dones"].to(torch.float32)
        # gradient (and TD) only after the burn-in prefix
        mask = b["mask"].clone()
        mask[:, :burn] = 0.0
        denom = torch.clamp(mask.sum(), min=1.0)
        zero = self._zero_carry(obs.shape[0])

        with torch.no_grad():
            tq_next = self.target_model.unroll(zero, nobs)[1]
            if cfg.get("double_q", True):
                best = torch.argmax(self.model.unroll(zero, nobs)[1], dim=-1)
            else:
                best = torch.argmax(tq_next, dim=-1)
            q_next = torch.gather(tq_next, -1, best[..., None])[..., 0]
            y = b["rewards"] + gamma * not_done * q_next

        q = self.model.unroll(zero, obs)[1]
        q_sel = torch.gather(q, -1, acts[..., None])[..., 0]
        td = (q_sel - y) * mask
        loss = torch.sum(td ** 2) / denom
        self.optimizer.zero_grad(set_to_none=True)
        grads = backward_grads(list(self.model.parameters()), loss)
        clip_and_step(self.optimizer, grads, 10.0)
        q_sel, td = q_sel.detach(), td.detach()
        return {"mean_q": torch.sum(q_sel * mask) / denom,
                "mean_td_error": torch.sum(torch.abs(td)) / denom,
                "loss": loss.detach()}

    # ---- acting ----

    @torch.no_grad()
    def _act(self, obs, epsilon: float) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32)[None],
                            device=self.device)
        self._carry, q = self.model.step(self._carry, x)
        if self._np_rng.random() < epsilon:
            return int(self._np_rng.integers(self.n_actions))
        return int(np.argmax(q.cpu().numpy()[0]))

    def _collect(self, num_steps: int, epsilon: float) -> int:
        for _ in range(num_steps):
            a = self._act(self._obs, epsilon)
            nobs, r, term, trunc, _ = self.env.step(a)
            rows = self._ep_rows
            rows["obs"].append(np.asarray(self._obs, np.float32))
            rows["actions"].append(np.int64(a))
            rows["rewards"].append(np.float32(r))
            rows["dones"].append(bool(term))
            rows["next_obs"].append(np.asarray(nobs, np.float32))
            self._ep_reward += float(r)
            if term or trunc:
                self.replay.add_episode(
                    {k: np.stack(v) if np.asarray(v[0]).ndim
                     else np.asarray(v) for k, v in rows.items()})
                self._episode_reward_window.append(self._ep_reward)
                self._reset_episode()
            else:
                self._obs = nobs
        return num_steps

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
        if self.replay.num_steps >= cfg["learning_starts"]:
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
            "replay_episodes": len(self.replay._episodes),
            "replay_steps": self.replay.num_steps,
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": sample_s * 1e3,
                       "replay_time_ms": replay_s * 1e3,
                       "learn_time_ms": learn_s * 1e3},
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        carry_box = [self._zero_carry()]

        def reset_carry():
            carry_box[0] = self._zero_carry()

        @torch.no_grad()
        def act(obs):
            x = torch.as_tensor(np.asarray(obs, np.float32)[None],
                                device=self.device)
            carry_box[0], q = self.model.step(carry_box[0], x)
            return int(np.argmax(q.cpu().numpy()[0]))

        out = self._eval_episodes(act, num_episodes,
                                  on_reset=reset_carry)
        self._reset_episode()
        return out
