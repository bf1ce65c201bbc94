"""SlateQ — slate recommendation Q-learning with per-item decomposition.

Reference analogue: rllib/algorithms/slateq/ (slateq.py,
slateq_tf_policy.py; Ie et al. 2019 "SlateQ: A Tractable Decomposition
for Reinforcement Learning with Recommendation Sets"): the slate
Q-value decomposes over items via the user's conditional choice model,

    Q(s, A) = sum_{i in A} P(click i | s, A) * q(s, i),

so only per-item q-values are learned (SARSA on the clicked item) and
slate optimization reduces to a top-k ranking — no combinatorial action
space. The environment is a RecSim-style interest-evolution simulator
(reference: recsim wrappers in rllib/examples/env/recommender_system*).

Counterpart of ``ray_tpu/rllib/algorithms/slateq.py`` with the same
env, net, update and defaults:

- ``InterestEvolutionEnv`` is a numpy copy (same draws);
- ``_ItemQNet``: ``Dense_0`` / ``Dense_1`` (``hidden``, ReLU) ->
  ``Dense_2`` (``num_docs``), ``nn.Linear``s initialised as flax's
  ``Dense`` (lecun-normal kernels, zero biases), on ``config["device"]``
  ("cuda" unless the caller asks for "cpu"); the target is a copy;
- ``_act`` draws ``random()`` first, then ``choice(..., replace=False)``
  from the algorithm's numpy RNG, and runs the forward only when greedy;
  the slate is the host's ``argsort`` of v(s, i) * max(q(s, i), 0);
- one update is one Adam step (no clip) on the clicked rows' squared
  error against the MNL-weighted target of the target net.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent sampling (the env loop and the fragment's replay add),
drawing train batches and learning.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.algorithms.sac import init_dense_
from ray_tpu_torch.rllib.policy import (backward_grads, policy_device,
                                        stats_to_host, to_device_batch)
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class InterestEvolutionEnv:
    """RecSim-class user simulator (reference analogue:
    recsim interest_evolution): ``num_docs`` candidate documents with
    fixed topic vectors; the user's interest vector drifts toward
    clicked topics; the conditional choice model is multinomial-logit
    over the slate plus a no-click option. Observation = user interest
    (the doc corpus is static and known to the agent via the env)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        cfg = config or {}
        self.num_docs = int(cfg.get("num_docs", 20))
        self.slate_size = int(cfg.get("slate_size", 3))
        self.num_topics = int(cfg.get("num_topics", 6))
        self.horizon = int(cfg.get("horizon", 20))
        self.no_click_mass = float(cfg.get("no_click_mass", 1.0))
        self.interest_step = float(cfg.get("interest_step", 0.2))
        rng = np.random.default_rng(cfg.get("doc_seed", 0))
        # fixed corpus: unit topic vectors + scalar quality (engagement)
        t = rng.normal(size=(self.num_docs, self.num_topics))
        self.doc_topics = (t / np.linalg.norm(t, axis=1, keepdims=True)
                           ).astype(np.float32)
        self.doc_quality = rng.uniform(
            0.2, 1.0, self.num_docs).astype(np.float32)
        self._rng = np.random.default_rng()
        self._interest: Optional[np.ndarray] = None
        self._t = 0

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        v = self._rng.normal(size=self.num_topics)
        self._interest = (v / np.linalg.norm(v)).astype(np.float32)
        self._t = 0
        return self._interest.copy(), {}

    def choice_scores(self, interest: np.ndarray) -> np.ndarray:
        """MNL attractiveness v(s, i) for every doc (the user model —
        SlateQ assumes the choice model is known or separately
        estimated, Ie et al. §4)."""
        return np.exp(self.doc_topics @ interest)

    def step(self, slate) -> Tuple[np.ndarray, float, bool, bool, dict]:
        slate = np.asarray(slate, np.int64)
        scores = self.choice_scores(self._interest)[slate]
        probs = np.concatenate([scores, [self.no_click_mass]])
        probs = probs / probs.sum()
        pick = self._rng.choice(len(slate) + 1, p=probs)
        reward, clicked = 0.0, -1
        if pick < len(slate):
            clicked = int(slate[pick])
            reward = float(self.doc_quality[clicked])
            # interest drifts toward the clicked topic
            ni = (1 - self.interest_step) * self._interest + \
                self.interest_step * self.doc_topics[clicked]
            self._interest = (ni / np.linalg.norm(ni)).astype(np.float32)
        self._t += 1
        return (self._interest.copy(), reward, False,
                self._t >= self.horizon, {"clicked": clicked})


class _ItemQNet(nn.Module):
    """q(s, i) for all docs at once: interest -> (num_docs,) values."""

    def __init__(self, num_topics: int, num_docs: int, hidden: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(num_topics, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, num_docs)

    def forward(self, interest):
        x = F.relu(self.Dense_0(interest))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class SlateQConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SlateQ)
        self._config.update({
            "env": "interest_evolution",
            "env_config": {},
            "lr": 1e-3,
            "gamma": 0.95,
            "rollout_fragment_length": 200,
            "train_batch_size": 128,
            "learning_starts": 500,
            "replay_buffer_capacity": 50_000,
            "target_network_update_freq": 500,
            "initial_epsilon": 1.0,
            "final_epsilon": 0.05,
            "epsilon_timesteps": 4_000,
            "training_intensity": 4,
            "hidden": 64,
        })


class SlateQ(LocalAlgorithm):
    """SlateQ with SARSA-on-clicked-item updates (reference:
    slateq.py; the decomposed target is
    r + gamma * sum_j P(click j | s', A') q(s', j))."""

    _default_config_cls = SlateQConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        env_cfg = cfg.get("env_config") or {}
        if cfg["env"] != "interest_evolution":
            raise ValueError("SlateQ ships the interest_evolution sim")
        self.env = InterestEvolutionEnv(env_cfg)
        self.k = self.env.slate_size
        self.num_docs = self.env.num_docs

        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        self.model = init_dense_(
            _ItemQNet(self.env.num_topics, self.num_docs, cfg["hidden"]),
            init_gen).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg["lr"], eps=1e-8)
        self.replay = ReplayBuffer(cfg["replay_buffer_capacity"],
                                   seed=cfg.get("seed"))
        self._init_local_state()
        self._obs, _ = self.env.reset(seed=cfg.get("seed"))
        self._episode_reward = 0.0

    # ---- slate construction ----

    def _build_slate(self, q_vals: np.ndarray,
                     interest: np.ndarray) -> np.ndarray:
        """Optimal slate under MNL: for top-k selection it suffices to
        rank items by v(s,i) * q(s,i) (Ie et al. Prop. 2 — the
        optimal slate is the top-k of the attractiveness-weighted
        q-values when the null mass is fixed)."""
        v = self.env.choice_scores(interest)
        return np.argsort(-(v * np.maximum(q_vals, 0.0)))[:self.k]

    @torch.no_grad()
    def _act(self, interest: np.ndarray, epsilon: float) -> np.ndarray:
        if self._np_rng.random() < epsilon:
            return self._np_rng.choice(self.num_docs, self.k,
                                       replace=False)
        x = torch.as_tensor(np.asarray(interest, np.float32)[None],
                            device=self.device)
        q = self.model(x)[0].cpu().numpy()
        return self._build_slate(q, interest)

    # ---- update ----

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        """One Adam step on a replayed batch (numpy columns: ``obs``,
        ``next_obs``, ``clicked`` (-1 = no click), ``rewards``,
        ``dones``, ``next_slate`` (the NEXT slate, SARSA),
        ``next_scores`` (its MNL v(s', j))). Returns the stats as
        tensors on the device."""
        b = to_device_batch(batch, self.device)
        gamma = self.config["gamma"]
        clicked = b["clicked"].long()
        dones = b["dones"].to(torch.float32)
        with torch.no_grad():
            q_next = self.target_model(b["next_obs"])
            q_sel = torch.gather(q_next, 1, b["next_slate"].long())
            # P(click j | s', A') over the next slate + null mass
            null = torch.full((q_sel.shape[0], 1), self.env.no_click_mass,
                              device=self.device)
            probs = torch.cat([b["next_scores"], null], dim=1)
            probs = probs / probs.sum(dim=1, keepdim=True)
            v_next = torch.sum(probs[:, :-1] * q_sel, dim=1)
            target = b["rewards"] + gamma * (1.0 - dones) * v_next

        has_click = (clicked >= 0).to(torch.float32)
        safe_idx = torch.clamp(clicked, min=0)
        q = self.model(b["obs"])
        q_clicked = torch.gather(q, 1, safe_idx[:, None])[:, 0]
        # only clicked transitions update item q-values (SlateQ's
        # SARSA decomposition learns item-level LTV from clicks)
        err = (q_clicked - target) * has_click
        denom = torch.clamp(has_click.sum(), min=1.0)
        loss = torch.sum(err ** 2) / denom
        self.optimizer.zero_grad(set_to_none=True)
        backward_grads(list(self.model.parameters()), loss)
        self.optimizer.step()
        return {"loss": loss.detach(),
                "mean_q_clicked": torch.mean(q_clicked.detach()),
                "click_fraction": torch.mean(has_click)}

    # ---- env loop ----

    def _collect(self, num_steps: int, epsilon: float) -> int:
        rows: Dict[str, list] = {k: [] for k in (
            "obs", "next_obs", "clicked", "rewards", "dones",
            "next_slate", "next_scores")}
        for _ in range(num_steps):
            slate = self._act(self._obs, epsilon)
            nobs, r, term, trunc, info = self.env.step(slate)
            done = term or trunc
            # SARSA: the NEXT slate under the current policy at s'
            nslate = self._act(nobs, epsilon)
            nscores = self.env.choice_scores(nobs)[nslate]
            rows["obs"].append(self._obs)
            rows["next_obs"].append(nobs)
            rows["clicked"].append(np.int32(info["clicked"]))
            rows["rewards"].append(np.float32(r))
            rows["dones"].append(term)  # horizon truncation bootstraps
            rows["next_slate"].append(nslate.astype(np.int32))
            rows["next_scores"].append(nscores.astype(np.float32))
            self._episode_reward += r
            if done:
                self._episode_reward_window.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nobs
        self.replay.add(SampleBatch(
            {k: np.stack(v) for k, v in rows.items()}))
        return num_steps

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
            lambda obs: self._act(obs, epsilon=0.0), num_episodes)
        self._obs, _ = self.env.reset()
        self._episode_reward = 0.0
        return out

    def random_baseline(self, num_episodes: int = 20,
                        seed: int = 123) -> float:
        """Mean episode engagement of uniformly random slates."""
        rng = np.random.default_rng(seed)
        totals = []
        for ep in range(num_episodes):
            self.env.reset(seed=seed + ep)
            total = 0.0
            for _ in range(self.env.horizon):
                slate = rng.choice(self.num_docs, self.k, replace=False)
                _, r, _, trunc, _ = self.env.step(slate)
                total += r
                if trunc:
                    break
            totals.append(total)
        return float(np.mean(totals))
