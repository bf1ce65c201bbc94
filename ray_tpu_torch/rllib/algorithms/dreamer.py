"""Dreamer (V1) — learned world model + actor-critic in imagination.

Reference analogue: rllib/algorithms/dreamer/ (dreamer.py,
dreamer_torch_policy.py, dreamer_model.py; Hafner et al. 2020): an RSSM
world model (deterministic GRU path + stochastic latent) trained on
replayed sequences by reconstruction + reward prediction + KL, and an
actor/value pair trained ENTIRELY on imagined latent rollouts with
lambda-returns, the actor by backprop THROUGH the learned dynamics
(reparameterized latents — no likelihood-ratio estimator).

Counterpart of ``ray_tpu/rllib/algorithms/dreamer.py`` with the same
nets, update, loop and defaults (vector observations, MLP encoder and
decoder). The nets keep flax's names, so the JAX trees load with
``models.params_from_flax`` (``dreamer_params_from_flax``), and live on
``config["device"]`` ("cuda" unless the caller asks for "cpu"):

- ``_GRUCell`` is flax's ``nn.GRUCell`` written out with its six Dense
  layers: ``ir``, ``iz``, ``in`` with bias, ``hr``, ``hz`` without,
  ``hn`` with; r = σ(ir x + hr h), z = σ(iz x + hz h), n = tanh(in x +
  r ⊙ hn h), h' = (1 - z) n + z h. (``torch.nn.GRUCell`` would carry r
  and z biases on the recurrent side that flax's cell has not.)
- One update is three Adams in JAX's order: the world model on its loss
  over ``observe``'s Python loop of T steps (the KL per element clamped
  at ``free_nats`` before its mean); then imagination from the
  PRE-update posterior features, detached, through the UPDATED world
  model; the actor on -mean(λ-returns), its grads taken by
  ``torch.autograd.grad`` over the actor's params alone (no ``.grad``
  lands on the world model or the value net); the value net on the
  detached features and returns of the actor's pass.
- The Gaussian draws that JAX takes from its keys come from one
  ``torch.Generator`` on the device through ``_draw_noise(kind)``:
  "filter" (z's [1, stoch], then the action's [1, act]) for each acting
  step, "update" (``observe``'s T [B, stoch] draws, then per imagined
  step the actor's [B·T, act] and the latent's [B·T, stoch]) for each
  update, so that a test can feed JAX's draws in JAX's order. The
  exploration noise and the sequence draws stay numpy
  (``self._np_rng``), in JAX's order.

``evaluate`` runs its own h/z stream on ``self.env`` but takes its
noise from the training stream and draws the (zero-scaled) exploration
normal from ``_np_rng``, as JAX does. The checkpoint holds the three
nets' weights as ``params`` and again as ``target_params`` and the three
Adams' state, not the episode store (as JAX's).

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent acting in the env, drawing sequences and updating.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import (AlgorithmConfig, LocalAlgorithm,
                                           evaluation_result)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.models import _lecun_normal_, params_from_flax
from ray_tpu_torch.rllib.policy import (host_copy, load_weights,
                                        policy_device, stats_to_host,
                                        weights_of)


def _mlp(sizes) -> nn.Sequential:
    """flax ``nn.Sequential([Dense, relu, Dense])``: layers 0 and 2."""
    return nn.Sequential(nn.Linear(sizes[0], sizes[1]), nn.ReLU(),
                         nn.Linear(sizes[1], sizes[2]))


class _GRUCell(nn.Module):
    """flax ``nn.GRUCell(features)`` with its six Dense layers."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_features, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class _RSSM(nn.Module):
    """h_t = GRU(h_{t-1}, [z_{t-1}, a_{t-1}]); prior p(z|h); posterior
    q(z|h, embed(obs))."""

    def __init__(self, act_dim: int, deter: int = 64, stoch: int = 8,
                 hidden: int = 64):
        super().__init__()
        self.gru = _GRUCell(hidden, deter)
        self.inp = nn.Linear(stoch + act_dim, hidden)
        self.prior_net = nn.Linear(deter, 2 * stoch)
        self.post_net = nn.Linear(deter + hidden, 2 * stoch)

    @staticmethod
    def _stats(net, x):
        mean, std = torch.chunk(net(x), 2, dim=-1)
        return mean, F.softplus(std) + 0.1

    def step_prior(self, h, z, a):
        x = F.relu(self.inp(torch.cat([z, a], -1)))
        h = self.gru(h, x)
        mean, std = self._stats(self.prior_net, h)
        return h, mean, std

    def posterior(self, h, embed):
        return self._stats(self.post_net, torch.cat([h, embed], -1))


class _WorldModel(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, deter: int = 64,
                 stoch: int = 8, hidden: int = 64):
        super().__init__()
        self.deter, self.stoch = deter, stoch
        self.rssm = _RSSM(act_dim, deter, stoch, hidden)
        self.encoder = _mlp((obs_dim, hidden, hidden))
        self.decoder = _mlp((deter + stoch, hidden, obs_dim))
        self.reward_head = _mlp((deter + stoch, hidden, 1))

    def observe(self, obs_seq, act_seq, noise):
        """obs_seq [B,T,do], act_seq [B,T,da] (act at t-1; zeros at 0),
        noise [T,B,stoch] (the posterior draws). Returns posterior
        features [B,T,deter+stoch] and the KL terms [B,T]."""
        b, t, _ = obs_seq.shape
        embed = self.encoder(obs_seq)
        h = obs_seq.new_zeros((b, self.deter))
        z = obs_seq.new_zeros((b, self.stoch))
        feats, kls = [], []
        for i in range(t):
            h, p_mean, p_std = self.rssm.step_prior(h, z, act_seq[:, i])
            q_mean, q_std = self.rssm.posterior(h, embed[:, i])
            z = q_mean + q_std * noise[i]
            kls.append(self._kl(q_mean, q_std, p_mean, p_std))
            feats.append(torch.cat([h, z], -1))
        return torch.stack(feats, 1), torch.stack(kls, 1)

    @staticmethod
    def _kl(qm, qs, pm, ps):
        return torch.sum(torch.log(ps / qs) + (qs ** 2 + (qm - pm) ** 2)
                         / (2 * ps ** 2) - 0.5, dim=-1)

    def decode(self, feat):
        return self.decoder(feat)

    def reward(self, feat):
        return self.reward_head(feat)[..., 0]

    def imagine_step(self, h, z, a, noise):
        h, mean, std = self.rssm.step_prior(h, z, a)
        return h, mean + std * noise


class _Actor(nn.Module):
    def __init__(self, feat_dim: int, act_dim: int, hidden: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(feat_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, act_dim)
        self.logstd = nn.Parameter(torch.full((act_dim,), -1.0))

    def forward(self, feat):
        x = F.relu(self.Dense_0(feat))
        return torch.tanh(self.Dense_1(x)), torch.exp(self.logstd)


class _Value(nn.Module):
    def __init__(self, feat_dim: int, hidden: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(feat_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, 1)

    def forward(self, feat):
        return self.Dense_1(F.relu(self.Dense_0(feat)))[..., 0]


@torch.no_grad()
def _init_flax_(module: nn.Module, generator: torch.Generator):
    """flax's laws: lecun-normal Dense kernels, orthogonal recurrent
    kernels (the GRU's ``h*``), zero biases; ``logstd`` keeps -1."""
    for mod in module.modules():
        if isinstance(mod, _GRUCell):
            for name in ("hr", "hz", "hn"):
                nn.init.orthogonal_(getattr(mod, name).weight,
                                    generator=generator)
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Linear):
            if name.rsplit(".", 1)[-1] not in ("hr", "hz", "hn"):
                _lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
    return module


def dreamer_params_from_flax(params: Mapping[str, Any], algo=None
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX Dreamer's ``params`` ({"wm", "actor", "value"}) -> the three
    nets' ``state_dict``s (``params_from_flax`` each: the GRU's six
    layers keep flax's names). With ``algo`` they are also loaded into
    its ``wm``, ``actor`` and ``value`` (strictly: no key left over)."""
    out = {k: params_from_flax(params[k]) for k in ("wm", "actor", "value")}
    if algo is not None:
        for k, sd in out.items():
            getattr(algo, k).load_state_dict(sd)
    return out


class DreamerConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or Dreamer)
        self._config.update({
            "env": "Pendulum-v1",
            "deter_size": 64,
            "stoch_size": 8,
            "hidden": 64,
            "model_lr": 3e-3,
            "actor_lr": 1e-3,
            "value_lr": 3e-3,
            "gamma": 0.97,
            "lambda_": 0.95,
            "imagine_horizon": 10,
            "kl_coeff": 0.3,
            "free_nats": 1.0,
            "batch_size": 24,     # sequences per model update
            "seq_len": 16,
            "prefill_steps": 1_000,
            "rollout_fragment_length": 200,
            "train_steps_per_iteration": 20,
            "expl_noise": 0.3,
        })


class Dreamer(LocalAlgorithm):
    """DreamerV1 (reference: dreamer.py training loop — collect,
    then model/actor/value updates on replayed sequences)."""

    _default_config_cls = DreamerConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        self.env = make_env(cfg["env"], cfg.get("env_config"))
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.act_dim = int(np.prod(self.env.action_space.shape))
        self.act_low = np.asarray(self.env.action_space.low, np.float32)
        self.act_high = np.asarray(self.env.action_space.high, np.float32)
        self.deter, self.stoch = cfg["deter_size"], cfg["stoch_size"]
        feat_dim = self.deter + self.stoch

        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        self.wm = _init_flax_(_WorldModel(
            self.obs_dim, self.act_dim, self.deter, self.stoch,
            cfg["hidden"]), init_gen).to(self.device)
        self.actor = _init_flax_(_Actor(feat_dim, self.act_dim,
                                        cfg["hidden"]), init_gen).to(
            self.device)
        self.value = _init_flax_(_Value(feat_dim, cfg["hidden"]),
                                 init_gen).to(self.device)
        self._gen = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=init_gen)))

        self.wm_opt = torch.optim.Adam(self.wm.parameters(),
                                       lr=cfg["model_lr"], eps=1e-8)
        self.actor_opt = torch.optim.Adam(self.actor.parameters(),
                                          lr=cfg["actor_lr"], eps=1e-8)
        self.value_opt = torch.optim.Adam(self.value.parameters(),
                                          lr=cfg["value_lr"], eps=1e-8)

        # episode replay: list of dicts of np arrays
        self._episodes: List[Dict[str, np.ndarray]] = []
        self._init_local_state()
        self._reset_collector()

    # ---- noise ----

    def _draw_noise(self, kind: str) -> Dict[str, torch.Tensor]:
        """The Gaussian draws of one acting step (``kind="filter"``:
        ``z`` [1, stoch], then ``a`` [1, act]) or of one update
        (``"update"``: ``obs`` [T, B, stoch] for ``observe``, then per
        imagined step ``act`` [H, B·T, act] and ``latent`` [H, B·T,
        stoch], drawn step by step in that order) from the generator."""
        cfg = self.config

        def normal(*shape):
            return torch.randn(shape, generator=self._gen,
                               device=self.device)

        if kind == "filter":
            z = normal(1, self.stoch)
            return {"z": z, "a": normal(1, self.act_dim)}
        T, B, H = cfg["seq_len"], cfg["batch_size"], cfg["imagine_horizon"]
        obs = torch.stack([normal(B, self.stoch) for _ in range(T)])
        act, latent = [], []
        for _ in range(H):
            act.append(normal(B * T, self.act_dim))
            latent.append(normal(B * T, self.stoch))
        return {"obs": obs, "act": torch.stack(act),
                "latent": torch.stack(latent)}

    # ---- acting (posterior filtering) ----

    def _zeros(self, n):
        return torch.zeros((1, n), device=self.device)

    def _reset_collector(self):
        self._obs, _ = self.env.reset(seed=self.config.get("seed"))
        self._h = self._zeros(self.deter)
        self._z = self._zeros(self.stoch)
        self._prev_a = self._zeros(self.act_dim)
        self._ep = {"obs": [], "actions": [], "rewards": []}
        self._episode_reward = 0.0

    @torch.no_grad()
    def _filter(self, h, z, prev_a, obs: np.ndarray, noise=None):
        """One posterior-filter step + action: (h, z, a) on the device.
        ``noise``: ``_draw_noise("filter")``'s dict, else drawn."""
        noise = noise or self._draw_noise("filter")
        x = torch.as_tensor(np.asarray(obs, np.float32)[None],
                            device=self.device)
        embed = self.wm.encoder(x)
        h, _pm, _ps = self.wm.rssm.step_prior(h, z, prev_a)
        q_mean, q_std = self.wm.rssm.posterior(h, embed)
        z = q_mean + q_std * noise["z"].to(self.device)
        mean, std = self.actor(torch.cat([h, z], -1))
        return h, z, mean + std * noise["a"].to(self.device)

    def _env_action(self, a: np.ndarray, noise: float) -> np.ndarray:
        a = a + noise * self._np_rng.standard_normal(a.shape)
        half = (self.act_high - self.act_low) / 2.0
        mid = (self.act_high + self.act_low) / 2.0
        return np.clip(mid + half * a, self.act_low, self.act_high)

    def _collect(self, num_steps: int, noise: float) -> int:
        for _ in range(num_steps):
            self._h, self._z, a = self._filter(self._h, self._z,
                                               self._prev_a, self._obs)
            a_np = a.cpu().numpy()[0]
            env_a = self._env_action(a_np, noise)
            nobs, r, term, trunc, _ = self.env.step(env_a)
            self._ep["obs"].append(np.asarray(self._obs, np.float32))
            self._ep["actions"].append(np.asarray(a_np, np.float32))
            self._ep["rewards"].append(np.float32(r))
            self._prev_a = a
            self._episode_reward += float(r)
            if term or trunc:
                self._episodes.append(
                    {k: np.stack(v) for k, v in self._ep.items()})
                self._episodes = self._episodes[-200:]
                self._episode_reward_window.append(self._episode_reward)
                self._reset_collector()
            else:
                self._obs = nobs
        return num_steps

    # ---- the three-headed update ----

    def _sample_sequences(self) -> Optional[Dict[str, np.ndarray]]:
        cfg = self.config
        T = cfg["seq_len"]
        eligible = [e for e in self._episodes
                    if e["obs"].shape[0] >= T]
        if not eligible:
            return None
        obs_b, act_b, rew_b = [], [], []
        for _ in range(cfg["batch_size"]):
            ep = eligible[self._np_rng.integers(len(eligible))]
            start = self._np_rng.integers(0, ep["obs"].shape[0] - T + 1)
            obs_b.append(ep["obs"][start:start + T])
            # action at index t is a_{t-1} (zeros at episode start)
            acts = ep["actions"][start:start + T]
            prev = np.concatenate(
                [np.zeros((1, self.act_dim), np.float32)
                 if start == 0 else
                 ep["actions"][start - 1:start], acts[:-1]])
            act_b.append(prev)
            rew_b.append(ep["rewards"][start:start + T])
        return {"obs": np.stack(obs_b),
                "prev_actions": np.stack(act_b),
                "rewards": np.stack(rew_b)}

    @staticmethod
    def _step(optimizer, params, loss):
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        optimizer.step()

    def _update(self, batch, noise=None) -> Dict[str, torch.Tensor]:
        """One world-model, actor and value update on a sequence batch
        (numpy or tensor ``obs`` [B,T,do], ``prev_actions`` [B,T,da],
        ``rewards`` [B,T]). ``noise``: ``_draw_noise("update")``'s dict,
        else drawn. Returns the stats as tensors on the device; each
        net's grads stay in its params' ``.grad``."""
        cfg = self.config
        noise = {k: v.to(self.device)
                 for k, v in (noise or self._draw_noise("update")).items()}
        b = {k: torch.as_tensor(np.asarray(v, np.float32)
                                if not torch.is_tensor(v) else v,
                                device=self.device)
             for k, v in batch.items()}
        obs = b["obs"]

        # --- world model ---
        feat, kls = self.wm.observe(obs, b["prev_actions"], noise["obs"])
        recon_l = torch.mean(torch.sum((self.wm.decode(feat) - obs) ** 2,
                                       -1))
        reward_l = torch.mean((self.wm.reward(feat) - b["rewards"]) ** 2)
        kl = torch.mean(torch.clamp(kls, min=cfg["free_nats"]))
        wm_l = recon_l + reward_l + cfg["kl_coeff"] * kl
        self._step(self.wm_opt, list(self.wm.parameters()), wm_l)

        # --- imagination from the (detached) pre-update posterior
        # states, through the updated world model ---
        feat = feat.detach().reshape(-1, feat.shape[-1])
        h, z = feat[:, :self.deter], feat[:, self.deter:]
        feats = []
        for t in range(cfg["imagine_horizon"]):
            mean, std = self.actor(torch.cat([h, z], -1))
            a = mean + std * noise["act"][t]
            h, z = self.wm.imagine_step(h, z, a, noise["latent"][t])
            feats.append(torch.cat([h, z], -1))
        feats = torch.stack(feats)  # [H, B·T, feat]
        rewards = self.wm.reward(feats)
        values = self.value(feats)
        # lambda-returns computed backwards (Hafner eq. 6)
        gamma, lam = cfg["gamma"], cfg["lambda_"]
        nxt, rets = values[-1], []
        for t in range(cfg["imagine_horizon"] - 2, -1, -1):
            nxt = rewards[t] + gamma * ((1 - lam) * values[t + 1] + lam * nxt)
            rets.append(nxt)
        returns = torch.stack(rets[::-1])  # [H-1, B·T]
        actor_l = -torch.mean(returns)
        self._step(self.actor_opt, list(self.actor.parameters()), actor_l)

        # --- value regression on the imagined lambda-returns ---
        v = self.value(feats[:-1].detach())
        value_l = torch.mean((v - returns.detach()) ** 2)
        self._step(self.value_opt, list(self.value.parameters()), value_l)
        return {"model_loss": wm_l.detach(), "recon_loss": recon_l.detach(),
                "reward_loss": reward_l.detach(), "kl": kl.detach(),
                "actor_loss": actor_l.detach(),
                "value_loss": value_l.detach()}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        if self._timesteps_total < cfg["prefill_steps"]:
            n = self._collect(cfg["prefill_steps"], noise=1.0)
        else:
            n = self._collect(cfg["rollout_fragment_length"],
                              noise=cfg["expl_noise"])
        sample_s = time.perf_counter() - t0
        self._timesteps_total += n
        stats: Dict[str, float] = {}
        dev_stats = None
        replay_s = learn_s = 0.0
        for _ in range(cfg["train_steps_per_iteration"]):
            t1 = time.perf_counter()
            batch = self._sample_sequences()
            t2 = time.perf_counter()
            replay_s += t2 - t1
            if batch is None:
                break
            dev_stats = self._update(batch)
            learn_s += time.perf_counter() - t2
        if dev_stats is not None:
            t3 = time.perf_counter()
            stats = stats_to_host(dev_stats)
            learn_s += time.perf_counter() - t3
        return {
            "num_env_steps_sampled_this_iter": n,
            "num_episodes": len(self._episodes),
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": sample_s * 1e3,
                       "replay_time_ms": replay_s * 1e3,
                       "learn_time_ms": learn_s * 1e3},
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        rewards = []
        for ep in range(num_episodes):
            obs, _ = self.env.reset(seed=20_000 + ep)
            h, z = self._zeros(self.deter), self._zeros(self.stoch)
            prev_a = self._zeros(self.act_dim)
            total, done = 0.0, False
            while not done:
                h, z, a = self._filter(h, z, prev_a, obs)
                env_a = self._env_action(a.cpu().numpy()[0], 0.0)
                obs, r, term, trunc, _ = self.env.step(env_a)
                prev_a = a
                total += float(r)
                done = term or trunc
            rewards.append(total)
        # collector state untouched: eval used its own h/z stream
        return evaluation_result(rewards)

    # ---- checkpoint ----

    def _weights(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {k: weights_of(getattr(self, k))
                for k in ("wm", "actor", "value")}

    def save_checkpoint(self) -> Dict[str, Any]:
        return {"params": self._weights(),
                "target_params": self._weights(),
                "opt_state": tuple(host_copy(o.state_dict()) for o in (
                    self.wm_opt, self.actor_opt, self.value_opt)),
                "iteration": self._iteration,
                "timesteps_total": self._timesteps_total}

    def load_checkpoint(self, state: Dict[str, Any]):
        for k in ("wm", "actor", "value"):
            load_weights(getattr(self, k), state["params"][k])
        for o, s in zip((self.wm_opt, self.actor_opt, self.value_opt),
                        state["opt_state"]):
            o.load_state_dict(host_copy(s))
        self._iteration = state.get("iteration", 0)
        self._timesteps_total = state.get("timesteps_total", 0)

