"""DT — Decision Transformer (Chen et al. 2021), offline RL as
sequence modeling.

Reference analogue: rllib/algorithms/dt/ (dt.py, dt_torch_model.py,
segmentation_buffer.py): trajectories become token sequences
[R̂_1, s_1, a_1, R̂_2, s_2, a_2, ...] (R̂ = return-to-go); a small
causal transformer is trained to predict a_t from the prefix ending at
s_t; acting conditions on a target return and feeds back observed
rewards. Trained purely from a JsonReader dataset.

Counterpart of ``ray_tpu/rllib/algorithms/dt.py`` with the same net,
data layout, update and defaults. flax's defaults are set where torch's
differ: ``LayerNorm`` eps 1e-6; ``gelu`` the tanh approximation;
``SelfAttention`` scales q by 1/sqrt(head_dim) and fills masked logits
with the f32 minimum, with the causal mask only (pad tokens are masked
by the loss, not by the attention); ``optax.adamw``'s weight decay
1e-4 on every param, after ``clip_by_global_norm(1.0)``
(``clip_and_step``). The attention is plain PyTorch ops, as flax
computes it; the JAX DT reaches no Pallas kernel, so neither does this.
Module names are flax's (``Embed_0`` the timestep table, ``Dense_0``
the return-to-go, ``Dense_1`` the state, ``Embed_1`` the action table,
``_CausalBlock_{i}``, ``LayerNorm_0``, ``Dense_2`` the head), so params
cross with ``models.params_from_flax``. The net lives on
``config["device"]`` ("cuda" unless the caller asks for "cpu"); the
flat episode store and the minibatch draws stay numpy on the host.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent drawing minibatches and learning.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import (AlgorithmConfig, LocalAlgorithm,
                                           evaluation_result)
from ray_tpu_torch.rllib.env import Discrete, make_env
from ray_tpu_torch.rllib.models import _lecun_normal_
from ray_tpu_torch.rllib.offline import JsonReader, OfflineDataConfigMixin
from ray_tpu_torch.rllib.policy import (backward_grads, clip_and_step,
                                        policy_device, stats_to_host)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

logger = logging.getLogger(__name__)

_LN_EPS = 1e-6  # flax's LayerNorm


class _SelfAttention(nn.Module):
    """flax ``nn.SelfAttention(num_heads, qkv_features=dim)``:
    ``query``/``key``/``value``/``out`` as ``Linear``s over the heads'
    concatenated features."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, mask):
        """x (B, T, D), mask (T, T) bool (True = attend)."""
        b, t, d = x.shape
        hd = d // self.heads
        q, k, v = (lin(x).reshape(b, t, self.heads, hd)
                   for lin in (self.query, self.key, self.value))
        q = q / math.sqrt(hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d)
        return self.out(o)


class _CausalBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.SelfAttention_0 = _SelfAttention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.Dense_0 = nn.Linear(dim, 4 * dim)
        self.Dense_1 = nn.Linear(4 * dim, dim)

    def forward(self, x, mask):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x), mask)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class _DTNet(nn.Module):
    """Interleaved (rtg, state, action) token transformer; action
    logits are read at the STATE token positions (reference:
    dt_torch_model.py)."""

    def __init__(self, obs_dim: int, n_actions: int, context: int,
                 dim: int = 64, heads: int = 4, layers: int = 2,
                 max_timestep: int = 1024):
        super().__init__()
        self.n_actions = n_actions
        self.context = context  # K timesteps -> 3K tokens
        self.dim = dim
        self.layers = layers
        self.max_timestep = max_timestep
        self.Embed_0 = nn.Embedding(max_timestep, dim)
        self.Dense_0 = nn.Linear(1, dim)
        self.Dense_1 = nn.Linear(obs_dim, dim)
        self.Embed_1 = nn.Embedding(n_actions + 1, dim)
        for i in range(layers):
            self.add_module(f"_CausalBlock_{i}", _CausalBlock(dim, heads))
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.Dense_2 = nn.Linear(dim, n_actions)

    def forward(self, rtg, obs, acts, timesteps):
        # rtg (B,K,1), obs (B,K,do), acts (B,K) int, timesteps (B,K) int
        b, k = acts.shape
        t_emb = self.Embed_0(torch.clamp(timesteps, 0,
                                         self.max_timestep - 1))
        r_tok = self.Dense_0(rtg) + t_emb
        s_tok = self.Dense_1(obs) + t_emb
        a_tok = self.Embed_1(torch.clamp(acts + 1, 0,
                                         self.n_actions)) + t_emb
        # interleave -> (B, 3K, D): [r_1, s_1, a_1, r_2, ...]
        x = torch.stack([r_tok, s_tok, a_tok],
                        dim=2).reshape(b, 3 * k, self.dim)
        causal = torch.ones(3 * k, 3 * k, dtype=torch.bool,
                            device=x.device).tril()
        for i in range(self.layers):
            x = self._modules[f"_CausalBlock_{i}"](x, causal)
        x = self.LayerNorm_0(x)
        s_positions = x.reshape(b, k, 3, self.dim)[:, :, 1]  # state toks
        return self.Dense_2(s_positions)  # (B, K, A)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's laws: ``Embed`` normal of variance 1 / dim,
        lecun-normal kernels (the attention's over their fan-in), zero
        biases, unit ``LayerNorm`` scales."""
        for mod in self.modules():
            if isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, 0.0, math.sqrt(1.0 / self.dim),
                                generator=generator)
            elif isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self


class DTConfig(OfflineDataConfigMixin, AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DT)
        self._config.update({
            "input_path": None,
            "context_length": 8,
            "embed_dim": 64,
            "num_heads": 4,
            "num_layers": 2,
            "lr": 1e-3,
            "train_batch_size": 64,
            "num_iters_per_step": 20,
            # acting: return prompt (None = best dataset return)
            "target_return": None,
        })


class DT(LocalAlgorithm):
    _default_config_cls = DTConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        self.env = make_env(cfg["env"], cfg.get("env_config"))
        if not isinstance(self.env.action_space, Discrete):
            raise ValueError("this DT implementation is discrete-only")
        self.n_actions = self.env.action_space.n
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.K = cfg["context_length"]

        path = cfg.get("input_path")
        if not path:
            raise ValueError("DT needs config['input_path']")
        self._segment(JsonReader(path).read_all())
        self.target_return = (cfg["target_return"]
                              if cfg["target_return"] is not None
                              else self._best_return)

        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        self.model = _DTNet(self.obs_dim, self.n_actions, self.K,
                            cfg["embed_dim"], cfg["num_heads"],
                            cfg["num_layers"]).init_weights(init_gen)
        self.model.to(self.device)
        self.target_model = None  # none: not a TD method
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=cfg["lr"], eps=1e-8,
            weight_decay=1e-4)
        self._init_local_state()

    # ---- data ----

    def _segment(self, data: SampleBatch) -> List[Dict[str, np.ndarray]]:
        """Split the flat batch into episodes with returns-to-go
        (reference: dt/segmentation_buffer.py)."""
        obs = np.asarray(data[SampleBatch.OBS], np.float32)
        acts = np.asarray(data[SampleBatch.ACTIONS], np.int64).reshape(-1)
        rews = np.asarray(data[SampleBatch.REWARDS], np.float32)
        dones = np.asarray(data[SampleBatch.DONES], bool)
        eps, start = [], 0
        for t in range(len(rews)):
            if dones[t]:
                sl = slice(start, t + 1)
                r = rews[sl]
                rtg = np.cumsum(r[::-1])[::-1].astype(np.float32)
                eps.append({"obs": obs[sl], "acts": acts[sl],
                            "rtg": rtg,
                            "t": np.arange(t + 1 - start, dtype=np.int64)})
                start = t + 1
        # a trailing fragment (recording stopped mid-episode) has an
        # understated return-to-go — drop it rather than train on it
        if start < len(rews):
            logger.warning(
                "DT: dropping %d-step trailing partial episode "
                "(dataset ends without done=True)", len(rews) - start)
        eps = [e for e in eps if len(e["acts"]) >= 2]
        if not eps:
            raise ValueError(
                "DT: dataset has no usable episodes (need >= 2 steps "
                "ending in done=True)")
        # left-pad each episode with K-1 rows and concatenate into one
        # flat array per field: every context window is then a uniform
        # slice and batch assembly is ONE fancy gather per field, no
        # per-row Python loop
        K = self.K

        def flat(field, pad_val, dtype):
            pads = []
            for e in eps:
                col = e[field]
                pad_shape = (K - 1, *col.shape[1:])
                pads.append(np.full(pad_shape, pad_val, dtype))
                pads.append(col.astype(dtype))
            return np.concatenate(pads)

        self._flat = {
            "obs": flat("obs", 0.0, np.float32),
            "acts": flat("acts", -1, np.int64),
            "rtg": flat("rtg", 0.0, np.float32),
            "t": flat("t", 0, np.int64),
        }
        lengths = np.array([len(e["acts"]) for e in eps], np.int64)
        padded = lengths + (K - 1)
        self._ep_bases = np.concatenate(
            [[0], np.cumsum(padded)[:-1]]).astype(np.int64)
        self._ep_lengths = lengths
        self._best_return = max(float(e["rtg"][0]) for e in eps)
        # the flat arrays are the training store; the per-episode
        # copies would double resident memory — drop them

    def _sample_batch(self, bs: int) -> Dict[str, torch.Tensor]:
        """One fancy-indexed gather per field from the pre-padded
        episodes (the window ending at step `end-1` is the uniform
        padded slice [end-1, end-1+K)), then one copy per field to the
        device."""
        K = self.K
        ep_ids = self._np_rng.integers(len(self._ep_lengths), size=bs)
        ends = self._np_rng.integers(1, self._ep_lengths[ep_ids] + 1)
        local = (ends[:, None] - 1) + np.arange(K)[None]  # padded coords
        idx = self._ep_bases[ep_ids][:, None] + local     # (bs, K)
        mask = (local >= K - 1).astype(np.float32)
        host = {
            "rtg": self._flat["rtg"][idx][..., None],
            "obs": self._flat["obs"][idx],
            "acts": self._flat["acts"][idx],
            "ts": self._flat["t"][idx],
            "mask": mask,
        }
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host.items()}

    # ---- training ----

    def _update(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """One clipped AdamW step on a ``_sample_batch``. Returns the
        stats as tensors on the device."""
        logits = self.model(batch["rtg"], batch["obs"], batch["acts"],
                            batch["ts"])
        # predict a_t from prefix ending at s_t: the action input
        # at position t is masked out by construction (the token
        # order puts a_t AFTER s_t, and attention is causal)
        targets = torch.clamp(batch["acts"], 0, self.n_actions - 1)
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        m = batch["mask"]
        denom = torch.clamp(m.sum(), min=1.0)
        loss = torch.sum(nll * m) / denom
        acc = torch.sum(
            (torch.argmax(logits.detach(), -1) == targets) * m) / denom
        self.optimizer.zero_grad(set_to_none=True)
        grads = backward_grads(list(self.model.parameters()), loss)
        clip_and_step(self.optimizer, grads, 1.0)
        loss = loss.detach()
        return {"action_nll": loss, "action_acc": acc, "loss": loss}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        draw_s = learn_s = 0.0
        for _ in range(cfg.get("num_iters_per_step", 20)):
            t0 = time.perf_counter()
            batch = self._sample_batch(cfg["train_batch_size"])
            t1 = time.perf_counter()
            dev_stats = self._update(batch)
            draw_s += t1 - t0
            learn_s += time.perf_counter() - t1
            self._timesteps_total += cfg["train_batch_size"]
        t2 = time.perf_counter()
        stats = stats_to_host(dev_stats)
        learn_s += time.perf_counter() - t2
        return {"num_env_steps_sampled_this_iter": 0,
                "target_return": self.target_return,
                **{f"learner/{k}": v for k, v in stats.items()},
                "timers": {"replay_time_ms": draw_s * 1e3,
                           "learn_time_ms": learn_s * 1e3}}

    # ---- acting ----

    @torch.no_grad()
    def _logits(self, rtg, obs, acts, ts) -> torch.Tensor:
        """The net's logits (B, K, A) for numpy (or tensor) inputs."""
        dev = self.device
        return self.model(torch.as_tensor(rtg, device=dev),
                          torch.as_tensor(obs, device=dev),
                          torch.as_tensor(acts, device=dev),
                          torch.as_tensor(ts, device=dev))

    def evaluate(self, num_episodes: int = 5,
                 target_return: Optional[float] = None) -> Dict[str, Any]:
        """Autoregressive rollouts conditioned on the target return
        (reference: dt.py evaluate with the rolling context)."""
        K = self.K
        tgt = (target_return if target_return is not None
               else self.target_return)
        rewards = []
        for ep in range(num_episodes):
            o, _ = self.env.reset(seed=20_000 + ep)
            rtg = np.zeros((1, K, 1), np.float32)
            obs = np.zeros((1, K, self.obs_dim), np.float32)
            acts = np.full((1, K), -1, np.int64)
            ts = np.zeros((1, K), np.int64)
            remaining = float(tgt)
            total, done, t = 0.0, False, 0
            while not done:
                # roll the window left; write the current step at K-1
                rtg[0, :-1] = rtg[0, 1:]
                obs[0, :-1] = obs[0, 1:]
                acts[0, :-1] = acts[0, 1:]
                ts[0, :-1] = ts[0, 1:]
                rtg[0, -1, 0] = remaining
                obs[0, -1] = np.asarray(o, np.float32)
                acts[0, -1] = -1  # current action unknown
                ts[0, -1] = min(t, self.model.max_timestep - 1)
                logits = self._logits(rtg, obs, acts, ts)[0, -1]
                a = int(np.argmax(logits.cpu().numpy()))
                acts[0, -1] = a
                o, r, term, trunc, _ = self.env.step(a)
                total += float(r)
                remaining -= float(r)
                done = term or trunc
                t += 1
            rewards.append(total)
        return evaluation_result(rewards)
