"""MAML — model-agnostic meta-learning for RL (meta-gradients).

Reference analogue: rllib/algorithms/maml/ (maml.py, maml_torch_policy.py;
Finn et al. 2017): train initial policy parameters such that ONE inner
policy-gradient step on a new task's data yields a good task policy.
The meta-gradient differentiates THROUGH the inner update, second-order
terms included. The task family is 2D point navigation with per-task
goals (reference analogue: rllib/examples/env/pointmass / the MAML
paper's point environment).

Counterpart of ``ray_tpu/rllib/algorithms/maml.py`` with the same env,
policy, update and defaults:

- ``PointGoalEnv`` is a numpy copy; ``sample_task`` draws from numpy;
- ``_GaussianPolicy`` (``Dense_0``/``Dense_1`` 64 tanh -> ``Dense_2``
  the mean; a fixed std of 0.3 that is no parameter) on
  ``config["device"]`` ("cuda" unless the caller asks for "cpu");
- the surrogate is -mean(logp · adv / (std(adv) + 1e-6)), std with
  ddof 0; the inner step θ' = θ - inner_lr ∇surrogate(θ, pre),
  ``inner_adaptation_steps`` times, runs over a params dict through
  ``torch.func.functional_call`` and stays differentiable
  (``create_graph``) inside the meta-update, whose loss is the mean over
  tasks of surrogate(θ'_task, post); one Adam step (no clip) follows,
  and ``grad_norm`` is the unclipped global norm. ``MetaPolicy``
  (the policy, its Adam, acting, ``adapt`` and ``meta_update``) is
  shared with MBMPO;
- ``_collect_task`` runs one forward on the card and one host read per
  env step and stores the UNCLIPPED action (the env clips it);
  advantages are returns-to-go minus their per-timestep mean over the
  task's episodes. Action noise comes from a ``torch.Generator`` on the
  device seeded from ``config["seed"]``, or from a ``noise`` argument
  (JAX's draws in the tests).

The checkpoint is ``LocalAlgorithm``'s: the policy, a frozen copy of the
initial policy (JAX's ``target_params = params`` binds the initial tree)
and Adam. ``training_step`` also reports ``timers``: the host
milliseconds of one iteration spent sampling, adapting and learning.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.algorithms.sac import init_dense_, noise_tensor
from ray_tpu_torch.rllib.policy import (backward_grads, clip_and_step,
                                        policy_device, stats_to_host)

Params = Dict[str, torch.Tensor]


class PointGoalEnv:
    """2D point mass navigating to a per-task goal on the unit circle.
    Reward = -distance to goal; the task (goal) is resampled by
    ``sample_task``/``set_task`` — the MAML adaptation axis."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        cfg = config or {}
        self.horizon = int(cfg.get("horizon", 20))
        self.action_scale = float(cfg.get("action_scale", 0.25))
        self.goal = np.array([1.0, 0.0], np.float32)
        self._pos = np.zeros(2, np.float32)
        self._t = 0

    def sample_task(self, rng: np.random.Generator) -> np.ndarray:
        theta = rng.uniform(0, 2 * np.pi)
        return np.array([np.cos(theta), np.sin(theta)], np.float32)

    def set_task(self, goal: np.ndarray):
        self.goal = np.asarray(goal, np.float32)

    def reset(self, *, seed=None):
        self._pos = np.zeros(2, np.float32)
        self._t = 0
        return self._pos.copy(), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        # bounded arena: keeps the reward scale sane under exploratory
        # policies (unbounded drift would dominate the meta-objective)
        self._pos = np.clip(self._pos + self.action_scale * a, -2.0, 2.0)
        self._t += 1
        r = -float(np.linalg.norm(self._pos - self.goal))
        return self._pos.copy(), r, False, self._t >= self.horizon, {}


class _GaussianPolicy(nn.Module):
    """Fixed-std Gaussian: MAML adapts the mean net. A learnable std
    under a pure REINFORCE meta-objective inflates without a KL
    constraint (the reference stabilizes with TRPO); fixing it keeps
    the meta-update stable."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64,
                 fixed_std: float = 0.3):
        super().__init__()
        self.fixed_std = fixed_std
        self.Dense_0 = nn.Linear(obs_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, act_dim)

    def forward(self, obs):
        x = torch.tanh(self.Dense_0(obs))
        x = torch.tanh(self.Dense_1(x))
        mean = self.Dense_2(x)
        logstd = torch.full_like(mean, math.log(self.fixed_std))
        return mean, logstd


# ---- surrogate / adaptation (the meta-gradient flows through) ----


def logp(policy: nn.Module, params: Params, obs, act):
    mean, logstd = functional_call(policy, params, (obs,))
    var = torch.exp(2 * logstd)
    return torch.sum(-0.5 * ((act - mean) ** 2 / var) - logstd
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def surrogate(policy: nn.Module, params: Params, batch: Params):
    # advantages are pre-baselined PER TIMESTEP across the task's
    # episodes (a global mean over returns-to-go manufactures a
    # time-index signal: early steps always carry lower rtg)
    adv = batch["advantages"]
    adv = adv / (torch.std(adv, unbiased=False) + 1e-6)
    return -torch.mean(logp(policy, params, batch["obs"],
                            batch["actions"]) * adv)


def adapt(policy: nn.Module, params: Params, batch: Params,
          inner_lr: float, steps: int, create_graph: bool = False
          ) -> Params:
    """``steps`` inner policy-gradient steps from ``params``. With
    ``create_graph`` the result stays a differentiable function of
    ``params`` (the meta-update); without it the result is detached."""
    for _ in range(steps):
        grads = torch.autograd.grad(surrogate(policy, params, batch),
                                    list(params.values()),
                                    create_graph=create_graph)
        params = {k: p - inner_lr * g
                  for (k, p), g in zip(params.items(), grads)}
        if not create_graph:
            params = {k: p.detach().requires_grad_()
                      for k, p in params.items()}
    if not create_graph:
        params = {k: p.detach() for k, p in params.items()}
    return params


def meta_update(policy: nn.Module, optimizer: torch.optim.Optimizer,
                pre_batches: List[Params], post_batches: List[Params],
                inner_lr: float, steps: int) -> Dict[str, torch.Tensor]:
    """d/dθ mean_tasks surrogate(adapt(θ, pre), post), second-order terms
    included (reference: maml_torch_policy.py MAMLLoss create_graph=True),
    then one ``optimizer`` step without clipping. Returns ``meta_loss``
    and ``grad_norm`` (unclipped) as tensors on the device; the grads
    stay in the params' ``.grad``."""
    params = dict(policy.named_parameters())
    losses = [surrogate(policy, adapt(policy, params, pre, inner_lr, steps,
                                      create_graph=True), post)
              for pre, post in zip(pre_batches, post_batches)]
    loss = torch.mean(torch.stack(losses))
    optimizer.zero_grad(set_to_none=True)
    grads = backward_grads(list(params.values()), loss)
    norm = clip_and_step(optimizer, grads, None)
    return {"meta_loss": loss.detach(), "grad_norm": norm}


class MAMLConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MAML)
        self._config.update({
            "env": "point_goal",
            "env_config": {},
            "inner_lr": 0.1,
            "lr": 1e-3,             # meta (outer) lr
            "meta_batch_size": 10,  # tasks per meta-update
            "episodes_per_task": 10,
            "inner_adaptation_steps": 1,
            "hidden": 64,
        })


class MetaPolicy:
    """The policy side that MAML and MBMPO share: the ``_GaussianPolicy``
    (``self.model``) on ``config["device"]``, a frozen copy of its
    initial params (``self.target_model``: JAX's ``target_params =
    params`` binds the initial tree, which its checkpoint saves), the
    outer Adam, the action generator, and the inner and outer steps."""

    def _init_policy(self, cfg):
        self.obs_dim, self.act_dim = 2, 2
        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        self.model = init_dense_(
            _GaussianPolicy(self.obs_dim, self.act_dim, cfg["hidden"]),
            init_gen).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg["lr"], eps=1e-8)
        self._gen = torch.Generator(self.device).manual_seed(
            cfg.get("seed") or 0)
        return init_gen

    @property
    def params(self) -> Params:
        return dict(self.model.named_parameters())

    def _adapt(self, params: Params, batch: Params) -> Params:
        """The inner steps, detached: the policy that collects after
        adaptation."""
        cfg = self.config
        return adapt(self.model, params, batch, cfg["inner_lr"],
                     cfg["inner_adaptation_steps"])

    def _meta_update(self, pre_batches, post_batches):
        cfg = self.config
        return meta_update(self.model, self.optimizer, pre_batches,
                           post_batches, cfg["inner_lr"],
                           cfg["inner_adaptation_steps"])

    @torch.no_grad()
    def _act(self, params: Params, obs: np.ndarray, eps=None) -> np.ndarray:
        """One sampled action for ``obs``, unclipped: one forward on the
        device and one host read. ``eps``: the (1, act_dim)
        standard-normal draw, else one from the algorithm's generator."""
        x = torch.as_tensor(np.asarray(obs, np.float32)[None],
                            device=self.device)
        mean, logstd = functional_call(self.model, params, (x,))
        if eps is None:
            eps = torch.randn(mean.shape, generator=self._gen,
                              device=self.device)
        else:
            eps = noise_tensor(eps, self.device).reshape(mean.shape)
        return (mean + torch.exp(logstd) * eps)[0].cpu().numpy()


class MAML(MetaPolicy, LocalAlgorithm):
    """MAML meta-RL (reference: maml.py training_step — sample tasks,
    inner adapt per task, outer update through the adaptation)."""

    _default_config_cls = MAMLConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        if cfg["env"] != "point_goal":
            raise ValueError("MAML ships the point_goal task family")
        self.env = PointGoalEnv(cfg.get("env_config"))
        self._init_policy(cfg)
        self._init_local_state()

    # ---- rollouts ----

    def _collect_task(self, params: Params, goal, noise=None
                      ) -> Tuple[Params, float]:
        """episodes_per_task rollouts on one task; returns the batch
        (obs/actions/advantages on the device) and the mean episode
        reward. ``noise``: the (episodes, horizon, act_dim) action draws,
        else the generator's."""
        cfg = self.config
        self.env.set_task(goal)
        all_obs, all_act, all_rtg, ep_rewards = [], [], [], []
        for ep in range(cfg["episodes_per_task"]):
            obs, _ = self.env.reset()
            o_l, a_l, r_l = [], [], []
            done = False
            while not done:
                eps = None if noise is None else noise[ep][len(o_l)]
                a = self._act(params, obs, eps)
                nobs, r, term, trunc, _ = self.env.step(a)
                o_l.append(obs)
                a_l.append(a)
                r_l.append(r)
                obs, done = nobs, (term or trunc)
            ep_rewards.append(float(np.sum(r_l)))
            all_obs.append(np.stack(o_l))
            all_act.append(np.stack(a_l))
            all_rtg.append(
                np.cumsum(np.asarray(r_l, np.float32)[::-1])[::-1])
        rtg = np.stack(all_rtg)                    # (E, T)
        adv = rtg - rtg.mean(axis=0, keepdims=True)  # per-timestep baseline
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in (
            ("obs", np.concatenate(all_obs)),
            ("actions", np.concatenate(all_act)),
            ("advantages", np.ascontiguousarray(adv.reshape(-1))))}
        return batch, float(np.mean(ep_rewards))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        pre_batches, post_batches = [], []
        pre_rewards, post_rewards = [], []
        n = 0
        sample_s = adapt_s = 0.0
        for _ in range(cfg["meta_batch_size"]):
            t0 = time.perf_counter()
            goal = self.env.sample_task(self._np_rng)
            pre, pre_rw = self._collect_task(self.params, goal)
            t1 = time.perf_counter()
            adapted = self._adapt(self.params, pre)
            t2 = time.perf_counter()
            post, post_rw = self._collect_task(adapted, goal)
            sample_s += t1 - t0 + time.perf_counter() - t2
            adapt_s += t2 - t1
            pre_batches.append(pre)
            post_batches.append(post)
            pre_rewards.append(pre_rw)
            post_rewards.append(post_rw)
            n += int(pre["obs"].shape[0] + post["obs"].shape[0])
        t3 = time.perf_counter()
        stats = stats_to_host(self._meta_update(pre_batches, post_batches))
        learn_s = time.perf_counter() - t3
        self._timesteps_total += n
        post_mean = float(np.mean(post_rewards))
        self._episode_reward_window.append(post_mean)
        return {
            "num_env_steps_sampled_this_iter": n,
            "pre_adaptation_reward_mean": float(np.mean(pre_rewards)),
            "post_adaptation_reward_mean": post_mean,
            "adaptation_gap": post_mean - float(np.mean(pre_rewards)),
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"sample_time_ms": sample_s * 1e3,
                       "adapt_time_ms": adapt_s * 1e3,
                       "learn_time_ms": learn_s * 1e3},
        }

    def adaptation_eval(self, num_tasks: int = 8,
                        seed: int = 500) -> Dict[str, float]:
        """Pre- vs post-adaptation reward on held-out tasks."""
        rng = np.random.default_rng(seed)
        pre_rw, post_rw = [], []
        for _ in range(num_tasks):
            goal = self.env.sample_task(rng)
            pre, prw = self._collect_task(self.params, goal)
            adapted = self._adapt(self.params, pre)
            _, porw = self._collect_task(adapted, goal)
            pre_rw.append(prw)
            post_rw.append(porw)
        return {"pre_adaptation_reward": float(np.mean(pre_rw)),
                "post_adaptation_reward": float(np.mean(post_rw))}
