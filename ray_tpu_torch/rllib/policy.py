"""TorchPolicy — the port's policy abstraction (the JAX package's
``JaxPolicy``; upstream Ray's name).

Reference analogue: rllib/policy/torch_policy_v2.py:62 (compute_actions
:499, loss :212, learn_on_batch :603). Counterpart of
``ray_tpu/rllib/policy.py`` with the same semantics:

- ``compute_actions`` is ONE batched forward over the whole vector env
  (no per-env Python loop), on ``config["device"]`` (``"cuda"`` unless
  the caller asks for ``"cpu"``); uint8 frames go to the device as
  uint8. Sampling draws from a ``torch.Generator`` on that device,
  seeded from the init generator, so the bits differ from
  ``jax.random``'s while the laws are the same.
- ``learn_on_batch`` is loss -> backward -> optax's
  ``clip_by_global_norm`` (scale by clip / norm only when norm > clip;
  no epsilon, unlike ``clip_grad_norm_``) -> ``torch.optim.Adam`` (eps
  1e-8 outside the bias-corrected sqrt(v), as ``optax.adam``). The
  reported ``grad_gnorm`` is the norm before clipping; the stats come
  to the host in one transfer. Only the columns the loss reads
  (``loss_columns``) go to the device; float64 columns go as float32
  (JAX's default without x64).
- A param that the loss does not reach gets a zero gradient, which Adam
  still steps (optax updates every leaf; torch's Adam skips a param
  whose ``grad`` is None).
- Weights are the model's ``state_dict`` as host numpy copies (torch
  layout; ``models.params_from_flax`` converts a flax tree).
- ``"cuda"`` becomes the card current at construction, with its index,
  so a learner thread launches on the policy's card whatever its own
  current device is.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib.env import Discrete
from ray_tpu_torch.rllib.models import (
    categorical_entropy, categorical_logp, categorical_sample,
    diag_gaussian_entropy, diag_gaussian_logp, diag_gaussian_sample,
    make_model)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def policy_device(config: Dict[str, Any]) -> torch.device:
    """``config["device"]`` ("cuda" unless the caller asks for "cpu");
    "cuda" becomes the current card with its index, pinned here: a
    learner thread must not read its own current device."""
    device = resolve_device(config.get("device", "cuda"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_device_batch(batch, device: torch.device,
                    columns: Optional[Tuple[str, ...]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Numeric numpy columns (all, or ``columns`` where present) ->
    tensors on ``device``; float64 -> float32."""
    keys = columns if columns is not None else list(batch.keys())
    out = {}
    for k in keys:
        if k not in batch:
            continue
        v = np.asarray(batch[k])
        if v.dtype == object:
            continue
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        out[k] = torch.as_tensor(v, device=device)
    return out


def stats_to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Scalars -> python floats (one device-to-host transfer); per-sample
    arrays stay as numpy."""
    scalars = [k for k, v in stats.items() if v.ndim == 0]
    out: Dict[str, Any] = {}
    if scalars:
        vals = torch.stack([stats[k].detach().float() for k in scalars])
        out.update(zip(scalars, vals.tolist()))
    for k, v in stats.items():
        if v.ndim:
            out[k] = v.detach().cpu().numpy()
    return out


def host_copy(obj):
    """A host snapshot of a state tree: tensors copied to the CPU (a CPU
    tensor too: the live one keeps changing in place)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def weights_of(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in host_copy(model.state_dict()).items()}


def host_tensor(v, device=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor; a
    read-only array (one that came out of the object store) is copied
    first, since a tensor may not alias it."""
    a = np.asarray(v)
    if not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=device)


def load_weights(model: torch.nn.Module, weights: Dict[str, Any]):
    model.load_state_dict({k: host_tensor(v) for k, v in weights.items()})


def backward_grads(params: List[torch.nn.Parameter], loss) -> List:
    """``loss.backward()``; a param the loss does not reach gets a zero
    gradient. Returns the gradients."""
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def clip_by_global_norm(grads: List, clip: Optional[float]) -> torch.Tensor:
    """The global norm of ``grads`` (before clipping), and optax's
    ``clip_by_global_norm(clip)`` in place where ``clip`` is set.
    Returns the norm."""
    norm = torch.nn.utils.get_total_norm(grads)
    if clip:
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        for g in grads:
            g.mul_(scale)
    return norm


def clip_and_step(optimizer: torch.optim.Optimizer, grads: List,
                  clip: Optional[float]) -> torch.Tensor:
    """``clip_by_global_norm(grads, clip)``, then ``optimizer.step()``.
    Returns the norm before clipping."""
    norm = clip_by_global_norm(grads, clip)
    optimizer.step()
    return norm


def grads_to_host(model: torch.nn.Module, grads: List) -> Dict[str, np.ndarray]:
    """``grads`` (in ``model.parameters()`` order) as host numpy copies
    by param name."""
    return {n: g.detach().to("cpu", copy=True).numpy()
            for (n, _), g in zip(model.named_parameters(), grads)}


def apply_host_grads(optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module, grads: Dict[str, Any],
                     clip: Optional[float]):
    """One ``clip_and_step`` from host grads by param name. The grads
    are copied first: the clip scales them in place, and the caller's
    arrays (or the object store's) stay as they were."""
    for n, p in model.named_parameters():
        p.grad = torch.as_tensor(np.array(grads[n]), device=p.device)
    clip_and_step(optimizer, [p.grad for p in model.parameters()], clip)


class TorchPolicy:
    """A policy = model + action distribution + Adam + a loss.
    Subclasses override :meth:`loss`."""

    # the batch columns the loss reads (None: every numeric column)
    loss_columns: Optional[Tuple[str, ...]] = None

    def __init__(self, obs_space, action_space, config: Dict[str, Any]):
        self.observation_space = obs_space
        self.action_space = action_space
        self.config = config
        self.discrete = isinstance(action_space, Discrete)
        self.device = policy_device(config)
        seed = config.get("seed") or 0
        init_gen = torch.Generator().manual_seed(seed)
        self.model = make_model(obs_space, action_space,
                                config.get("model")).init_weights(init_gen)
        self.model.to(self.device)
        self._gen = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=init_gen)))
        self._optimizer: Optional[torch.optim.Optimizer] = None
        self.global_timestep = 0

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        """Adam over the model's params (eps 1e-8, as optax's), made at
        first use: a remote sampler never learns, and the first
        optimizer of a process imports much of torch (``torch._dynamo``),
        seconds of an actor's start."""
        if self._optimizer is None:
            self._optimizer = torch.optim.Adam(
                self.model.parameters(), lr=self.config.get("lr", 5e-5),
                eps=1e-8)
        return self._optimizer

    @optimizer.setter
    def optimizer(self, optimizer: torch.optim.Optimizer):
        self._optimizer = optimizer

    # ---- inference ----

    def _obs_tensor(self, obs) -> torch.Tensor:
        return to_device_batch({"obs": obs}, self.device)["obs"]

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        dist_inputs, vf = self.model(self._obs_tensor(obs))
        if self.discrete:
            actions = (categorical_sample(self._gen, dist_inputs) if explore
                       else torch.argmax(dist_inputs, dim=-1))
            logp = categorical_logp(dist_inputs, actions)
            actions = actions.to(torch.int32)
        else:
            actions = (diag_gaussian_sample(self._gen, dist_inputs)
                       if explore else torch.chunk(dist_inputs, 2, -1)[0])
            logp = diag_gaussian_logp(dist_inputs, actions)
        extras = {
            SampleBatch.ACTION_LOGP: logp.cpu().numpy(),
            SampleBatch.ACTION_DIST_INPUTS: dist_inputs.cpu().numpy(),
            SampleBatch.VF_PREDS: vf.cpu().numpy(),
        }
        return actions.cpu().numpy(), extras

    @torch.no_grad()
    def value(self, obs: np.ndarray) -> np.ndarray:
        return self.model(self._obs_tensor(obs))[1].cpu().numpy()

    # ---- action-dist helpers the losses use ----

    def dist_logp(self, dist_inputs, actions):
        if self.discrete:
            return categorical_logp(dist_inputs, actions)
        return diag_gaussian_logp(dist_inputs, actions)

    def dist_entropy(self, dist_inputs):
        if self.discrete:
            return categorical_entropy(dist_inputs)
        return diag_gaussian_entropy(dist_inputs)

    # ---- learning ----

    def postprocess_trajectory(self, batch: SampleBatch) -> SampleBatch:
        """Per-episode-fragment hook run worker-side after sampling
        (reference: Policy.postprocess_trajectory). Default: no-op;
        PPO overrides to compute GAE."""
        return batch

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(scalar loss, stats dict) on device tensors, through
        ``self.model``."""
        raise NotImplementedError

    def _loss_and_grads(self, batch: SampleBatch):
        self.optimizer.zero_grad(set_to_none=True)
        total, stats = self.loss(to_device_batch(batch, self.device,
                                                 self.loss_columns))
        grads = backward_grads(list(self.model.parameters()), total)
        stats = dict(stats)
        stats["total_loss"] = total.detach()
        return grads, stats

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        grads, stats = self._loss_and_grads(batch)
        stats["grad_gnorm"] = clip_and_step(self.optimizer, grads,
                                            self.config.get("grad_clip"))
        self.global_timestep += batch.count
        return stats_to_host(stats)

    # ---- split grad computation/application (reference: policy.py
    # compute_gradients/apply_gradients — the A3C-style decomposition
    # where rollout workers compute grads and a learner applies them) ----

    def compute_gradients(self, batch: SampleBatch):
        """Worker-side half: (host-numpy grads by param name, stats)."""
        grads, stats = self._loss_and_grads(batch)
        host = grads_to_host(self.model, grads)
        self.optimizer.zero_grad(set_to_none=True)
        return host, stats_to_host(stats)

    def apply_gradients(self, grads: Dict[str, np.ndarray]):
        """Learner-side half: one update from externally computed grads
        (the same clip and Adam as ``learn_on_batch``)."""
        apply_host_grads(self.optimizer, self.model, grads,
                         self.config.get("grad_clip"))

    # ---- weights ----

    def get_weights(self) -> Dict[str, np.ndarray]:
        return weights_of(self.model)

    def set_weights(self, weights: Dict[str, Any]):
        load_weights(self.model, weights)

    def get_state(self) -> Dict[str, Any]:
        return {
            "weights": self.get_weights(),
            "opt_state": host_copy(self.optimizer.state_dict()),
            "global_timestep": self.global_timestep,
        }

    def set_state(self, state: Dict[str, Any]):
        self.set_weights(state["weights"])
        self.optimizer.load_state_dict(host_copy(state["opt_state"]))
        self.global_timestep = state.get("global_timestep", 0)
