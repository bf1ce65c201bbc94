"""Learner — the next-generation training abstraction.

Reference analogue: rllib/core/learner/learner.py (Learner:139,
compute_loss_for_module, update_from_batch) — the training half of the
RLModule/Learner split: the Learner owns optimizers and losses over one
MultiRLModule; algorithms subclass only `compute_loss_for_module`.
Counterpart of ``ray_tpu/rllib/core/learner.py``: per module one
loss -> backward -> optax-style global-norm clip (``grad_clip``) ->
``torch.optim.Adam`` step (``policy.clip_and_step``); ``grad_norm`` is
the norm before clipping; multi-module updates run each module's step
in turn.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.rllib.core.rl_module import (MultiRLModule, RLModule,
                                                RLModuleSpec)
from ray_tpu_torch.rllib.policy import (apply_host_grads, backward_grads,
                                        clip_and_step, grads_to_host,
                                        host_copy, stats_to_host,
                                        to_device_batch)

DEFAULT_MODULE_ID = "default_policy"


class Learner:
    """Owns a MultiRLModule + one optimizer per module; subclasses
    override :meth:`compute_loss_for_module`."""

    def __init__(self, *, module_spec: Optional[RLModuleSpec] = None,
                 module_specs: Optional[Dict[str, RLModuleSpec]] = None,
                 config: Optional[Dict[str, Any]] = None):
        if (module_spec is None) == (module_specs is None):
            raise ValueError(
                "provide exactly one of module_spec / module_specs")
        if module_spec is not None:
            module_specs = {DEFAULT_MODULE_ID: module_spec}
        self.config = dict(config or {})
        self.module = MultiRLModule(module_specs)
        self._opt = {mid: self.configure_optimizer_for_module(mid)
                     for mid in self.module.keys()}

    # ---- override points (reference method names) ----

    def configure_optimizer_for_module(self, module_id: str):
        return torch.optim.Adam(self.module[module_id].model.parameters(),
                                lr=self.config.get("lr", 5e-4), eps=1e-8)

    def compute_loss_for_module(self, module_id: str, module: RLModule,
                                batch: Dict[str, torch.Tensor]):
        """Return (loss, stats_dict) on device tensors, through
        ``module``'s params."""
        raise NotImplementedError

    # ---- update machinery ----

    def _route_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        if any(mid in batch for mid in self.module.keys()):
            return batch
        if DEFAULT_MODULE_ID not in self.module:
            raise ValueError(
                "plain column batch given to a multi-module Learner "
                f"(modules: {sorted(self.module.keys())}); pass "
                "{module_id: batch} so updates route explicitly")
        return {DEFAULT_MODULE_ID: batch}

    def _loss_and_grads(self, module_id: str, batch: Dict[str, Any]):
        module = self.module[module_id]
        self._opt[module_id].zero_grad(set_to_none=True)
        loss, stats = self.compute_loss_for_module(
            module_id, module, to_device_batch(batch, module.device))
        grads = backward_grads(list(module.model.parameters()), loss)
        stats = dict(stats)
        stats["total_loss"] = loss.detach()
        return grads, stats

    def update_from_batch(self, batch: Dict[str, Any]
                          ) -> Dict[str, Dict[str, float]]:
        """One SGD step.  ``batch`` is either a column dict (single
        module) or {module_id: column dict} (reference:
        update_from_batch / MultiAgentBatch routing)."""
        batch = self._route_batch(batch)
        results = {}
        for mid, b in batch.items():
            if mid not in self.module:
                continue
            grads, stats = self._loss_and_grads(mid, b)
            stats["grad_norm"] = clip_and_step(
                self._opt[mid], grads, self.config.get("grad_clip"))
            results[mid] = {k: v for k, v in stats_to_host(stats).items()
                            if isinstance(v, float)}
        return results

    # ---- gradient-exchange hooks ----

    def compute_gradients(self, batch: Dict[str, Any]
                          ) -> Dict[str, Any]:
        """Per-module grads as host numpy dicts by param name
        (reference: Learner.compute_gradients)."""
        batch = self._route_batch(batch)
        out = {}
        for mid, b in batch.items():
            if mid not in self.module:
                continue
            grads, _ = self._loss_and_grads(mid, b)
            out[mid] = grads_to_host(self.module[mid].model, grads)
            self._opt[mid].zero_grad(set_to_none=True)
        return out

    def apply_gradients(self, grads: Dict[str, Any]):
        for mid, g in grads.items():
            apply_host_grads(self._opt[mid], self.module[mid].model, g,
                             self.config.get("grad_clip"))

    # ---- state ----

    def get_state(self) -> Dict[str, Any]:
        # optimizer state included: a restore that resets Adam moments
        # silently changes learning dynamics (reference Learner
        # persists optimizers too)
        return {"module": self.module.get_state(),
                "optimizer": {mid: host_copy(opt.state_dict())
                              for mid, opt in self._opt.items()}}

    def set_state(self, state: Dict[str, Any]):
        self.module.set_state(state["module"])
        for mid, st in (state.get("optimizer") or {}).items():
            if mid in self._opt:
                self._opt[mid].load_state_dict(host_copy(st))


class PPOLearner(Learner):
    """Clipped-surrogate PPO loss on the new stack (reference:
    rllib/algorithms/ppo/ppo_learner.py + torch ppo_torch_learner) —
    the canonical example algorithm of the RLModule/Learner API."""

    def compute_loss_for_module(self, module_id, module, batch):
        cfg = self.config
        clip = cfg.get("clip_param", 0.2)
        vf_coeff = cfg.get("vf_loss_coeff", 0.5)
        ent_coeff = cfg.get("entropy_coeff", 0.0)
        out = module._forward_train(batch["obs"])
        dist_inputs = out["action_dist_inputs"]
        vf = out["vf_preds"]
        logp = module.logp(dist_inputs, batch["actions"])
        ratio = torch.exp(logp - batch["action_logp"])
        adv = batch["advantages"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        policy_loss = -torch.mean(surrogate)
        vf_loss = torch.mean((vf - batch["value_targets"]) ** 2)
        entropy = torch.mean(module.entropy(dist_inputs))
        loss = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": entropy}
