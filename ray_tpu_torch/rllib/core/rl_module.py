"""RLModule — the next-generation model abstraction.

Reference analogue: rllib/core/rl_module/rl_module.py (RLModule:120,
RLModuleSpec) and multi_rl_module.py — the reference's API that
separates the NETWORK (RLModule: three forward passes, no optimizer)
from the TRAINING LOOP (Learner: losses + optimizers, see learner.py).
Counterpart of ``ray_tpu/rllib/core/rl_module.py``:

- a module is an ``nn.Module`` (``models.make_model``) on ``device``
  (``"cuda"`` unless the caller asks for ``"cpu"``); the three forwards
  are batched (vector-env-wide, no per-env Python) and return host
  numpy; the private ``_forward_*`` keep tensors, so the Learner
  differentiates through ``_forward_train``;
- specs are plain dataclasses: ``build()`` is deterministic from
  (spaces, model_config, seed): the init draws from a CPU
  ``torch.Generator`` seeded with ``seed``, whatever the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib.env import Discrete
from ray_tpu_torch.rllib.models import (categorical_entropy, categorical_logp,
                                        categorical_sample,
                                        diag_gaussian_entropy,
                                        diag_gaussian_logp,
                                        diag_gaussian_sample, make_model)
from ray_tpu_torch.rllib.policy import load_weights, to_device_batch, weights_of


class RLModule:
    """Network container with the reference's three forward passes
    (reference: rl_module.py forward_inference:542 /
    forward_exploration:528 / forward_train:556)."""

    def __init__(self, observation_space, action_space,
                 model_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device="cuda"):
        self.observation_space = observation_space
        self.action_space = action_space
        self.model_config = dict(model_config or {})
        self.discrete = isinstance(action_space, Discrete)
        self.device = resolve_device(device)
        init_gen = torch.Generator().manual_seed(seed)
        self.model = make_model(observation_space, action_space,
                                self.model_config or None
                                ).init_weights(init_gen).to(self.device)
        self._gen = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=init_gen)))

    # ---- the three forwards on device tensors ----

    def _forward_inference(self, obs):
        dist_inputs, vf = self.model(obs)
        if self.discrete:
            actions = torch.argmax(dist_inputs, dim=-1)
        else:
            actions = torch.chunk(dist_inputs, 2, dim=-1)[0]
        return {"actions": actions, "action_dist_inputs": dist_inputs,
                "vf_preds": vf}

    def _forward_exploration(self, obs):
        dist_inputs, vf = self.model(obs)
        if self.discrete:
            actions = categorical_sample(self._gen, dist_inputs)
            logp = categorical_logp(dist_inputs, actions)
        else:
            actions = diag_gaussian_sample(self._gen, dist_inputs)
            logp = diag_gaussian_logp(dist_inputs, actions)
        return {"actions": actions, "action_logp": logp,
                "action_dist_inputs": dist_inputs, "vf_preds": vf}

    def _forward_train(self, obs):
        dist_inputs, vf = self.model(obs)
        return {"action_dist_inputs": dist_inputs, "vf_preds": vf}

    # ---- public API (host-facing; reference method names) ----

    @torch.no_grad()
    def _host_forward(self, fn, batch):
        obs = to_device_batch(batch, self.device, ("obs",))["obs"]
        out = fn(obs)
        if self.discrete and "actions" in out:
            out["actions"] = out["actions"].to(torch.int32)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def forward_inference(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
        return self._host_forward(self._forward_inference, batch)

    def forward_exploration(self, batch: Dict[str, np.ndarray]
                            ) -> Dict[str, np.ndarray]:
        return self._host_forward(self._forward_exploration, batch)

    def forward_train(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        return self._host_forward(self._forward_train, batch)

    # ---- distribution helpers the Learner's losses use ----

    def logp(self, dist_inputs, actions):
        if self.discrete:
            return categorical_logp(dist_inputs, actions)
        return diag_gaussian_logp(dist_inputs, actions)

    def entropy(self, dist_inputs):
        if self.discrete:
            return categorical_entropy(dist_inputs)
        return diag_gaussian_entropy(dist_inputs)

    # ---- weights ----

    def get_state(self) -> Dict[str, Any]:
        return weights_of(self.model)

    def set_state(self, state: Dict[str, Any]):
        load_weights(self.model, state)


@dataclass
class RLModuleSpec:
    """Deterministic module recipe (reference:
    rl_module.py RLModuleSpec) — build() on any worker yields an
    identical module."""

    observation_space: Any = None
    action_space: Any = None
    model_config: Dict[str, Any] = field(default_factory=dict)
    module_class: type = RLModule
    seed: int = 0
    device: str = "cuda"

    def build(self) -> RLModule:
        return self.module_class(self.observation_space,
                                 self.action_space,
                                 self.model_config, seed=self.seed,
                                 device=self.device)


class MultiRLModule:
    """Dict of RLModules by module id (reference:
    multi_rl_module.py MultiRLModule) — the multi-agent container the
    Learner iterates for per-module losses."""

    def __init__(self, specs: Dict[str, RLModuleSpec]):
        self._modules = {mid: spec.build() for mid, spec in specs.items()}

    def __getitem__(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def __contains__(self, module_id: str) -> bool:
        return module_id in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def get_state(self) -> Dict[str, Any]:
        return {mid: m.get_state() for mid, m in self._modules.items()}

    def set_state(self, state: Dict[str, Any]):
        for mid, st in state.items():
            self._modules[mid].set_state(st)
