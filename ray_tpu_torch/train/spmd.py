"""Training-step builders: the port of ``ray_tpu/train/spmd.py``.

The JAX package jits the whole step (forward, backward, optimizer
update) over a mesh. PyTorch runs it eagerly on one device in this
slice; the layout comes from the same ``MeshSpec``, and more than one
device raises (ROADMAP.md Queue A item 4).

The state is a dict ``{"model", "opt", "step"}``. Where JAX donates
the state buffers (``donate_argnums=(0,)``) so the update lands in
place, the port updates the module's f32 params and the optimizer's
moments in place and returns the same dict.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel.mesh import Mesh, MeshSpec

_DROPOUT_SEED = 17   # the JAX trainer's dropout base key


@dataclasses.dataclass
class SpmdTrainer:
    """A training program bound to a mesh.

    init(seed=0, params=None) -> state   (``params``: a flax GPT-2 tree
                                          to start from instead)
    step(state, batch) -> state, metrics
    """
    mesh: Mesh
    spec: MeshSpec
    init: Callable
    step: Callable
    device: torch.device


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every element squared."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, g_norm: torch.Tensor):
    """``optax.clip_by_global_norm`` in place: where ``g_norm >=
    max_norm`` each grad becomes ``g / g_norm * max_norm`` (no epsilon,
    unlike ``torch.nn.utils.clip_grad_norm_``); otherwise it stays."""
    keep = g_norm < max_norm
    div = torch.where(keep, torch.ones_like(g_norm), g_norm)
    mul = torch.where(keep, torch.ones_like(g_norm),
                      torch.full_like(g_norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)


def adamw(params, learning_rate: float, weight_decay: float):
    """``optax.adamw(lr, b1=.9, b2=.95, eps=1e-8, weight_decay=wd)``:
    the same update formula, and like optax it decays EVERY leaf
    (biases and LayerNorm included: no no-decay groups)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=weight_decay)


def make_causal_lm_trainer(model_config=None, *, spec: Optional[MeshSpec] = None,
                           learning_rate: float = 3e-4,
                           weight_decay: float = 0.1, grad_clip: float = 1.0,
                           model=None, device="cuda") -> SpmdTrainer:
    """GPT-style causal-LM trainer (the flagship train step): forward,
    ``causal_lm_loss``, backward, ``clip_by_global_norm(grad_clip)``,
    AdamW. Metrics: ``loss`` and ``grad_norm``, the global norm of the
    f32 grads before the clip. ``model`` (a ``GPT2``, copied at every
    ``init``) overrides ``model_config``; runs on ``cuda`` unless
    ``device`` says otherwise."""
    from ray_tpu_torch.models.gpt2 import (GPT2, GPT2Config, causal_lm_loss,
                                           params_from_flax)

    dev = resolve_device(device)
    if spec is None:
        spec = MeshSpec()
    mesh = spec.build([dev])
    if model is None:
        cfg = model_config or GPT2Config.small()
    else:
        cfg = model.cfg
    p_drop = float(cfg.dropout or 0.0)

    def init(seed: int = 0, params: Optional[Dict[str, Any]] = None):
        m = GPT2(cfg) if model is None else copy.deepcopy(model)
        if params is None:
            m.init_weights(torch.Generator().manual_seed(seed))
        else:
            params_from_flax(params, m)
        m = m.to(dev).train()
        opt = adamw(m.parameters(), learning_rate, weight_decay)
        return {"model": m, "opt": opt, "step": 0}

    def step(state, batch):
        m, opt = state["model"], state["opt"]
        gen = None
        if p_drop > 0.0:
            # a fresh stream per step, from the step number: the same
            # step of a restarted run drops the same units
            gen = torch.Generator(device=dev).manual_seed(
                (_DROPOUT_SEED << 32) + state["step"])
        opt.zero_grad(set_to_none=True)
        loss = causal_lm_loss(m(batch["input_ids"], dropout_generator=gen),
                              batch["labels"])
        loss.backward()
        grads = [p.grad for p in m.parameters()]
        g_norm = global_norm(grads)
        clip_by_global_norm_(grads, grad_clip, g_norm)
        opt.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": g_norm}

    return SpmdTrainer(mesh=mesh, spec=spec, init=init, step=step,
                       device=dev)


def put_batch(trainer: SpmdTrainer, batch: Dict[str, np.ndarray]):
    """Host batch -> tensors on the trainer's device (token ids as
    int64, which embedding and gather take)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(trainer.device)
    return out


def default_spec_for(n_devices: int) -> MeshSpec:
    """A multi-axis MeshSpec exercising dp/tp/sp for N devices: tp/sp
    innermost, dp taking the remainder."""
    tp = 2 if n_devices % 2 == 0 else 1
    rem = n_devices // tp
    sp = 2 if rem % 2 == 0 and rem >= 4 else 1
    dp = rem // sp
    return MeshSpec(dp=dp, sp=sp, tp=tp)
