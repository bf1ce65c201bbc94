"""Training-step builders: the port of ``ray_tpu/train/spmd.py``.

The JAX package jits the whole step (forward, backward, optimizer
update) over a mesh. PyTorch runs it eagerly on one device in this
slice; the layout comes from the same ``MeshSpec``, and more than one
device raises (ROADMAP.md Queue A item 4).

The state is a dict ``{"model", "opt", "step"}``. Where JAX donates
the state buffers (``donate_argnums=(0,)``) so the update lands in
place, the port updates the module's f32 params and the optimizer's
moments in place and returns the same dict. Batch-norm running stats
(flax's ``batch_stats``) live in the module's buffers.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel.mesh import Mesh, MeshSpec

_DROPOUT_SEED = 17   # the JAX trainer's dropout base key


@dataclasses.dataclass
class SpmdTrainer:
    """A training program bound to a mesh.

    init(seed=0, params=None) -> state   (``params``: a flax variables
                                          tree to start from instead)
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


def sgd_nesterov(params, learning_rate: float, momentum: float,
                 weight_decay: float):
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum,
    nesterov=True))``: the decay joins the grad before the momentum
    trace, as torch's ``weight_decay`` does, and like optax it decays
    EVERY leaf (batch-norm scales and biases, the Dense bias) in one
    group."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           weight_decay=weight_decay, nesterov=True)


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


def make_image_classifier_trainer(model, *, spec: Optional[MeshSpec] = None,
                                  learning_rate: float = 0.1,
                                  momentum: float = 0.9,
                                  weight_decay: float = 1e-4,
                                  input_shape: Tuple[int, ...] = (1, 224, 224,
                                                                  3),
                                  device="cuda") -> SpmdTrainer:
    """ResNet-style trainer with batch-norm state: forward in train
    mode (batch stats, running stats updated in the module's buffers),
    mean softmax cross-entropy on the f32 logits, backward, weight decay
    and SGD with Nesterov momentum. Metrics: ``loss`` and ``accuracy``
    (argmax, the first maximum on ties). A batch is ``{"image": NHWC
    uint8 or float, "label": int}``; uint8 images become ``x / 127.5 -
    1`` in f32 on the device. ``model`` (a ``models.resnet.ResNet``) is
    copied at every ``init``; ``input_shape`` is the images' NHWC shape,
    whose channels must be the model's. Runs on ``cuda`` unless
    ``device`` says otherwise."""
    from ray_tpu_torch.models.resnet import params_from_flax

    dev = resolve_device(device)
    if spec is None:
        spec = MeshSpec()
    mesh = spec.build([dev])
    if input_shape[-1] != model.in_features:
        raise ValueError(f"input_shape {tuple(input_shape)} has "
                         f"{input_shape[-1]} channels; the model takes "
                         f"{model.in_features}")

    def init(seed: int = 0, params: Optional[Dict[str, Any]] = None):
        m = copy.deepcopy(model)
        if params is None:
            m.init_weights(torch.Generator().manual_seed(seed))
        else:
            params_from_flax(params, m)
        # conv kernels in the activations' layout: no copy per call
        m = m.to(dev, memory_format=torch.channels_last).train()
        opt = sgd_nesterov(m.parameters(), learning_rate, momentum,
                           weight_decay)
        return {"model": m, "opt": opt, "step": 0}

    def step(state, batch):
        m, opt = state["model"], state["opt"]
        img, label = batch["image"], batch["label"]
        if img.dtype == torch.uint8:
            # ship bytes, normalise on the device
            img = img.float() / 127.5 - 1.0
        opt.zero_grad(set_to_none=True)
        logits = m(img)
        loss = F.cross_entropy(logits, label)
        loss.backward()
        opt.step()
        state["step"] += 1
        acc = (logits.detach().argmax(-1) == label).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return SpmdTrainer(mesh=mesh, spec=spec, init=init, step=step,
                       device=dev)


def put_batch(trainer: SpmdTrainer, batch: Dict[str, np.ndarray]):
    """Host batch -> tensors on the trainer's device, dtypes kept except
    that integers other than uint8 become int64 (token ids and labels:
    what embedding, gather and the loss take). uint8 images stay bytes
    until the step normalises them on the device."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not t.is_floating_point() and t.dtype != torch.uint8:
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
