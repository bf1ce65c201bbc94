"""Training-step builders: the port of ``ray_tpu/train/spmd.py``.

The JAX package jits the whole step (forward, backward, optimizer
update) over a mesh and lets XLA place the collectives. The port runs
it eagerly, one process per device, on a ``Mesh`` from the same
``MeshSpec``:

  - without a process group: one device, no collective;
  - with one (``collectives.initialize_distributed``; NCCL on the card,
    gloo on the CPU): dp, fsdp and tp over the group's ranks. Each
    rank stores, and its optimizer updates, only its block of each
    param (``state_shardings``: the JAX package's ``param_sharding``
    rules, so the optimizer's moments are sharded as in ZeRO). A step
    gathers the whole params, runs forward and backward on the rank's
    rows of the global batch (``put_batch``: by its (dp, fsdp)
    coordinate, dp-major), sums the grads over (dp, fsdp) and keeps
    each block's part (``_MeshState``). Under tp the model splits its
    own work (``GPT2.set_mesh``: heads, MLP columns, the tied head);
    ResNet's convs are not split (tp shards their storage only), and
    its batch norm takes global-batch statistics (``ResNet.set_mesh``).

One step on n ranks computes what one step on one device computes for
the whole global batch: the loss is the global mean (over the valid
tokens of the whole batch, however the ignored ones fall), the grad norm
and the clip are global, and so are batch norm's statistics and the
accuracy. Only the order of the sums differs.

The state is a dict ``{"model", "opt", "step", "mesh_state"}``. Where
JAX donates the state buffers (``donate_argnums=(0,)``) so the update
lands in place, the port updates the params and the optimizer's
moments in place and returns the same dict. Batch-norm running stats
(flax's ``batch_stats``) live in the module's buffers, whole on every
rank. ``gather_state`` reads the whole params and moments back.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import (BATCH_AXES, Mesh,
                                         MeshSpec, local_shard,
                                         param_sharding, shard_dims)

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


def flax_layout(model: nn.Module) -> Dict[str, Tuple[tuple, tuple]]:
    """For every param and batch-norm buffer of a port model: its
    flax-style path (``("params", "h_0", "attn", "c_attn", "kernel")``,
    ``("batch_stats", "bn_init", "mean")``) and, for each flax dim, the
    torch dim that holds it (a Dense kernel [in, out] is the
    transposed ``weight`` [out, in]; a conv kernel HWIO is OIHW)."""
    out = {}
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        prefix, _, attr = name.rpartition(".")
        mod = model.get_submodule(prefix)
        coll, perm = "params", tuple(range(t.ndim))
        if attr in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", attr[len("running_"):]
        elif isinstance(mod, nn.Embedding):
            leaf = "embedding"
        elif attr == "bias":
            leaf = "bias"
        elif attr == "weight" and t.ndim == 1:
            leaf = "scale"
        elif attr == "weight" and t.ndim in (2, 4):
            leaf, perm = "kernel", ((1, 0) if t.ndim == 2 else (2, 3, 1, 0))
        else:
            raise ValueError(f"{name}: no flax counterpart")
        out[name] = ((coll, *prefix.split("."), leaf), perm)
    return out


def state_shardings(model: nn.Module, mesh,
                    spec: MeshSpec) -> Dict[str, tuple]:
    """The placements (one per mesh axis, on the torch tensor's dims) of
    every param and batch-norm buffer of ``model``: ``param_sharding``
    on the flax path and shape. The optimizer's moments take their
    param's. (The trainers keep the buffers whole on every rank.)"""
    from torch.distributed.tensor import Shard
    tensors = dict(itertools.chain(model.named_parameters(),
                                   model.named_buffers()))
    out = {}
    for name, (path, perm) in flax_layout(model).items():
        shape = tuple(tensors[name].shape[d] for d in perm)
        out[name] = tuple(Shard(perm[p.dim]) if p.is_shard() else p
                          for p in param_sharding(mesh, path, shape, spec))
    return out


def _batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the batch's ranks (dp and fsdp)."""
    return C.psum(x, BATCH_AXES, mesh)


class _MeshState:
    """The mesh route's params. The master copy of each param is this
    rank's block of it (``state_shardings``); the optimizer updates the
    blocks. Where no axis shards a param its block is the model's param
    itself; the others are gathered into the model's params at the
    start of each step. Without a process group nothing is sharded and
    no collective runs."""

    def __init__(self, model: nn.Module, mesh: Mesh, spec: MeshSpec):
        self.mesh = mesh
        self.params = dict(model.named_parameters())
        placements = state_shardings(model, mesh, spec)
        self.sharded = {n: shard_dims(placements[n]) for n in self.params
                        if shard_dims(placements[n])}
        self.shards = {
            n: (nn.Parameter(local_shard(p.detach(), placements[n],
                                         mesh).clone())
                if n in self.sharded else p)
            for n, p in self.params.items()}

    def full(self, name: str, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``block`` is this rank's block under
        param ``name``'s placements (a collective)."""
        for axis, dim in reversed(list(self.sharded.get(name, {}).items())):
            block = C.all_gather(block, axis, self.mesh, gather_axis=dim)
        return block

    @torch.no_grad()
    def gather(self):
        for n in self.sharded:
            self.params[n].copy_(self.full(n, self.shards[n]))

    def _grad(self, n):
        g = self.params[n].grad
        return torch.zeros_like(self.params[n]) if g is None else g

    @torch.no_grad()
    def reduce_grads(self):
        """The model params' grads (this rank's rows) -> each block's
        grad for the global batch: summed over (dp, fsdp), of which the
        block keeps its part (fsdp by reduce-scatter, tp by a slice:
        every tp rank holds the same whole grad)."""
        mesh = self.mesh
        if mesh.device_mesh is None:
            return
        whole = [n for n in self.params if n not in self.sharded]
        if whole:
            grads = [self._grad(n) for n in whole]
            flat = _batch_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
            for n, g, part in zip(whole, grads, flat.split(
                    [g.numel() for g in grads])):
                g.copy_(part.view(g.shape))
                self.params[n].grad = g
        for n, dims in self.sharded.items():
            g = self._grad(n)
            if "fsdp" in dims:
                g = C.psum(C.reduce_scatter(g, "fsdp", mesh,
                                            scatter_axis=dims["fsdp"]),
                           "dp", mesh)
            else:
                g = _batch_sum(g, mesh)
            if "tp" in dims:
                g = g.chunk(mesh.size("tp"), dims["tp"])[mesh.index("tp")]
            self.shards[n].grad = g.contiguous()

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the grads of the whole params: each block's
        sum of squares, summed over the axes that shard it (in param
        order, as ``global_norm`` sums on one device)."""
        parts: Dict[tuple, torch.Tensor] = {}
        for n, block in self.shards.items():
            axes = tuple(self.sharded.get(n, ()))
            sq = block.grad.float().square().sum()
            parts[axes] = parts[axes] + sq if axes in parts else sq
        total = None
        for axes, sq in parts.items():
            for axis in axes:
                sq = C.psum(sq, axis, self.mesh)
            total = sq if total is None else total + sq
        return torch.sqrt(total)


def _zero_grads(state):
    state["opt"].zero_grad(set_to_none=True)
    state["model"].zero_grad(set_to_none=True)


@torch.no_grad()
def gather_state(state) -> Dict[str, Any]:
    """The whole params and buffers (``"model"``, a state_dict) and the
    optimizer's per-param state (``"opt"``: {param name: {key: tensor}})
    of a trainer state, on every rank. A collective on the mesh route:
    every rank calls it."""
    ms: _MeshState = state["mesh_state"]
    model = {**{n: ms.full(n, ms.shards[n]).detach().clone()
                for n in ms.params},
             **{n: b.detach().clone()
                for n, b in state["model"].named_buffers()}}
    opt = {}
    for n, block in ms.shards.items():
        st = state["opt"].state.get(block, {})
        opt[n] = {k: (ms.full(n, v).clone() if torch.is_tensor(v) and v.ndim
                      else v) for k, v in st.items()}
    return {"model": model, "opt": opt}


def _build(spec: Optional[MeshSpec], device) -> Tuple[Mesh, MeshSpec]:
    spec = MeshSpec() if spec is None else spec
    return spec.build([resolve_device(device)]), spec


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


def make_causal_lm_trainer(model_config=None, *,
                           spec: Optional[MeshSpec] = None,
                           learning_rate: float = 3e-4,
                           weight_decay: float = 0.1, grad_clip: float = 1.0,
                           model=None, exact: bool = False,
                           device="cuda") -> SpmdTrainer:
    """GPT-style causal-LM trainer (the flagship train step): forward,
    ``causal_lm_loss``, backward, ``clip_by_global_norm(grad_clip)``,
    AdamW. Metrics: ``loss`` and ``grad_norm``, the global norm of the
    f32 grads before the clip. ``model`` (a ``GPT2``, copied at every
    ``init``) overrides ``model_config``. ``exact=True`` sends the
    attention down the streaming path (``flash_attention(exact=True)``:
    the exact running-max softmax), as the JAX package's
    ``RTPU_ATTN_EXACT`` does. ``mesh`` (default ``spec.build()``) picks
    the route (module docstring); runs on ``cuda`` unless ``device``
    says otherwise. Dropout runs on the route without a process group
    only."""
    from ray_tpu_torch.models.gpt2 import (GPT2, GPT2Config,
                                           causal_lm_loss_terms,
                                           params_from_flax)

    mesh, spec = _build(spec, device)
    dev = mesh.device
    if model is None:
        cfg = model_config or GPT2Config.small()
    else:
        cfg = model.cfg
    p_drop = float(cfg.dropout or 0.0)
    if p_drop > 0.0 and mesh.device_mesh is not None:
        raise NotImplementedError(
            "dropout on a mesh with a process group: each rank would need "
            "its rows of the one-device mask")

    def init(seed: int = 0, params: Optional[Dict[str, Any]] = None):
        m = GPT2(cfg) if model is None else copy.deepcopy(model)
        if params is None:
            m.init_weights(torch.Generator().manual_seed(seed))
        else:
            params_from_flax(params, m)
        m = m.to(dev).train().set_exact(exact).set_mesh(mesh)
        ms = _MeshState(m, mesh, spec)
        opt = adamw(list(ms.shards.values()), learning_rate, weight_decay)
        return {"model": m, "opt": opt, "step": 0, "mesh_state": ms}

    def step(state, batch):
        m, opt, ms = state["model"], state["opt"], state["mesh_state"]
        gen = None
        if p_drop > 0.0:
            # a fresh stream per step, from the step number: the same
            # step of a restarted run drops the same units
            gen = torch.Generator(device=dev).manual_seed(
                (_DROPOUT_SEED << 32) + state["step"])
        ms.gather()
        _zero_grads(state)
        total, count = causal_lm_loss_terms(
            m(batch["input_ids"], dropout_generator=gen), batch["labels"])
        count = _batch_sum(count, mesh).clamp(min=1)
        (total / count).backward()
        ms.reduce_grads()
        g_norm = ms.grad_norm()
        clip_by_global_norm_([b.grad for b in ms.shards.values()],
                             grad_clip, g_norm)
        opt.step()
        state["step"] += 1
        loss = _batch_sum(total.detach(), mesh) / count
        return state, {"loss": loss, "grad_norm": g_norm}

    return SpmdTrainer(mesh=mesh, spec=spec, init=init, step=step,
                       device=dev)


def make_image_classifier_trainer(model, *,
                                  spec: Optional[MeshSpec] = None,
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
    whose channels must be the model's. On a mesh with a process group
    batch norm takes global-batch statistics, as the JAX trainer's does
    under ``jit`` (whose docstring says local shard statistics; what it
    computes is global). ``spec.build()`` picks the route; runs on
    ``cuda`` unless ``device`` says otherwise."""
    from ray_tpu_torch.models.resnet import params_from_flax

    mesh, spec = _build(spec, device)
    dev = mesh.device
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
        m.set_mesh(mesh)
        ms = _MeshState(m, mesh, spec)
        opt = sgd_nesterov(list(ms.shards.values()), learning_rate,
                           momentum, weight_decay)
        return {"model": m, "opt": opt, "step": 0, "mesh_state": ms}

    def step(state, batch):
        m, opt, ms = state["model"], state["opt"], state["mesh_state"]
        img, label = batch["image"], batch["label"]
        if img.dtype == torch.uint8:
            # ship bytes, normalise on the device
            img = img.float() / 127.5 - 1.0
        ms.gather()
        _zero_grads(state)
        logits = m(img)
        n = _batch_sum(torch.full((), float(label.shape[0]), device=dev),
                       mesh)
        total = F.cross_entropy(logits, label, reduction="sum")
        (total / n).backward()
        ms.reduce_grads()
        opt.step()
        state["step"] += 1
        hits = (logits.detach().argmax(-1) == label).float().sum()
        return state, {"loss": _batch_sum(total.detach(), mesh) / n,
                       "accuracy": _batch_sum(hits, mesh) / n}

    return SpmdTrainer(mesh=mesh, spec=spec, init=init, step=step,
                       device=dev)


def put_batch(trainer: SpmdTrainer, batch: Dict[str, np.ndarray]):
    """Host batch (the global batch) -> this rank's rows as tensors on
    the trainer's device: the batch dim split over (dp, fsdp), dp-major,
    as ``P(("dp", "fsdp"))`` splits it. Dtypes are kept except that
    integers other than uint8 become int64 (token ids and labels: what
    embedding, gather and the loss take). uint8 images stay bytes until
    the step normalises them on the device."""
    mesh = trainer.mesh
    n, i = mesh.size(BATCH_AXES), mesh.index(BATCH_AXES)
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.shape[0] % n:
            raise ValueError(f"{k}: a batch of {a.shape[0]} rows does not "
                             f"split over {n} (dp, fsdp) ranks")
        rows = a.shape[0] // n
        t = torch.as_tensor(a[i * rows:(i + 1) * rows])
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
