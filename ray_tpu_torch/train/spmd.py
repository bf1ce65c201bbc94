"""Training-step builders: the port of ``ray_tpu/train/spmd.py``.

The JAX package jits the whole step (forward, backward, optimizer
update) over a mesh and lets XLA place the collectives. The port runs
it eagerly, one process per device, on a ``Mesh`` from the same
``MeshSpec``:

  - without a process group: one device, no collective;
  - with one (``collectives.initialize_distributed``; NCCL on the card,
    gloo on the CPU): every axis over the group's ranks. Each
    rank stores, and its optimizer updates, only its block of each
    param (``state_shardings``: the JAX package's ``param_sharding``
    rules, so the optimizer's moments are sharded as in ZeRO). A step
    gathers the whole params, runs forward and backward on the rank's
    part of the global batch (``put_batch``: rows by its (dp, fsdp)
    coordinate, dp-major, and for a causal LM positions by its sp
    coordinate), sums the grads over (dp, fsdp) (and sp) and keeps
    each block's part (``_MeshState``). Under tp the model splits its
    own work (``GPT2.set_mesh``: heads, MLP columns, the tied head);
    ResNet's convs are not split (tp shards their storage only), and
    its batch norm takes global-batch statistics (``ResNet.set_mesh``).
    Under sp GPT-2's attention runs through the ring, its positions
    and the loss's one-token shift cross the slices' bounds. Under pp
    (``make_pipelined_lm_trainer``) each rank holds one stage of
    blocks and ``parallel.pipeline`` runs the microbatch schedule.

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
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.gpt2 import (Block, Dense, Embed, LayerNorm,
                                       init_flax_weights, set_blocks_mesh)
from ray_tpu_torch.ops.attention import TRAINING_KERNELS
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import (BATCH_AXES, TOKEN_AXES, Mesh,
                                         MeshSpec, local_shard,
                                         param_sharding, shard_dims)

_DROPOUT_SEED = 17   # the JAX trainer's dropout base key


@dataclasses.dataclass
class SpmdTrainer:
    """A training program bound to a mesh.

    init(seed=0, params=None) -> state   (``params``: a flax variables
                                          tree to start from instead)
    step(state, batch) -> state, metrics
    eval_loss(state, batch) -> loss      (the pipelined trainer's pp = 1
                                          oracle on the same params)

    ``batch_dims`` gives, for each batch key, the axes that split each
    of its dims (None: whole), as the JAX trainer's batch
    ``PartitionSpec``s do; ``put_batch`` reads it.
    """
    mesh: Mesh
    spec: MeshSpec
    init: Callable
    step: Callable
    device: torch.device
    batch_dims: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    eval_loss: Optional[Callable] = None


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
        elif attr.startswith("experts_"):     # MoE: flax's own layout
            leaf = attr
        else:
            raise ValueError(f"{name}: no flax counterpart")
        out[name] = ((coll, *prefix.split("."), leaf), perm)
    return out


def state_shardings(model: nn.Module, mesh, spec: MeshSpec,
                    override: Optional[Callable] = None) -> Dict[str, tuple]:
    """The placements (one per mesh axis, on the torch tensor's dims) of
    every param and batch-norm buffer of ``model``: ``param_sharding``
    on the flax path and shape, or what ``override(mesh, path, shape,
    spec)`` returns where it returns placements (the JAX package's
    ``override`` hook; e.g. ``moe.expert_sharding_rule``). The
    optimizer's moments take their param's. (The trainers keep the
    buffers whole on every rank.)"""
    from torch.distributed.tensor import Shard
    tensors = dict(itertools.chain(model.named_parameters(),
                                   model.named_buffers()))
    out = {}
    for name, (path, perm) in flax_layout(model).items():
        shape = tuple(tensors[name].shape[d] for d in perm)
        pl = override(mesh, path, shape, spec) if override else None
        if pl is None:
            pl = param_sharding(mesh, path, shape, spec)
        out[name] = tuple(Shard(perm[p.dim]) if p.is_shard() else p
                          for p in pl)
    return out


def _batch_sum(x: torch.Tensor, mesh, axes=BATCH_AXES) -> torch.Tensor:
    """The sum of ``x`` over the batch's ranks (dp and fsdp; ``axes``
    = ``TOKEN_AXES`` adds sp)."""
    return C.psum(x, axes, mesh)


# axes whose ranks each compute a part of the work on the same batch
# rows and, after the backward, hold the same whole gradient
_MODEL_AXES = ("tp", "ep")


class _MeshState:
    """The mesh route's params. The master copy of each param is this
    rank's block of it (``state_shardings``); the optimizer updates the
    blocks. Where no axis shards a param its block is the model's param
    itself; the others are gathered into the model's params at the
    start of each step. Without a process group nothing is sharded and
    no collective runs.

    ``sum_axes``: the axes over which the batch's work is split, over
    which the grads are summed (``BATCH_AXES``; ``TOKEN_AXES`` for a
    causal LM, whose positions sp splits). ``pieces`` = {param name:
    axes}: params of which each rank along those axes holds a piece of
    its own that no placement names (pp: a stage's blocks); their grads
    are not summed there, and the global norm counts each piece once."""

    def __init__(self, model: nn.Module, mesh: Mesh, spec: MeshSpec, *,
                 sum_axes=BATCH_AXES, override: Optional[Callable] = None,
                 pieces: Optional[Dict[str, tuple]] = None):
        self.mesh = mesh
        self.sum_axes = sum_axes
        self.pieces = dict(pieces or {})
        self.params = dict(model.named_parameters())
        placements = state_shardings(model, mesh, spec, override)
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
        """The model params' grads (this rank's part of the batch) ->
        each block's grad for the global batch: summed over
        ``sum_axes``, of which the block keeps its part (fsdp by
        reduce-scatter; tp and ep by a slice: every rank along them
        holds the same whole grad)."""
        mesh = self.mesh
        if mesh.device_mesh is None:
            return
        whole = [n for n in self.params if n not in self.sharded]
        if whole:
            grads = [self._grad(n) for n in whole]
            flat = _batch_sum(torch.cat([g.reshape(-1) for g in grads]), mesh,
                              self.sum_axes)
            for n, g, part in zip(whole, grads, flat.split(
                    [g.numel() for g in grads])):
                g.copy_(part.view(g.shape))
                self.params[n].grad = g
        for n, dims in self.sharded.items():
            g = self._grad(n)
            if "fsdp" in dims:
                g = C.reduce_scatter(g, "fsdp", mesh,
                                     scatter_axis=dims["fsdp"])
                for axis in self.sum_axes:
                    if axis != "fsdp":
                        g = C.psum(g, axis, mesh)
            else:
                g = _batch_sum(g, mesh, self.sum_axes)
            for axis in _MODEL_AXES:
                if axis in dims:
                    g = g.chunk(mesh.size(axis), dims[axis])[mesh.index(axis)]
            self.shards[n].grad = g.contiguous()

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the grads of the whole params: each block's
        sum of squares, summed over the axes that shard it and the axes
        of its ``pieces`` (in param order, as ``global_norm`` sums on
        one device)."""
        parts: Dict[tuple, torch.Tensor] = {}
        for n, block in self.shards.items():
            axes = tuple(self.sharded.get(n, ())) + self.pieces.get(n, ())
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
    of a trainer state, on every rank, as copies (AdamW steps its
    moments and its ``step`` scalars in place). A param held in
    ``pieces`` (a pipeline's stage) comes stacked on a new leading
    axis, one row per rank of the piece's axis. A collective on the
    mesh route: every rank calls it."""
    ms: _MeshState = state["mesh_state"]

    def whole(n, t):
        t = ms.full(n, t)
        for axis in ms.pieces.get(n, ()):
            t = C.all_gather(t, axis, ms.mesh, tiled=False)
        return t.detach().clone()
    model = {**{n: whole(n, ms.shards[n]) for n in ms.params},
             **{n: b.detach().clone()
                for n, b in state["model"].named_buffers()}}
    opt = {}
    for n, block in ms.shards.items():
        st = state["opt"].state.get(block, {})
        opt[n] = {k: (whole(n, v) if torch.is_tensor(v) and v.ndim
                      else v.detach().clone() if torch.is_tensor(v)
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
    ``RTPU_ATTN_EXACT`` does. ``spec.build()`` picks the route (module
    docstring); runs on ``cuda`` unless ``device`` says otherwise.
    Batches are [B, T]: B split over (dp, fsdp), T over sp, as JAX's
    ``P(("dp", "fsdp"), "sp")``; at sp > 1 the one-device step's
    semantics hold (global positions, the loss's shift across slices,
    the token count and the grads summed over sp too). Dropout runs on
    the route without a process group only."""
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
        ms = _MeshState(m, mesh, spec, sum_axes=TOKEN_AXES)
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
        labels = batch["labels"]
        total, count = causal_lm_loss_terms(
            m(batch["input_ids"], dropout_generator=gen), labels,
            next_labels=next_labels(labels, mesh))
        count = _batch_sum(count, mesh, TOKEN_AXES).clamp(min=1)
        (total / count).backward()
        ms.reduce_grads()
        g_norm = ms.grad_norm()
        clip_by_global_norm_([b.grad for b in ms.shards.values()],
                             grad_clip, g_norm)
        opt.step()
        state["step"] += 1
        loss = _batch_sum(total.detach(), mesh, TOKEN_AXES) / count
        return state, {"loss": loss, "grad_norm": g_norm}

    rows_pos = (BATCH_AXES, "sp")       # JAX's P(("dp", "fsdp"), "sp")
    return SpmdTrainer(mesh=mesh, spec=spec, init=init, step=step,
                       device=dev, batch_dims={"input_ids": rows_pos,
                                               "labels": rows_pos})


def next_labels(labels: torch.Tensor, mesh, axis: str = "sp",
                ignore_index: int = -100):
    """For a causal LM whose positions ``axis`` splits: each row's label
    at the first position of the next slice ([B, 1]; ``ignore_index``
    on the last slice), from the next rank along ``axis``. None where
    the axis has size 1."""
    n = mesh.size(axis)
    if n == 1:
        return None
    got = C.ppermute(labels[:, :1].contiguous(), axis, mesh,
                     [(i, i - 1) for i in range(1, n)])
    if mesh.index(axis) == n - 1:
        got = torch.full_like(got, ignore_index)
    return got


class PipelineEmbed(nn.Module):
    """The pipelined trainer's embedding, outside the pipeline: wte(ids)
    + wpe(positions) in ``cfg.dtype`` (flax ``Embed``s)."""

    def __init__(self, cfg):
        super().__init__()
        self.wte = Embed(cfg.vocab_size, cfg.n_embd, cfg.dtype)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, cfg.dtype)

    def forward(self, ids, offset: int = 0):
        pos = torch.arange(ids.shape[-1], device=ids.device) + offset
        return self.wte(ids) + self.wpe(pos)


class PipelineStage(nn.Module):
    """One pipeline stage: ``n_layer / pp`` GPT-2 ``Block``s
    (``h_0`` ...), deterministic."""

    def __init__(self, cfg, n_blocks: int):
        super().__init__()
        for i in range(n_blocks):
            self.add_module(f"h_{i}", Block(cfg, TRAINING_KERNELS))

    def blocks(self):
        return list(self.children())

    def forward(self, x):
        for blk in self.blocks():
            x = blk(x)
        return x


class PipelineHead(nn.Module):
    """The final LayerNorm and an untied f32 ``lm_head`` Dense (with
    bias): f32 logits."""

    def __init__(self, cfg):
        super().__init__()
        self.ln_f = LayerNorm(cfg.n_embd)
        self.lm_head = Dense(cfg.n_embd, cfg.vocab_size, torch.float32)

    def forward(self, x):
        return self.lm_head(self.ln_f(x))


class PipelinedLM(nn.Module):
    """This rank's part of the pipelined causal LM: ``embed`` and
    ``head`` (the same on every pp rank) and ``stages``, the rank's own
    stage. Module paths are the JAX trainer's param tree
    (``{"embed", "stages", "head"}``) without the stage axis."""

    def __init__(self, cfg, n_stages: int):
        super().__init__()
        if cfg.n_layer % n_stages:
            raise ValueError(f"n_layer={cfg.n_layer} must divide into "
                             f"pp={n_stages} stages")
        self.cfg = cfg
        self.embed = PipelineEmbed(cfg)
        self.stages = PipelineStage(cfg, cfg.n_layer // n_stages)
        self.head = PipelineHead(cfg)

    def set_mesh(self, mesh):
        """tp splits each block's heads and MLP columns (GPT-2's tp
        path); sp sends its attention through the ring."""
        set_blocks_mesh(self.stages.blocks(), self.cfg, mesh)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, stage: int,
                     n_stages: int):
        """flax's initialisers from ``generator`` in the order embed,
        the n_layer blocks of every stage, head, so that the params do
        not depend on the pp size; this rank keeps ``stage``'s blocks."""
        init_flax_weights(self.embed, generator)
        mine = self.stages.blocks()
        for s in range(n_stages):
            for i in range(len(mine)):
                init_flax_weights(mine[i] if s == stage else
                                  Block(self.cfg, None), generator)
        init_flax_weights(self.head, generator)
        return self


def pipelined_params_from_flax(tree: Dict[str, Any], stage: int,
                               model: Optional[PipelinedLM] = None
                               ) -> Dict[str, torch.Tensor]:
    """The JAX pipelined trainer's params (``{"params": {"embed",
    "stages", "head"}}``; ``stages``' leaves have the leading stage axis)
    -> ``PipelinedLM``'s state_dict in f32 for pp rank ``stage`` (its
    row of ``stages``). With ``model`` the weights are also loaded."""
    from ray_tpu_torch.models.gpt2 import params_from_flax
    p = tree["params"]
    row = _tree_rows(p["stages"], stage)
    blocks = params_from_flax({"params": {
        **row, "wte": {"embedding": p["embed"]["wte"]["embedding"]},
        "wpe": {"embedding": p["embed"]["wpe"]["embedding"]},
        "ln_f": p["head"]["ln_f"]}})

    def t(x, transpose=False):
        a = torch.from_numpy(np.array(np.asarray(x), np.float32))
        return a.T.contiguous() if transpose else a
    sd = {"embed.wte.weight": blocks.pop("wte.weight"),
          "embed.wpe.weight": blocks.pop("wpe.weight"),
          "head.ln_f.weight": blocks.pop("ln_f.weight"),
          "head.ln_f.bias": blocks.pop("ln_f.bias"),
          "head.lm_head.weight": t(p["head"]["lm_head"]["kernel"], True),
          "head.lm_head.bias": t(p["head"]["lm_head"]["bias"]),
          **{f"stages.{k}": v for k, v in blocks.items()}}
    if model is not None:
        model.load_state_dict(sd)
    return sd


def _tree_rows(tree, i):
    if isinstance(tree, Mapping):
        return {k: _tree_rows(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def make_pipelined_lm_trainer(model_config, *,
                              spec: Optional[MeshSpec] = None,
                              learning_rate: float = 3e-4,
                              weight_decay: float = 0.1,
                              grad_clip: float = 1.0,
                              device="cuda") -> SpmdTrainer:
    """Causal-LM trainer with pipeline parallelism over ``pp``: the
    embedding outside the pipeline (the same on every pp rank), the
    rank's stage of GPT-2 ``Block``s through ``pipeline.pipeline_run``
    (remat: each stage's forward again in the backward), the final
    LayerNorm and an untied f32 ``lm_head`` (the same on every pp
    rank), ``causal_lm_loss`` over all microbatches; then the global
    norm, the clip and AdamW (b2 0.95), as ``make_causal_lm_trainer``.
    Batches are [M, mb, T]: M microbatches, mb split over (dp, fsdp),
    T over sp (JAX's ``P(None, ("dp", "fsdp"), "sp")``). Gradients:
    the embedding's flow through stage 0's inputs only, the head's
    come from the loss on every pp rank and are not summed over pp, and
    each stage's count once in the global norm. ``eval_loss(state,
    batch)`` is the pp = 1 oracle on the same params
    (``pipeline.sequential_apply``). The blocks run deterministic, as
    the JAX trainer's do. Runs on ``cuda`` unless ``device`` says
    otherwise."""
    from ray_tpu_torch.models.gpt2 import causal_lm_loss_terms
    from ray_tpu_torch.parallel.pipeline import (pipeline_run,
                                                 sequential_apply)
    from torch.func import functional_call

    cfg = model_config
    mesh, spec = _build(spec, device)
    dev = mesh.device
    S, stage = mesh.size("pp"), mesh.index("pp")
    if cfg.n_layer % S:
        raise ValueError(f"n_layer={cfg.n_layer} must divide into pp={S} "
                         "stages")

    def init(seed: int = 0, params: Optional[Dict[str, Any]] = None):
        m = PipelinedLM(cfg, S)
        if params is None:
            m.init_weights(torch.Generator().manual_seed(seed), stage, S)
        else:
            pipelined_params_from_flax(params, stage, m)
        m = m.to(dev).train().set_mesh(mesh)
        ms = _MeshState(m, mesh, spec, sum_axes=TOKEN_AXES, pieces={
            n: ("pp",) for n, _ in m.named_parameters()
            if n.startswith("stages.")})
        opt = adamw(list(ms.shards.values()), learning_rate, weight_decay)
        return {"model": m, "opt": opt, "step": 0, "mesh_state": ms}

    def stage_fn(model):
        return lambda p, x: functional_call(model.stages, p, (x,))

    def loss_terms(model, y, labels):
        M, mb, T = labels.shape
        logits = model.head(y)
        labels = labels.reshape(M * mb, T)
        return causal_lm_loss_terms(logits.reshape(M * mb, T, -1), labels,
                                    next_labels=next_labels(labels, mesh))

    def embed(model, ids):
        return model.embed(ids, mesh.index("sp") * ids.shape[-1]).to(
            cfg.dtype)

    def step(state, batch):
        m, opt, ms = state["model"], state["opt"], state["mesh_state"]
        ms.gather()
        _zero_grads(state)
        x = embed(m, batch["input_ids"])
        params = dict(m.stages.named_parameters())
        y = pipeline_run(stage_fn(m), params, x, mesh)
        total, count = loss_terms(m, y, batch["labels"])
        count = _batch_sum(count, mesh, TOKEN_AXES).clamp(min=1)
        (total / count).backward()
        ms.reduce_grads()
        g_norm = ms.grad_norm()
        clip_by_global_norm_([b.grad for b in ms.shards.values()],
                             grad_clip, g_norm)
        opt.step()
        state["step"] += 1
        loss = _batch_sum(total.detach(), mesh, TOKEN_AXES) / count
        return state, {"loss": loss, "grad_norm": g_norm}

    @torch.no_grad()
    def eval_loss(state, batch):
        """The pp = 1 oracle: the same params, every stage in order on
        each microbatch (the other stages' params gathered over pp)."""
        m, ms = state["model"], state["mesh_state"]
        ms.gather()
        stacked = {n[len("stages."):]: C.all_gather(p, "pp", mesh,
                                                    tiled=False)
                   for n, p in m.named_parameters()
                   if n.startswith("stages.")}
        y = sequential_apply(stage_fn(m), stacked,
                             embed(m, batch["input_ids"]))
        total, count = loss_terms(m, y, batch["labels"])
        return (_batch_sum(total, mesh, TOKEN_AXES)
                / _batch_sum(count, mesh, TOKEN_AXES).clamp(min=1))

    dims = (None, BATCH_AXES, "sp")     # JAX's P(None, ("dp", "fsdp"), "sp")
    return SpmdTrainer(mesh=mesh, spec=spec, init=init, step=step,
                       device=dev, batch_dims={"input_ids": dims,
                                               "labels": dims},
                       eval_loss=eval_loss)


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
                       device=dev,
                       batch_dims={"image": (BATCH_AXES,),
                                   "label": (BATCH_AXES,)})


SESSION_NEEDS_A6B = (
    "{what} without manager= binds to the train session's checkpoint "
    "root, which needs the train gang (ROADMAP.md Queue A, A6b); pass "
    "manager= (a CheckpointManager){alt}")


def _rank_and_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_async_checkpointer(manager=None, **kwargs):
    """An ``AsyncCheckpointer`` for a trainer state, bound to
    ``manager`` (a ``CheckpointManager``). ``process_index`` and
    ``process_count`` default to the process group's rank and world
    size (0 and 1 without one), so each rank writes its own
    ``process_<rank>/``; a single process commits its own saves, a gang
    commits through ``commit_gang_step``. ``async_=False`` writes
    inline. Without ``manager`` it would bind to the train session's
    root (A6b): it raises.

    Usage::

        ckpter = spmd.make_async_checkpointer(manager=mgr)
        ...
        ckpter.save(state["step"], state)  # blocks only for the snapshot
        ...
        ckpter.finalize()                  # before returning
    """
    from ray_tpu_torch.checkpoint import AsyncCheckpointer
    if manager is None:
        raise NotImplementedError(SESSION_NEEDS_A6B.format(
            what="make_async_checkpointer", alt=""))
    rank, world = _rank_and_world()
    kwargs.setdefault("process_index", rank)
    kwargs.setdefault("process_count", world)
    return AsyncCheckpointer(manager, **kwargs)


def commit_gang_step(checkpointer, step: int, metadata=None):
    """Seal ``step`` of a gang's save: every rank waits for its own
    write, a barrier, rank 0 commits, a barrier. Every rank calls it.
    It stands in for the train gang's round barrier (A6b)."""
    import torch.distributed as dist
    checkpointer.wait()
    grouped = dist.is_available() and dist.is_initialized()
    if grouped:
        dist.barrier()
    if _rank_and_world()[0] == 0:
        checkpointer.manager.commit_step(step, metadata=metadata)
    if grouped:
        dist.barrier()


def restore_spmd_state(target_state, *, manager=None, checkpoint=None,
                       step: Optional[int] = None):
    """Restore a sharded checkpoint onto ``target_state``, a trainer
    state (loaded in place and returned: each param block, the model's
    buffers, the optimizer's per-block state, ``step``) or any tree
    (``ShardedCheckpoint.restore``).

    Independent of the mesh: blocks are keyed by their *global* index
    slices, so a state saved by two ranks at fsdp 2 restores onto one
    device (and back); each leaf is rebuilt whole on the host and the
    target's block taken from it. A pipelined trainer restores at the
    same pp (its stages are stacked on a leading axis of size pp),
    across dp and fsdp. Source: a ``CheckpointManager`` (a committed
    step, default the latest; checksums verified when the manager's
    ``verify`` is on) or a directory-backed ``air.Checkpoint``. Without
    either it would read the train session's (A6b): it raises."""
    from ray_tpu_torch.air.checkpoint import ShardedCheckpoint
    if manager is None and checkpoint is None:
        raise NotImplementedError(SESSION_NEEDS_A6B.format(
            what="restore_spmd_state",
            alt=" or checkpoint= (a directory Checkpoint)"))
    if manager is not None:
        return manager.restore_state(target_state, step=step)
    root = getattr(checkpoint, "_dir", None)
    if root is None:
        raise ValueError("restore_spmd_state needs a CheckpointManager or "
                         "a directory-backed Checkpoint")
    return ShardedCheckpoint(root).restore(target_state)


def put_batch(trainer: SpmdTrainer, batch: Dict[str, np.ndarray]):
    """Host batch (the global batch) -> this rank's part as tensors on
    the trainer's device: each dim split over the axes that
    ``trainer.batch_dims`` names for it (by default the first dim over
    (dp, fsdp), dp-major, as ``P(("dp", "fsdp"))`` splits it). Dtypes
    are kept except that integers other than uint8 become int64 (token
    ids and labels: what embedding, gather and the loss take). uint8
    images stay bytes until the step normalises them on the device."""
    mesh = trainer.mesh
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        for dim, axes in enumerate(trainer.batch_dims.get(k, (BATCH_AXES,))):
            if axes is None:
                continue
            n, i = mesh.size(axes), mesh.index(axes)
            if a.shape[dim] % n:
                raise ValueError(f"{k}: dim {dim} of {a.shape[dim]} does not "
                                 f"split over {n} {axes} ranks")
            size = a.shape[dim] // n
            a = a.take(range(i * size, (i + 1) * size), axis=dim)
        t = torch.as_tensor(a)
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
