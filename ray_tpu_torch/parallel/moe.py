"""Mixture-of-Experts with expert parallelism over ``ep``: the port of
``ray_tpu/parallel/moe.py``.

Switch (top-1) routing with capacity slots and the load-balance
auxiliary loss, the JAX package's numbers:

  gates    [S, E]   softmax of the f32 router
  slot     each token's position among ALL tokens routed to its expert,
           in global token order; tokens at slot >= C are dropped (zero
           output), C = max(1, int(capacity_factor * S_global / E))
  xin      [E, C, d] the kept tokens at their slots
  out      = act(xin @ w1[e]) @ w2[e]  per expert
  y[s]     = gate[s] * out[expert(s), slot(s)]
  aux      = E * sum_e(fraction of tokens routed to e * mean gate of e)

The JAX package builds the dispatch as a dense [S, E, C] one-hot and
einsums over it; here the one-hot's single entry per token is an index
(``index_add`` into the slots, a gather back), which sums the same
terms. GELU is the tanh form (flax's default). The layer computes in
f32, the JAX layer's default ``dtype``; its ``act``, ``dtype`` and
``router_noise`` options, which no caller in the repo sets, are not
carried over.

On a mesh (``set_mesh``) the layer keeps the semantics of one device
over the global batch, as GSPMD gives the JAX package:
  - a rank's tokens are its rows of the batch (split over (dp, fsdp));
    the ep ranks that share those rows each route a 1/ep slice of them;
  - the slot offsets come from every earlier slice's per-expert counts
    (an exclusive prefix sum across ranks, in global token order), the
    capacity and the aux loss's means from global counts;
  - the experts are split over ep (rank i computes experts i E/ep to
    (i + 1) E/ep - 1): each slice's slots go to the rank of their
    expert by an ``all_to_all`` and come back by the inverse one, which
    is also the gradient's path (``collectives.all_to_all_grad``);
  - the outputs are gathered over ep, so y is the whole of the rank's
    rows on every ep rank. After the backward every ep rank holds the
    whole gradient of every param for its rows, as under tp (the
    trainers' ``_MeshState`` then sums over (dp, fsdp)); ``aux`` is
    the rank's rows' part of the global aux loss (the parts sum to it
    over (dp, fsdp)), as a batch shard's loss terms are.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.gpt2 import Dense, _truncated_normal, dense
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import BATCH_AXES, _placements


class MoE(nn.Module):
    """Switch-style top-1 MoE feed-forward layer: ``forward(x) -> (y,
    aux)``, x [..., d_model] f32. Params: ``router`` (an f32 Dense,
    d_model -> E, with bias), ``experts_w1`` [E, d_model, d_ff],
    ``experts_w2`` [E, d_ff, d_model]; shard the expert params over ep
    with ``expert_sharding_rule``."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts, self.d_ff = num_experts, d_ff
        self.capacity_factor = capacity_factor
        self.router = Dense(d_model, num_experts, torch.float32)
        self.experts_w1 = nn.Parameter(torch.empty(num_experts, d_model,
                                                   d_ff))
        self.experts_w2 = nn.Parameter(torch.empty(num_experts, d_ff,
                                                   d_model))
        self.mesh = None

    def set_mesh(self, mesh):
        """Route over ``mesh``'s global batch and split the experts over
        its ep axis (module docstring); E must divide by ep."""
        ep = mesh.size("ep")
        if mesh.size("sp") > 1 or mesh.size("tp") > 1:
            raise ValueError("MoE splits tokens over (dp, fsdp) and experts "
                             "over ep; sp and tp must be 1")
        if self.num_experts % ep:
            raise ValueError(f"ep={ep} must divide num_experts="
                             f"{self.num_experts}")
        self.mesh = mesh if mesh.device_mesh is not None else None
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initialisers from ``generator``: lecun-normal (normal
        truncated at 2 sigma) with flax's fan-in, the input dim times
        the expert count for the [E, in, out] kernels; a zero router
        bias."""
        for w in (self.router.weight, self.experts_w1, self.experts_w2):
            fan_in = (w.shape[1] if w.ndim == 2
                      else w.shape[0] * w.shape[1])
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            w.copy_(_truncated_normal(w.shape, generator) * std)
        self.router.bias.zero_()
        return self

    def forward(self, x):
        mesh = self.mesh
        *lead, d = x.shape
        E = self.num_experts
        xf = x.reshape(-1, d)
        n_rows = xf.shape[0]
        n_b = 1 if mesh is None else mesh.size(BATCH_AXES)
        ep = 1 if mesh is None else mesh.size("ep")
        r = 0 if mesh is None else mesh.index("ep")
        s_global = n_rows * n_b
        cap = max(1, int(self.capacity_factor * s_global / E))
        if n_rows % ep:
            raise ValueError(f"{n_rows} tokens do not split over ep={ep}")
        if ep > 1:
            xf = C.psum_backward(xf, "ep", mesh).chunk(ep)[r]
        w_r, b_r = self.router.weight, self.router.bias
        w1, w2 = self.experts_w1, self.experts_w2
        if ep > 1:
            w_r, b_r, w1, w2 = (C.psum_backward(t, "ep", mesh)
                                for t in (w_r, b_r, w1, w2))

        # ---- router (f32)
        logits = dense(xf.float(), w_r, b_r, torch.float32)
        gates = torch.softmax(logits, dim=-1)               # [s, E]
        expert = gates.argmax(-1)                           # [s]
        onehot = F.one_hot(expert, E).float()
        counts = onehot.sum(0)

        # ---- global token order: the slice's offset per expert and the
        # global counts (prefix over the earlier ep slices of these rows,
        # then over the earlier batch shards)
        offset = torch.zeros_like(counts)
        total = counts
        if mesh is not None:
            per_ep = C.all_gather(counts, "ep", mesh, tiled=False)
            rows_total = per_ep.sum(0)
            per_b = C.all_gather(rows_total, BATCH_AXES, mesh, tiled=False)
            bi = mesh.index(BATCH_AXES)
            offset = per_b[:bi].sum(0) + per_ep[:r].sum(0)
            total = per_b.sum(0)
        slot = ((torch.cumsum(onehot, 0) - 1.0) * onehot).sum(-1) + offset[
            expert]
        keep = (slot < cap).float()
        gate = (gates * onehot).sum(-1) * keep

        # ---- load-balance aux (Switch eq. 4), this slice's part
        density = total / s_global
        aux = E * torch.sum(density * gates.sum(0) / s_global)
        if ep > 1:
            aux = C.psum_forward(aux, "ep", mesh)

        # ---- dispatch to the slots, the experts, and back
        idx = expert * cap + slot.clamp(max=cap - 1).long()
        buf = xf.new_zeros(E * cap, d).index_add(
            0, idx, xf * keep[:, None]).view(E, cap, d)
        e_loc = E // ep
        if ep > 1:
            buf = C.all_to_all_grad(buf, "ep", mesh, split_axis=0,
                                    concat_axis=0)
            buf = buf.view(ep, e_loc, cap, d).sum(0)
            w1, w2 = w1[r * e_loc:(r + 1) * e_loc], w2[r * e_loc:
                                                        (r + 1) * e_loc]
        h = F.gelu(torch.bmm(buf, w1), approximate="tanh")
        out = torch.bmm(h, w2)                              # [e_loc, C, d]
        if ep > 1:
            out = C.all_to_all_grad(
                out.unsqueeze(0).expand(ep, -1, -1, -1).reshape(
                    E, cap, d), "ep", mesh, split_axis=0, concat_axis=0)
        y = gate[:, None] * out.reshape(E * cap, d)[idx]
        if ep > 1:
            y = C.all_gather_forward(y, "ep", mesh, gather_axis=0)
        return y.reshape(*lead, d).to(x.dtype), aux


def expert_sharding_rule(mesh, path: Tuple[str, ...], shape, spec):
    """Param-sharding hook (``spmd.state_shardings``' ``override``):
    leaves named experts_* shard their leading (expert) dim over ep and
    replicate otherwise; None for every other leaf (the default rules
    apply)."""
    name = "/".join(str(p) for p in path)
    if "experts_" in name and spec.ep > 1 and shape and \
            shape[0] % spec.ep == 0:
        return _placements(["ep"] + [None] * (len(shape) - 1))
    return None


def moe_params_from_flax(tree: Dict[str, Any],
                         model: Optional[MoE] = None
                         ) -> Dict[str, torch.Tensor]:
    """flax ``MoE`` params (``{"params": {"router": {"kernel", "bias"},
    "experts_w1", "experts_w2"}}``) -> ``MoE``'s state_dict in f32 (the
    router's kernel [in, out] lands transposed). With ``model`` the
    weights are also loaded into it."""
    p = tree["params"]

    def t(x):
        return torch.from_numpy(np.array(np.asarray(x), np.float32))
    sd = {"router.weight": t(p["router"]["kernel"]).T.contiguous(),
          "router.bias": t(p["router"]["bias"]),
          "experts_w1": t(p["experts_w1"]),
          "experts_w2": t(p["experts_w2"])}
    if model is not None:
        model.load_state_dict(sd)
    return sd
