"""Model catalog: the RL policy/value networks as ``nn.Module``s.

Counterpart of ``ray_tpu/rllib/models.py`` with the same numerics:

  - module names are flax's (``MLPNet``: ``pi_{i}``, ``vf_{i}``,
    ``Dense_0`` the logits, ``Dense_1`` the value, ``log_std``;
    ``AtariCNN``: ``Conv_0..2``, ``Dense_0`` the 512-wide layer,
    ``Dense_1`` the logits, ``Dense_2`` the value), so params cross with
    ``params_from_flax``: Dense kernels [in, out] -> [out, in], conv
    kernels HWIO -> OIHW;
  - params are f32 and cast to the compute dtype at every call (flax's
    ``dtype=``; ``gpt2.Dense``);
  - ``AtariCNN`` takes NHWC observations (uint8 frames stay uint8 up to
    here), casts them to ``compute_dtype`` and divides by 255, runs the
    Nature-DQN trunk 32-8-4 / 64-4-2 / 64-3-1 with flax's default
    ``padding="SAME"`` (84 -> 21 -> 11 -> 11: the 4x4 stride-2 conv on 21
    pads (1, 2), which ``F.pad`` applies; ``resnet._pad_same``), flattens
    in flax's NHWC order (the NHWC input's permute is a channels_last
    view, so the flatten reads it as it lies), then Dense 512 in
    ``compute_dtype`` and both heads in f32;
  - ``init_weights(generator)`` follows flax's laws: ``MLPNet``
    orthogonal kernels with gains sqrt(2) (trunks), 0.01 (logits) and
    1.0 (value), ``AtariCNN`` lecun-normal (normal truncated at 2 sigma,
    variance 1 / fan_in); zero biases and ``log_std``. The bits differ
    from ``jax.random``'s, so parity goes through ``params_from_flax``.

The action-distribution functions take tensors and, to sample, an
explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.gpt2 import Dense, _truncated_normal
from ray_tpu_torch.models.resnet import _pad_same
from ray_tpu_torch.rllib.env import Discrete

_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "swish": F.silu}


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator):
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    w.copy_(_truncated_normal(w.shape, generator) * std)


class MLPNet(nn.Module):
    """MLP with policy logits + value heads
    (reference: rllib/models/torch/fcnet.py). Value branch is a separate
    trunk by default (the reference's PPO `vf_share_layers=False`) so the
    large-magnitude value loss can't wreck the policy features."""

    def __init__(self, obs_dim: int, num_outputs: int,
                 hiddens: Sequence[int] = (256, 256),
                 activation: str = "tanh", free_log_std: bool = False,
                 vf_share_layers: bool = False):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.vf_share_layers = vf_share_layers
        sizes = (obs_dim, *hiddens)
        self.trunks = ("pi",) if vf_share_layers else ("pi", "vf")
        self.depth = len(hiddens)
        for name in self.trunks:
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
                self.add_module(f"{name}_{i}", Dense(a, b, torch.float32))
        self.Dense_0 = Dense(sizes[-1], num_outputs, torch.float32)
        self.Dense_1 = Dense(sizes[-1], 1, torch.float32)
        self.log_std = (nn.Parameter(torch.zeros(num_outputs))
                        if free_log_std else None)

    def _trunk(self, x, name):
        for i in range(self.depth):
            x = self.act(getattr(self, f"{name}_{i}")(x))
        return x

    def forward(self, obs):
        x = obs.to(torch.float32).reshape(obs.shape[0], -1)
        pi = self._trunk(x, "pi")
        vf = pi if self.vf_share_layers else self._trunk(x, "vf")
        logits = self.Dense_0(pi)
        value = self.Dense_1(vf)
        if self.log_std is not None:
            logits = torch.cat([logits, self.log_std.expand_as(logits)], -1)
        return logits, value[..., 0]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        gains = {f"{t}_{i}": math.sqrt(2) for t in self.trunks
                 for i in range(self.depth)}
        gains.update(Dense_0=0.01, Dense_1=1.0)
        for name, gain in gains.items():
            mod = getattr(self, name)
            nn.init.orthogonal_(mod.weight, gain, generator=generator)
            mod.bias.zero_()
        if self.log_std is not None:
            self.log_std.zero_()
        return self


class _SameConv(nn.Conv2d):
    """flax ``nn.Conv(features, (k, k), strides, dtype=...)``: SAME
    padding, an f32 OIHW kernel and bias cast to ``dtype`` at every
    call."""

    def __init__(self, in_features, features, kernel, stride, dtype):
        super().__init__(in_features, features, kernel, stride)
        self.compute_dtype = dtype

    def forward(self, x):
        x, pad = _pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight.to(self.compute_dtype),
                        self.bias.to(self.compute_dtype), self.stride, pad)


class AtariCNN(nn.Module):
    """Nature-DQN conv trunk (reference: rllib/models/torch/visionnet.py)
    on NHWC observations of ``obs_shape`` (H, W, C)."""

    LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, obs_shape: Tuple[int, int, int], num_outputs: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        h, w, c = obs_shape
        for i, (feat, kern, stride) in enumerate(self.LAYERS):
            self.add_module(f"Conv_{i}", _SameConv(c, feat, kern, stride,
                                                   compute_dtype))
            h, w, c = -(-h // stride), -(-w // stride), feat
        # the heads run in f32 (in f64 for an f64 trunk: the yardstick)
        self.head_dtype = torch.promote_types(compute_dtype, torch.float32)
        self.Dense_0 = Dense(h * w * c, 512, compute_dtype)
        self.Dense_1 = Dense(512, num_outputs, self.head_dtype)
        self.Dense_2 = Dense(512, 1, self.head_dtype)

    def forward(self, obs):
        x = obs.permute(0, 3, 1, 2).to(self.compute_dtype) / 255.0
        for i in range(len(self.LAYERS)):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x)).to(self.head_dtype)
        return self.Dense_1(x), self.Dense_2(x)[..., 0]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for mod in self.modules():
            if isinstance(mod, (_SameConv, Dense)):
                _lecun_normal_(mod.weight, generator)
                mod.bias.zero_()
        return self


def num_action_outputs(action_space) -> Tuple[int, bool]:
    """(num distribution inputs before log-std doubling, is_discrete)."""
    if isinstance(action_space, Discrete):
        return action_space.n, True
    return int(np.prod(action_space.shape)), False


def make_model(obs_space, action_space,
               model_config: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Pick a network for the given spaces (reference:
    models/catalog.py ModelCatalog.get_model_v2). Its weights follow
    flax's laws only after ``init_weights``."""
    model_config = model_config or {}
    n_out, discrete = num_action_outputs(action_space)
    shape = tuple(obs_space.shape or (1,))
    if len(shape) == 3:
        return AtariCNN(shape, n_out)
    return MLPNet(
        int(np.prod(shape)), n_out,
        hiddens=tuple(model_config.get("fcnet_hiddens", (256, 256))),
        activation=model_config.get("fcnet_activation", "tanh"),
        free_log_std=not discrete,
        vf_share_layers=model_config.get("vf_share_layers", False))


# flax leaf names that torch calls otherwise
_LEAF_NAMES = {"scale": "weight", "embedding": "weight"}


def params_from_flax(tree: Mapping[str, Any],
                     model: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """A flax params tree (arrays or anything ``np.asarray`` takes:
    params, or grads of them) -> the port's ``state_dict`` in f32: Dense
    kernels [in, out] -> [out, in], conv kernels HWIO -> OIHW. Nested
    modules join with dots, and flax's ``nn.Sequential`` names its layers
    ``layers_{i}``, which become ``nn.Sequential``'s ``{i}`` (SAC's and
    DDPG's ``pi_net.layers_0`` -> ``pi_net.0``). ``MLPNet``'s and
    ``AtariCNN``'s trees are flat; the 512-wide Dense's rows are already
    in the port's flatten order (NHWC, as flax's). With ``model`` they
    are also loaded into it.

    Also: a kernel without a bias (an LSTM cell's input kernels ``ii``,
    ``if``, ``ig``, ``io``) gives a weight alone; ``DenseGeneral``'s
    kernels [in..., out...] (``SelfAttention``'s ``query``/``key``/
    ``value`` [d, heads, head_dim] with bias [heads, head_dim], its
    ``out`` [heads, head_dim, d]) become ``Linear`` weights [prod(out),
    prod(in)] and flat biases, the out axes being the bias's; flax's
    ``LayerNorm`` ``scale`` and ``Embed`` ``embedding`` become
    ``weight``. A tree stacked on a leading member axis (MADDPG's
    agents, MBMPO's ensemble) goes through ``stacked_params_from_flax``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(sub, prefix):
        for name, v in sub.items():
            if name.startswith("layers_"):
                name = name[len("layers_"):]
            key = prefix + name
            if isinstance(v, Mapping) and "kernel" in v:
                k = np.asarray(v["kernel"], np.float32)
                if k.ndim == 4:
                    k = k.transpose(3, 2, 0, 1)
                else:
                    n_out = np.ndim(v["bias"]) if "bias" in v else 1
                    k = k.reshape(int(np.prod(k.shape[:k.ndim - n_out])),
                                  -1).T
                sd[f"{key}.weight"] = torch.from_numpy(np.array(k, order="C"))
                if "bias" in v:
                    sd[f"{key}.bias"] = torch.from_numpy(
                        np.array(v["bias"], np.float32).reshape(-1))
            elif isinstance(v, Mapping):
                walk(v, key + ".")
            else:
                sd[prefix + _LEAF_NAMES.get(name, name)] = torch.from_numpy(
                    np.array(v, np.float32))

    walk(tree, "")
    if model is not None:
        model.load_state_dict(sd)
    return sd


def policy_map_from_flax(trees: Mapping[str, Mapping[str, Any]],
                         policy_map: Mapping[str, Any]
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX multi-agent worker's params by policy id ({pid: flax tree},
    as ``{pid: policy.params}``) -> each port policy's ``model`` in
    ``policy_map`` (``MultiAgentRolloutWorker.policy_map``), through
    ``params_from_flax``, strictly: a key left over or missing raises.
    Returns the state dicts by policy id."""
    return {pid: params_from_flax(tree, policy_map[pid].model)
            for pid, tree in trees.items()}


# flax kernel layouts from torch weights: Dense [out, in] -> [in, out],
# conv OIHW -> HWIO (and back)
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0)}
_FROM_FLAX = {2: (1, 0), 4: (3, 2, 0, 1)}


def _flax_leaves(model: nn.Module):
    """``model``'s params as [(flax key path, param)] in
    ``jax.flatten_util.ravel_pytree``'s order: flax's keys (a 2-D or 4-D
    ``weight`` is a ``kernel``, a 1-D one a ``scale``; ``nn.Sequential``'s
    ``{i}`` is ``layers_{i}``) sorted as strings at every level, so
    ``bias`` comes before ``kernel`` and ``layers_10`` before
    ``layers_2``."""
    leaves = []
    for name, p in model.named_parameters():
        *mods, leaf = name.split(".")
        path = [f"layers_{m}" if m.isdigit() else m for m in mods]
        if leaf == "weight":
            leaf = "scale" if p.ndim == 1 else "kernel"
        leaves.append((tuple(path + [leaf]), p))
    return sorted(leaves, key=lambda t: t[0])


def flat_params(model: nn.Module) -> np.ndarray:
    """The flat f32 vector of ``model``'s params that ``ravel_pytree``
    gives for the same params as a flax tree (kernels in flax's
    layout)."""
    parts = []
    for path, p in _flax_leaves(model):
        t = p.detach().to("cpu", torch.float32)
        if path[-1] == "kernel":
            t = t.permute(_TO_FLAX[t.ndim])
        parts.append(t.reshape(-1))
    return torch.cat(parts).numpy()


@torch.no_grad()
def load_flat_params(model: nn.Module, theta) -> nn.Module:
    """The inverse of ``flat_params``: ``theta`` (``ravel_pytree``'s
    order and layout) into ``model``'s params, in place."""
    theta = torch.as_tensor(np.asarray(theta, np.float32))
    i = 0
    for path, p in _flax_leaves(model):
        chunk = theta[i:i + p.numel()]
        if path[-1] == "kernel":
            shape = [p.shape[d] for d in _TO_FLAX[p.ndim]]
            chunk = chunk.reshape(shape).permute(_FROM_FLAX[p.ndim])
        p.copy_(chunk.reshape(p.shape))
        i += p.numel()
    if i != theta.numel():
        raise ValueError(f"theta has {theta.numel()} entries, the model "
                         f"{i} params")
    return model


class StackedLinear(nn.Module):
    """``m`` Dense layers of one shape side by side: ``weight`` [m, in,
    out] (flax's kernel layout with the member axis in front), ``bias``
    [m, out]. x [m, B, in] -> [m, B, out] in one batched product."""

    def __init__(self, m: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(m, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(m, out_features))

    def forward(self, x, detach: bool = False):
        w, b = self.weight, self.bias
        if detach:
            w, b = w.detach(), b.detach()
        return torch.baddbmm(b[:, None, :], x, w)

    def member(self, k: int, x):
        """Member ``k`` alone on x [B, in]."""
        return torch.addmm(self.bias[k], x, self.weight[k])


class StackedMLP(nn.Module):
    """``m`` MLPs of one shape stacked on a leading axis, as a flax tree
    that ``jax.vmap`` inits or ``jnp.stack`` joins: ``Dense_0`` ..
    ``Dense_{L-1}`` (``StackedLinear``), ReLU between them, ``out``
    (None or a function) after the last; one batched product a layer for
    all ``m`` members. x [m, B, sizes[0]] -> [m, B, sizes[-1]]; x [B,
    sizes[0]] is shared by every member. ``detach`` computes with the
    params cut from the graph (the gradient still reaches x)."""

    def __init__(self, m: int, sizes: Sequence[int], out=None):
        super().__init__()
        self.m, self.out, self.depth = m, out, len(sizes) - 1
        for i in range(self.depth):
            setattr(self, f"Dense_{i}",
                    StackedLinear(m, sizes[i], sizes[i + 1]))

    def _layers(self):
        return [getattr(self, f"Dense_{i}") for i in range(self.depth)]

    def _run(self, x, step):
        for i, layer in enumerate(self._layers()):
            x = step(layer, x)
            if i < self.depth - 1:
                x = F.relu(x)
        return x if self.out is None else self.out(x)

    def forward(self, x, detach: bool = False):
        if x.ndim == 2:
            x = x.expand(self.m, *x.shape)
        return self._run(x, lambda layer, h: layer(h, detach))

    def member(self, k: int, x):
        """Member ``k`` alone on x [B, sizes[0]]."""
        return self._run(x, lambda layer, h: layer.member(k, h))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax ``Dense``'s init for every member: lecun-normal kernels
        (fan-in ``in``), zero biases."""
        for layer in self._layers():
            m, fan_in, fan_out = layer.weight.shape
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            for k in range(m):
                layer.weight[k].copy_(
                    _truncated_normal((fan_in, fan_out), generator) * std)
            layer.bias.zero_()
        return self


def stacked_params_from_flax(tree: Mapping[str, Any],
                             model: Optional[nn.Module] = None
                             ) -> Dict[str, torch.Tensor]:
    """A flax params tree stacked on a leading member axis (MADDPG's
    per-agent actors and critics, MBMPO's dynamics ensemble) -> the
    ``state_dict`` of ``StackedMLP``s in f32: kernels [m, in, out] and
    biases [m, out] copied as they stand, nested modules joined with
    dots. Raises on a kernel that is not 3-D with a 2-D bias. With
    ``model`` they are also loaded into it."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(sub, prefix):
        for name, v in sub.items():
            key = prefix + name
            if isinstance(v, Mapping) and "kernel" in v:
                k, b = np.asarray(v["kernel"]), np.asarray(v.get("bias"))
                if k.ndim != 3 or b.ndim != 2:
                    raise ValueError(f"{key}: kernel {k.shape} and bias "
                                     f"{b.shape} are not stacked Dense")
                sd[f"{key}.weight"] = torch.from_numpy(np.array(k, np.float32))
                sd[f"{key}.bias"] = torch.from_numpy(np.array(b, np.float32))
            elif isinstance(v, Mapping):
                walk(v, key + ".")
            else:
                sd[key] = torch.from_numpy(np.array(v, np.float32))

    walk(tree, "")
    if model is not None:
        model.load_state_dict(sd)
    return sd


def load_offpolicy_from_flax(policy, params: Mapping[str, Any],
                             target_params: Mapping[str, Any],
                             log_alpha: Optional[float] = None):
    """A JAX SAC, CQL or CRR policy's (``params``, ``target_params``,
    ``log_alpha``) or a DDPG/TD3 policy's (no ``log_alpha``) flax trees
    -> the port's policy: its ``model``, ``target_model`` and
    ``log_alpha``, in place."""
    params_from_flax(params, policy.model)
    params_from_flax(target_params, policy.target_model)
    if log_alpha is not None:
        with torch.no_grad():
            policy.log_alpha.fill_(float(log_alpha))


# ---- action distributions ----


def categorical_sample(generator: torch.Generator, logits):
    """Gumbel-max, as ``jax.random.categorical``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def categorical_logp(logits, actions):
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def diag_gaussian_split(dist_inputs):
    mean, log_std = torch.chunk(dist_inputs, 2, dim=-1)
    return mean, torch.clamp(log_std, -20.0, 2.0)


def diag_gaussian_sample(generator: torch.Generator, dist_inputs):
    mean, log_std = diag_gaussian_split(dist_inputs)
    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + torch.exp(log_std) * noise


def diag_gaussian_logp(dist_inputs, actions):
    mean, log_std = diag_gaussian_split(dist_inputs)
    actions = actions.reshape(mean.shape)
    var = torch.exp(2 * log_std)
    return torch.sum(
        -0.5 * ((actions - mean) ** 2 / var)
        - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def diag_gaussian_entropy(dist_inputs):
    _, log_std = diag_gaussian_split(dist_inputs)
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
