"""ResNet family as ``nn.Module``s: the image-classifier training slice's model.

Counterpart of ``ray_tpu/models/resnet.py`` with the same numerics:

  - module paths are flax's (``conv_init``, ``bn_init``,
    ``BottleneckResNetBlock_{i}.Conv_{j}`` / ``.BatchNorm_{j}``,
    ``conv_proj``, ``norm_proj``, ``Dense_0``), so weights and batch
    stats carry across with ``params_from_flax``; a flax conv kernel is
    HWIO and lands as OIHW, a Dense kernel [in, out] as [out, in];
  - params are kept in f32 and cast to ``dtype`` at every call (flax's
    ``dtype=``); the head's Dense runs in f32 and returns f32 logits;
  - ``padding="SAME"`` is flax's: per spatial dim out = ceil(in / s)
    and the pad total max((out - 1) s + k - in, 0) split low = total
    // 2, high = the rest, from the input's actual size. A strided conv
    on an even input pads (0, 1) and the 7x7/2 stem at 224 pads (2, 3),
    which torch's symmetric ``padding=`` cannot say, so those get an
    explicit ``F.pad``; max-pool pads with -inf (``reduce_window``'s
    init);
  - batch norm is flax's (momentum 0.9, eps 1e-5): batch mean and the
    biased variance in f32 from the input, normalised in f32 and cast
    to ``dtype``; the running stats move as 0.9 ra + 0.1 batch with
    the BIASED variance (torch's own BatchNorm updates with the
    unbiased one, and its momentum is 1 - flax's). ``model.eval()``
    normalises with the running stats (flax's ``train=False``);
  - the input is flax's NHWC batch; ``permute(0, 3, 1, 2)`` makes an
    NCHW view whose strides are already ``channels_last``, the layout
    the whole network keeps (cuDNN's preferred one for bf16).

Build a model with ``create_resnet`` (or ``ResNet50(...)``) and give it
weights with ``init_weights(generator)`` or ``params_from_flax``.

On a mesh with a process group (``ResNet.set_mesh``) batch norm takes
its statistics over the whole global batch, as the JAX trainer does
under ``jit`` (its flax ``BatchNorm`` reduces over the batch-sharded
array, so the mean is global; ``bn_axis_name`` plays no part): each
rank's per-channel count, mean and variance are gathered over (dp,
fsdp) and merged, and the backward's two per-channel sums are summed
over the same ranks (``_GlobalBatchNorm``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.gpt2 import Dense, _truncated_normal
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import BATCH_AXES

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    """SAME padding of ``x`` [N, C, H, W] for a ``kernel``/``stride``
    window: returns (x, (ph, pw)). Symmetric pads are returned for the
    op's own ``padding=``; asymmetric ones are applied here with
    ``F.pad`` (which keeps ``channels_last``) and (0, 0) returned."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (*pw, *ph), value=value), (0, 0)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``."""
    x, pad = _pad_same(x, kernel, stride, value=-math.inf)
    return F.max_pool2d(x, kernel, stride, pad)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, use_bias=False,
    padding="SAME", dtype=...)``: an f32 OIHW kernel cast to ``dtype``
    at every call."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 strides: int = 1, *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features,
                                               kernel, kernel))
        self.strides = strides
        self.compute_dtype = dtype

    def forward(self, x):
        k = self.weight.shape[-1]
        x, pad = _pad_same(x, k, self.strides)
        return F.conv2d(x, self.weight.to(self.compute_dtype), None,
                        self.strides, pad)


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the global batch of a mesh's (dp,
    fsdp) ranks: y, and the global mean and biased variance (f32, no
    gradient). Forward: each rank's per-channel statistics and count are
    gathered over the batch's ranks and merged (Chan's parallel
    variance). Backward: the per-channel sums of dy and dy (x - mean)
    are summed over the same ranks; the weight's and bias's grads stay
    local (the trainer sums param grads over the batch).

    On the card PyTorch's SyncBatchNorm kernels do every pass (the
    statistics, the merge of the gathered means and 1 / sqrt(var + eps),
    the normalisation and the backward's two): one kernel each, so the
    host keeps ahead of the device. On the CPU, which has none of them,
    the same arithmetic in plain ops, with the variance itself
    gathered."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mesh):
        C_ = x.shape[1]
        count = torch.full((1,), x.numel() // C_, dtype=torch.float32,
                           device=x.device)
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, BN_EPS)
            stats = C.all_gather(torch.cat([mean, invstd, count]),
                                 BATCH_AXES, mesh, tiled=False)
            counts = stats[:, -1]
            # the running stats go in with momentum 0, which leaves them
            # as they are (the caller moves them flax's way): given
            # them, the op takes f32 counts; without, counts in x's dtype
            # (bf16 would round a count)
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, stats[:, :C_], stats[:, C_:-1], running_mean,
                running_var, 0.0, BN_EPS, counts)
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, BN_EPS)
            var = invstd.square().reciprocal() - BN_EPS
            counts = counts.to(torch.int32)
        else:
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            stats = C.all_gather(torch.cat([mean, var, count]), BATCH_AXES,
                                 mesh, tiled=False)
            counts = stats[:, -1:]                          # [ranks, 1]
            means, vars_ = stats[:, :C_], stats[:, C_:-1]   # [ranks, C]
            n = counts.sum()
            mean = (counts * means).sum(0) / n
            var = ((counts * (vars_ + (means - mean).square())).sum(0)
                   / n).clamp(min=0.0)
            invstd = torch.rsqrt(var + BN_EPS)
            y = ((x.float() - mean[:, None, None])
                 * (invstd * weight)[:, None, None]
                 + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, counts)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        fmt = (torch.channels_last
               if x.is_contiguous(memory_format=torch.channels_last)
               and not x.is_contiguous() else torch.contiguous_format)
        dy = dy.contiguous(memory_format=fmt)
        if dy.is_cuda:
            sum_dy, sum_dy_xmu, g_w, g_b = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
        else:
            dyf = dy.float()
            xmu = x.float() - mean[:, None, None]
            sum_dy = dyf.sum((0, 2, 3))
            sum_dy_xmu = (dyf * xmu).sum((0, 2, 3))
            g_w, g_b = sum_dy_xmu * invstd, sum_dy
        sum_dy, sum_dy_xmu = C.psum(torch.cat([sum_dy, sum_dy_xmu]),
                                    BATCH_AXES, ctx.mesh).chunk(2)
        if dy.is_cuda:
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, counts)
        else:
            n = counts.sum()
            dx = ((dyf - (sum_dy / n)[:, None, None]
                   - xmu * (invstd.square() * sum_dy_xmu / n)[:, None, None])
                  * (invstd * weight)[:, None, None]).to(x.dtype)
        return dx, g_w, g_b, None, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=...)`` over
    the channel dim. ``zero_scale``: flax's ``scale_init=zeros_init()``
    (the last norm of every block). ``batch_mesh`` (set by
    ``ResNet.set_mesh``): take the training statistics over that mesh's
    global batch."""

    def __init__(self, features: int, *, dtype, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.compute_dtype = dtype
        self.zero_scale = zero_scale
        self.batch_mesh = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                BN_EPS).to(self.compute_dtype)
        if self.batch_mesh is not None:
            y, mean, var = _GlobalBatchNorm.apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.batch_mesh)
            self._update_running(mean, var)
            return y.to(self.compute_dtype)
        # one call gives y and the batch's mean and 1 / sqrt(var + eps),
        # var biased, in f32; the running stats take var from those
        # (torch.var_mean would read the activation again: a slower step
        # on an H100, PERF.md)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, BN_EPS)
        with torch.no_grad():
            var = (invstd.square().reciprocal() - BN_EPS).clamp_(min=0.0)
        self._update_running(mean, var)
        return y.to(self.compute_dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)


class ResNetBlock(nn.Module):
    """Two 3x3 convs; a 1x1 projection where the shape changes."""

    def __init__(self, in_features: int, filters: int, *, dtype,
                 act: Callable, strides: int = 1):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_features, filters, 3, strides, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype, zero_scale=True)
        self.out_features = filters
        if strides != 1 or in_features != filters:
            self.conv_proj = Conv(in_features, filters, 1, strides,
                                  dtype=dtype)
            self.norm_proj = BatchNorm(filters, dtype=dtype)

    def forward(self, x):
        y = self.act(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return self.act(x + y)


class BottleneckResNetBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 to 4 x ``filters``; a 1x1 projection
    where the shape changes."""

    def __init__(self, in_features: int, filters: int, *, dtype,
                 act: Callable, strides: int = 1):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_features, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv(filters, filters * 4, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype=dtype,
                                     zero_scale=True)
        self.out_features = filters * 4
        if strides != 1 or in_features != filters * 4:
            self.conv_proj = Conv(in_features, filters * 4, 1, strides,
                                  dtype=dtype)
            self.norm_proj = BatchNorm(filters * 4, dtype=dtype)

    def forward(self, x):
        y = self.act(self.BatchNorm_0(self.Conv_0(x)))
        y = self.act(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return self.act(x + y)


class ResNet(nn.Module):
    """``forward(images)``: NHWC images (any float dtype) -> f32 logits
    [N, num_classes]. ``small_images``: the CIFAR stem (3x3/1 conv, no
    max-pool). RGB input (3 channels)."""

    in_features = 3

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: Any = torch.bfloat16, act: Callable = F.relu,
                 small_images: bool = False):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.small_images = small_images
        if small_images:
            self.conv_init = Conv(self.in_features, num_filters, 3,
                                  dtype=dtype)
        else:
            self.conv_init = Conv(self.in_features, num_filters, 7, 2,
                                  dtype=dtype)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        n_in, k = num_filters, 0
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = 2 if i > 0 and j == 0 else 1
                blk = block_cls(n_in, num_filters * 2 ** i, dtype=dtype,
                                act=act, strides=strides)
                self.add_module(f"{block_cls.__name__}_{k}", blk)
                n_in, k = blk.out_features, k + 1
        self.n_blocks = k
        self.block_name = block_cls.__name__
        self.Dense_0 = Dense(n_in, num_classes, torch.float32)

    def blocks(self):
        return [getattr(self, f"{self.block_name}_{k}")
                for k in range(self.n_blocks)]

    def set_mesh(self, mesh):
        """Batch norm over ``mesh``'s global batch where it has a process
        group (at any size: the same route at world size 1); the
        single-device route's batch norm without one. The convs are not
        split over tp: tp shards their weights' storage only."""
        on = mesh if mesh.device_mesh is not None else None
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.batch_mesh = on
        return self

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = self.act(self.bn_init(self.conv_init(x)))
        if not self.small_images:
            x = max_pool_same(x, 3, 2)
        for blk in self.blocks():
            x = blk(x)
        # jnp.mean of the compute dtype: summed in f32, rounded back
        x = torch.mean(x, dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initialisers, drawn from ``generator``: lecun-normal
        conv and Dense kernels (normal truncated at 2 sigma, variance 1 /
        fan_in, fan_in = kh * kw * in), Dense bias 0, batch-norm scale 1
        (0 where ``zero_scale``) and bias 0, running mean 0 and variance
        1."""
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                w = mod.weight
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w.copy_(_truncated_normal(w.shape, generator) * std)
                if isinstance(mod, Dense):
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        return self


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)


def create_resnet(name: str, num_classes: int, *,
                  small_images: bool = False,
                  dtype=torch.bfloat16) -> ResNet:
    table = {"resnet18": ResNet18, "resnet34": ResNet34,
             "resnet50": ResNet50, "resnet101": ResNet101,
             "resnet152": ResNet152}
    if name not in table:
        raise ValueError(f"unknown resnet {name!r}; options {sorted(table)}")
    return table[name](num_classes=num_classes, small_images=small_images,
                       dtype=dtype)


# flax leaf name -> this module's name, per collection
_LEAF_NAMES = {"params": {"kernel": "weight", "scale": "weight",
                          "bias": "bias"},
               "batch_stats": {"mean": "running_mean",
                               "var": "running_var"}}


def params_from_flax(variables: Mapping[str, Any],
                     model: Optional[ResNet] = None
                     ) -> Dict[str, torch.Tensor]:
    """flax ResNet variables (``{"params": ..., "batch_stats": ...}``,
    arrays or anything ``np.asarray`` takes) -> this module's
    ``state_dict`` in f32: conv kernels HWIO -> OIHW, the Dense kernel
    [in, out] -> [out, in]. With ``model`` they are also loaded into it
    (into its existing tensors, whose layout stays)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, names):
        for key, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{key}.", names)
                continue
            a = torch.from_numpy(np.array(np.asarray(sub), np.float32))
            if a.ndim == 4:
                a = a.permute(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            sd[prefix + names[key]] = a.contiguous()

    for collection, names in _LEAF_NAMES.items():
        walk(variables.get(collection, {}), "", names)
    if model is not None:
        model.load_state_dict(sd)
    return sd
