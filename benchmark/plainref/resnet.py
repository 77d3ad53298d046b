"""Dilated ResNet trunk, port of ``e_osvos_tpu/models/resnet.py``.

Module names follow the flax module names (``stem_conv``, ``layer1_block0``,
``conv1``, ``norm1``, ``down_conv``...), so the weights of the JAX package
map onto this trunk one to one (``models/jax_weights.py``).

Tensors are NCHW in ``torch.channels_last`` memory format, which keeps them
physically NHWC, the JAX layout. ``dtype`` is the compute dtype (float32 in the reference, lower in its
control, with ``operand_dtype`` rounding the products' operands): parameters
stay float32 and are cast at each convolution, as flax's
``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from plainref.group_norm import FusedGroupNorm

Norm = Callable[[int], nn.Module]


class _GradRound(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to ``low``."""

    @staticmethod
    def forward(ctx, t, low):
        ctx.low = low
        return t

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.low), None


def _round(t: torch.Tensor, low) -> torch.Tensor:
    """``t`` rounded to the float8 type ``low`` with a per-tensor scale
    (its largest magnitude at the type's largest finite value) and back."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) \
        / torch.finfo(low).max
    return (t.detach().float() / scale).to(low).float().mul(scale).to(t.dtype)


def operand(t: torch.Tensor, low) -> torch.Tensor:
    """An operand of a convolution or dense layer rounded to the float8
    type ``low`` (per-tensor scale), the gradient passed straight through;
    ``t`` itself when ``low`` is None. The benchmark's control sets ``low``
    on the convolutions and dense layers (``operand_dtype``) to compute the
    reference one precision below the configuration's: float8 training,
    e4m3 operands forward and e5m2 gradients backward (``output``)."""
    if low is None:
        return t
    return t + (_round(t, low) - t).detach()


def output(t: torch.Tensor, low) -> torch.Tensor:
    """A convolution's or dense layer's output whose gradient is rounded
    to e5m2 on its way back into the product's backward, where ``low``
    is set."""
    if low is None:
        return t
    return _GradRound.apply(t, torch.float8_e5m2)


class Conv(nn.Module):
    """``nn.Conv`` of flax with explicit symmetric padding: weight
    ``[O, I, kh, kw]`` (float32), input and weight cast to ``dtype``.

    ``groups`` (flax's ``feature_group_count``) is 1 but in an
    object-stacked model (``models/stacked.py``), where each object is a
    group; an input of one group's width is then shared by every group (an
    ungrouped convolution with the groups' weights concatenated)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, padding: int = 0, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dilation, self.padding = stride, dilation, padding
        self.dtype = dtype
        self.groups = 1
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    operand_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        groups = self.groups if x.shape[1] != self.weight.shape[1] else 1
        low = self.operand_dtype
        return output(F.conv2d(operand(x.to(self.dtype), low),
                               operand(self.weight.to(self.dtype), low),
                               bias, self.stride, self.padding,
                               self.dilation, groups), low)


class Dense(nn.Module):
    """``nn.Dense`` of flax: weight ``[out, in]`` (float32, the transpose
    of the flax kernel), bias ``[out]``; input and weights cast to
    ``dtype``.

    ``objects`` is 1 but in an object-stacked model (``models/stacked.py``):
    the weight is then the objects' ``[out, in]`` blocks along dim 0, the
    input ``[objects, N, in]``, and object o's rows meet object o's block
    in one batched matrix product."""

    objects = 1
    operand_dtype = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low = self.operand_dtype
        w = operand(self.weight.to(self.dtype), low)
        b = self.bias.to(self.dtype)
        x = operand(x.to(self.dtype), low)
        if self.objects == 1:
            return output(F.linear(x, w, b), low)
        o = self.objects
        return output(torch.baddbmm(b.view(o, 1, -1), x,
                                    w.view(o, -1, w.shape[1]).transpose(1, 2)),
                      low)


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose`` of flax with ``padding="SAME"`` and kernel size
    equal to the stride: each input pixel becomes one ``k x k`` output
    tile. The weight is stored ``[O, I, kh, kw]`` (the neuron axis first,
    as every other weight of the port) with the taps flipped from the flax
    kernel, and handed to ``conv_transpose2d`` as ``[I, O, kh, kw]``.
    ``groups`` is 1 but in an object-stacked model, where each object's
    ``[O, I]`` block of dim 0 is transposed on its own."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = kernel
        self.dtype = dtype
        self.groups = 1
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    operand_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        low = self.operand_dtype
        w = operand(self.weight.to(self.dtype), low)
        if g == 1:
            w = w.transpose(0, 1)
        else:
            o, i, kh, kw = w.shape
            w = w.view(g, o // g, i, kh, kw).transpose(1, 2).reshape(
                g * i, o // g, kh, kw)
        return output(F.conv_transpose2d(
            operand(x.to(self.dtype), low), w, self.bias.to(self.dtype),
            stride=self.stride, groups=g), low)


class FrozenScaleBias(nn.Module):
    """Per-channel affine ``y = x·scale + bias`` with frozen constants.

    Stands in for a BatchNorm whose statistics and affine terms are frozen.
    ``scale``/``bias`` are buffers, the counterpart of flax's ``constants``
    collection, so the learned optimizer never updates them."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(num_channels))
        self.register_buffer("bias", torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return (x * self.scale.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(use_running_average=True)``: running
    statistics that are never recomputed and a learned affine.

    ``scale``/``bias`` are parameters (flax's ``params``), ``mean``/``var``
    buffers (its ``batch_stats`` collection), so the learned init carries
    them without a learning rate, as it carries the frozen-BN constants.
    The forward is flax's ``_normalize`` in float32 (a bf16 input promotes
    against the f32 statistics), cast to the input's dtype at the end:
    ``y = (x − mean)·(rsqrt(var + eps)·scale) + bias``. It is plain tensor
    arithmetic, which autograd differentiates to any order and through the
    statistics too: the JAX package differentiates ``batch_stats`` in its
    parent step and its outer step. ``var + eps`` is not clamped; a ``var``
    moved below ``-eps`` gives NaN, as in the JAX package."""

    eps = 1e-5  # flax's default (the port's GroupNorm takes 1e-6)

    def __init__(self, num_channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("mean", torch.zeros(num_channels))
        self.register_buffer("var", torch.ones(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.var.float() + self.eps) * self.scale.float()
        y = (x.float() - self.mean.float().view(shape)) * mul.view(shape)
        return (y + self.bias.float().view(shape)).to(x.dtype)


_GROUPS = {"group": 32, "group16": 16, "group4": 4}


def make_norm(norm: str) -> Norm:
    """Norm factory by name: ``group`` (32 groups), ``group16``, ``group4``,
    their ``_xla`` forms (plain formulation, no kernel: for
    differentiation beyond one reverse-mode level), ``frozen_bn`` and
    ``batch`` (running statistics, learned affine)."""
    if norm in _GROUPS:
        return partial(FusedGroupNorm, num_groups=_GROUPS[norm])
    if norm.endswith("_xla") and norm[:-4] in _GROUPS:
        return partial(FusedGroupNorm, num_groups=_GROUPS[norm[:-4]],
                       use_kernel=False)
    if norm == "frozen_bn":
        return FrozenScaleBias
    if norm == "batch":
        return BatchNorm
    raise ValueError(f"unknown norm {norm!r}")


class Bottleneck(nn.Module):
    """1x1 reduce → 3x3 (stride/dilation) → 1x1 expand (4x), with a
    projection shortcut on shape change."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dilation: int = 1, norm: Norm = FrozenScaleBias,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = filters * 4
        conv = partial(Conv, dtype=dtype)
        self.conv1 = conv(in_ch, filters, 1)
        self.norm1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride=stride,
                          dilation=dilation, padding=dilation)
        self.norm2 = norm(filters)
        self.conv3 = conv(filters, out_ch, 1)
        self.norm3 = norm(out_ch)
        self.has_down = in_ch != out_ch or stride != 1
        if self.has_down:
            self.down_conv = conv(in_ch, out_ch, 1, stride=stride)
            self.down_norm = norm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = self.down_norm(self.down_conv(x)) if self.has_down else x
        return F.relu(y + residual)


STAGE_SIZES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet10": (1, 1, 1, 1),  # miniature for tests
}
STAGE_FILTERS = {
    "resnet50": (64, 128, 256, 512),
    "resnet101": (64, 128, 256, 512),
    "resnet10": (8, 16, 32, 64),
}
STEM_WIDTH = {"resnet50": 64, "resnet101": 64, "resnet10": 8}


class ResNet(nn.Module):
    """ResNet trunk returning the C2..C5 features.

    ``dilate_stages``: per-stage (layer2, layer3, layer4) flags replacing
    stride with dilation; all-False is the stride-32 trunk."""

    def __init__(self, arch: str = "resnet50", norm_layer: str = "group",
                 dilate_stages: Tuple[bool, bool, bool] = (False, False, False),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        norm = make_norm(norm_layer)
        self.dtype = dtype
        stem = STEM_WIDTH[arch]
        self.stem_conv = Conv(3, stem, 7, stride=2, padding=3, dtype=dtype)
        self.stem_norm = norm(stem)
        self.block_names = []
        in_ch = stem
        dilation = 1
        for stage_idx, (blocks, filters) in enumerate(
                zip(STAGE_SIZES[arch], STAGE_FILTERS[arch])):
            if stage_idx == 0:
                stride, stage_dilation = 1, 1
            else:
                if dilate_stages[stage_idx - 1]:
                    dilation *= 2
                    stride = 1
                else:
                    stride = 2
                stage_dilation = dilation
            names = []
            for b in range(blocks):
                name = f"layer{stage_idx + 1}_block{b}"
                self.add_module(name, Bottleneck(
                    in_ch, filters,
                    stride=stride if b == 0 else 1,
                    # torchvision semantics: the first block of a dilated
                    # stage uses the previous dilation for its 3x3
                    dilation=stage_dilation // 2
                    if (b == 0 and stage_dilation > 1) else stage_dilation,
                    norm=norm, dtype=dtype,
                ))
                in_ch = filters * 4
                names.append(name)
            self.block_names.append(names)
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.stem_norm(self.stem_conv(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for stage_idx, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"C{stage_idx + 2}"] = x
        return feats
