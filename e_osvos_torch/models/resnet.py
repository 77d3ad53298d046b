"""Dilated ResNet trunk, port of ``e_osvos_tpu/models/resnet.py``.

Module names follow the flax module names (``stem_conv``, ``layer1_block0``,
``conv1``, ``norm1``, ``down_conv``...), so the weights of the JAX package
map onto this trunk one to one (``models/jax_weights.py``).

Tensors are NCHW in ``torch.channels_last`` memory format, which keeps them
physically NHWC, the JAX layout. ``dtype`` is the compute dtype: parameters
stay float32 and are cast at each convolution, as flax's
``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from e_osvos_torch.ops.group_norm import FusedGroupNorm

Norm = Callable[[int], nn.Module]


class Conv(nn.Module):
    """``nn.Conv`` of flax with explicit symmetric padding: weight
    ``[O, I, kh, kw]`` (float32), input and weight cast to ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, padding: int = 0, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dilation, self.padding = stride, dilation, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, self.padding, self.dilation)


class Dense(nn.Module):
    """``nn.Dense`` of flax: weight ``[out, in]`` (float32, the transpose
    of the flax kernel), bias ``[out]``; input and weights cast to
    ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose`` of flax with ``padding="SAME"`` and kernel size
    equal to the stride: each input pixel becomes one ``k x k`` output
    tile. The weight is stored ``[O, I, kh, kw]`` (the neuron axis first,
    as every other weight of the port) with the taps flipped from the flax
    kernel, and handed to ``conv_transpose2d`` as ``[I, O, kh, kw]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = kernel
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype).transpose(0, 1),
            self.bias.to(self.dtype), stride=self.stride)


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


_GROUPS = {"group": 32, "group16": 16, "group4": 4}


def make_norm(norm: str) -> Norm:
    """Norm factory by name: ``group`` (32 groups), ``group16``, ``group4``,
    their ``_xla`` forms (plain formulation, no kernel: for
    differentiation beyond one reverse-mode level), and ``frozen_bn``."""
    if norm in _GROUPS:
        return partial(FusedGroupNorm, num_groups=_GROUPS[norm])
    if norm.endswith("_xla") and norm[:-4] in _GROUPS:
        return partial(FusedGroupNorm, num_groups=_GROUPS[norm[:-4]],
                       use_kernel=False)
    if norm == "frozen_bn":
        return FrozenScaleBias
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
