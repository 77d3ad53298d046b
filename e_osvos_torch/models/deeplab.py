"""DeepLabV3 and DeepLabV3+ heads, port of ``e_osvos_tpu/models/deeplab.py``.

Public layout is the JAX one: ``forward`` takes images ``[B, H, W, 3]`` and
returns float32 logits ``[B, H, W, num_classes]`` at the input resolution.
Inside, tensors are NCHW in ``torch.channels_last`` memory format (physically
NHWC). Parameters are float32; compute runs in ``dtype``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from e_osvos_torch.models.resnet import (
    Conv, ConvTranspose, Dense, ResNet, make_norm,
)
from e_osvos_torch.utils.device import resolve_device


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel bilinear resize of NCHW (``jax.image.resize`` bilinear
    when upsampling)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the reference decoder's
    upsampling of the ASPP output onto the low-level features)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def cat_channels(tensors: Sequence[torch.Tensor], objects: int = 1
                 ) -> torch.Tensor:
    """Concatenate NCHW tensors along the channels into a
    ``channels_last`` tensor. With ``objects`` > 1 (an object-stacked
    model, ``models/stacked.py``) each tensor holds ``objects`` equal
    channel blocks, and the result is object by object: [object 0's block of
    each tensor, object 1's, ...], the input a grouped convolution reads."""
    if objects == 1:
        return torch.cat(tensors, dim=1).contiguous(
            memory_format=torch.channels_last)
    n, _, h, w = tensors[0].shape
    parts = [t.permute(0, 2, 3, 1).reshape(n, h, w, objects, -1)
             for t in tensors]
    return torch.cat(parts, dim=-1).reshape(n, h, w, -1).permute(0, 3, 1, 2)


class ASPP(nn.Module):
    """1x1 + three dilated 3x3 branches + image-pooling branch, fused by a
    1x1 projection; every branch conv → norm → relu."""

    objects = 1  # object blocks of the channels (models/stacked.py)

    def __init__(self, in_ch: int, out_ch: int = 256,
                 rates: Sequence[int] = (6, 12, 18),
                 norm_layer: str = "group16",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        norm = make_norm(norm_layer)
        conv = partial(Conv, dtype=dtype)
        self.rates = tuple(rates)
        self.b0_conv = conv(in_ch, out_ch, 1)
        self.b0_norm = norm(out_ch)
        for i, r in enumerate(self.rates):
            self.add_module(f"b{i + 1}_conv",
                            conv(in_ch, out_ch, 3, dilation=r, padding=r))
            self.add_module(f"b{i + 1}_norm", norm(out_ch))
        self.pool_conv = conv(in_ch, out_ch, 1)
        self.pool_norm = norm(out_ch)
        n_branches = len(self.rates) + 2
        self.proj_conv = conv(n_branches * out_ch, out_ch, 1)
        self.proj_norm = norm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(self.b0_norm(self.b0_conv(x)))]
        for i in range(len(self.rates)):
            y = getattr(self, f"b{i + 1}_conv")(x)
            branches.append(F.relu(getattr(self, f"b{i + 1}_norm")(y)))
        pooled = x.mean(dim=(2, 3), keepdim=True)
        pooled = F.relu(self.pool_norm(self.pool_conv(pooled)))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = cat_channels(branches, self.objects)
        return F.relu(self.proj_norm(self.proj_conv(y)))


def _dilate_stages(output_stride: int):
    """8 → dilate layer3 and layer4; 16 → layer4 only."""
    if output_stride == 8:
        return (False, True, True)
    if output_stride == 16:
        return (False, False, True)
    raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded init with flax's defaults: convolution and dense kernels
    lecun-normal (normal truncated at two standard deviations, variance
    1/fan_in), biases 0; norms keep their ones/zeros."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, ConvTranspose, Dense)):
                fan_in = math.prod(mod.weight.shape[1:])
                # std of the unit normal truncated to [-2, 2]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                mod.weight.copy_(w)


class _SegmentationModel(nn.Module):
    """Shared set-up: seeded init, device, channels_last, NHWC interface."""

    objects = 1  # object blocks of the channels (models/stacked.py)

    def _finish(self, seed: int, device) -> None:
        init_weights(self, seed)
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        y = self.logits_nchw(x.permute(0, 3, 1, 2))  # channels_last view
        y = resize_bilinear(y.float(), (h, w))
        return y.permute(0, 2, 3, 1)


class DeepLabV3(_SegmentationModel):
    """ASPP head on a dilated ResNet trunk; logits at input resolution."""

    def __init__(self, num_classes: int = 1, arch: str = "resnet50",
                 backbone_norm: str = "group", head_norm: str = "group16",
                 output_stride: int = 8, dtype: torch.dtype = torch.float32,
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.backbone = ResNet(arch, backbone_norm,
                               _dilate_stages(output_stride), dtype)
        self.aspp = ASPP(self.backbone.out_channels, norm_layer=head_norm,
                         dtype=dtype)
        self.head_conv = Conv(256, 256, 3, padding=1, dtype=dtype)
        self.head_norm = make_norm(head_norm)(256)
        self.classifier = Conv(256, num_classes, 1, use_bias=True,
                               dtype=dtype)
        self._finish(seed, device)

    def logits_nchw(self, x: torch.Tensor) -> torch.Tensor:
        y = self.aspp(self.backbone(x)["C5"])
        y = F.relu(self.head_norm(self.head_conv(y)))
        return self.classifier(y)


class DeepLabV3Plus(_SegmentationModel):
    """ASPP + low-level-feature decoder; logits at input resolution."""

    def __init__(self, num_classes: int = 1, arch: str = "resnet50",
                 backbone_norm: str = "group", head_norm: str = "group16",
                 output_stride: int = 8, dtype: torch.dtype = torch.float32,
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.backbone = ResNet(arch, backbone_norm,
                               _dilate_stages(output_stride), dtype)
        self.aspp = ASPP(self.backbone.out_channels, norm_layer=head_norm,
                         dtype=dtype)
        norm = make_norm(head_norm)
        conv = partial(Conv, dtype=dtype)
        c2 = self.backbone.out_channels // 8  # layer1 output width
        self.low_conv = conv(c2, 48, 1)
        self.low_norm = norm(48)
        self.dec_conv1 = conv(256 + 48, 256, 3, padding=1)
        self.dec_norm1 = norm(256)
        self.dec_conv2 = conv(256, 256, 3, padding=1)
        self.dec_norm2 = norm(256)
        self.classifier = conv(256, num_classes, 1, use_bias=True)
        self._finish(seed, device)

    def logits_nchw(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        y = self.aspp(feats["C5"])
        low = F.relu(self.low_norm(self.low_conv(feats["C2"])))
        y = resize_bilinear_align_corners(y, low.shape[-2:])
        y = cat_channels([y, low.to(y.dtype)], self.objects)
        y = F.relu(self.dec_norm1(self.dec_conv1(y)))
        y = F.relu(self.dec_norm2(self.dec_conv2(y)))
        return self.classifier(y)


ARCHITECTURES = {"DeepLabV3": DeepLabV3, "DeepLabV3Plus": DeepLabV3Plus}


def build_model(architecture: str, **kwargs) -> nn.Module:
    """Model factory by architecture name."""
    if architecture not in ARCHITECTURES:
        raise ValueError(
            f"unknown architecture {architecture!r}; have {list(ARCHITECTURES)}"
        )
    return ARCHITECTURES[architecture](**kwargs)


def functional_apply(model: nn.Module):
    """``apply(params, *args, **kwargs)`` over a dict of parameters, the
    counterpart of flax's ``model.apply(variables, ...)``; buffers stay the
    module's unless ``params`` names them. ``apply.model`` is ``model``."""

    def apply(params, *args, **kwargs):
        return torch.func.functional_call(model, params, args, kwargs)

    apply.model = model  # for its object-stacked form (models/stacked.py)
    return apply
