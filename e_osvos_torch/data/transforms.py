"""On-device augmentation of the support frame, port of the main-path subset
of ``e_osvos_tpu/data/transforms.py``.

Every random draw is split from its use: ``sample_augment_draws`` draws the
scale, rotation, flip and colour-jitter factors from an explicit
``torch.Generator``, and the transforms take them as arguments, so tests
can feed in the JAX package's draws.

The warp has the semantics of ``affine_warp_packed``: a bilinear image with
0 outside the frame, the nearest label corner with 255 outside, and an
``inside`` mask of pixels with any bilinear support. The nearest label
corner is picked by ``w >= 0.5`` (ties round up), as the packed warp does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

# DAVIS BGR channel means (the reference's davis.py) reordered to RGB
DAVIS_MEAN_RGB = (122.679, 116.669, 104.007)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Per-task augmentation ranges (the reference's meta-task transform
    stack): scale in [0.75, 1.25], rotation in [-30°, 30°], colour jitter
    0.1/0.1/0.1, 50% horizontal flip. ``compute_dtype`` is the warp's and
    jitter's arithmetic dtype."""

    scale_min: float = 0.75
    scale_max: float = 1.25
    rot_deg: float = 30.0
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.1
    flip_prob: float = 0.5
    compute_dtype: str = "bfloat16"


class AugmentDraws(NamedTuple):
    """Random factors of a batch of augmentations, each shaped like the
    batch (``[B]`` or ``[steps, B]``): scale, rotation (radians), flip
    (bool), brightness, contrast and saturation factors."""

    scale: torch.Tensor
    theta: torch.Tensor
    flip: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device, non_blocking=True) for t in self))

    def select(self, i: int) -> "AugmentDraws":
        """The draws of step ``i`` (index along the leading axis)."""
        return AugmentDraws(*(t[i] for t in self))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def sample_augment_draws(gen: torch.Generator, cfg: AugmentConfig,
                         shape: Union[int, Tuple[int, ...]]) -> AugmentDraws:
    """Draw the factors of ``shape`` augmentations (on the generator's
    device, the CPU by default)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    deg = math.pi / 180.0
    return AugmentDraws(
        scale=_uniform(gen, shape, cfg.scale_min, cfg.scale_max),
        theta=_uniform(gen, shape, -cfg.rot_deg, cfg.rot_deg) * deg,
        flip=torch.rand(shape, generator=gen) < cfg.flip_prob,
        brightness=_uniform(gen, shape, 1 - cfg.brightness, 1 + cfg.brightness),
        contrast=_uniform(gen, shape, 1 - cfg.contrast, 1 + cfg.contrast),
        saturation=_uniform(gen, shape, 1 - cfg.saturation, 1 + cfg.saturation),
    )


def normalize(img: torch.Tensor, mode: str = "davis") -> torch.Tensor:
    """RGB ``[..., 3]`` → normalized float32: ``davis`` subtracts the DAVIS
    channel means, ``unit`` divides by 255, ``none`` only casts."""
    img = img.float()
    if mode == "davis":
        return img - torch.tensor(DAVIS_MEAN_RGB, dtype=torch.float32,
                                  device=img.device)
    if mode == "unit":
        return img / 255.0
    if mode == "none":
        return img
    raise ValueError(f"unknown normalize mode {mode!r}")


def scale_rotate_flip_matrix(scale: torch.Tensor, theta: torch.Tensor,
                             flip: torch.Tensor) -> torch.Tensor:
    """Inverse (sampling) matrix ``[..., 2, 3]`` of a scale-by-s, rotate-by-θ
    transform with an optional horizontal flip, in centred pixel units:
    ``R(-θ)/s`` with the x-axis sign flip folded in."""
    fx = torch.where(flip, -1.0, 1.0).to(torch.float32)
    cos = torch.cos(theta) / scale
    sin = torch.sin(theta) / scale
    zero = torch.zeros_like(cos)
    return torch.stack([
        torch.stack([cos * fx, sin, zero], -1),
        torch.stack([-sin * fx, cos, zero], -1),
    ], -2).to(torch.float32)


def _affine_grid(h: int, w: int, matrix: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates ``[B, H, W]`` of an inverse affine map about the
    image centre; ``matrix`` is ``[B, 2, 3]`` in pixel units."""
    dev = matrix.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = matrix[:, :, :, None, None]  # [B, 2, 3, 1, 1]
    src_x = m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2] + (w - 1) / 2.0
    src_y = m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2] + (h - 1) / 2.0
    return src_y, src_x


def affine_warp_packed(img: torch.Tensor, label: torch.Tensor,
                       matrix: torch.Tensor,
                       compute_dtype: Union[str, torch.dtype] = torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp one frame ``img [H, W, 3]`` / ``label [H, W]`` by each matrix of
    ``matrix [B, 2, 3]`` (or one ``[2, 3]``).

    Returns ``(img [B, H, W, 3] in compute_dtype, label [B, H, W] int32
    with 255 outside, inside [B, H, W] bool)`` (without the B axis for one
    matrix). Label values must be ≤ 255."""
    single = matrix.dim() == 2
    if single:
        matrix = matrix[None]
    dt = _dtype(compute_dtype)
    h, w = img.shape[0], img.shape[1]
    flat_img = img.to(dt).reshape(h * w, 3)
    flat_lab = label.to(torch.int32).reshape(h * w)

    src_y, src_x = _affine_grid(h, w, matrix)
    y0f = torch.floor(src_y)
    x0f = torch.floor(src_x)
    wy = (src_y - y0f).to(dt)
    wx = (src_x - x0f).to(dt)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    ny = wy >= 0.5  # nearest corner for the label
    nx = wx >= 0.5

    rgb = torch.zeros(src_y.shape + (3,), dtype=dt, device=img.device)
    lab = torch.full(src_y.shape, 255, dtype=torch.int32, device=img.device)
    inside = torch.zeros(src_y.shape, dtype=torch.bool, device=img.device)
    zero = torch.zeros((), dtype=dt, device=img.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yi = y0 + dy
            xi = x0 + dx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            wgt = (wy if dy else 1 - wy) * (wx if dx else 1 - wx)
            wgt = torch.where(ok, wgt, zero)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            rgb = rgb + flat_img[idx] * wgt[..., None]
            is_nearest = (ny == bool(dy)) & (nx == bool(dx))
            lab = torch.where(is_nearest & ok, flat_lab[idx], lab)
            inside = inside | ok
    if single:
        return rgb[0], lab[0], inside[0]
    return rgb, lab, inside


def _dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def color_jitter(img: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor, saturation: torch.Tensor,
                 mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Brightness/contrast/saturation jitter of ``[B, H, W, 3]`` images in
    [0, 255], with factors ``[B]`` (torchvision ColorJitter semantics).
    ``mean`` supplies the contrast anchor (the pre-warp image mean when the
    jitter runs after the warp). Arithmetic in the image's float dtype."""
    dt = img.dtype if img.is_floating_point() else torch.float32
    shape = (-1, 1, 1, 1)
    b = brightness.to(dt).view(shape)
    c = contrast.to(dt).view(shape)
    s = saturation.to(dt).view(shape)
    img = img.to(dt)
    if mean is None:
        mean = img.mean(dim=(1, 2, 3))
    mean = mean.to(dt).reshape(-1, 1, 1, 1) * b
    img = img * b
    img = (img - mean) * c + mean
    k = [torch.tensor(v, dtype=dt, device=img.device)
         for v in (0.299, 0.587, 0.114)]
    gray = (k[0] * img[..., 0] + k[1] * img[..., 1]
            + k[2] * img[..., 2])[..., None]
    img = (img - gray) * s + gray
    return img.clamp(0.0, 255.0)


def augment_support_batch(img: torch.Tensor, label: torch.Tensor,
                          draws: AugmentDraws, cfg: AugmentConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EpochSampler semantics: one support frame ``[H, W, 3]`` (in [0, 255],
    before normalize) augmented independently once per draw (``draws``
    fields ``[B]``): one scale/rotate/flip warp, then colour jitter anchored
    on the pre-warp mean; warped-in border pixels get image 0 and label
    255. Returns ``([B, H, W, 3] float32, [B, H, W] int32)``."""
    dt = _dtype(cfg.compute_dtype)
    matrix = scale_rotate_flip_matrix(draws.scale, draws.theta, draws.flip)
    wimg, wlabel, inside = affine_warp_packed(img, label, matrix, dt)
    mean = img.to(dt).mean()
    jimg = color_jitter(wimg, draws.brightness, draws.contrast,
                        draws.saturation, mean=mean.expand(matrix.shape[0]))
    jimg = torch.where(inside[..., None], jimg,
                       torch.zeros((), dtype=jimg.dtype, device=jimg.device))
    return jimg.float(), wlabel


def augment_frame(img: torch.Tensor, label: torch.Tensor, draws: AugmentDraws,
                  cfg: AugmentConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One augmentation of one frame, with scalar ``draws``: returns
    ``([H, W, 3] float32, [H, W] int32)``."""
    batch = AugmentDraws(*(t.reshape(1) for t in draws))
    out_img, out_label = augment_support_batch(img, label, batch, cfg)
    return out_img[0], out_label[0]


def pad_label_to(label: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """255-pad an ``[H, W]`` label map bottom/right to ``hw``."""
    h, w = label.shape
    th, tw = hw
    if (th, tw) == (h, w):
        return label
    return F.pad(label, (0, tw - w, 0, th - h), value=255)
