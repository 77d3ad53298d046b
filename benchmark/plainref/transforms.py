"""On-device augmentation, port of ``e_osvos_tpu/data/transforms.py``.

Every random draw is split from its use: ``sample_augment_draws`` draws the
scale, rotation, flip, colour-jitter factors, translation and blur from an
explicit ``torch.Generator`` (on the card, a generator on the device), and
the transforms take them as arguments, so tests can feed in the JAX
package's draws.

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
    0.1/0.1/0.1, 50% horizontal flip. ``trans_frac`` > 0 adds a random
    translation of up to that fraction of the frame to the warp;
    ``blur_prob`` > 0 blurs with that probability, sigma uniform in
    [0, ``blur_sigma_max``). ``compute_dtype`` is the warp's and jitter's
    arithmetic dtype."""

    scale_min: float = 0.75
    scale_max: float = 1.25
    rot_deg: float = 30.0
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.1
    flip_prob: float = 0.5
    trans_frac: float = 0.0
    blur_prob: float = 0.0
    blur_sigma_max: float = 1.0
    compute_dtype: str = "bfloat16"


# The reference's VOC parent-training stack: flip 0.5, scale in [0.5, 2.0]
# with a random crop (the translation), Gaussian blur with p = 0.5 and sigma
# in [0, 1), no colour jitter. Pair with ``normalize(mode="unit")``.
VOC_PARENT_AUGMENT = AugmentConfig(
    scale_min=0.5, scale_max=2.0, rot_deg=0.0,
    brightness=0.0, contrast=0.0, saturation=0.0,
    flip_prob=0.5, trans_frac=0.25, blur_prob=0.5, blur_sigma_max=1.0,
)


class AugmentDraws(NamedTuple):
    """Random factors of a batch of augmentations, each shaped like the
    batch (``[B]`` or ``[steps, B]``): scale, rotation (radians), flip
    (bool), brightness, contrast and saturation factors; with a translation
    the shift ``trans [..., 2]`` (x, y) as fractions of the frame's width
    and height, with a blur its decision ``blur`` (bool) and ``sigma``.
    Those three are None when the configuration has no such step."""

    scale: torch.Tensor
    theta: torch.Tensor
    flip: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    trans: Optional[torch.Tensor] = None
    blur: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(None if t is None
                              else t.to(device, non_blocking=True)
                              for t in self))

    def select(self, i) -> "AugmentDraws":
        """The draws of step ``i`` (index along the leading axis)."""
        return AugmentDraws(*(None if t is None else t[i] for t in self))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def sample_augment_draws(gen: torch.Generator, cfg: AugmentConfig,
                         shape: Union[int, Tuple[int, ...]]) -> AugmentDraws:
    """Draw the factors of ``shape`` augmentations, on the generator's
    device. The translation and blur draws follow the others, and only
    when the configuration has those steps."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    deg = math.pi / 180.0
    draws = AugmentDraws(
        scale=_uniform(gen, shape, cfg.scale_min, cfg.scale_max),
        theta=_uniform(gen, shape, -cfg.rot_deg, cfg.rot_deg) * deg,
        flip=torch.rand(shape, generator=gen, device=gen.device) < cfg.flip_prob,
        brightness=_uniform(gen, shape, 1 - cfg.brightness, 1 + cfg.brightness),
        contrast=_uniform(gen, shape, 1 - cfg.contrast, 1 + cfg.contrast),
        saturation=_uniform(gen, shape, 1 - cfg.saturation, 1 + cfg.saturation),
    )
    if cfg.trans_frac > 0:
        draws = draws._replace(trans=_uniform(
            gen, shape + (2,), -cfg.trans_frac, cfg.trans_frac))
    if cfg.blur_prob > 0:
        draws = draws._replace(
            blur=torch.rand(shape, generator=gen, device=gen.device)
            < cfg.blur_prob,
            sigma=_uniform(gen, shape, 0.0, cfg.blur_sigma_max))
    return draws


def sample_task_draws(gen: torch.Generator, cfg: AugmentConfig,
                      num_frames: int) -> AugmentDraws:
    """Draws ``[num_frames]`` for one task's frames (support first): a warp,
    translation and blur a frame, one flip decision and one set of colour
    factors shared by every frame of the task."""
    draws = sample_augment_draws(gen, cfg, num_frames)

    def shared(t):
        return t[:1].expand_as(t)

    return draws._replace(
        flip=shared(draws.flip), brightness=shared(draws.brightness),
        contrast=shared(draws.contrast), saturation=shared(draws.saturation))


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


def affine_warp(img: torch.Tensor, label: torch.Tensor, matrix: torch.Tensor,
                img_cval: float = 0.0, label_cval: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One inverse-affine warp of ``img [H, W, C]`` and ``label [H, W]`` by
    ``matrix [2, 3]``: bilinear in the image's dtype with ``img_cval``
    outside the frame, nearest (round half to even) for the label with
    ``label_cval`` outside."""
    h, w = img.shape[0], img.shape[1]
    src_y, src_x = (t[0] for t in _affine_grid(h, w, matrix[None]))
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    wy = (src_y - y0f)[..., None].to(img.dtype)
    wx = (src_x - x0f)[..., None].to(img.dtype)
    y0, x0 = y0f.long(), x0f.long()

    def gather(x, yi, xi, cval):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = x[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if vals.dim() > ok.dim():
            ok = ok[..., None]
        return torch.where(ok, vals, torch.tensor(cval, dtype=x.dtype,
                                                  device=x.device))

    out_img = (gather(img, y0, x0, img_cval) * (1 - wy) * (1 - wx)
               + gather(img, y0, x0 + 1, img_cval) * (1 - wy) * wx
               + gather(img, y0 + 1, x0, img_cval) * wy * (1 - wx)
               + gather(img, y0 + 1, x0 + 1, img_cval) * wy * wx)
    out_label = gather(label, torch.round(src_y).long(),
                       torch.round(src_x).long(), label_cval)
    return out_img, out_label


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


def gaussian_blur(img: torch.Tensor, blur: torch.Tensor,
                  sigma: torch.Tensor, taps: int = 7) -> torch.Tensor:
    """RandomGaussianBlur of ``img [B, H, W, C]``: image b is blurred where
    ``blur[b]``, with a separable ``taps``-wide Gaussian of standard
    deviation ``sigma[b]`` (at least 1e-3) and edge-replicate padding, in
    float32. Returns the image's dtype."""
    b, c = img.shape[0], img.shape[-1]
    r = taps // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    kern = torch.exp(-0.5 * (x / sigma.float().clamp_min(1e-3)[:, None]) ** 2)
    kern = (kern / kern.sum(-1, keepdim=True)).repeat_interleave(c, 0)
    src = img.float().permute(0, 3, 1, 2)  # [B, C, H, W]
    pad = F.pad(src, (r, r, r, r), mode="replicate")
    pad = pad.reshape(1, b * c, *pad.shape[2:])
    out = F.conv2d(pad, kern.view(b * c, 1, taps, 1), groups=b * c)
    out = F.conv2d(out, kern.view(b * c, 1, 1, taps), groups=b * c)
    out = torch.where(blur.view(b, 1, 1, 1), out.view_as(src), src)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def augment_support_batch(img: torch.Tensor, label: torch.Tensor,
                          draws: AugmentDraws, cfg: AugmentConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EpochSampler semantics: one support frame ``[H, W, 3]`` (in [0, 255],
    before normalize) augmented independently once per draw (``draws``
    fields ``[B]``): one scale/rotate/flip warp (with the translation, when
    the configuration has one), then colour jitter anchored on the pre-warp
    mean; warped-in border pixels get image 0 and label 255; then the blur,
    when the configuration has one. Returns ``([B, H, W, 3] float32,
    [B, H, W] int32)``."""
    dt = _dtype(cfg.compute_dtype)
    matrix = scale_rotate_flip_matrix(draws.scale, draws.theta, draws.flip)
    if cfg.trans_frac > 0:
        h, w = img.shape[0], img.shape[1]
        size = torch.tensor([w, h], dtype=torch.float32, device=img.device)
        matrix = torch.cat([matrix[..., :2],
                            (draws.trans.float() * size)[..., None]], -1)
    wimg, wlabel, inside = affine_warp_packed(img, label, matrix, dt)
    mean = img.to(dt).mean()
    jimg = color_jitter(wimg, draws.brightness, draws.contrast,
                        draws.saturation, mean=mean.expand(matrix.shape[0]))
    jimg = torch.where(inside[..., None], jimg,
                       torch.zeros((), dtype=jimg.dtype, device=jimg.device))
    if cfg.blur_prob > 0:
        jimg = gaussian_blur(jimg, draws.blur, draws.sigma)
    return jimg.float(), wlabel


def augment_frame(img: torch.Tensor, label: torch.Tensor, draws: AugmentDraws,
                  cfg: AugmentConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One augmentation of one frame, with scalar ``draws``: returns
    ``([H, W, 3] float32, [H, W] int32)``."""
    batch = draws.select(None)  # a batch of one
    out_img, out_label = augment_support_batch(img, label, batch, cfg)
    return out_img[0], out_label[0]


def augment_task_frames(support_img: torch.Tensor,
                        support_label: torch.Tensor,
                        query_imgs: torch.Tensor, query_labels: torch.Tensor,
                        draws: AugmentDraws, cfg: AugmentConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Per-task augmentation (the reference's
    ``random_frame_transform_per_task``): the support ``[H, W, 3]``/``[H,
    W]`` and each query ``[Q, H, W, 3]``/``[Q, H, W]`` augmented once with
    its frame's draws (``draws`` fields ``[1 + Q]``, support first, from
    ``sample_task_draws``: one flip and one colour draw for the task).
    Returns the augmented ``(support_img, support_label, query_imgs,
    query_labels)``; the caller reuses the support for every inner step."""
    s_img, s_label = augment_frame(support_img, support_label,
                                   draws.select(0), cfg)
    qs = [augment_frame(query_imgs[i], query_labels[i], draws.select(i + 1),
                        cfg) for i in range(query_imgs.shape[0])]
    return (s_img, s_label, torch.stack([q[0] for q in qs]),
            torch.stack([q[1] for q in qs]))


def sample_crop_offset(gen: torch.Generator, hw: Tuple[int, int],
                       size: Tuple[int, int]) -> Tuple[int, int]:
    """A random crop's top-left corner ``(y0, x0)``, uniform over the
    positions where ``size`` fits in ``hw``, as host ints."""
    (h, w), (th, tw) = hw, size
    y0 = torch.randint(0, max(h - th, 0) + 1, (), generator=gen,
                       device=gen.device)
    x0 = torch.randint(0, max(w - tw, 0) + 1, (), generator=gen,
                       device=gen.device)
    return int(y0), int(x0)


def random_crop(img: torch.Tensor, label: torch.Tensor,
                size: Tuple[int, int], offset: Tuple[int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop ``img [H, W, C]`` and ``label [H, W]`` to ``size`` at ``offset``
    (``sample_crop_offset``), the offset clamped so the crop stays inside
    the frame, as ``dynamic_slice`` clamps it."""
    h, w = img.shape[0], img.shape[1]
    th, tw = size
    if th > h or tw > w:
        raise ValueError(f"crop {th}x{tw} larger than frame {h}x{w}")
    y0 = min(max(int(offset[0]), 0), h - th)
    x0 = min(max(int(offset[1]), 0), w - tw)
    return img[y0:y0 + th, x0:x0 + tw], label[y0:y0 + th, x0:x0 + tw]


def pad_label_to(label: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """255-pad an ``[..., H, W]`` label map bottom/right to ``hw``."""
    h, w = label.shape[-2:]
    th, tw = hw
    if (th, tw) == (h, w):
        return label
    return F.pad(label, (0, tw - w, 0, th - h), value=255)


def pad_to(img: torch.Tensor, label: torch.Tensor, size: Tuple[int, int]
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad ``img [H, W, 3]`` (zeros) and ``label [H, W]`` (255) bottom/right
    to ``size``; returns ``(img, label, valid)`` with ``valid`` the original
    pixels."""
    h, w = img.shape[0], img.shape[1]
    th, tw = size
    if h > th or w > tw:
        raise ValueError(f"frame {h}x{w} larger than canvas {th}x{tw}")
    valid = F.pad(torch.ones((h, w), dtype=torch.uint8, device=img.device),
                  (0, tw - w, 0, th - h)).bool()
    return (F.pad(img, (0, 0, 0, tw - w, 0, th - h)),
            pad_label_to(label, size), valid)


def bucket_hw(h: int, w: int, multiple: int) -> Tuple[int, int]:
    """``(h, w)`` rounded up to the next multiple: the evaluation-resolution
    bucket. Scoring still runs on the original geometry."""
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def pad_frames_to_multiple(frames: torch.Tensor, multiple: int
                           ) -> torch.Tensor:
    """Zero-pad a ``[T, H, W, 3]`` frame stack bottom/right to its bucket."""
    h, w = frames.shape[1], frames.shape[2]
    hb, wb = bucket_hw(h, w, multiple)
    if (hb, wb) == (h, w):
        return frames
    return F.pad(frames, (0, 0, 0, wb - w, 0, hb - h))
