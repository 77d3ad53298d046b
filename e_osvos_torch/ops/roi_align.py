"""ROI-align, single- and multi-level (FPN), port of
``e_osvos_tpu/ops/roi_align.py``.

torchvision ``roi_align`` semantics: continuous coordinates, the
``aligned=True`` half-pixel offset, each output cell the mean of
``sampling_ratio²`` bilinear samples, samples outside the map contributing
zero. Features are ``[H, W, C]`` (one image, the JAX layout); rows of C are
gathered with ``index_select``, whose backward is autograd's scatter-add.

The JAX package's corner-packed and byte-packed buffers exist because TPU
gathers are bound by their slice count; here the plain four-corner gather
computes the same values, so ``multiscale_roi_align`` also stands for the
JAX ``multiscale_roi_align_packed`` (the training path's form), and
``stack_roi_align_u8`` is ``stack_roi_align_1ch`` on the integer map.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch


def _sample_coords(boxes: torch.Tensor, output_size: Tuple[int, int],
                   sampling_ratio: int, aligned: bool):
    """Bilinear sample positions ``yy, xx [N, oh, ow, s, s]`` of boxes
    already in the map's coordinates."""
    oh, ow = output_size
    s = sampling_ratio
    n = boxes.shape[0]
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] - offset
    y1 = boxes[:, 1] - offset
    bw = (boxes[:, 2] - offset - x1).clamp_min(1e-6)
    bh = (boxes[:, 3] - offset - y1).clamp_min(1e-6)
    cell_w = bw / ow
    cell_h = bh / oh
    dev = boxes.device
    frac = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    gy = torch.arange(oh, dtype=torch.float32, device=dev)
    gx = torch.arange(ow, dtype=torch.float32, device=dev)
    y = y1[:, None, None] + (gy[None, :, None] + frac[None, None, :]) * cell_h[:, None, None]
    x = x1[:, None, None] + (gx[None, :, None] + frac[None, None, :]) * cell_w[:, None, None]
    yy = y[:, :, None, :, None].expand(n, oh, ow, s, s)
    xx = x[:, None, :, None, :].expand(n, oh, ow, s, s)
    return yy, xx


def _gather_pool(flat: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
                 hb, wb, off, blend_dtype: torch.dtype) -> torch.Tensor:
    """Bilinear samples of ``flat [M, C]`` (one or more stacked maps; a
    sample's map is rows ``off + [0, hb·wb)``, integer tensors broadcasting
    against the samples) averaged over the sampling grid →
    ``[N, oh, ow, C]`` in ``blend_dtype``."""
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = (yy - y0)[..., None].to(blend_dtype)
    wx = (xx - x0)[..., None].to(blend_dtype)
    y0i = y0.long()
    x0i = x0.long()
    m_tot = flat.shape[0]
    c = flat.shape[1]
    zero = torch.zeros((), dtype=blend_dtype, device=flat.device)

    def corner(yi, xi):
        ok = (yi >= 0) & (yi < hb) & (xi >= 0) & (xi < wb)
        idx = (off + torch.minimum(yi.clamp_min(0), hb - 1) * wb
               + torch.minimum(xi.clamp_min(0), wb - 1)).clamp(0, m_tot - 1)
        v = flat.index_select(0, idx.reshape(-1)).view(idx.shape + (c,))
        return torch.where(ok[..., None], v.to(blend_dtype), zero)

    one = torch.ones((), dtype=blend_dtype, device=flat.device)
    vals = (corner(y0i, x0i) * (one - wy) * (one - wx)
            + corner(y0i, x0i + 1) * (one - wy) * wx
            + corner(y0i + 1, x0i) * wy * (one - wx)
            + corner(y0i + 1, x0i + 1) * wy * wx)  # [N, oh, ow, s, s, C]
    return vals.mean(dim=(3, 4))


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              output_size: Tuple[int, int], spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """``feat [H, W, C]``, ``boxes [N, 4]`` xyxy in image coordinates →
    ``[N, oh, ow, C]``; the blend runs in f32 (or wider), as in the JAX
    package."""
    h, w, c = feat.shape
    yy, xx = _sample_coords(boxes * spatial_scale, output_size,
                            sampling_ratio, aligned)
    dt = torch.promote_types(feat.dtype, torch.float32)
    hb, wb, off = (torch.tensor(v, device=feat.device) for v in (h, w, 0))
    return _gather_pool(feat.reshape(h * w, c), yy, xx, hb, wb, off, dt)


def fpn_level_assignment(boxes: torch.Tensor, num_levels: int,
                         canonical_level: int = 2,
                         canonical_size: float = 224.0) -> torch.Tensor:
    """Per-roi pyramid level index in ``[0, num_levels)`` (FPN eq. 1, with
    k0 = 4 at index 2 of [P2, P3, P4, P5])."""
    w = (boxes[:, 2] - boxes[:, 0]).clamp_min(1e-6)
    h = (boxes[:, 3] - boxes[:, 1]).clamp_min(1e-6)
    k = torch.floor(canonical_level
                    + torch.log2(torch.sqrt(w * h) / canonical_size + 1e-8))
    return k.clamp(0, num_levels - 1).long()


@functools.lru_cache(maxsize=32)
def _level_table(hs, ws, offsets, scales, device) -> torch.Tensor:
    """Per-level (H, W, row offset, spatial scale) as one f32 ``[4, L]``
    tensor on ``device``, made once per pyramid shape: a host-to-device copy
    on every call would stall the launch queue. (Offsets stay below 2^24, so
    f32 holds them exactly.)"""
    return torch.tensor([hs, ws, offsets, scales], dtype=torch.float32,
                        device=device)


def multiscale_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                         output_size: Tuple[int, int],
                         spatial_scales: Sequence[float],
                         sampling_ratio: int = 2, aligned: bool = True
                         ) -> torch.Tensor:
    """FPN ROI-align: ``feats`` = [P2..P5] as ``[H_l, W_l, C]``, ``boxes
    [N, 4]`` in image coordinates → ``[N, oh, ow, C]`` in the features'
    dtype. Each roi pools from its assigned level of one flattened
    ``[Σ H_l·W_l, C]`` buffer."""
    c = feats[0].shape[-1]
    dev = boxes.device
    hs = [f.shape[0] for f in feats]
    ws = [f.shape[1] for f in feats]
    offsets: List[int] = [0]
    for h, w in zip(hs[:-1], ws[:-1]):
        offsets.append(offsets[-1] + h * w)
    flat = torch.cat([f.reshape(-1, c) for f in feats], 0)

    levels = fpn_level_assignment(boxes, len(feats))
    table = _level_table(tuple(hs), tuple(ws), tuple(offsets),
                         tuple(spatial_scales), dev)
    h_l, w_l, off = table[0, levels].long(), table[1, levels].long(), table[2, levels].long()
    scale = table[3, levels]
    yy, xx = _sample_coords(boxes * scale[:, None], output_size,
                            sampling_ratio, aligned)

    def per_roi(t):
        return t[:, None, None, None, None]

    return _gather_pool(flat, yy, xx, per_roi(h_l), per_roi(w_l),
                        per_roi(off), flat.dtype)


def stack_roi_align_1ch(maps: torch.Tensor, boxes: torch.Tensor,
                        map_idx: torch.Tensor, output_size: Tuple[int, int],
                        sampling_ratio: int = 2, aligned: bool = True
                        ) -> torch.Tensor:
    """Single-channel ROI-align from a stack of maps: ``maps [O, H, W]``,
    ``boxes [P, 4]`` (image coordinates, spatial scale 1), ``map_idx [P]``
    the map of each roi → ``[P, oh, ow]`` float32 (torchvision
    ``project_masks_on_boxes`` semantics: GT-mask crops without a ``[P, H,
    W]`` copy). Differentiable with respect to ``maps``."""
    o, h, w = maps.shape
    flat = maps.reshape(-1).float()
    yy, xx = _sample_coords(boxes, output_size, sampling_ratio, aligned)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = yy - y0
    wx = xx - x0
    y0i = y0.long()
    x0i = x0.long()
    base = (map_idx.long() * (h * w))[:, None, None, None, None]
    acc = torch.zeros(yy.shape, dtype=torch.float32, device=maps.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yi = y0i + dy
            xi = x0i + dx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            wgt = (wy if dy else 1.0 - wy) * (wx if dx else 1.0 - wx)
            idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            acc = acc + flat[idx] * torch.where(ok, wgt, 0.0)
    return acc.mean(dim=(3, 4))


def stack_roi_align_u8(maps: torch.Tensor, boxes: torch.Tensor,
                       map_idx: torch.Tensor, output_size: Tuple[int, int],
                       sampling_ratio: int = 2, aligned: bool = True
                       ) -> torch.Tensor:
    """``stack_roi_align_1ch`` of integer maps in [0, 255] (GT masks with
    the 255 ignore label), taken as integers → ``[P, oh, ow]`` float32.
    Not differentiable: GT targets need no gradient."""
    ints = maps.detach().clamp(0, 255).to(torch.int32)
    return stack_roi_align_1ch(ints, boxes, map_idx, output_size,
                               sampling_ratio, aligned)
