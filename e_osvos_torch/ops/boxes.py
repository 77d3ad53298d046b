"""Box utilities of the detection path, port of ``e_osvos_tpu/ops/boxes.py``.

Boxes are ``[..., 4]`` xyxy float32 in image pixels. Everything works on
fixed-size padded arrays with a ``valid`` mask: invalid boxes are zeros and
are masked, never filtered.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# standard R-CNN bbox regression weights (dx, dy, dw, dh)
BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
# cap on exp() growth in decode, log(1000/16)
BBOX_XFORM_CLIP = 4.135166556742356


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` → ``[...]`` areas (0 for degenerate boxes)."""
    return ((boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0))


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a ``[N, 4]``, b ``[M, 4]`` → ``[N, M]``."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    del lt, rb, wh
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), 0.0)


def clip_boxes(boxes: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to ``[0, W] x [0, H]``; ``size = (H, W)``."""
    h, w = size
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       -1)


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights=BBOX_REG_WEIGHTS) -> torch.Tensor:
    """R-CNN regression targets taking ``proposals`` to ``reference`` (GT)
    boxes: ``[..., 4]`` xyxy → ``[..., 4]`` (dx, dy, dw, dh)."""
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp_min(1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp_min(1e-6)
    gx = (reference[..., 0] + reference[..., 2]) * 0.5
    gy = (reference[..., 1] + reference[..., 3]) * 0.5
    gw = (reference[..., 2] - reference[..., 0]).clamp_min(1e-6)
    gh = (reference[..., 3] - reference[..., 1]).clamp_min(1e-6)
    return torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)], -1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=BBOX_REG_WEIGHTS) -> torch.Tensor:
    """Apply regression deltas ``[..., 4]`` to boxes ``[..., 4]`` xyxy."""
    wx, wy, ww, wh = weights
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    pw = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    ph = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp_max(BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp_max(BBOX_XFORM_CLIP)
    cx = dx * pw + px
    cy = dy * ph + py
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], -1)


def masks_to_boxes(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tight xyxy boxes of masks ``[N, H, W]`` (any value > 0 is inside) →
    ``(boxes [N, 4] float32, valid [N])``; an empty mask gives a zero box
    and valid False."""
    n, h, w = masks.shape
    m = masks > 0
    any_row = m.any(2)  # [N, H]
    any_col = m.any(1)  # [N, W]
    ys = torch.arange(h, device=masks.device)
    xs = torch.arange(w, device=masks.device)
    big = torch.iinfo(torch.int32).max
    y1 = torch.where(any_row, ys, big).amin(1)
    y2 = torch.where(any_row, ys, -1).amax(1)
    x1 = torch.where(any_col, xs, big).amin(1)
    x2 = torch.where(any_col, xs, -1).amax(1)
    valid = any_row.any(1)
    boxes = torch.stack([x1, y1, x2 + 1, y2 + 1], -1).float()
    return torch.where(valid[:, None], boxes, 0.0), valid


def jitter_boxes(boxes: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Relative jitter of box coordinates: ``noise`` (shaped like the boxes,
    in ``[-rel, rel)``) scaled by the box's width or height."""
    w = (boxes[..., 2] - boxes[..., 0])[..., None]
    h = (boxes[..., 3] - boxes[..., 1])[..., None]
    return boxes + noise * torch.cat([w, h, w, h], -1)


def uniform_to_noise(u: torch.Tensor, rel: float) -> torch.Tensor:
    """Uniforms in ``[0, 1)`` → noise in ``[-rel, rel)``, as
    ``jax.random.uniform(minval=-rel, maxval=rel)`` maps its unit draws
    (bounds and span rounded to float32 first)."""
    lo = float(np.float32(-rel))
    span = float(np.float32(rel) - np.float32(-rel))
    return (u * span + lo).clamp_min(lo)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float
                            ) -> torch.Tensor:
    """Mask of the boxes whose both sides are at least ``min_size``."""
    return (((boxes[..., 2] - boxes[..., 0]) >= min_size)
            & ((boxes[..., 3] - boxes[..., 1]) >= min_size))
