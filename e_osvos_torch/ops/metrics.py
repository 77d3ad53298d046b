"""DAVIS evaluation metrics, port of ``e_osvos_tpu/ops/metrics.py``: J (region
IoU) and F (boundary F-measure) as batched tensor code that runs where its
inputs live, plus the mean/recall/decay statistics on the host in numpy.

Every function takes masks ``[..., H, W]`` and reduces the last two axes, so
one call scores a frame, a sequence or a stack of objects' sequences:
``jaccard`` and ``boundary_f_measure`` on ``[T, H, W]`` are the JAX package's
per-frame ``jaccard_frames`` and ``boundary_f_frames``.

Boundary F: the boundary map is the seg2bmap construction of the davis
package (a pixel that differs from its east, south or south-east neighbour,
zero-padded), and its dilation by a disk is a convolution with the binary
disk (``padding=radius``, the "SAME" of an odd kernel) followed by ``> 0``.
Each output of that convolution is a count of at most (2r+1)^2 (289 at the
radius 8 of 480x854), exact in float32 and TF32, so the comparison gives
the same map on any device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Pixels set in ``mask [..., H, W]``, as float32 (exact below 2^24)."""
    return mask.sum(dim=(-2, -1)).float()


def jaccard(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Region similarity J = |pred ∧ gt| / |pred ∨ gt| of binary masks
    ``[..., H, W]``; 1 where both masks are empty."""
    pred, gt = pred.bool(), gt.bool()
    inter = _count(pred & gt)
    union = _count(pred | gt)
    return torch.where(union == 0, 1.0, inter / union.clamp_min(1.0))


def _boundary_map(mask: torch.Tensor) -> torch.Tensor:
    """Boundary pixels of ``mask [..., H, W]``: those that differ from their
    east, south or south-east neighbour, with zeros beyond the image (a
    foreground pixel on the border is boundary). Returns bool."""
    m = mask.bool()
    e = torch.zeros_like(m)
    e[..., :, :-1] = m[..., :, 1:]
    s = torch.zeros_like(m)
    s[..., :-1, :] = m[..., 1:, :]
    se = torch.zeros_like(m)
    se[..., :-1, :-1] = m[..., 1:, 1:]
    return (m != e) | (m != s) | (m != se)


def _disk_kernel(radius: int) -> np.ndarray:
    """Binary disk structuring element ``[2r+1, 2r+1]`` float32."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return ((yy * yy + xx * xx) <= radius * radius + 1e-9).astype(np.float32)


def _dilate(b: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation of ``b [..., H, W]`` by a disk: a convolution with
    the disk kernel, then ``> 0``. Returns bool. The counts are integers, so
    the comparison is made at 0.5: a convolution algorithm that rounds (an
    FFT) cannot turn a zero count into a hit."""
    if radius <= 0:
        return b.bool()
    lead, (h, w) = b.shape[:-2], b.shape[-2:]
    disk = torch.from_numpy(_disk_kernel(radius)).to(b.device)
    out = F.conv2d(b.reshape(-1, 1, h, w).float(), disk[None, None],
                   padding=radius)
    return (out > 0.5).reshape(lead + (h, w))


def _radius(h: int, w: int, bound_th: float) -> int:
    """Dilation radius: ``bound_th`` pixels when ≥ 1, else that fraction of
    the image diagonal, rounded up."""
    if bound_th >= 1:
        return int(math.ceil(bound_th))
    return int(math.ceil(bound_th * math.sqrt(h * h + w * w)))


def boundary_f_measure(pred: torch.Tensor, gt: torch.Tensor,
                       bound_th: float = 0.008) -> torch.Tensor:
    """Boundary F-measure of binary masks ``[..., H, W]`` (the davis
    package's db_eval_boundary): 1 where neither mask has a boundary."""
    radius = _radius(pred.shape[-2], pred.shape[-1], bound_th)
    fg_b = _boundary_map(pred)
    gt_b = _boundary_map(gt)
    fg_dil = _dilate(fg_b, radius)
    gt_dil = _dilate(gt_b, radius)

    n_fg = _count(fg_b)
    n_gt = _count(gt_b)
    precision = torch.where(n_fg > 0, _count(fg_b & gt_dil)
                            / n_fg.clamp_min(1.0), 0.0)
    recall = torch.where(n_gt > 0, _count(gt_b & fg_dil)
                         / n_gt.clamp_min(1.0), 0.0)
    f = torch.where(precision + recall > 0,
                    2.0 * precision * recall
                    / (precision + recall).clamp_min(1e-12), 0.0)
    return torch.where((n_fg == 0) & (n_gt == 0), 1.0, f)


def sequence_scores(merged: torch.Tensor, gt_raw: torch.Tensor,
                    ids: torch.Tensor):
    """Per-frame, per-object J and F of an argmax-merged label map, on the
    device that holds it.

    merged  ``[T, H, W]`` int: 0 = background, gi+1 = object group gi
    gt_raw  ``[T, H, W]`` int: raw GT id maps, 255 = ignore; frames without
            annotation are 255-filled and left out of the means by the caller
    ids     ``[O, M]`` int32: each group's object ids, padded with -1

    Returns ``(J [O, T], F [O, T])`` float32: pred = (merged == gi+1) &
    valid, gt = (id match) & valid, valid = gt_raw != 255. With no group,
    both are ``[0, T]``."""
    n_groups = ids.shape[0]
    if n_groups == 0:
        empty = torch.zeros((0, merged.shape[0]), dtype=torch.float32,
                            device=merged.device)
        return empty, empty.clone()
    valid = gt_raw != 255
    groups = torch.arange(1, n_groups + 1, dtype=torch.int32,
                          device=merged.device)
    pred = (merged[None] == groups[:, None, None, None]) & valid
    # tensor against tensor: a uint8 map is promoted to int32, so the -1
    # padding matches no pixel (a Python -1 would wrap to 255)
    ids = ids.to(device=gt_raw.device, dtype=torch.int32)
    gt_bin = (gt_raw[None, None] == ids[:, :, None, None, None]).any(1)
    gt_bin &= valid
    return jaccard(pred, gt_bin), boundary_f_measure(pred, gt_bin)


def db_statistics(per_frame: np.ndarray) -> Dict[str, float]:
    """Mean, recall (share of frames above 0.5) and decay (mean of the first
    of 4 equal frame bins less that of the last) of a per-frame metric, as
    the davis package's db_statistics."""
    per_frame = np.asarray(per_frame, dtype=np.float64)
    if per_frame.size == 0:
        return {"mean": float("nan"), "recall": float("nan"),
                "decay": float("nan")}
    mean = float(np.nanmean(per_frame))
    recall = float(np.nanmean(per_frame > 0.5))
    n = len(per_frame)
    ids = (np.round(np.linspace(1, n, 5) + 1e-10) - 1).astype(int)
    bins = [per_frame[ids[i]:ids[i + 1] + 1] for i in range(4)]
    decay = float(np.nanmean(bins[0]) - np.nanmean(bins[3]))
    return {"mean": mean, "recall": recall, "decay": decay}


def evaluate_sequence(pred_masks: np.ndarray, gt_masks: np.ndarray,
                      exclude_first_last: bool = True
                      ) -> Dict[str, Dict[str, float]]:
    """J/F statistics of one (sequence, object) pair of binary ``[T, H, W]``
    host masks. The DAVIS protocol leaves the first (given) and the last
    frame out of the statistics; ``exclude_first_last=False`` keeps them."""
    preds = torch.from_numpy(np.asarray(pred_masks))
    gts = torch.from_numpy(np.asarray(gt_masks))
    j = jaccard(preds, gts).numpy()
    f = boundary_f_measure(preds, gts).numpy()
    if exclude_first_last and len(j) > 2:
        j_stat, f_stat = j[1:-1], f[1:-1]
    else:
        j_stat, f_stat = j, f
    return {
        "J": db_statistics(j_stat),
        "F": db_statistics(f_stat),
        "J_per_frame": j.tolist(),
        "F_per_frame": f.tolist(),
    }
