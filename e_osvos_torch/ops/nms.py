"""Padded fixed-shape non-maximum suppression, port of
``e_osvos_tpu/ops/nms.py``.

Every function returns ``(idx [max_out] int32 with -1 padding, keep
[max_out] bool)``; invalid input slots are masked by ``valid``, never
filtered, so no result depends on a host sync.

  * ``nms``: greedy NMS, the plain twin of the K3 kernel (``ops/cuda_nms.py``)
    on any device;
  * ``batched_nms``: category/level-aware greedy NMS by the coordinate-offset
    trick; the K3 kernel on CUDA tensors, the twin on CPU tensors;
  * ``fast_nms``: one-pass "Fast NMS" (a box is suppressed by ANY valid
    higher-scoring box above the threshold), torch ops over one
    upper-triangular IoU matrix; the RPN's proposal selection.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from e_osvos_torch.ops import cuda_nms
from e_osvos_torch.ops.boxes import box_iou


def _valid(scores: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    return valid.bool()


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, valid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over ``[N, 4]`` xyxy boxes (the kernel's plain twin)."""
    return cuda_nms.greedy_nms_plain(boxes, scores, _valid(scores, valid),
                                     iou_threshold, max_out)


def fast_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             max_out: int, valid: Optional[torch.Tensor] = None,
             ids: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass parallel NMS (YOLACT Fast NMS). Returns indices sorted by
    score (stable: ties by index), then -1 padding."""
    n = boxes.shape[0]
    v = _valid(scores, valid)
    if ids is not None:
        boxes = boxes + ids.to(boxes.dtype)[:, None] * (boxes.max() + 1.0)
    s = torch.where(v, scores, -torch.inf)
    order = torch.sort(-s, stable=True).indices
    b_sorted = boxes[order]
    v_sorted = v[order]
    iou = box_iou(b_sorted, b_sorted)
    # [a, b]: b < a, b valid, overlapping
    earlier = torch.ones((n, n), dtype=torch.bool, device=boxes.device).tril(-1)
    suppressed = ((iou > iou_threshold) & earlier & v_sorted[None, :]).any(1)
    del iou, earlier
    keep_sorted = v_sorted & ~suppressed
    rank = torch.cumsum(keep_sorted, 0) - 1
    take = keep_sorted & (rank < max_out)
    # slot max_out is the "not taken" sink, dropped after the scatter
    slot = torch.where(take, rank, max_out)
    out = torch.full((max_out + 1,), -1, dtype=torch.int32, device=boxes.device)
    out.scatter_(0, slot, order.int())
    out_ok = torch.arange(max_out, device=boxes.device) < take.sum()
    return torch.where(out_ok, out[:max_out], -1), out_ok


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, ids: torch.Tensor,
                iou_threshold: float, max_out: int,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS in which boxes of different ``ids`` never suppress each
    other (torchvision ``batched_nms`` semantics)."""
    if boxes.shape[0] == 0:
        return (torch.full((max_out,), -1, dtype=torch.int32,
                           device=boxes.device),
                torch.zeros((max_out,), dtype=torch.bool, device=boxes.device))
    shifted = boxes + ids.to(boxes.dtype)[:, None] * (boxes.max() + 1.0)
    return cuda_nms.greedy_nms(shifted.float().contiguous(),
                               scores.float().contiguous(),
                               _valid(scores, valid).contiguous(),
                               iou_threshold, max_out)
