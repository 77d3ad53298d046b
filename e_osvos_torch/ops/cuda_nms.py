"""Hand-written CUDA kernel of padded greedy NMS (K3), and its plain twin.

``greedy_nms(boxes, scores, valid, iou_threshold, max_out)`` over boxes
``[N, 4]`` (or ``[B, N, 4]``) xyxy f32, scores ``[N]`` f32 and valid ``[N]``
bool returns ``(idx [max_out] int32, -1 padded; keep [max_out] bool)``: the
semantics of the Pallas ``_nms_kernel`` in ``e_osvos_tpu/ops/pallas_nms.py``.
The source note in ``csrc/nms.cu`` gives the kernel's bound and design.

Given CPU tensors the wrapper computes the plain twin ``greedy_nms_plain``
(max_out rounds of arg-max with lowest-index ties, one-vs-all IoU, suppress);
given CUDA tensors it launches the kernel or raises. ``greedy_nms.launches``
counts the kernel launches (one per call on the card), never the twin.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from e_osvos_torch.ops import cuda_build

NAME = "nms"  # csrc/nms.cu
# the IoU must round as the twin's separate multiply and add do
NVCC_EXTRA = ("-fmad=false",)

_lib: Optional[ctypes.CDLL] = None  # loaded at first launch


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load(NAME, NVCC_EXTRA)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nms_max_boxes.argtypes = []
        lib.nms_max_boxes.restype = i
        lib.nms_greedy.argtypes = [p, p, p, i, i, ctypes.c_float, i, p, p, p]
        lib.nms_greedy.restype = i
        _lib = lib
    return _lib


def iou_one_vs_all(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one xyxy box ``[..., 4]`` against ``[..., N, 4]``, with the
    TPU kernel's guard: ``union > 0 ? inter / max(union, 1e-9) : 0``."""
    box = box[..., None, :]
    iw = (torch.minimum(box[..., 2], boxes[..., 2])
          - torch.maximum(box[..., 0], boxes[..., 0])).clamp_min(0.0)
    ih = (torch.minimum(box[..., 3], boxes[..., 3])
          - torch.maximum(box[..., 1], boxes[..., 1])).clamp_min(0.0)
    inter = iw * ih
    area_w = ((box[..., 2] - box[..., 0]).clamp_min(0.0)
              * (box[..., 3] - box[..., 1]).clamp_min(0.0))
    area = ((boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0))
    union = area + area_w - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), 0.0)


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float, max_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin, over ``[..., N]`` with no host sync."""
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    lane = torch.arange(n, device=scores.device)
    alive = valid.bool() & (scores > -torch.inf)
    idx = torch.full(lead + (max_out,), -1, dtype=torch.int32,
                     device=scores.device)
    keep = torch.zeros(lead + (max_out,), dtype=torch.bool,
                       device=scores.device)
    for r in range(max_out):
        masked = torch.where(alive, scores, -torch.inf)
        best_s = masked.amax(-1, keepdim=True)
        ok = best_s > -torch.inf
        best = torch.where(alive & (masked >= best_s), lane, n).amin(
            -1, keepdim=True)
        best_box = torch.gather(
            boxes, -2, best.clamp_max(n - 1)[..., None].expand(
                lead + (1, 4)))[..., 0, :]
        iou = iou_one_vs_all(best_box, boxes)
        alive = alive & (iou <= iou_threshold) & (lane != best) & ok
        idx[..., r] = torch.where(ok[..., 0], best[..., 0].int(), -1)
        keep[..., r] = ok[..., 0]
    return idx, keep


def _check(boxes, scores, valid, max_out: int) -> Tuple[int, int]:
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("boxes and scores must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    single = scores.dim() == 1
    b = 1 if single else scores.shape[0]
    n = scores.shape[-1]
    want = ((n, 4), (n,)) if single else ((b, n, 4), (b, n))
    if (tuple(boxes.shape), tuple(scores.shape)) != want or valid.shape != scores.shape:
        raise ValueError(f"expected boxes {want[0]}, scores/valid {want[1]}; "
                         f"got {tuple(boxes.shape)}, {tuple(scores.shape)}, "
                         f"{tuple(valid.shape)}")
    for t in (boxes, scores, valid):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if n < 1 or max_out < 1:
        raise ValueError(f"need at least one box and one output, got N={n}, "
                         f"max_out={max_out}")
    return b, n


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: padded greedy NMS of ``N ≤ 16384`` boxes (per image) →
    ``(idx [.., max_out] int32, keep [.., max_out] bool)``."""
    if cuda_build.is_cpu(boxes, scores, valid):
        return greedy_nms_plain(boxes, scores, valid, iou_threshold, max_out)
    b, n = _check(boxes, scores, valid, max_out)
    lib = _load()
    if n > lib.nms_max_boxes():
        raise ValueError(f"N={n} exceeds the kernel's {lib.nms_max_boxes()} "
                         "boxes an image")
    lead = scores.shape[:-1]
    idx = torch.empty(lead + (max_out,), dtype=torch.int32, device=boxes.device)
    keep = torch.empty(lead + (max_out,), dtype=torch.bool, device=boxes.device)
    err = lib.nms_greedy(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                         b, n, float(iou_threshold), max_out, idx.data_ptr(),
                         keep.data_ptr(), cuda_build.stream())
    cuda_build.raise_on(err, "greedy_nms")
    greedy_nms.launches += 1
    return idx, keep


greedy_nms.launches = 0


def reset_launch_counts() -> None:
    greedy_nms.launches = 0


def launch_counts():
    return {"greedy_nms": greedy_nms.launches}
