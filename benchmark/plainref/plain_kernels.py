"""The plain twins of the port's two CUDA kernels, copied unchanged from
the port (GroupNorm statistics with their group algebra; padded greedy
NMS), so the reference never reaches a kernel."""

from __future__ import annotations

from typing import Tuple

import torch

def check_groups(c: int, g: int) -> None:
    if g < 1 or c % g:
        raise ValueError(f"channels {c} not divisible by groups {g}")


# ---- plain twins --------------------------------------------------------


def _group_stats(s: torch.Tensor, sq: torch.Tensor, g: int, m_per_group: int,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel sums [N, C] → per-group (mean, rstd) [N, G]."""
    n, c = s.shape
    gs = s.view(n, g, c // g).sum(-1)
    gsq = sq.view(n, g, c // g).sum(-1)
    mean = gs / m_per_group
    # clamp: E[x^2]-E[x]^2 can cancel slightly negative in f32
    var = (gsq / m_per_group - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def _expand(t: torch.Tensor, c: int) -> torch.Tensor:
    """[N, G] → [N, C] per-channel broadcast."""
    return t.repeat_interleave(c // t.shape[-1], dim=-1)


def _coefficients(mean, rstd, scale, bias, c):
    a = _expand(rstd, c) * scale.float()[None]
    b = bias.float()[None] - _expand(mean, c) * a
    return a.contiguous(), b.contiguous()


def group_stats_plain(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, num_groups: int, eps: float):
    n, m, c = x.shape
    xf = x.float()
    s, sq = xf.sum(1), (xf * xf).sum(1)
    mean, rstd = _group_stats(s, sq, num_groups, m * (c // num_groups), eps)
    a, b = _coefficients(mean, rstd, scale, bias, c)
    return a, b, mean, rstd


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


