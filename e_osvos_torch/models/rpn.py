"""Region Proposal Network, port of ``e_osvos_tpu/models/rpn.py``.

Anchors over the FPN levels (made on the host in numpy, once per image
size), a shared 3x3 + 1x1 head, per-level top-k, decode, clip and Fast-NMS
to a fixed proposal budget, IoU matching with balanced sampling for the
objectness and box losses, and the eval-time tracking prior (jittered
previous-frame boxes EXTEND or REPLACE the proposals).

Every stage is fixed-shape: filtering is masking, proposal lists are padded
to ``post_nms_top_n`` with a validity mask. The random draws (anchor
sampling, box jitter) are arguments, uniforms in ``[0, 1)``. Ties of every
top-k and sort break by the lowest index, as ``jax.lax.top_k`` and the
stable ``jnp.argsort`` do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from e_osvos_torch.models.resnet import Conv
from e_osvos_torch.ops.boxes import (
    box_iou,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    jitter_boxes,
    remove_small_boxes_mask,
    uniform_to_noise,
)
from e_osvos_torch.ops.nms import batched_nms, fast_nms


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    pre_nms_top_n: int = 1000  # per level
    post_nms_top_n: int = 512
    nms_thresh: float = 0.7
    # one-pass Fast NMS for proposal selection; False: exact greedy NMS
    # (the K3 kernel on the card)
    use_fast_nms: bool = True
    min_size: float = 1e-3
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.3
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5


@functools.lru_cache(maxsize=16)
def generate_anchors(image_hw: Tuple[int, int], cfg: RPNConfig
                     ) -> Tuple[np.ndarray, ...]:
    """Per-level anchor grids ``[H_l·W_l·A, 4]`` xyxy float32 (numpy), one
    size per level × every ratio, centred on the cell corners."""
    h, w = image_hw
    out = []
    for size, stride in zip(cfg.anchor_sizes, cfg.strides):
        gh = (h + stride - 1) // stride
        gw = (w + stride - 1) // stride
        base = []
        for r in cfg.aspect_ratios:
            ah = size * np.sqrt(r)
            aw = size / np.sqrt(r)
            base.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
        base = np.asarray(base, np.float32)  # [A, 4]
        ys = np.arange(gh, dtype=np.float32) * stride
        xs = np.arange(gw, dtype=np.float32) * stride
        cx, cy = np.meshgrid(xs, ys)
        shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + base[None]).reshape(-1, 4).astype(np.float32))
    return tuple(out)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k`` largest along the last axis, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class RPNHead(nn.Module):
    """Shared conv head: 3x3 + ReLU → (objectness [A], deltas [4A]) per
    cell. Returns per-level logits ``[B, H·W·A]`` and deltas
    ``[B, H·W·A, 4]`` in float32, in the anchors' (h, w, a) order."""

    def __init__(self, channels: int = 256, num_anchors: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, use_bias=True,
                         dtype=dtype)
        self.cls_logits = Conv(channels, num_anchors, 1, use_bias=True,
                               dtype=dtype)
        self.bbox_pred = Conv(channels, num_anchors * 4, 1, use_bias=True,
                              dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            logits.append(self.cls_logits(t).float().permute(0, 2, 3, 1)
                          .reshape(b, -1))
            deltas.append(self.bbox_pred(t).float().permute(0, 2, 3, 1)
                          .reshape(b, -1, 4))
        return logits, deltas


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [B, post_nms_top_n, 4]
    scores: torch.Tensor  # [B, post_nms_top_n]
    valid: torch.Tensor  # [B, post_nms_top_n] bool


def select_proposals(cfg: RPNConfig, anchors: Sequence[torch.Tensor],
                     logits: Sequence[torch.Tensor],
                     deltas: Sequence[torch.Tensor],
                     image_hw: Tuple[int, int]) -> Proposals:
    """Top-k per level → decode → clip → level-aware NMS → fixed budget.
    ``logits``/``deltas`` are the head's per-level ``[B, N_l(, 4)]``."""
    all_boxes, all_scores, all_levels, all_valid = [], [], [], []
    for lvl, (anc, lg, dl) in enumerate(zip(anchors, logits, deltas)):
        k = min(cfg.pre_nms_top_n, lg.shape[1])
        scores, idx = topk_stable(lg, k)  # [B, k]
        d = torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4))
        boxes = clip_boxes(decode_boxes(d, anc[idx]), image_hw)
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_levels.append(torch.full((k,), lvl, dtype=torch.int32,
                                     device=lg.device))
        all_valid.append(remove_small_boxes_mask(boxes, cfg.min_size))
    boxes = torch.cat(all_boxes, 1)
    probs = torch.sigmoid(torch.cat(all_scores, 1))
    levels = torch.cat(all_levels)
    valid = torch.cat(all_valid, 1)
    out_boxes, out_scores, out_valid = [], [], []
    for i in range(boxes.shape[0]):
        if cfg.use_fast_nms:
            idx, keep = fast_nms(boxes[i], probs[i], cfg.nms_thresh,
                                 cfg.post_nms_top_n, valid=valid[i],
                                 ids=levels)
        else:
            idx, keep = batched_nms(boxes[i], probs[i], levels,
                                    cfg.nms_thresh, cfg.post_nms_top_n,
                                    valid=valid[i])
        safe = idx.long().clamp_min(0)
        out_boxes.append(torch.where(keep[:, None], boxes[i][safe], 0.0))
        out_scores.append(torch.where(keep, probs[i][safe], 0.0))
        out_valid.append(keep)
    return Proposals(torch.stack(out_boxes), torch.stack(out_scores),
                     torch.stack(out_valid))


class RPNTargets(NamedTuple):
    labels: torch.Tensor  # [N_anchors] 1 fg / 0 bg / -1 ignore
    matched_boxes: torch.Tensor  # [N_anchors, 4] the assigned GT box
    sample_mask: torch.Tensor  # [N_anchors] bool: in the sampled minibatch


def assign_rpn_targets(cfg: RPNConfig, anchors: torch.Tensor,
                       gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                       u_pos: torch.Tensor, u_neg: torch.Tensor
                       ) -> RPNTargets:
    """IoU matching and balanced sampling (torchvision Matcher and
    BalancedPositiveNegativeSampler semantics, fixed shapes): anchors
    ``[N, 4]``, gt ``[M, 4]`` padded with ``gt_valid [M]``; ``u_pos`` and
    ``u_neg`` are ``[N]`` uniforms ranking the positives and negatives."""
    n = anchors.shape[0]
    iou = torch.where(gt_valid[None, :], box_iou(anchors, gt_boxes), -1.0)
    best_iou = iou.amax(1)
    best_gt = iou.argmax(1)  # the first maximum
    labels = torch.where(best_iou >= cfg.fg_iou_thresh, 1,
                         torch.where(best_iou < cfg.bg_iou_thresh, 0, -1))
    # low-quality matches: every GT's best anchor is positive
    per_gt_best = iou.amax(0)  # invalid GT columns are -1 already
    is_best = ((iou >= per_gt_best[None, :] - 1e-6) & gt_valid[None, :]
               & (iou > 0)).any(1)
    labels = torch.where(is_best & gt_valid.any(), 1, labels)
    matched = gt_boxes[best_gt]
    del iou

    num_pos_max = int(cfg.batch_size_per_image * cfg.positive_fraction)

    def sample(mask, count, max_count, u):
        """Random subset of ``mask`` of size min(count, |mask|)."""
        kk = min(max_count, n)
        vals, idx = topk_stable(torch.where(mask, u, -1.0), kk)
        chosen = (vals >= 0.0) & (torch.arange(kk, device=u.device) < count)
        return torch.zeros(n, dtype=torch.bool, device=u.device).scatter(
            0, idx, chosen)

    pos = sample(labels == 1, num_pos_max, num_pos_max, u_pos)
    num_neg = cfg.batch_size_per_image - pos.sum()
    neg = sample(labels == 0, num_neg, cfg.batch_size_per_image, u_neg)
    return RPNTargets(labels, matched, pos | neg)


def smooth_l1(diff: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def rpn_losses(cfg: RPNConfig, anchors: torch.Tensor, logits: torch.Tensor,
               deltas: torch.Tensor, targets: RPNTargets
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(objectness BCE, box smooth-L1) over the sampled anchors, each
    divided by the number sampled."""
    labels = targets.labels
    sm = targets.sample_mask.float()
    lab = labels.clamp(0, 1).float()
    per = (logits.clamp_min(0.0) - logits * lab
           + torch.log1p(torch.exp(-logits.abs())))
    denom = sm.sum().clamp_min(1.0)
    obj_loss = (per * sm).sum() / denom
    pos = (targets.sample_mask & (labels == 1)).float()
    reg_targets = encode_boxes(targets.matched_boxes, anchors)
    box_loss = (smooth_l1(deltas - reg_targets).sum(-1) * pos).sum() / denom
    return obj_loss, box_loss


def augment_proposals_with_targets(proposals: Proposals,
                                   target_boxes: torch.Tensor,
                                   target_valid: torch.Tensor, mode: str,
                                   u_jitter: torch.Tensor,
                                   jitter: float = 0.1) -> Proposals:
    """Eval-time tracking prior: the previous-frame boxes ``[B, M, 4]``,
    tiled over the proposal budget and jittered by ±``jitter`` of their
    size (``u_jitter [B, n, 4]`` uniforms), EXTEND (the second half of the
    proposals) or REPLACE the proposals."""
    if mode is None or mode == "NONE":
        return proposals
    n = proposals.boxes.shape[-2]
    m = target_boxes.shape[-2]
    reps = (n + m - 1) // m
    tiled = target_boxes.repeat(1, reps, 1)[:, :n]
    tiled_valid = target_valid.repeat(1, reps)[:, :n]
    jittered = jitter_boxes(tiled, uniform_to_noise(u_jitter, jitter))
    tiled_scores = tiled_valid.float()
    if mode == "REPLACE":
        return Proposals(jittered, tiled_scores, tiled_valid)
    if mode == "EXTEND":
        first = torch.arange(n, device=tiled.device) < n // 2
        return Proposals(
            torch.where(first[:, None], proposals.boxes, jittered),
            torch.where(first, proposals.scores, tiled_scores),
            torch.where(first, proposals.valid, tiled_valid))
    raise ValueError(f"unknown proposal augmentation mode {mode!r}")
