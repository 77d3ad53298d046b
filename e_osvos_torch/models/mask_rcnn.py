"""Mask R-CNN for one-shot VOS, port of ``e_osvos_tpu/models/mask_rcnn.py``.

ResNet FPN backbone (GroupNorm-32 by default), RPN with the eval-time
tracking prior, box head (multi-scale ROI-align 7x7 → 2 FC → class logits
and per-class deltas), mask head (14x14 → 4 convs → 2x deconv → per-class
28x28 logits), targets synthesised from the GT masks inside the forward, and
the fixed-size detection output (score threshold, greedy NMS through the K3
kernel, top ``detections_per_img``).

Public layouts are the JAX ones: images ``[B, H, W, 3]`` (normalized), GT
masks ``[B, O, H, W]`` in {0, 1, 255}, boxes xyxy float32, ``Detections``
fields as in the JAX package. Inside, feature maps are NCHW in
``torch.channels_last``; ROI features are ``[N, h, w, C]``, and ``fc6``
flattens them in (h, w, c) order, the order of the flax kernel's rows.

The random draws are arguments, uniforms in ``[0, 1)`` (``TrainDraws`` for
training; ``[B, post_nms_top_n, 4]`` jitter uniforms for the tracking
prior), so the caller owns the generator and the tests can feed the JAX
package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from e_osvos_torch.models.deeplab import init_weights
from e_osvos_torch.models.fpn import FPN
from e_osvos_torch.models.resnet import (
    STAGE_FILTERS, Conv, ConvTranspose, Dense, ResNet,
)
from e_osvos_torch.models.rpn import (
    Proposals,
    RPNConfig,
    RPNHead,
    assign_rpn_targets,
    augment_proposals_with_targets,
    generate_anchors,
    rpn_losses,
    select_proposals,
    smooth_l1,
)
from e_osvos_torch.ops import losses as loss_ops
from e_osvos_torch.ops.boxes import (
    box_iou,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    masks_to_boxes,
)
from e_osvos_torch.ops.nms import batched_nms
from e_osvos_torch.ops.roi_align import (
    multiscale_roi_align,
    stack_roi_align_u8,
)
from e_osvos_torch.utils.device import resolve_device

# FPN level spatial scales for P2..P5 (the ROI heads never see P6)
ROI_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
LOSS_NAMES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
              "loss_box_reg", "loss_mask")


@dataclasses.dataclass(frozen=True)
class RoIConfig:
    num_classes: int = 2  # background + object (VOS is class-agnostic)
    box_roi_size: int = 7
    mask_roi_size: int = 14
    mask_out_size: int = 28
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.5
    batch_size_per_image: int = 256
    positive_fraction: float = 0.25
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 4
    mask_loss: str = "lovasz"  # or "bce"


class TrainDraws(NamedTuple):
    """Uniforms in [0, 1) of one training forward of B images: anchor
    sampling ``[B, N_anchors]`` (positives, negatives) and box-head
    sampling ``[B, post_nms_top_n + O]`` (positives, negatives)."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    box_pos: torch.Tensor
    box_neg: torch.Tensor

    def to(self, device) -> "TrainDraws":
        return TrainDraws(*(t.to(device, non_blocking=True) for t in self))

    def select(self, i: int) -> "TrainDraws":
        """The draws of step ``i`` (index along the leading axis)."""
        return TrainDraws(*(t[i] for t in self))


class BoxHead(nn.Module):
    """7x7x256 ROI features → 2x FC-1024 → (class logits, per-class
    deltas), both float32."""

    def __init__(self, in_features: int, num_classes: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.fc6 = Dense(in_features, 1024, dtype)
        self.fc7 = Dense(1024, 1024, dtype)
        self.cls_score = Dense(1024, num_classes, dtype)
        self.bbox_pred = Dense(1024, num_classes * 4, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n = x.shape[0]
        x = F.relu(self.fc6(x.reshape(n, -1)))  # (h, w, c) order
        x = F.relu(self.fc7(x))
        return (self.cls_score(x).float(),
                self.bbox_pred(x).float().reshape(n, self.num_classes, 4))


class MaskHead(nn.Module):
    """14x14x256 ROI features ``[N, 14, 14, C]`` → 4 convs → 2x deconv →
    per-class 28x28 logits ``[N, 28, 28, classes]`` float32."""

    def __init__(self, channels: int = 256, num_classes: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}",
                            Conv(channels, 256, 3, padding=1, use_bias=True,
                                 dtype=dtype))
            channels = 256
        self.deconv = ConvTranspose(256, 256, 2, dtype)
        self.mask_logits = Conv(256, num_classes, 1, use_bias=True,
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC → channels_last NCHW view
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.mask_logits(x).permute(0, 2, 3, 1).float()


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, K, 4]
    scores: torch.Tensor  # [B, K]
    classes: torch.Tensor  # [B, K] int32
    masks: torch.Tensor  # [B, K, H, W] probabilities pasted to image size
    valid: torch.Tensor  # [B, K] bool


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor,
                image_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear paste of masks ``[K, m, m]`` into their boxes ``[K, 4]``
    on ``[H, W]`` canvases (torchvision ``paste_masks_in_image`` semantics
    as one inverse gather) → ``[K, H, W]``."""
    h, w = image_hw
    k, m = masks.shape[0], masks.shape[1]
    dev = masks.device
    x1, y1, x2, y2 = (boxes[:, i, None] for i in range(4))
    bw = (x2 - x1).clamp_min(1e-3)
    bh = (y2 - y1).clamp_min(1e-3)
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 - y1) / bh * m - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - x1) / bw * m - 0.5
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None]
    wx = (xs - x0)[:, None, :]
    y0 = y0.long()
    x0 = x0.long()
    kk = torch.arange(k, device=dev)[:, None, None]

    def g(yi, xi):
        ok = (((yi >= 0) & (yi < m))[:, :, None]
              & ((xi >= 0) & (xi < m))[:, None, :])
        v = masks[kk, yi.clamp(0, m - 1)[:, :, None], xi.clamp(0, m - 1)[:, None, :]]
        return torch.where(ok, v, 0.0)

    return (g(y0, x0) * (1 - wy) * (1 - wx)
            + g(y0, x0 + 1) * (1 - wy) * wx
            + g(y0 + 1, x0) * wy * (1 - wx)
            + g(y0 + 1, x0 + 1) * wy * wx)


def _sample_fixed(mask: torch.Tensor, count: int, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of a random fixed-size subset of ``mask`` ranked by the
    uniforms ``u``, repeating eligible slots when fewer than ``count``;
    returns (indices, validity)."""
    n = mask.shape[0]
    order = torch.sort(torch.where(mask, u, 2.0), stable=True).indices
    avail = mask.sum()
    ar = torch.arange(count, device=mask.device)
    take = ar < avail
    wrapped = order[ar % avail.clamp_min(1)]
    idx = torch.where(take, order[ar % max(n, 1)], wrapped)
    return idx, take | (avail > 0)


class MaskRCNN(nn.Module):
    """The detector.

    training: ``model(images, gt_masks, gt_valid, train=True,
    draws=TrainDraws(...), box_coord_perm=None)`` → (total loss, loss
    dict); ``box_coord_perm`` (``[4]`` long) permutes the box-regression
    targets' coordinates (the meta-tasks' ``random_box_coord_perm``);
    inference: ``model(images, prev_boxes=..., prev_valid=...,
    proposal_aug_mode="EXTEND", draws=u_jitter)`` → ``Detections``.
    """

    def __init__(self, arch: str = "resnet50", backbone_norm: str = "group",
                 dtype: torch.dtype = torch.float32,
                 rpn: RPNConfig = RPNConfig(), roi: RoIConfig = RoIConfig(),
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.rpn = rpn
        self.roi = roi
        self.backbone = ResNet(arch, backbone_norm, (False, False, False),
                               dtype)
        self.fpn = FPN([f * 4 for f in STAGE_FILTERS[arch]], 256, dtype)
        self.rpn_head = RPNHead(256, len(rpn.aspect_ratios), dtype)
        self.box_head = BoxHead(256 * roi.box_roi_size ** 2, roi.num_classes,
                                dtype)
        self.mask_head = MaskHead(256, roi.num_classes, dtype)
        self._anchors: Dict[Tuple, List[torch.Tensor]] = {}
        init_weights(self, seed)
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)

    def anchors(self, image_hw: Tuple[int, int], device) -> List[torch.Tensor]:
        """Per-level anchors on ``device``, copied there once per size."""
        key = (tuple(image_hw), str(device))
        if key not in self._anchors:
            self._anchors[key] = [torch.from_numpy(a).to(device) for a in
                                  generate_anchors(tuple(image_hw), self.rpn)]
        return self._anchors[key]

    def draw_shapes(self, image_hw: Tuple[int, int], batch: int,
                    num_objects: int = 1, train: bool = True
                    ) -> List[Tuple[int, ...]]:
        """Shapes of the uniforms one forward consumes: the four fields of
        ``TrainDraws``, or the one jitter tensor of the tracking prior."""
        if not train:
            return [(batch, self.rpn.post_nms_top_n, 4)]
        n = sum(a.shape[0] for a in generate_anchors(tuple(image_hw),
                                                     self.rpn))
        p = self.rpn.post_nms_top_n + num_objects
        return [(batch, n), (batch, n), (batch, p), (batch, p)]

    def forward(self, images: torch.Tensor,
                gt_masks: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None, train: bool = False,
                prev_boxes: Optional[torch.Tensor] = None,
                prev_valid: Optional[torch.Tensor] = None,
                proposal_aug_mode: Optional[str] = None, draws=None,
                box_coord_perm: Optional[torch.Tensor] = None):
        h, w = images.shape[1], images.shape[2]
        feats = self.backbone(images.permute(0, 3, 1, 2))
        pyramid = self.fpn(feats)  # [P2..P6], NCHW channels_last
        logits, deltas = self.rpn_head(pyramid)
        anchors = self.anchors((h, w), images.device)
        proposals = select_proposals(self.rpn, anchors,
                                     [lg.detach() for lg in logits],
                                     [d.detach() for d in deltas], (h, w))
        # per-image [H_l, W_l, C] views of P2..P5
        roi_feats = [[p[i].permute(1, 2, 0) for p in pyramid[:4]]
                     for i in range(images.shape[0])]
        if train:
            return self._forward_train(draws, torch.cat(anchors), logits,
                                       deltas, proposals, roi_feats,
                                       gt_masks, gt_valid, box_coord_perm)
        if proposal_aug_mode and prev_boxes is not None:
            proposals = augment_proposals_with_targets(
                proposals, prev_boxes, prev_valid, proposal_aug_mode, draws)
        return self._forward_eval((h, w), proposals, roi_feats)

    # ---- training --------------------------------------------------------

    def _forward_train(self, draws: TrainDraws, all_anchors, rpn_logits,
                       rpn_deltas, proposals: Proposals, roi_feats,
                       gt_masks, gt_valid, box_coord_perm=None):
        cfg = self.roi
        lg_all = torch.cat(rpn_logits, 1)  # [B, N]
        dl_all = torch.cat(rpn_deltas, 1)  # [B, N, 4]
        num_pos = int(cfg.batch_size_per_image * cfg.positive_fraction)
        per_image = []
        for i in range(gt_masks.shape[0]):
            masks = gt_masks[i]
            feats = roi_feats[i]
            gt_boxes, box_ok = masks_to_boxes(masks)
            gt_ok = gt_valid[i] & box_ok

            tgt = assign_rpn_targets(self.rpn, all_anchors, gt_boxes, gt_ok,
                                     draws.rpn_pos[i], draws.rpn_neg[i])
            obj_l, rpnbox_l = rpn_losses(self.rpn, all_anchors, lg_all[i],
                                         dl_all[i], tgt)

            # the GT boxes join the proposals (torchvision behaviour)
            boxes = torch.cat([proposals.boxes[i], gt_boxes], 0)
            valid = torch.cat([proposals.valid[i], gt_ok], 0)
            iou = torch.where(gt_ok[None, :], box_iou(boxes, gt_boxes), -1.0)
            best_gt = iou.argmax(1)
            best_iou = iou.amax(1)
            is_fg = (best_iou >= cfg.fg_iou_thresh) & valid
            is_bg = (best_iou < cfg.bg_iou_thresh) & valid

            pos_idx, pos_ok = _sample_fixed(is_fg, num_pos, draws.box_pos[i])
            neg_idx, neg_ok = _sample_fixed(
                is_bg, cfg.batch_size_per_image - num_pos, draws.box_neg[i])
            pos_ok = pos_ok & is_fg[pos_idx]
            neg_ok = neg_ok & is_bg[neg_idx]
            samp_idx = torch.cat([pos_idx, neg_idx])
            samp_ok = torch.cat([pos_ok, neg_ok])
            samp_boxes = boxes[samp_idx]
            samp_gt = best_gt[samp_idx]
            is_pos_slot = torch.arange(samp_idx.shape[0],
                                       device=samp_idx.device) < num_pos
            samp_label = is_pos_slot.long() * samp_ok.long()
            n_ok = samp_ok.float().sum().clamp_min(1.0)

            box_feats = multiscale_roi_align(
                feats, samp_boxes, (cfg.box_roi_size, cfg.box_roi_size),
                ROI_SCALES)
            cls_logits, box_deltas = self.box_head(box_feats)
            logp = F.log_softmax(cls_logits, dim=-1)
            cls_l = -(logp.gather(1, samp_label[:, None])[:, 0]
                      * samp_ok).sum() / n_ok

            reg_t = encode_boxes(gt_boxes[samp_gt], samp_boxes)
            if box_coord_perm is not None:
                reg_t = reg_t[:, box_coord_perm]
            posm = (samp_label == 1) & samp_ok
            breg_l = (smooth_l1(box_deltas[:, 1] - reg_t).sum(-1)
                      * posm).sum() / n_ok

            m_boxes = samp_boxes[:num_pos]
            m_ok = posm[:num_pos]
            m_feats = multiscale_roi_align(
                feats, m_boxes, (cfg.mask_roi_size, cfg.mask_roi_size),
                ROI_SCALES)
            m_logits = self.mask_head(m_feats)[..., 1]  # class-1 channel
            crops = stack_roi_align_u8(masks, m_boxes, samp_gt[:num_pos],
                                       (cfg.mask_out_size, cfg.mask_out_size))
            ignore = crops > 200.0  # the 255 label, pooled
            tgt_bin = ((crops >= 0.5) & ~ignore).float()
            valid_px = ~ignore & m_ok[:, None, None]
            if cfg.mask_loss.lower() == "lovasz":
                mask_l = loss_ops.lovasz_hinge(m_logits, tgt_bin, valid_px,
                                               per_image=True)
            else:
                mask_l = loss_ops.cross_entropy_loss(m_logits, tgt_bin,
                                                     valid_px)
            per_image.append((obj_l, rpnbox_l, cls_l, breg_l, mask_l))
        loss_dict = {name: torch.stack(ls).mean()
                     for name, ls in zip(LOSS_NAMES, zip(*per_image))}
        total = sum(loss_dict.values())
        return total, loss_dict

    # ---- inference -------------------------------------------------------

    def _forward_eval(self, image_hw, proposals: Proposals, roi_feats
                      ) -> Detections:
        cfg = self.roi
        h, w = image_hw
        outs = []
        for i, feats in enumerate(roi_feats):
            p_boxes, p_valid = proposals.boxes[i], proposals.valid[i]
            box_feats = multiscale_roi_align(
                feats, p_boxes, (cfg.box_roi_size, cfg.box_roi_size),
                ROI_SCALES)
            cls_logits, box_deltas = self.box_head(box_feats)
            probs = F.softmax(cls_logits, dim=-1)  # [P, C]
            n, c = probs.shape
            # (roi, class) pairs of the foreground classes, flattened
            boxes_f = clip_boxes(decode_boxes(
                box_deltas[:, 1:], p_boxes[:, None].expand(n, c - 1, 4)
            ).reshape(-1, 4), (h, w))
            scores_f = probs[:, 1:].reshape(-1)
            classes_f = torch.arange(1, c, device=probs.device).repeat(n)
            valid_f = (p_valid[:, None].expand(n, c - 1).reshape(-1)
                       & (scores_f > cfg.score_thresh))
            idx, keep = batched_nms(boxes_f, scores_f, classes_f,
                                    cfg.nms_thresh, cfg.detections_per_img,
                                    valid=valid_f)
            safe = idx.long().clamp_min(0)
            det_boxes = torch.where(keep[:, None], boxes_f[safe], 0.0)
            det_scores = torch.where(keep, scores_f[safe], 0.0)
            det_classes = torch.where(keep, classes_f[safe], 0)

            m_feats = multiscale_roi_align(
                feats, det_boxes, (cfg.mask_roi_size, cfg.mask_roi_size),
                ROI_SCALES)
            m_logits = self.mask_head(m_feats)  # [K, 2m, 2m, C]
            sel = m_logits.gather(
                3, det_classes[:, None, None, None].expand(
                    -1, m_logits.shape[1], m_logits.shape[2], 1))[..., 0]
            pasted = paste_masks(torch.sigmoid(sel), det_boxes, (h, w))
            pasted = pasted * keep[:, None, None]
            outs.append((det_boxes, det_scores, det_classes.int(), pasted,
                         keep))
        return Detections(*(torch.stack(t) for t in zip(*outs)))
