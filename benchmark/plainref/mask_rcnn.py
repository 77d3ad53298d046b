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

from plainref.fpn import FPN
from plainref.resnet import (
    STAGE_FILTERS, Conv, ConvTranspose, Dense, ResNet,
)
from plainref.rpn import (
    Proposals,
    RPNConfig,
    RPNHead,
    assign_rpn_targets,
    augment_proposals_with_targets,
    generate_anchors,
    rpn_losses,
    select_proposals,
    smooth_l1,
    unfold_objects,
)
from plainref import losses as loss_ops
from plainref.boxes import (
    box_iou,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    masks_to_boxes,
)
from plainref.nms import batched_nms
from plainref.roi_align import (
    multiscale_roi_align,
    stack_roi_align_u8,
)
from plainref.device import resolve_device

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
    """7x7x256 ROI features ``[N, 7, 7, C]`` → 2x FC-1024 → (class logits
    ``[N, classes]``, per-class deltas ``[N, classes, 4]``), both float32.
    In an object-stacked model (``objects`` > 1) the features are
    ``[O, N, 7, 7, C]``, object o's rows through object o's weights, and
    the outputs gain the leading O."""

    objects = 1

    def __init__(self, in_features: int, num_classes: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.fc6 = Dense(in_features, 1024, dtype)
        self.fc7 = Dense(1024, 1024, dtype)
        self.cls_score = Dense(1024, num_classes, dtype)
        self.bbox_pred = Dense(1024, num_classes * 4, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lead = tuple(x.shape[:-3])
        x = x.reshape(lead + (-1,))  # (h, w, c) order
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        return (self.cls_score(x).float(),
                self.bbox_pred(x).float().reshape(lead + (self.num_classes,
                                                          4)))


class MaskHead(nn.Module):
    """14x14x256 ROI features ``[N, 14, 14, C]`` → 4 convs → 2x deconv →
    per-class 28x28 logits ``[N, 28, 28, classes]`` float32. In an
    object-stacked model (``objects`` > 1) the features are ``[O, N, 14,
    14, C]`` and run as one grouped stack, object o in channel block o;
    the logits gain the leading O."""

    objects = 1

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
        o = self.objects
        if o > 1:  # [O, N, h, w, C] → [N, h, w, O·C]
            _, n, h, w, c = x.shape
            x = x.permute(1, 2, 3, 0, 4).reshape(n, h, w, o * c)
        x = x.permute(0, 3, 1, 2)  # NHWC → channels_last NCHW view
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        x = self.mask_logits(x).permute(0, 2, 3, 1).float()
        if o > 1:
            n, h, w, oc = x.shape
            x = x.reshape(n, h, w, o, oc // o).permute(3, 0, 1, 2, 4)
        return x


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

    Object-stacked (``objects`` = O > 1, ``models/stacked.py``): the trunk,
    FPN and RPN head run on channels folded object by object, images
    ``[B, H, W, 3]`` shared or ``[B, H, W, O·3]`` (object o's images in
    channel block o); the RPN unfolds them into O·B images (image o·B + b,
    ``rpn.unfold_objects``), over which the proposals, targets and RoI
    pooling run as over any batch; the heads run each object's RoIs
    through its own weights. Every per-object argument gains a leading O
    (``gt_masks [O, B, M, H, W]``, ``gt_valid``, the draws' fields,
    ``prev_boxes``, ``prev_valid``, the jitter uniforms), and so does
    every output: the total ``[O]``, each loss ``[O]`` (a mean over that
    object's images), the ``Detections`` fields.
    """

    objects = 1

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
        # the benchmark loads every weight; no init of its own
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

    def _images(self, x: Optional[torch.Tensor]):
        """A per-object argument ``[O, B, ...]`` as O·B images."""
        if x is None or self.objects == 1:
            return x
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def _objects(self, x: torch.Tensor) -> torch.Tensor:
        """A per-image result ``[O·B, ...]`` as ``[O, B, ...]``."""
        if self.objects == 1:
            return x
        return x.reshape((self.objects, -1) + tuple(x.shape[1:]))

    def _head(self, head: nn.Module, rois: torch.Tensor):
        """``head`` over the RoI features ``[O·B, R, h, w, C]``, each
        object's rows through its own weights → outputs ``[O·B, R, ...]``."""
        e, r = rois.shape[:2]
        lead = (-1,) if self.objects == 1 else (self.objects, -1)
        out = head(rois.reshape(lead + tuple(rois.shape[2:])))
        return tuple(t.reshape((e, r) + tuple(t.shape[len(lead):]))
                     for t in (out if isinstance(out, tuple) else (out,)))

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
        # per-image [H_l, W_l, C] maps of P2..P5, one copy a level when the
        # objects' channels unfold
        roi_feats = [unfold_objects(p, self.objects) for p in pyramid[:4]]
        if train:
            if draws is not None:
                draws = TrainDraws(*(self._images(t) for t in draws))
            return self._forward_train(
                draws, torch.cat(anchors), logits, deltas, proposals,
                roi_feats, self._images(gt_masks), self._images(gt_valid),
                box_coord_perm)
        if proposal_aug_mode and prev_boxes is not None:
            proposals = augment_proposals_with_targets(
                proposals, self._images(prev_boxes),
                self._images(prev_valid), proposal_aug_mode,
                self._images(draws))
        det = self._forward_eval((h, w), proposals, roi_feats)
        return Detections(*(self._objects(t) for t in det))

    # ---- training --------------------------------------------------------

    def _forward_train(self, draws: TrainDraws, all_anchors, rpn_logits,
                       rpn_deltas, proposals: Proposals, roi_feats,
                       gt_masks, gt_valid, box_coord_perm=None):
        """The losses of images ``[E, ...]`` (E = O·B): each image's
        targets and samples, the heads over every image's RoIs at once,
        then each image's losses; each loss is the mean over an object's
        images."""
        cfg = self.roi
        lg_all = torch.cat(rpn_logits, 1)  # [E, N]
        dl_all = torch.cat(rpn_deltas, 1)  # [E, N, 4]
        num_pos = int(cfg.batch_size_per_image * cfg.positive_fraction)
        rpn_l, samples = [], []
        for i in range(gt_masks.shape[0]):
            masks = gt_masks[i]
            gt_boxes, box_ok = masks_to_boxes(masks)
            gt_ok = gt_valid[i] & box_ok

            tgt = assign_rpn_targets(self.rpn, all_anchors, gt_boxes, gt_ok,
                                     draws.rpn_pos[i], draws.rpn_neg[i])
            rpn_l.append(rpn_losses(self.rpn, all_anchors, lg_all[i],
                                    dl_all[i], tgt))

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

            reg_t = encode_boxes(gt_boxes[samp_gt], samp_boxes)
            if box_coord_perm is not None:
                reg_t = reg_t[:, box_coord_perm]
            posm = (samp_label == 1) & samp_ok
            crops = stack_roi_align_u8(masks, samp_boxes[:num_pos],
                                       samp_gt[:num_pos],
                                       (cfg.mask_out_size, cfg.mask_out_size))
            samples.append((samp_boxes, samp_label, samp_ok, reg_t, posm,
                            crops))

        samp_boxes = torch.stack([smp[0] for smp in samples])  # [E, R, 4]
        cls_logits, box_deltas = self._head(
            self.box_head, multiscale_roi_align(
                roi_feats, samp_boxes, (cfg.box_roi_size, cfg.box_roi_size),
                ROI_SCALES))
        (m_logits,) = self._head(
            self.mask_head, multiscale_roi_align(
                roi_feats, samp_boxes[:, :num_pos].contiguous(),
                (cfg.mask_roi_size, cfg.mask_roi_size), ROI_SCALES))

        per_image = []
        for i, (_, samp_label, samp_ok, reg_t, posm, crops) in enumerate(
                samples):
            n_ok = samp_ok.float().sum().clamp_min(1.0)
            logp = F.log_softmax(cls_logits[i], dim=-1)
            cls_l = -(logp.gather(1, samp_label[:, None])[:, 0]
                      * samp_ok).sum() / n_ok
            breg_l = (smooth_l1(box_deltas[i][:, 1] - reg_t).sum(-1)
                      * posm).sum() / n_ok

            ignore = crops > 200.0  # the 255 label, pooled
            tgt_bin = ((crops >= 0.5) & ~ignore).float()
            valid_px = ~ignore & posm[:num_pos, None, None]
            logits_1 = m_logits[i][..., 1]  # class-1 channel
            if cfg.mask_loss.lower() == "lovasz":
                mask_l = loss_ops.lovasz_hinge(logits_1, tgt_bin, valid_px,
                                               per_image=True)
            else:
                mask_l = loss_ops.cross_entropy_loss(logits_1, tgt_bin,
                                                     valid_px)
            per_image.append((*rpn_l[i], cls_l, breg_l, mask_l))
        if self.objects == 1:
            loss_dict = {name: torch.stack(ls).mean()
                         for name, ls in zip(LOSS_NAMES, zip(*per_image))}
        else:
            loss_dict = {name: torch.stack(ls).view(self.objects, -1).mean(1)
                         for name, ls in zip(LOSS_NAMES, zip(*per_image))}
        total = sum(loss_dict.values())
        return total, loss_dict

    # ---- inference -------------------------------------------------------

    def _forward_eval(self, image_hw, proposals: Proposals, roi_feats
                      ) -> Detections:
        """Detections of images ``[E, ...]`` at once: one RoI gather, one
        pass of each head (each object's through its own weights), one K3
        call over every image's candidates."""
        cfg = self.roi
        h, w = image_hw
        p_boxes, p_valid = proposals.boxes, proposals.valid  # [E, P(, 4)]
        e, n = p_valid.shape
        cls_logits, box_deltas = self._head(
            self.box_head, multiscale_roi_align(
                roi_feats, p_boxes, (cfg.box_roi_size, cfg.box_roi_size),
                ROI_SCALES))
        probs = F.softmax(cls_logits, dim=-1)  # [E, P, C]
        c = probs.shape[-1]
        # (roi, class) pairs of the foreground classes, flattened
        boxes_f = clip_boxes(decode_boxes(
            box_deltas[:, :, 1:], p_boxes[:, :, None].expand(e, n, c - 1, 4)
        ).reshape(e, -1, 4), (h, w))
        scores_f = probs[:, :, 1:].reshape(e, -1)
        classes_f = torch.arange(1, c, device=probs.device).repeat(n)
        valid_f = (p_valid[:, :, None].expand(e, n, c - 1).reshape(e, -1)
                   & (scores_f > cfg.score_thresh))
        idx, keep = batched_nms(boxes_f, scores_f, classes_f,
                                cfg.nms_thresh, cfg.detections_per_img,
                                valid=valid_f)  # [E, K]
        safe = idx.long().clamp_min(0)
        det_boxes = torch.where(keep[..., None], torch.gather(
            boxes_f, 1, safe[..., None].expand(-1, -1, 4)), 0.0)
        det_scores = torch.where(keep, torch.gather(scores_f, 1, safe), 0.0)
        det_classes = torch.where(keep, classes_f[safe], 0)

        (m_logits,) = self._head(
            self.mask_head, multiscale_roi_align(
                roi_feats, det_boxes, (cfg.mask_roi_size, cfg.mask_roi_size),
                ROI_SCALES))  # [E, K, 2m, 2m, C]
        k, m = m_logits.shape[1], m_logits.shape[2]
        sel = m_logits.gather(
            4, det_classes[:, :, None, None, None].expand(
                -1, -1, m, m_logits.shape[3], 1))[..., 0]
        pasted = paste_masks(torch.sigmoid(sel).reshape(e * k, m, -1),
                             det_boxes.reshape(e * k, 4), (h, w))
        pasted = pasted.view(e, k, h, w) * keep[:, :, None, None]
        return Detections(det_boxes, det_scores, det_classes.int(), pasted,
                          keep)
