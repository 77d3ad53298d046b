"""Segmentation losses, port of ``e_osvos_tpu/ops/losses.py``: dice, the
per-pixel sigmoid BCE, the plain and the class-balanced BCE, the binary
Lovász hinge (the Mask R-CNN mask loss), the multi-class Lovász-softmax and
the dispatcher. Ignored pixels are masked by a static-shape ``valid`` mask;
in the Lovász losses they sort after every valid pixel and weigh 0."""

from __future__ import annotations

import math
from typing import Optional

import torch


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                                 ) -> torch.Tensor:
    """Numerically stable per-pixel BCE with logits (elementwise)."""
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              valid: Optional[torch.Tensor] = None,
              batch_average: bool = True, smooth: float = 1.0) -> torch.Tensor:
    """Smooth dice loss on sigmoid probabilities. ``batch_average=True``
    pools all pixels of the batch into one score; False gives one per
    sample."""
    probs = torch.sigmoid(logits)
    labels = labels.to(probs.dtype)
    if valid is not None:
        v = valid.to(probs.dtype)
        probs = probs * v
        labels = labels * v
    if batch_average:
        inter = (probs * labels).sum()
        return 1.0 - (2.0 * inter + smooth) / (probs.sum() + labels.sum()
                                               + smooth)
    probs_f = probs.reshape(probs.shape[0], -1)
    labels_f = labels.reshape(labels.shape[0], -1)
    inter = (probs_f * labels_f).sum(1)
    return 1.0 - (2.0 * inter + smooth) / (probs_f.sum(1) + labels_f.sum(1)
                                           + smooth)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       batch_average: bool = True) -> torch.Tensor:
    """Plain (unbalanced) BCE-with-logits mean; with ``valid``, the mean
    over the valid pixels."""
    per_pixel = sigmoid_binary_cross_entropy(logits, labels.to(logits.dtype))
    if valid is not None:
        v = valid.to(logits.dtype)
        return (per_pixel * v).sum() / v.sum().clamp_min(1.0)
    if batch_average:
        return per_pixel.mean()
    return per_pixel.reshape(per_pixel.shape[0], -1).mean(1)


def class_balanced_cross_entropy_loss(logits: torch.Tensor,
                                      labels: torch.Tensor,
                                      valid: Optional[torch.Tensor] = None,
                                      size_average: bool = True,
                                      batch_average: bool = True
                                      ) -> torch.Tensor:
    """OSVOS class-balanced BCE: positive pixels weighted by the negative
    class frequency and vice versa. ``batch_average=True`` takes the
    frequencies over the whole batch and divides by the batch size; False
    gives one loss per sample. ``size_average`` divides by the pixels of a
    sample."""
    labels = (labels >= 0.5).to(logits.dtype)
    per_pixel = sigmoid_binary_cross_entropy(logits, labels)
    pos, neg = labels, 1.0 - labels
    if valid is not None:
        v = valid.to(logits.dtype)
        per_pixel, pos, neg = per_pixel * v, pos * v, neg * v
    if batch_average:
        def sums(t):
            return t.sum()
    else:
        def sums(t):
            return t.reshape(t.shape[0], -1).sum(1)
    n_pos, n_neg = sums(pos), sums(neg)
    n_tot = (n_pos + n_neg).clamp_min(1.0)
    final = ((n_neg / n_tot) * sums(pos * per_pixel)
             + (n_pos / n_tot) * sums(neg * per_pixel))
    if batch_average:
        final = final / labels.shape[0]
    if size_average:
        final = final / float(math.prod(labels.shape[1:]))
    return final


# invalid pixels' error: sorts after every valid one, relu() gives 0
_NEG_LARGE = -1.0e30


def _lovasz_grad_from_sorted(gt_sorted: torch.Tensor,
                             valid_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. the errors sorted in
    descending order (rows of ``[R, P]``), invalid pixels excluded from both
    running sums."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + ((1.0 - gt_sorted) * valid_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp_min(1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     -1)


def _lovasz_hinge_rows(logits: torch.Tensor, labels: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Binary Lovász hinge of each row of ``[R, P]`` → ``[R]``. A stable
    sort on the negated errors orders ties as the JAX sort does."""
    signs = 2.0 * labels - 1.0
    errors = torch.where(v > 0, 1.0 - logits * signs, _NEG_LARGE)
    neg_sorted, order = torch.sort(-errors, dim=-1, stable=True)
    gt_sorted = (labels * v).gather(-1, order)
    valid_sorted = v.gather(-1, order)
    grad = _lovasz_grad_from_sorted(gt_sorted, valid_sorted)
    return (torch.relu(-neg_sorted) * grad * valid_sorted).sum(-1)


def lovasz_hinge_flat(logits: torch.Tensor, labels: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary Lovász hinge over all pixels of ``logits``; 0 when no pixel
    is valid."""
    logits = logits.reshape(1, -1)
    labels = labels.reshape(1, -1).to(logits.dtype)
    v = (torch.ones_like(logits) if valid is None
         else valid.reshape(1, -1).to(logits.dtype))
    return _lovasz_hinge_rows(logits, labels, v)[0]


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 per_image: bool = True) -> torch.Tensor:
    """Batched binary Lovász hinge over ``[B, ...]``: the mean of the
    per-sample losses (``per_image``), else one loss over every pixel."""
    if not per_image:
        return lovasz_hinge_flat(logits, labels, valid)
    b = logits.shape[0]
    logits = logits.reshape(b, -1)
    labels = labels.reshape(b, -1).to(logits.dtype)
    v = (torch.ones_like(logits) if valid is None
         else valid.reshape(b, -1).to(logits.dtype))
    return _lovasz_hinge_rows(logits, labels, v).mean()


def _lovasz_softmax_rows(probs: torch.Tensor, labels: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Lovász-softmax of each image of ``probs [R, P, C]`` (labels and
    ``v`` ``[R, P]``) → ``[R]``: the mean over the classes present in the
    image of each class's Lovász extension of its errors."""
    c = probs.shape[-1]
    classes = torch.arange(c, device=labels.device)
    fg = (labels[..., None] == classes).to(probs.dtype) * v[..., None]
    errors = torch.where(v[..., None] > 0, (fg - probs).abs(), _NEG_LARGE)
    # one row per (image, class): [R, C, P]
    errors, fg = errors.transpose(1, 2), fg.transpose(1, 2)
    vc = v[:, None].expand_as(fg)
    neg_sorted, order = torch.sort(-errors, dim=-1, stable=True)
    fg_sorted = fg.gather(-1, order)
    valid_sorted = vc.gather(-1, order)
    grad = _lovasz_grad_from_sorted(fg_sorted, valid_sorted)
    loss_c = (torch.relu(-neg_sorted) * grad * valid_sorted).sum(-1)
    present = (fg.sum(-1) > 0).to(probs.dtype)
    return (loss_c * present).sum(-1) / present.sum(-1).clamp_min(1.0)


def lovasz_softmax_flat(probs: torch.Tensor, labels: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-class Lovász-softmax over flat pixels: ``probs [P, C]`` softmax
    probabilities, ``labels [P]`` class ids. Absent classes contribute 0
    and leave the class mean (``classes='present'``)."""
    v = (torch.ones(probs.shape[:1], dtype=probs.dtype, device=probs.device)
         if valid is None else valid.reshape(-1).to(probs.dtype))
    return _lovasz_softmax_rows(probs[None], labels.reshape(1, -1).long(),
                                v[None])[0]


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   per_image: bool = False) -> torch.Tensor:
    """Batched Lovász-softmax: ``probs [B, H, W, C]``, ``labels [B, H, W]``;
    the mean of the per-image losses (``per_image``), else one loss over
    every pixel."""
    b, c = probs.shape[0], probs.shape[-1]
    rows = b if per_image else 1
    probs = probs.reshape(rows, -1, c)
    labels = labels.reshape(rows, -1).long()
    v = (torch.ones(labels.shape, dtype=probs.dtype, device=probs.device)
         if valid is None else valid.reshape(rows, -1).to(probs.dtype))
    return _lovasz_softmax_rows(probs, labels, v).mean()


LOSS_FUNCS = {
    "cross_entropy": cross_entropy_loss,
    "class_balanced_cross_entropy": class_balanced_cross_entropy_loss,
    "dice": dice_loss,
    "lovasz_hinge": lovasz_hinge,
}


def compute_loss(loss_func: str, logits: torch.Tensor, labels: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 batch_average: bool = True) -> torch.Tensor:
    """Loss dispatcher over ``LOSS_FUNCS`` and ``cross_entropy_and_dice``
    (their sum). ``lovasz_hinge`` is per image and takes no
    ``batch_average``."""
    if loss_func == "cross_entropy_and_dice":
        return (cross_entropy_loss(logits, labels, valid,
                                   batch_average=batch_average)
                + dice_loss(logits, labels, valid,
                            batch_average=batch_average))
    if loss_func == "lovasz_hinge":
        return lovasz_hinge(logits, labels, valid)
    if loss_func not in LOSS_FUNCS:
        raise ValueError(f"unknown loss_func {loss_func!r}")
    return LOSS_FUNCS[loss_func](logits, labels, valid,
                                 batch_average=batch_average)
