"""Segmentation losses, port of the one-shot subset of
``e_osvos_tpu/ops/losses.py``: dice, the per-pixel sigmoid BCE, the plain
BCE mean, the binary Lovász hinge (the Mask R-CNN mask loss) and the
dispatcher. Ignored pixels are masked by a static-shape ``valid`` mask."""

from __future__ import annotations

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


LOSS_FUNCS = {"dice": dice_loss}


def compute_loss(loss_func: str, logits: torch.Tensor, labels: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 batch_average: bool = True) -> torch.Tensor:
    """Loss dispatcher. Only the losses ported so far are known; any other
    name raises."""
    if loss_func not in LOSS_FUNCS:
        raise ValueError(f"unknown or not yet ported loss_func {loss_func!r}; "
                         f"have {sorted(LOSS_FUNCS)}")
    return LOSS_FUNCS[loss_func](logits, labels, valid,
                                 batch_average=batch_average)
