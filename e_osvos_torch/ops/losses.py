"""Segmentation losses, port of the main-path subset of
``e_osvos_tpu/ops/losses.py``: dice, the per-pixel sigmoid BCE and the
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
