"""The one-shot losses, pseudo ground truth and merge of the reference,
copied from the port's ``engine/one_shot.py`` (DeepLab) and
``engine/one_shot_detection.py`` (Mask R-CNN, as free functions of the
model apply and the configuration), with the reference's transforms and
losses beneath them."""

from __future__ import annotations

from typing import Callable

import torch

from plainref import losses as loss_ops
from plainref import transforms


def _loss_on(model_apply, cfg, params, imgs, labels):
    """The loss of ``imgs`` against ``labels [B, H, W]``; with stacked
    objects (``labels [O, B, H, W]``) one loss an object, each over its own
    labels and logit plane."""
    imgs = transforms.normalize(imgs, cfg.normalize_mode)
    valid = labels != 255
    gts = torch.where(valid, labels, 0).float()
    logits = model_apply(params, imgs)
    if labels.dim() == 3:
        return loss_ops.compute_loss(cfg.loss_func, logits[..., 0], gts,
                                     valid)
    return torch.stack([
        loss_ops.compute_loss(cfg.loss_func, logits[..., o], gts[o],
                              valid[o]) for o in range(labels.shape[0])])


def make_support_loss_fn(model_apply: Callable, cfg: OneShotConfig
                         ) -> Callable:
    """``loss_fn(params, (img, label, draws))`` over one augmented support
    batch: img is the raw ``[H, W, 3]`` support frame, label its {0, 1, 255}
    mask, draws the batch's ``AugmentDraws``; with stacked objects, labels
    ``[O, H, W]`` and a list of each object's draws."""

    def loss_fn(params, batch):
        img, label, draws = batch
        if label.dim() == 2:
            imgs, labels = transforms.augment_support_batch(
                img.float(), label, draws, cfg.augment)
        else:
            pairs = [transforms.augment_support_batch(
                img.float(), lab, d, cfg.augment)
                for lab, d in zip(label, draws)]
            imgs = torch.stack([im for im, _ in pairs])
            labels = torch.stack([lab for _, lab in pairs])
        return _loss_on(model_apply, cfg, params, imgs, labels)

    return loss_fn


def make_pseudo_gt_loss_fn(model_apply: Callable, cfg: OneShotConfig
                           ) -> Callable:
    """Online-adaptation loss over ``(support_img, support_label,
    prop_imgs [K, H, W, 3], prop_labels [K, H, W])``: the un-augmented
    support frame plus K pseudo-GT frames (all-255 frames carry no loss);
    with stacked objects, labels ``[O, H, W]`` and ``[O, K, H, W]``."""

    def loss_fn(params, batch):
        img, label, prop_imgs, prop_labels = batch
        imgs = torch.cat([img.float()[None], prop_imgs.float()], 0)
        labels = torch.cat([label.unsqueeze(-3).to(prop_labels.dtype),
                            prop_labels], -3)
        return _loss_on(model_apply, cfg, params, imgs, labels)

    return loss_fn


def pseudo_ignore_padding(pseudo: torch.Tensor, orig_hw) -> torch.Tensor:
    """Pixels outside the original ``(h, w)`` (bucket padding) become 255:
    the model's response to padding is no prediction about the scene."""
    if orig_hw is None or tuple(orig_hw) == tuple(pseudo.shape[-2:]):
        return pseudo
    h0, w0 = orig_hw
    pseudo = pseudo.clone()
    pseudo[..., h0:, :] = 255
    pseudo[..., :, w0:] = 255
    return pseudo


def build_pseudo_gt(w_probs: torch.Tensor, min_prop: float, orig_hw
                    ) -> torch.Tensor:
    """Predictions ``[..., K, H, W]`` → pseudo ground truth: prob ≥
    min_prop → 1, ≤ 1 − min_prop → 0, else 255; frames without confident
    foreground become all-255."""
    pseudo = torch.where(
        w_probs >= min_prop, 1,
        torch.where(w_probs <= 1.0 - min_prop, 0, 255)).to(torch.int32)
    pseudo = pseudo_ignore_padding(pseudo, orig_hw)
    has_fg = (pseudo == 1).any(dim=-1).any(dim=-1)
    return torch.where(has_fg[..., None, None], pseudo, 255)


def merge_objects(probs: torch.Tensor, threshold: float = 0.5
                  ) -> torch.Tensor:
    """Per-pixel argmax over object probability maps ``[O, ...]`` with a
    background plane at ``threshold`` → int32 label map (0 = background,
    k+1 = object k; ties go to the lower label)."""
    bg = torch.full((1,) + tuple(probs.shape[1:]), threshold,
                    dtype=probs.dtype, device=probs.device)
    return torch.cat([bg, probs], 0).argmax(0).to(torch.int32)


def detection_loss(model_apply: Callable, cfg, params, imgs: torch.Tensor,
                   labels: torch.Tensor, draws) -> torch.Tensor:
    """Total Mask R-CNN training loss of raw images ``[B, H, W, 3]`` with
    one object each (labels ``[B, H, W]`` in {0, 1, 255});
    ``DetectionOneShotEvaluator._detection_loss`` for one object group."""
    imgs = transforms.normalize(imgs, cfg.normalize_mode)
    gt_masks = torch.where(labels == 255, 255.0,
                           labels.float()).unsqueeze(-3)
    gt_valid = (gt_masks == 1).any(dim=(-2, -1))
    total, _ = model_apply(params, imgs, gt_masks, gt_valid, train=True,
                           draws=draws)
    return total


def detection_support_loss(model_apply: Callable, cfg, params, batch
                           ) -> torch.Tensor:
    """``_loss_fn``: one augmented support batch ``(img, label, aug,
    draws)``."""
    img, label, aug, draws = batch
    imgs, labels = transforms.augment_support_batch(img.float(), label, aug,
                                                    cfg.augment)
    return detection_loss(model_apply, cfg, params, imgs, labels, draws)


def detection_pseudo_gt_loss(model_apply: Callable, cfg, params, batch
                             ) -> torch.Tensor:
    """``_ona_loss_fn``: the un-augmented support frame plus the pseudo-GT
    frames ``(img, label, prop_imgs, prop_labels, draws)``."""
    img, label, prop_imgs, prop_labels, draws = batch
    imgs = torch.cat([img.float()[None], prop_imgs.float()], 0)
    labels = torch.cat([label.unsqueeze(-3).to(prop_labels.dtype),
                        prop_labels], -3)
    return detection_loss(model_apply, cfg, params, imgs, labels, draws)
