"""One-shot fine-tune + propagate evaluation, port of the single-object-group
path of ``e_osvos_tpu/engine/one_shot.py``.

For one object group of a sequence: reset to the learned init, fine-tune on
augmented copies of the support frame, then walk the rest of the sequence in
windows of ``online_adapt_step`` frames. Each window is segmented; its last
``min(step, batch_size)`` predictions become pseudo ground truth
(prob ≥ min_prop → 1, ≤ 1 − min_prop → 0, else 255), and the model is refit
on the un-augmented support frame plus those frames.

The window loop keeps the semantics of the JAX package's fused propagation
(``propagate_windows_fused``): the tail window is padded by replicating the
last real frame, and no refit runs from the last real window on.

Public layouts are the JAX ones: frames ``[T, H, W, 3]`` raw 0..255, labels
``[H, W]`` in {0, 1, 255}, probabilities ``[T, H, W]``, packed masks uint8
``[T, H, ceil(W/8)]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from e_osvos_torch.data import transforms
from e_osvos_torch.data.datasets import binarize_label
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams, fine_tune
from e_osvos_torch.ops import losses as loss_ops
from e_osvos_torch.ops.bits import pack_mask_bits
from e_osvos_torch.utils.device import resolve_device

Params = Any


@dataclasses.dataclass(frozen=True)
class OneShotConfig:
    """Evaluation configuration: ``num_epochs`` fine-tune steps on
    ``batch_size`` augmented support copies, online adaptation every
    ``online_adapt_step`` frames (0 = off) for ``online_adapt_epochs``
    steps with pseudo-GT confidence ``online_adapt_min_prop``, the loss,
    the early-stop patience (0 = off) and the mask threshold."""

    num_epochs: int = 10
    batch_size: int = 3
    loss_func: str = "dice"
    early_stop_patience: int = 0
    online_adapt_step: int = 0
    online_adapt_epochs: int = 10
    online_adapt_min_prop: float = 0.75
    threshold: float = 0.5
    normalize_mode: str = "davis"
    augment: transforms.AugmentConfig = dataclasses.field(
        default_factory=transforms.AugmentConfig)


def _loss_on(model_apply, cfg, params, imgs, labels):
    imgs = transforms.normalize(imgs, cfg.normalize_mode)
    valid = labels != 255
    gts = torch.where(valid, labels, 0).float()
    logits = model_apply(params, imgs)[..., 0]
    return loss_ops.compute_loss(cfg.loss_func, logits, gts, valid)


def make_support_loss_fn(model_apply: Callable, cfg: OneShotConfig
                         ) -> Callable:
    """``loss_fn(params, (img, label, draws))`` over one augmented support
    batch: img is the raw ``[H, W, 3]`` support frame, label its {0, 1, 255}
    mask, draws the batch's ``AugmentDraws``."""

    def loss_fn(params, batch):
        img, label, draws = batch
        imgs, labels = transforms.augment_support_batch(
            img.float(), label, draws, cfg.augment)
        return _loss_on(model_apply, cfg, params, imgs, labels)

    return loss_fn


def make_pseudo_gt_loss_fn(model_apply: Callable, cfg: OneShotConfig
                           ) -> Callable:
    """Online-adaptation loss over ``(support_img, support_label,
    prop_imgs [K, H, W, 3], prop_labels [K, H, W])``: the un-augmented
    support frame plus K pseudo-GT frames (all-255 frames carry no loss)."""

    def loss_fn(params, batch):
        img, label, prop_imgs, prop_labels = batch
        imgs = torch.cat([img.float()[None], prop_imgs.float()], 0)
        labels = torch.cat([label[None].to(prop_labels.dtype), prop_labels], 0)
        return _loss_on(model_apply, cfg, params, imgs, labels)

    return loss_fn


def fine_tune_on_support(model_apply: Callable, meta_cfg: MetaOptimConfig,
                         cfg: OneShotConfig, meta_params: MetaParams,
                         generator: torch.Generator, img: torch.Tensor,
                         label: torch.Tensor, init_params: Params = None
                         ) -> Tuple[Params, torch.Tensor]:
    """One-shot adaptation: ``num_epochs`` learned-SGD steps, each on a fresh
    augmentation batch of the support frame. All draws are taken from
    ``generator`` up front and cross to the device once."""
    draws = transforms.sample_augment_draws(
        generator, cfg.augment, (cfg.num_epochs, cfg.batch_size)
    ).to(img.device)
    batches = [(img, label, draws.select(i)) for i in range(cfg.num_epochs)]
    return fine_tune(meta_cfg, make_support_loss_fn(model_apply, cfg),
                     meta_params, batches, init_params=init_params,
                     early_stop_patience=cfg.early_stop_patience)


@torch.no_grad()
def segment_frames(model_apply: Callable, cfg: OneShotConfig, params: Params,
                   frames: torch.Tensor) -> torch.Tensor:
    """Inference over a raw ``[T, H, W, 3]`` frame stack → ``[T, H, W]``
    foreground probability."""
    imgs = transforms.normalize(frames, cfg.normalize_mode)
    return torch.sigmoid(model_apply(params, imgs)[..., 0])


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
    """Predictions ``[K, H, W]`` → pseudo ground truth: prob ≥ min_prop → 1,
    ≤ 1 − min_prop → 0, else 255; frames without confident foreground
    become all-255."""
    pseudo = torch.where(
        w_probs >= min_prop, 1,
        torch.where(w_probs <= 1.0 - min_prop, 0, 255)).to(torch.int32)
    pseudo = pseudo_ignore_padding(pseudo, orig_hw)
    has_fg = (pseudo == 1).any(dim=(1, 2))
    return torch.where(has_fg[:, None, None], pseudo, 255)


def make_ona_refit_fn(model_apply: Callable, meta_cfg: MetaOptimConfig,
                      cfg: OneShotConfig) -> Callable:
    """Online-adaptation refit: ``online_adapt_epochs`` deterministic
    learned-SGD steps on (support + pseudo-GT), continuing from ``params``
    (which it updates in place)."""
    loss_fn = make_pseudo_gt_loss_fn(model_apply, cfg)

    def refit(meta_params, img, label, prop_imgs, prop_labels, params):
        batch = (img, label, prop_imgs, prop_labels)
        return fine_tune(meta_cfg, loss_fn, meta_params,
                         [batch] * cfg.online_adapt_epochs,
                         init_params=params,
                         early_stop_patience=cfg.early_stop_patience,
                         reset=False)[0]

    return refit


def stack_windows(frames_rest: torch.Tensor, step: int
                  ) -> Tuple[torch.Tensor, int, int]:
    """``[R, H, W, 3]`` → ``[Wn, step, H, W, 3]``, the tail padded by
    replicating the last real frame. Returns ``(windows, R, Wn)``."""
    r = frames_rest.shape[0]
    pad = (-r) % step
    if pad:
        tail = frames_rest[-1:].expand((pad,) + tuple(frames_rest.shape[1:]))
        frames_rest = torch.cat([frames_rest, tail], 0)
    wn = frames_rest.shape[0] // step
    return frames_rest.reshape((wn, step) + tuple(frames_rest.shape[1:])), r, wn


def propagate_windows(model_apply: Callable, meta_cfg: MetaOptimConfig,
                      cfg: OneShotConfig, orig_hw, meta_params: MetaParams,
                      support_img: torch.Tensor, support_label: torch.Tensor,
                      windows: torch.Tensor, params: Params, wn_real: int
                      ) -> Tuple[torch.Tensor, Params]:
    """Segment each window of ``windows [Wn, step, H, W, 3]`` in turn,
    refitting after every window before the last real one. Returns
    (``[Wn*step, H, W]`` probs, params)."""
    refit = make_ona_refit_fn(model_apply, meta_cfg, cfg)
    k = min(cfg.online_adapt_step, cfg.batch_size)
    probs = []
    for i in range(windows.shape[0]):
        window = windows[i]
        w_probs = segment_frames(model_apply, cfg, params, window)
        probs.append(w_probs)
        if i < wn_real - 1:
            pseudo = build_pseudo_gt(w_probs[-k:], cfg.online_adapt_min_prop,
                                     orig_hw)
            params = refit(meta_params, support_img, support_label,
                           window[-k:], pseudo, params)
    return torch.cat(probs, 0), params


def one_shot_packed_ona(model_apply: Callable, meta_cfg: MetaOptimConfig,
                        cfg: OneShotConfig, orig_hw, meta_params: MetaParams,
                        generator: torch.Generator, support_img: torch.Tensor,
                        support_label: torch.Tensor, windows: torch.Tensor,
                        wn_real: int, init_params: Params = None
                        ) -> torch.Tensor:
    """e-OSVOS-OnA serving: fine-tune → windowed online adaptation →
    threshold → bit-pack. ``windows`` are the frames after the support
    frame (``stack_windows``). Returns uint8 ``[Wn*step, H, ceil(W/8)]``."""
    params, _ = fine_tune_on_support(model_apply, meta_cfg, cfg, meta_params,
                                     generator, support_img, support_label,
                                     init_params)
    probs, _ = propagate_windows(model_apply, meta_cfg, cfg, orig_hw,
                                 meta_params, support_img, support_label,
                                 windows, params, wn_real)
    return pack_mask_bits(probs >= cfg.threshold)


class OneShotEvaluator:
    """Drives one-shot evaluation of object groups of a dataset index.

    ``model_apply(params, imgs [B, H, W, 3]) -> logits [B, H, W, 1]``
    (``models.functional_apply``). ``device`` is where frames and labels
    live: ``cuda`` unless the caller asks for another. ``on_phase(name)``,
    when given, is called as each phase of an object group ends
    (``"fine_tune"``, then ``"propagate"``), e.g. to record a CUDA event
    there; it never synchronizes the device."""

    def __init__(self, model_apply: Callable, meta_cfg: MetaOptimConfig,
                 cfg: OneShotConfig, device=None,
                 on_phase: Optional[Callable[[str], None]] = None):
        self.model_apply = model_apply
        self.meta_cfg = meta_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.on_phase = on_phase

    def _phase_done(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    def _eval_object_group(self, index, seq, frames: torch.Tensor, group,
                           meta_params: MetaParams,
                           generator: torch.Generator, init_params: Params,
                           orig_hw=None,
                           support_img: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """``[T, H, W]`` foreground probability of one object group.
        ``frames`` is the raw ``[T, H, W, 3]`` stack on the evaluator's
        device; ``generator`` draws the fine-tune's augmentations."""
        cfg = self.cfg
        frames = frames.to(self.device)
        T = frames.shape[0]
        hw = tuple(frames.shape[1:3])
        sf = group.support_frame
        if support_img is None:
            support_img = frames[sf]
        gt = index.get_label(seq.name, sf)
        support_label = transforms.pad_label_to(
            torch.from_numpy(binarize_label(gt, group.object_ids)).to(
                self.device, torch.int32), hw)

        params, _ = fine_tune_on_support(
            self.model_apply, self.meta_cfg, cfg, meta_params, generator,
            support_img, support_label, init_params)
        self._phase_done("fine_tune")

        probs = torch.zeros((T,) + hw, dtype=torch.float32,
                            device=self.device)
        # support frame gets its GT (void pixels are not foreground); frames
        # before it stay 0
        probs[sf] = (support_label == 1).float()
        if sf + 1 < T and cfg.online_adapt_step <= 0:
            probs[sf + 1:] = segment_frames(self.model_apply, cfg, params,
                                            frames[sf + 1:])
        elif sf + 1 < T:
            windows, r, wn_real = stack_windows(frames[sf + 1:],
                                                cfg.online_adapt_step)
            w_flat, _ = propagate_windows(
                self.model_apply, self.meta_cfg, cfg, orig_hw, meta_params,
                support_img, support_label, windows, params, wn_real)
            probs[sf + 1:] = w_flat[:r]
        self._phase_done("propagate")
        return probs
