"""One-shot evaluation of the detection family (Mask R-CNN), port of the
per-group fused path of ``e_osvos_tpu/engine/one_shot_detection.py``.

``eval_sequence`` runs a sequence's object groups in turn, group gi on the
seed ``fold_in(seed, gi)``, then merges and scores them on the device;
``eval_sequence_init`` tracks with the un-fine-tuned init. For one object
group: reset to the learned init and fine-tune on augmented
copies of the support frame (the mask targets are synthesised inside the
model's forward), then walk the rest of the sequence frame by frame, feeding
each frame's predicted mask boxes, jittered, to the next frame's RPN as
extra proposals (the tracking prior). With online adaptation the frames go
in windows of ``online_adapt_step``: after each window the last
``min(step, batch_size)`` predictions become pseudo ground truth and the
model is refit on the un-augmented support frame plus those frames, except
from the last real window on. The tail window is padded by replicating the
last real frame, as the JAX package's fused propagation does.

Every random number of the path comes from ``sample_draws``, drawn from the
caller's ``torch.Generator`` on the generator's device (a CUDA generator
keeps the ~10^8 anchor-sampling uniforms of a sequence off the host) and
moved to the evaluator's device.

Public layouts are the JAX ones: frames ``[T, H, W, 3]`` raw 0..255, labels
``[H, W]`` in {0, 1, 255}, probabilities ``[T, H, W]``, boxes ``[K, 4]``
xyxy float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from e_osvos_torch.data import transforms
from e_osvos_torch.data.datasets import binarize_label
from e_osvos_torch.engine.one_shot import (
    OneShotConfig,
    _generator,
    _merged_to_host,
    _nanmean,
    build_pseudo_gt,
    fold_in,
    merge_objects,
    score_merged_device,
    stack_windows,
    stage_sequence,
)
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams, fine_tune
from e_osvos_torch.models.deeplab import functional_apply
from e_osvos_torch.models.mask_rcnn import MaskRCNN, TrainDraws
from e_osvos_torch.ops.boxes import masks_to_boxes
from e_osvos_torch.utils.device import resolve_device, upload


@dataclasses.dataclass(frozen=True)
class DetectionOneShotConfig(OneShotConfig):
    """Adds the detection knobs: the RPN proposal augmentation mode, the
    threshold turning a predicted mask into the next frame's box, and the
    online-adaptation reset mode (``FIRST_STEP`` continues from the current
    params, ``FULL`` restarts from the learned init each refit).
    ``ona_only_box_head`` is not ported yet."""

    proposal_aug_mode: str = "EXTEND"
    box_from_mask_thresh: float = 0.5
    ona_reset_mode: str = "FIRST_STEP"
    ona_only_box_head: bool = False


class DetectionOneShotEvaluator:
    """Drives one-shot tracking of object groups with a ``MaskRCNN``.

    ``device`` is where frames, labels and draws live: ``cuda`` unless the
    caller asks for another. ``eval_sequence`` and ``eval_sequence_init``
    draw from CPU generators. ``on_phase(name)``, when given, is called as
    each phase ends (``"fine_tune"`` and ``"propagate"`` of each object
    group, then ``"score"`` of a sequence); it never synchronizes the
    device."""

    def __init__(self, model: MaskRCNN, meta_cfg: MetaOptimConfig,
                 cfg: DetectionOneShotConfig, device=None,
                 on_phase: Optional[Callable[[str], None]] = None):
        if cfg.ona_only_box_head:
            raise NotImplementedError(
                "ona_only_box_head is not ported yet (it needs the lr mask "
                "by parameter path)")
        if cfg.ona_reset_mode not in ("FIRST_STEP", "FULL"):
            raise ValueError(f"unknown ona_reset_mode {cfg.ona_reset_mode!r}")
        self.model = model
        self.model_apply = functional_apply(model)
        self.meta_cfg = meta_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.on_phase = on_phase

    def _phase_done(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    def _support_label(self, index, seq, group, hw) -> torch.Tensor:
        """The group's {0, 1, 255} label of its support frame on the device,
        255-padded to ``hw``."""
        gt = index.get_label(seq.name, group.support_frame)
        return transforms.pad_label_to(upload(
            binarize_label(gt, group.object_ids).astype(np.int32),
            self.device), hw)

    def _initial_boxes(self, support_label: torch.Tensor):
        """The support mask's box and validity, one copy per tracked
        detection: ``[K, 4]``, ``[K]``."""
        k = self.model.roi.detections_per_img
        boxes0, valid0 = masks_to_boxes((support_label == 1).float()[None])
        return boxes0.repeat(k, 1), valid0.repeat(k)

    # -- random draws ---------------------------------------------------------

    def sample_draws(self, generator: torch.Generator, kind: str, count: int,
                     hw: Tuple[int, int]):
        """Every random number of the path, for ``count`` consecutive uses:

          * ``"fine_tune"``: ``(AugmentDraws [count, B], TrainDraws)`` of
            ``count`` fine-tune steps at batch ``B = batch_size``;
          * ``"refit"``: ``TrainDraws`` of ``count`` refit steps at batch
            1 + ``min(online_adapt_step, batch_size)``;
          * ``"frames"``: the tracking prior's jitter uniforms
            ``[count, 1, post_nms_top_n, 4]`` of ``count`` frames.

        ``TrainDraws`` fields carry the leading ``count`` axis. Uniforms in
        [0, 1) are drawn on the generator's device, then moved to the
        evaluator's."""
        dev = generator.device

        def uniforms(shape):
            return torch.rand((count,) + tuple(shape), generator=generator,
                              device=dev).to(self.device, non_blocking=True)

        if kind == "frames":
            (shape,) = self.model.draw_shapes(hw, 1, train=False)
            return uniforms(shape)
        cfg = self.cfg
        if kind == "fine_tune":
            batch = cfg.batch_size
        elif kind == "refit":
            batch = 1 + min(cfg.online_adapt_step, cfg.batch_size)
        else:
            raise ValueError(f"unknown draw kind {kind!r}")
        train = TrainDraws(*(uniforms(s) for s in
                             self.model.draw_shapes(hw, batch, num_objects=1)))
        if kind == "refit":
            return train
        aug = transforms.sample_augment_draws(generator, cfg.augment,
                                              (count, batch))
        return aug.to(self.device), train

    # -- fine-tune --------------------------------------------------------------

    def _detection_loss(self, params, imgs: torch.Tensor, labels: torch.Tensor,
                        draws: TrainDraws) -> torch.Tensor:
        """Total Mask R-CNN training loss of raw images ``[B, H, W, 3]`` with
        one object each (labels ``[B, H, W]`` in {0, 1, 255})."""
        imgs = transforms.normalize(imgs, self.cfg.normalize_mode)
        gt_masks = torch.where(labels == 255, 255.0, labels.float())[:, None]
        gt_valid = (gt_masks == 1).any(dim=(2, 3))
        total, _ = self.model_apply(params, imgs, gt_masks, gt_valid,
                                    train=True, draws=draws)
        return total

    def _loss_fn(self, params, batch) -> torch.Tensor:
        img, label, aug, draws = batch
        imgs, labels = transforms.augment_support_batch(
            img.float(), label, aug, self.cfg.augment)
        return self._detection_loss(params, imgs, labels, draws)

    def _fine_tune(self, meta_params: MetaParams, generator: torch.Generator,
                   img: torch.Tensor, label: torch.Tensor, init_params):
        """``num_epochs`` learned-SGD steps, each on a fresh augmentation
        batch of the support frame → (params, per-step losses)."""
        cfg = self.cfg
        aug, draws = self.sample_draws(generator, "fine_tune", cfg.num_epochs,
                                       tuple(img.shape[:2]))
        batches = [(img, label, aug.select(i), draws.select(i))
                   for i in range(cfg.num_epochs)]
        return fine_tune(self.meta_cfg, self._loss_fn, meta_params, batches,
                         init_params=init_params,
                         early_stop_patience=cfg.early_stop_patience)

    def _ona_loss_fn(self, params, batch) -> torch.Tensor:
        """The un-augmented support frame plus the pseudo-GT frames."""
        img, label, prop_imgs, prop_labels, draws = batch
        imgs = torch.cat([img.float()[None], prop_imgs.float()], 0)
        labels = torch.cat([label[None].to(prop_labels.dtype), prop_labels], 0)
        return self._detection_loss(params, imgs, labels, draws)

    def _ona_fine_tune(self, meta_params: MetaParams,
                       generator: torch.Generator, img, label, prop_imgs,
                       prop_labels, params):
        """``online_adapt_epochs`` steps on the support frame and the
        pseudo-GT frames, continuing from ``params`` (updated in place) or,
        with ``ona_reset_mode="FULL"``, from the learned init."""
        cfg = self.cfg
        n = cfg.online_adapt_epochs
        draws = self.sample_draws(generator, "refit", n, tuple(img.shape[:2]))
        batches = [(img, label, prop_imgs, prop_labels, draws.select(i))
                   for i in range(n)]
        return fine_tune(self.meta_cfg, self._ona_loss_fn, meta_params,
                         batches, init_params=params,
                         early_stop_patience=cfg.early_stop_patience,
                         reset=cfg.ona_reset_mode == "FULL")[0]

    # -- propagation ------------------------------------------------------------

    @torch.no_grad()
    def _segment_window(self, params, frames: torch.Tensor,
                        init_boxes: torch.Tensor, init_valid: torch.Tensor,
                        jitter_u: torch.Tensor):
        """Frame by frame over raw ``frames [T, H, W, 3]``, the previous
        frame's boxes ``[K, 4]`` as the proposal prior (``jitter_u`` the
        ``"frames"`` draws of these T frames). Returns (probs ``[T, H, W]``,
        boxes ``[T, K, 4]``, valid ``[T, K]``, final boxes ``[K, 4]``, final
        valid ``[K]``); the final carry seeds the next window, all on the
        device."""
        cfg = self.cfg
        prev_boxes, prev_valid = init_boxes, init_valid
        probs, det_boxes, det_valid = [], [], []
        for t in range(frames.shape[0]):
            img = transforms.normalize(frames[t].float(), cfg.normalize_mode)
            det = self.model_apply(
                params, img[None], prev_boxes=prev_boxes[None],
                prev_valid=prev_valid[None],
                proposal_aug_mode=cfg.proposal_aug_mode, draws=jitter_u[t])
            masks = det.masks[0]  # [K, H, W]
            probs.append(masks.amax(0))
            det_boxes.append(det.boxes[0])
            det_valid.append(det.valid[0])
            # the next frame's boxes from the predicted masks; with no
            # detection left, the previous boxes carry on
            new_boxes, new_valid = masks_to_boxes(
                (masks >= cfg.box_from_mask_thresh).float())
            new_valid = new_valid & det.valid[0]
            keep_prev = ~new_valid.any()
            prev_boxes = torch.where(keep_prev, prev_boxes, new_boxes)
            prev_valid = torch.where(keep_prev, prev_valid, new_valid)
        return (torch.stack(probs), torch.stack(det_boxes),
                torch.stack(det_valid), prev_boxes, prev_valid)

    def _eval_object_group(self, index, seq, frames: torch.Tensor, group,
                           meta_params: MetaParams,
                           generator: torch.Generator, init_params,
                           orig_hw=None,
                           support_img: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """``[T, H, W]`` foreground probability of one object group.
        ``frames`` is the raw ``[T, H, W, 3]`` stack on the evaluator's
        device; ``generator`` gives every draw (``sample_draws``)."""
        cfg = self.cfg
        frames = frames.to(self.device)
        T = frames.shape[0]
        hw = tuple(frames.shape[1:3])
        sf = group.support_frame
        if support_img is None:
            support_img = frames[sf]
        support_label = self._support_label(index, seq, group, hw)

        params, _ = self._fine_tune(meta_params, generator, support_img,
                                    support_label, init_params)
        self._phase_done("fine_tune")

        probs = torch.zeros((T,) + hw, dtype=torch.float32,
                            device=self.device)
        probs[sf] = (support_label == 1).float()
        if sf + 1 < T:
            boxes, valid = self._initial_boxes(support_label)
            ona = cfg.online_adapt_step > 0
            step = cfg.online_adapt_step if ona else T - sf - 1
            windows, r, wn_real = stack_windows(
                frames[sf + 1:], step, cfg.ona_window_bucket if ona else 0)
            kk = min(step, cfg.batch_size)
            out = []
            for i in range(windows.shape[0]):
                jitter_u = self.sample_draws(generator, "frames", step, hw)
                w_probs, _, _, boxes, valid = self._segment_window(
                    params, windows[i], boxes, valid, jitter_u)
                out.append(w_probs)
                if ona and i < wn_real - 1:
                    pseudo = build_pseudo_gt(
                        w_probs[-kk:], cfg.online_adapt_min_prop, orig_hw)
                    params = self._ona_fine_tune(
                        meta_params, generator, support_img, support_label,
                        windows[i][-kk:], pseudo, params)
            probs[sf + 1:] = torch.cat(out)[:r]
        self._phase_done("propagate")
        return probs

    # -- sequences ----------------------------------------------------------

    def eval_sequence(self, index, seq_name: str, meta_params: MetaParams,
                      seed: int, init_params=None) -> Dict[str, Any]:
        """Fine-tune and track every object group of one sequence in turn,
        group gi on the seed ``fold_in(seed, gi)``, then merge and score.
        Returns the merged uint8 labels ``[T, H, W]`` on the host, the
        probabilities ``[O, T, H, W]`` as a device tensor, and the J/F
        means per object and over objects."""
        seq = index.sequences[seq_name]
        frames, support, (T, h0, w0) = stage_sequence(
            index, seq_name, self.device, self.cfg.pad_multiple)
        obj_probs = [
            self._eval_object_group(
                index, seq, frames, g, meta_params,
                _generator(fold_in(seed, gi)), init_params,
                orig_hw=(h0, w0), support_img=support[g.support_frame])
            for gi, g in enumerate(seq.object_groups)]
        res = self._score(index, seq_name, seq,
                          torch.stack(obj_probs)[..., :h0, :w0])
        self._phase_done("score")
        return res

    def eval_sequence_init(self, index, seq_name: str,
                           meta_params: MetaParams, init_params=None
                           ) -> Dict[str, Any]:
        """init_J of the detection path: the un-fine-tuned init tracks the
        sequence with the box-carry proposal prior, with no fine-tune and
        no refit, in windows of ``online_adapt_step`` frames (a ragged tail,
        the rest in one window without OnA). Group gi's draws come from the
        seed ``fold_in(0, gi)``."""
        cfg = self.cfg
        seq = index.sequences[seq_name]
        frames, _, (T, h0, w0) = stage_sequence(index, seq_name, self.device,
                                                cfg.pad_multiple)
        hw = tuple(frames.shape[1:3])
        params = (init_params if init_params is not None
                  else meta_params.model_init)
        if params is None:
            raise ValueError("eval_sequence_init needs init_params when the "
                             "meta-parameters have no learned init")
        step = cfg.online_adapt_step if cfg.online_adapt_step > 0 else T
        obj_probs = []
        for gi, group in enumerate(seq.object_groups):
            sf = group.support_frame
            label = self._support_label(index, seq, group, hw)
            boxes, valid = self._initial_boxes(label)
            probs = torch.zeros((T,) + hw, dtype=torch.float32,
                                device=self.device)
            probs[sf] = (label == 1).float()
            generator = _generator(fold_in(0, gi))
            for start in range(sf + 1, T, step):
                end = min(start + step, T)
                jitter_u = self.sample_draws(generator, "frames", end - start,
                                             hw)
                w_probs, _, _, boxes, valid = self._segment_window(
                    params, frames[start:end], boxes, valid, jitter_u)
                probs[start:end] = w_probs
            obj_probs.append(probs)
        res = self._score(index, seq_name, seq,
                          torch.stack(obj_probs)[..., :h0, :w0])
        return {"seq": seq_name, "init_J_mean": res["J_mean"],
                "init_F_mean": res["F_mean"]}

    def _score(self, index, seq_name: str, seq, probs: torch.Tensor
               ) -> Dict[str, Any]:
        """Merge and score ``probs [O, T, H, W]`` with two fetches: the
        ``[O, T]`` J/F arrays and the packed merged planes. ``probs`` stays
        a device tensor in the result; fetching it is the caller's
        choice."""
        merged = merge_objects(probs, self.cfg.threshold)
        j_means, f_means, _ = score_merged_device(index, seq_name, seq, merged)
        return {
            "seq": seq_name,
            "merged": _merged_to_host(merged, len(seq.object_groups)),
            "probs": probs,
            "J_per_object": j_means,
            "F_per_object": f_means,
            "J_mean": _nanmean(j_means),
            "F_mean": _nanmean(f_means),
        }
