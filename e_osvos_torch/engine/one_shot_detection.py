"""One-shot evaluation of the detection family (Mask R-CNN), port of
``e_osvos_tpu/engine/one_shot_detection.py``.

``eval_sequence`` fine-tunes and tracks a sequence's object groups, then
merges and scores them on the device. With ``batch_objects`` (the default,
as in the JAX package) groups that share a support frame run together as
one object-stacked model (``models/stacked.py``: the objects folded into
the channel axis up to the RPN, then O images); otherwise, and with
``batch_objects=False``, they run in turn. Group gi draws from the seed
``fold_in(seed, gi)`` either way, so the batched result is the loop's to
rounding. ``eval_sequence_init`` tracks with the un-fine-tuned init;
``eval_stream`` issues many sequences before fetching any result, tracks
each sequence's first object group, and brings back only bit-packed masks.

For one object group: reset to the learned init and fine-tune on augmented
copies of the support frame (the mask targets are synthesised inside the
model's forward), then walk the rest of the sequence frame by frame,
feeding each frame's predicted mask boxes, jittered, to the next frame's
RPN as extra proposals (the tracking prior). With online adaptation the
frames go in windows of ``online_adapt_step``: after a window its last
``min(step, batch_size)`` predictions become pseudo ground truth and the
model is refit on the un-augmented support frame plus those frames.

Two window loops, as in the JAX package: the host loop (``fused_ona=False``,
the default) ends on a ragged tail window and refits while frames remain;
the fused formulation (``fused_ona=True``) pads the tail window by
replicating the last real frame and refits after every window but the last
real one. ``ona_only_box_head`` refits the box and mask heads alone and
takes no gradient of the rest.

Functions that take one group's support label ``[H, W]`` take the stacked
groups' ``[O, H, W]`` (with stacked meta-parameters and params, and a list
of generators, one a group) and give ``[O, ...]`` results: each object
keeps its own box carry and empty-mask fallback, pseudo ground truth and
early-stop latch.

Over several GPUs (``mesh`` with a process group), the objects of a
batched sequence are sharded, as the JAX package's
``_install_object_sharding`` does: the box carry makes the frames
sequential, but objects are independent. The object axis is padded to a
multiple of the ranks by repeating the last object; each rank fine-tunes
and tracks its contiguous share (the object-stacked model, or the plain
model where its share is one object), object i drawing from ``fold_in(seed,
i)`` by its index in the sequence, so the result is the one-process batched
one to rounding; the ``[O, T, H, W]`` probabilities are gathered once, by
one ``all_reduce`` (``parallel.mesh.gather_rows``), before the merge and the
score, and the pad is dropped. Single-object sequences, groups with
distinct support frames, ``eval_sequence_init`` and ``eval_stream`` run
whole on every rank, with no collective. The fused loop is off under a
group, as in JAX.

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
    object_generators,
    score_merged_device,
    stack_for_objects,
    stack_windows,
    stage_sequence,
)
from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    fine_tune,
    select_lrs_by_path,
)
from e_osvos_torch.models.deeplab import functional_apply
from e_osvos_torch.models.mask_rcnn import MaskRCNN, TrainDraws
from e_osvos_torch.models.stacked import object_stacked_apply
from e_osvos_torch.ops.bits import pack_mask_bits, unpack_mask_bits
from e_osvos_torch.ops.boxes import masks_to_boxes
from e_osvos_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    pad_rows,
    padded_rows,
)
from e_osvos_torch.utils import tracing
from e_osvos_torch.utils.device import resolve_device, upload


@dataclasses.dataclass(frozen=True)
class DetectionOneShotConfig(OneShotConfig):
    """Adds the detection knobs: the RPN proposal augmentation mode, the
    threshold turning a predicted mask into the next frame's box, the
    online-adaptation reset mode (``FIRST_STEP`` continues from the current
    params, ``FULL`` restarts from the learned init each refit), and
    ``ona_only_box_head``, which refits only the parameters of the box and
    mask heads."""

    proposal_aug_mode: str = "EXTEND"
    box_from_mask_thresh: float = 0.5
    ona_reset_mode: str = "FIRST_STEP"
    ona_only_box_head: bool = False


# the parameters an ``ona_only_box_head`` refit updates, by name
ONA_HEADS = ("box_head", "mask_head")


class DetectionOneShotEvaluator:
    """Drives one-shot tracking of object groups with a ``MaskRCNN``.

    ``device`` is where frames, labels and draws live: ``cuda`` unless the
    caller asks for another. ``batch_objects`` (on by default, as in the
    JAX package) runs the object groups of a sequence that share a support
    frame together, as an object-stacked model. ``fused_ona`` picks the
    fused window loop (off by default, as in the JAX package).
    ``eval_sequence``, ``eval_sequence_init`` and ``eval_stream`` draw from
    CPU generators. ``on_phase(name)``, when given, is called as each phase
    ends (``"fine_tune"`` and ``"propagate"`` of each object group, or once
    for batched groups, then ``"score"`` of a sequence); it never
    synchronizes the device.

    ``mesh`` (``parallel.make_mesh()`` under a process group) shards the
    objects of a batched sequence over its task axis (the module
    docstring); with a group the fused loop is off. Every rank returns the
    whole result. The default, and a mesh without a group, run in one
    process."""

    def __init__(self, model: MaskRCNN, meta_cfg: MetaOptimConfig,
                 cfg: DetectionOneShotConfig, device=None,
                 on_phase: Optional[Callable[[str], None]] = None,
                 fused_ona: bool = False, batch_objects: bool = True,
                 mesh: Optional[Mesh] = None):
        if cfg.ona_reset_mode not in ("FIRST_STEP", "FULL"):
            raise ValueError(f"unknown ona_reset_mode {cfg.ona_reset_mode!r}")
        self.model = model
        self.model_apply = functional_apply(model)
        self.meta_cfg = meta_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.on_phase = on_phase
        self.mesh = Mesh() if mesh is None else mesh
        self.fused_ona = (fused_ona and cfg.online_adapt_step > 0
                          and self.mesh.group is None)
        self.batch_objects = batch_objects

    def _phase_done(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    def _apply(self, objects: int) -> Callable:
        """The model apply of one group (``objects`` 0) or of ``objects``
        stacked groups."""
        if not objects:
            return self.model_apply
        return object_stacked_apply(self.model_apply, objects)

    def _support_label(self, index, seq, groups, hw) -> torch.Tensor:
        """The {0, 1, 255} label of a group's support frame (``groups`` one
        group) or of each of ``groups`` (a list sharing a support frame:
        ``[O, H, W]``) on the device, 255-padded to ``hw``."""
        stacked = isinstance(groups, (list, tuple))
        gs = groups if stacked else [groups]
        with tracing.span("stage"):
            gt = index.get_label(seq.name, gs[0].support_frame)
            bins = np.stack([binarize_label(gt, g.object_ids) for g in gs])
            label = transforms.pad_label_to(
                upload(bins.astype(np.int32), self.device), hw)
        return label if stacked else label[0]

    def _initial_boxes(self, support_label: torch.Tensor):
        """The support mask's box and validity, one copy per tracked
        detection: ``[K, 4]``, ``[K]`` (stacked groups: ``[O, K, 4]``,
        ``[O, K]``)."""
        k = self.model.roi.detections_per_img
        lead = tuple(support_label.shape[:-2])
        boxes0, valid0 = masks_to_boxes((support_label == 1).float().reshape(
            (-1,) + tuple(support_label.shape[-2:])))
        return (boxes0[:, None].expand(-1, k, 4).reshape(lead + (k, 4)),
                valid0[:, None].expand(-1, k).reshape(lead + (k,)))

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

    def _draws(self, generator, kind: str, count: int, hw):
        """``sample_draws`` of one group, or of stacked groups from their
        generators (a list, one a group, each drawing what its group would
        alone): the uniforms gain the object axis after the step axis
        (``[count, O, ...]``), the augmentation draws are a list."""
        if not isinstance(generator, (list, tuple)):
            return self.sample_draws(generator, kind, count, hw)
        per = [self.sample_draws(g, kind, count, hw) for g in generator]
        if kind == "frames":
            return torch.stack(per, 1)
        if kind == "refit":
            return TrainDraws(*(torch.stack(f, 1) for f in zip(*per)))
        augs, trains = zip(*per)
        return list(augs), TrainDraws(*(torch.stack(f, 1)
                                        for f in zip(*trains)))

    # -- fine-tune --------------------------------------------------------------

    def _detection_loss(self, params, imgs: torch.Tensor, labels: torch.Tensor,
                        draws: TrainDraws) -> torch.Tensor:
        """Total Mask R-CNN training loss of raw images ``[B, H, W, 3]`` with
        one object each (labels ``[B, H, W]`` in {0, 1, 255}); stacked
        groups: labels ``[O, B, H, W]``, images shared or ``[O, B, H, W,
        3]``, one total an object."""
        imgs = transforms.normalize(imgs, self.cfg.normalize_mode)
        gt_masks = torch.where(labels == 255, 255.0,
                               labels.float()).unsqueeze(-3)
        gt_valid = (gt_masks == 1).any(dim=(-2, -1))
        objects = labels.shape[0] if labels.dim() == 4 else 0
        total, _ = self._apply(objects)(params, imgs, gt_masks, gt_valid,
                                        train=True, draws=draws)
        return total

    def _loss_fn(self, params, batch) -> torch.Tensor:
        img, label, aug, draws = batch
        if label.dim() == 2:
            imgs, labels = transforms.augment_support_batch(
                img.float(), label, aug, self.cfg.augment)
        else:  # each group's own augmented copies
            pairs = [transforms.augment_support_batch(
                img.float(), lab, a, self.cfg.augment)
                for lab, a in zip(label, aug)]
            imgs = torch.stack([im for im, _ in pairs])
            labels = torch.stack([lab for _, lab in pairs])
        return self._detection_loss(params, imgs, labels, draws)

    def _fine_tune(self, meta_params: MetaParams, generator, img: torch.Tensor,
                   label: torch.Tensor, init_params):
        """``num_epochs`` learned-SGD steps, each on a fresh augmentation
        batch of the support frame → (params, per-step losses)."""
        cfg = self.cfg
        with tracing.span("fine_tune"):
            aug, draws = self._draws(generator, "fine_tune", cfg.num_epochs,
                                     tuple(img.shape[:2]))
            batches = [(img, label, [a.select(i) for a in aug]
                        if isinstance(aug, list) else aug.select(i),
                        draws.select(i)) for i in range(cfg.num_epochs)]
            return fine_tune(self.meta_cfg, self._loss_fn, meta_params,
                             batches, init_params=init_params,
                             early_stop_patience=cfg.early_stop_patience)

    def _ona_loss_fn(self, params, batch) -> torch.Tensor:
        """The un-augmented support frame plus the pseudo-GT frames."""
        img, label, prop_imgs, prop_labels, draws = batch
        imgs = torch.cat([img.float()[None], prop_imgs.float()], 0)
        labels = torch.cat([label.unsqueeze(-3).to(prop_labels.dtype),
                            prop_labels], -3)
        return self._detection_loss(params, imgs, labels, draws)

    def _ona_meta_params(self, meta_params: MetaParams) -> MetaParams:
        """The refits' lrs: with ``ona_only_box_head``, those of the box
        and mask heads alone. The JAX package masks the other lrs to zero
        (``mask_lrs_by_path``) and stops their gradient; a refit over the
        heads' lrs alone leaves the other parameters as they are and takes
        no gradient of the backbone, FPN or RPN."""
        if not self.cfg.ona_only_box_head:
            return meta_params
        return meta_params._replace(log_init_lr=select_lrs_by_path(
            meta_params.log_init_lr, ONA_HEADS))

    def _ona_fine_tune(self, meta_params: MetaParams, generator, img, label,
                       prop_imgs, prop_labels, params):
        """``online_adapt_epochs`` steps on the support frame and the
        pseudo-GT frames, continuing from ``params`` (updated in place) or,
        with ``ona_reset_mode="FULL"``, from the learned init."""
        cfg = self.cfg
        n = cfg.online_adapt_epochs
        with tracing.span("refit"):
            draws = self._draws(generator, "refit", n, tuple(img.shape[:2]))
            batches = [(img, label, prop_imgs, prop_labels, draws.select(i))
                       for i in range(n)]
            return fine_tune(self.meta_cfg, self._ona_loss_fn,
                             self._ona_meta_params(meta_params),
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
        device. Stacked groups (boxes ``[O, K, 4]``) give each result a
        leading O, and each keeps its own carry."""
        cfg = self.cfg
        objects = init_boxes.shape[0] if init_boxes.dim() == 3 else 0
        apply = self._apply(objects)
        prev_boxes, prev_valid = init_boxes, init_valid
        probs, det_boxes, det_valid = [], [], []
        for t in range(frames.shape[0]):
            img = transforms.normalize(frames[t].float(), cfg.normalize_mode)
            det = apply(params, img[None], prev_boxes=prev_boxes.unsqueeze(-3),
                        prev_valid=prev_valid.unsqueeze(-2),
                        proposal_aug_mode=cfg.proposal_aug_mode,
                        draws=jitter_u[t])
            masks = det.masks.select(-4, 0)  # [(O,) K, H, W]
            valid = det.valid.select(-2, 0)
            probs.append(masks.amax(-3))
            det_boxes.append(det.boxes.select(-3, 0))
            det_valid.append(valid)
            # the next frame's boxes from the predicted masks; with no
            # detection left, the previous boxes carry on (per object)
            new_boxes, new_valid = masks_to_boxes(
                (masks >= cfg.box_from_mask_thresh).float().reshape(
                    (-1,) + tuple(masks.shape[-2:])))
            new_boxes = new_boxes.view(prev_boxes.shape)
            new_valid = new_valid.view(valid.shape) & valid
            keep_prev = ~new_valid.any(-1)
            prev_boxes = torch.where(keep_prev[..., None, None], prev_boxes,
                                     new_boxes)
            prev_valid = torch.where(keep_prev[..., None], prev_valid,
                                     new_valid)
        return (torch.stack(probs, -3), torch.stack(det_boxes, -3),
                torch.stack(det_valid, -2), prev_boxes, prev_valid)

    def _propagate(self, meta_params, generator, support_img,
                   support_label, rest: torch.Tensor, params, boxes, valid,
                   orig_hw, fused: bool) -> torch.Tensor:
        """The frames after the support frame, ``rest [R, H, W, 3]``, in
        windows of ``online_adapt_step`` (all R in one window without
        online adaptation), with a refit after every window but the last.
        The host loop ends on a ragged tail window; the fused loop
        (``fused``) pads it by replicating the last frame, and pads the
        window count to ``ona_window_bucket``. Returns the probabilities
        ``[R, H, W]`` (stacked groups: ``[O, R, H, W]``)."""
        with tracing.span("propagate"):
            cfg = self.cfg
            R = rest.shape[0]
            ona = cfg.online_adapt_step > 0
            step = cfg.online_adapt_step if ona else R
            if fused:
                windows = stack_windows(rest, step,
                                        cfg.ona_window_bucket if ona else 0)[0]
            else:
                windows = rest.split(step)
            wn_real = -(-R // step)
            kk = min(step, cfg.batch_size)
            hw = tuple(rest.shape[1:3])
            out = []
            for i, window in enumerate(windows):
                with tracing.span("segment"):
                    jitter_u = self._draws(generator, "frames", len(window),
                                           hw)
                    w_probs, _, _, boxes, valid = self._segment_window(
                        params, window, boxes, valid, jitter_u)
                out.append(w_probs)
                if ona and i < wn_real - 1:
                    with tracing.span("pseudo_gt"):
                        pseudo = build_pseudo_gt(w_probs[..., -kk:, :, :],
                                                 cfg.online_adapt_min_prop,
                                                 orig_hw)
                    params = self._ona_fine_tune(
                        meta_params, generator, support_img, support_label,
                        window[-kk:], pseudo, params)
            return torch.cat(out, -3)[..., :R, :, :]

    def _eval_object_group(self, index, seq, frames: torch.Tensor, group,
                           meta_params: MetaParams,
                           generator: torch.Generator, init_params,
                           orig_hw=None,
                           support_img: Optional[torch.Tensor] = None,
                           fused: Optional[bool] = None) -> torch.Tensor:
        """``[T, H, W]`` foreground probability of one object group.
        ``frames`` is the raw ``[T, H, W, 3]`` stack on the evaluator's
        device; ``generator`` gives every draw (``sample_draws``); ``fused``
        picks the window loop (default: the evaluator's)."""
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
            probs[sf + 1:] = self._propagate(
                meta_params, generator, support_img, support_label,
                frames[sf + 1:], params, boxes, valid, orig_hw,
                self.fused_ona if fused is None else fused)
        self._phase_done("propagate")
        return probs

    def _batched(self, groups) -> bool:
        """Whether the groups run together: more than one, one support
        frame, ``batch_objects`` (the JAX package's rule)."""
        return (self.batch_objects and len(groups) > 1
                and len({g.support_frame for g in groups}) == 1)

    def _eval_objects_batched(self, index, seq, frames: torch.Tensor,
                              meta_params: MetaParams, seed: int,
                              init_params, orig_hw=None,
                              support_img: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """``[O, T, H, W]`` foreground probabilities of the object groups
        of ``seq``, which share a support frame, fine-tuned, tracked and
        refit together by the object-stacked model in the evaluator's
        window loop; group i draws from ``fold_in(seed, i)``. Under a mesh
        each rank runs its share of the padded object axis (the plain model
        for a share of one) and the shares are gathered."""
        groups = seq.object_groups
        frames = frames.to(self.device)
        T = frames.shape[0]
        hw = tuple(frames.shape[1:3])
        sf = groups[0].support_frame
        if support_img is None:
            support_img = frames[sf]
        objects = len(groups)
        n_pad, rows = padded_rows(self.mesh, objects)
        labels = pad_rows(self._support_label(index, seq, list(groups), hw),
                          n_pad)[rows]
        mine = labels.shape[0]
        gens = object_generators(seed, mine, first=rows.start)
        if mine == 1:  # one object: the plain model
            labels, gens = labels[0], gens[0]
            meta, init = meta_params, init_params
        else:
            _, meta, init = stack_for_objects(self.model_apply, self.meta_cfg,
                                              meta_params, init_params, mine)
        params, _ = self._fine_tune(meta, gens, support_img, labels, init)
        self._phase_done("fine_tune")

        probs = torch.zeros(tuple(labels.shape[:-2]) + (T,) + hw,
                            dtype=torch.float32, device=self.device)
        probs[..., sf, :, :] = (labels == 1).float()
        if sf + 1 < T:
            boxes, valid = self._initial_boxes(labels)
            probs[..., sf + 1:, :, :] = self._propagate(
                meta, gens, support_img, labels, frames[sf + 1:], params,
                boxes, valid, orig_hw, self.fused_ona)
        self._phase_done("propagate")
        probs = probs.reshape((mine, T) + hw)
        return gather_rows(self.mesh, probs, n_pad, rows)[:objects]

    # -- sequences ----------------------------------------------------------

    def eval_sequence(self, index, seq_name: str, meta_params: MetaParams,
                      seed: int, init_params=None) -> Dict[str, Any]:
        """Fine-tune and track every object group of one sequence, group gi
        on the seed ``fold_in(seed, gi)``, then merge and score. Groups that
        share a support frame run together with ``batch_objects``, else in
        turn. Returns the merged uint8 labels ``[T, H, W]`` on the host, the
        probabilities ``[O, T, H, W]`` as a device tensor, and the J/F
        means per object and over objects."""
        seq = index.sequences[seq_name]
        groups = seq.object_groups
        with tracing.span("sequence"):
            with tracing.span("stage"):
                frames, support, (T, h0, w0) = stage_sequence(
                    index, seq_name, self.device, self.cfg.pad_multiple)
            if self._batched(groups):
                probs = self._eval_objects_batched(
                    index, seq, frames, meta_params, seed, init_params,
                    orig_hw=(h0, w0),
                    support_img=support[groups[0].support_frame])
            else:
                probs = torch.stack([
                    self._eval_object_group(
                        index, seq, frames, g, meta_params,
                        _generator(fold_in(seed, gi)), init_params,
                        orig_hw=(h0, w0),
                        support_img=support[g.support_frame])
                    for gi, g in enumerate(groups)])
            res = self._score(index, seq_name, seq, probs[..., :h0, :w0])
            self._phase_done("score")
        return res

    def eval_stream(self, index, seq_names, meta_params: MetaParams,
                    seed: int, init_params=None) -> Dict[str, np.ndarray]:
        """One-shot tracking of many sequences (serving), one object group
        a sequence, as in the JAX package: every sequence's fine-tune and
        window loop are issued before any result is fetched, and only
        packed masks come back, drained in order.

        Sequence i tracks its first object group on the seed
        ``fold_in(fold_in(seed, i), 0)``, in the fused loop with online
        adaptation and as one window without, so its row equals the first
        group's mask of ``eval_sequence(fold_in(seed, i))`` with the groups
        in turn and ``fused_ona=True``. Returns ``{name: uint8 [T, H, W]}``
        {0, 1} masks of that group: the support row from the GT, the frames
        before it 0."""
        with tracing.span("stream"):
            return self._eval_stream(index, seq_names, meta_params, seed,
                                     init_params)

    def _eval_stream(self, index, seq_names, meta_params: MetaParams,
                     seed: int, init_params) -> Dict[str, np.ndarray]:
        pend = []
        for i, name in enumerate(seq_names):
            seq = index.sequences[name]
            group = seq.object_groups[0]
            sf = group.support_frame
            with tracing.span("stage"):
                frames, support, (T, h0, w0) = stage_sequence(
                    index, name, self.device, self.cfg.pad_multiple)
            gt_bin = binarize_label(index.get_label(name, sf),
                                    group.object_ids)
            probs = self._eval_object_group(
                index, seq, frames, group, meta_params,
                _generator(fold_in(fold_in(seed, i), 0)), init_params,
                orig_hw=(h0, w0), support_img=support[sf], fused=True)
            packed = (pack_mask_bits(probs[sf + 1:, :h0, :w0]
                                     >= self.cfg.threshold)
                      if sf + 1 < T else None)
            pend.append((name, sf, gt_bin, packed, (T, h0, w0)))
        out = {}
        for name, sf, gt_bin, packed, (T, h0, w0) in pend:
            mask = np.zeros((T, h0, w0), np.uint8)
            mask[sf] = gt_bin == 1
            if packed is not None:
                with tracing.span("score"):
                    mask[sf + 1:] = unpack_mask_bits(packed.cpu().numpy(),
                                                     w0)
            out[name] = mask
        return out

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
        with tracing.span("score"):
            merged = merge_objects(probs, self.cfg.threshold)
            j_means, f_means, _ = score_merged_device(index, seq_name, seq,
                                                      merged)
            merged = _merged_to_host(merged, len(seq.object_groups))
        return {
            "seq": seq_name,
            "merged": merged,
            "probs": probs,
            "J_per_object": j_means,
            "F_per_object": f_means,
            "J_mean": _nanmean(j_means),
            "F_mean": _nanmean(f_means),
        }
