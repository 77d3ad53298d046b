"""One-shot fine-tune + propagate evaluation, port of
``e_osvos_tpu/engine/one_shot.py``.

For each object group of a sequence: reset to the learned init, fine-tune on
augmented copies of the support frame, then walk the rest of the sequence in
windows of ``online_adapt_step`` frames. Each window is segmented; its last
``min(step, batch_size)`` predictions become pseudo ground truth
(prob ≥ min_prop → 1, ≤ 1 − min_prop → 0, else 255), and the model is refit
on the un-augmented support frame plus those frames. Objects are merged per
pixel by argmax over their probability maps with a background plane at the
threshold, and the merged map is scored (J and F) on the device.

Two window loops, as in the JAX package: the host loop (``fused_ona=False``,
the default) ends on a ragged tail window and refits while frames remain;
the fused formulation (``propagate_windows``, ``fused_ona=True``) pads the
tail window by replicating the last real frame and refits before every
window but the last real one. The probabilities agree to rounding.

Objects run in turn, each through the single-group fine-tune and window
loop; the JAX package's ``batch_objects`` (objects as a ``vmap`` axis) has
no counterpart yet. Object i draws from the seed ``fold_in(seed, i)``, the
schedule of the JAX package's ``jax.random.fold_in(key, i)``, on a CPU
generator, so the draws are the same whatever the device.

Public layouts are the JAX ones: frames ``[T, H, W, 3]`` raw 0..255, labels
``[H, W]`` in {0, 1, 255}, probabilities ``[T, H, W]`` (``[O, T, H, W]`` for
a sequence), merged label maps int32 on the device and uint8 on the host,
packed masks uint8 ``[T, H, ceil(W/8)]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from e_osvos_torch.data import transforms
from e_osvos_torch.data.datasets import binarize_label
from e_osvos_torch.data.loader import load_frames
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams, fine_tune
from e_osvos_torch.ops import losses as loss_ops
from e_osvos_torch.ops import metrics as metric_ops
from e_osvos_torch.ops.bits import pack_mask_bits, unpack_mask_bits
from e_osvos_torch.utils.device import resolve_device, upload
from e_osvos_torch.utils.seeds import fold_in

Params = Any


@dataclasses.dataclass(frozen=True)
class OneShotConfig:
    """Evaluation configuration: ``num_epochs`` fine-tune steps on
    ``batch_size`` augmented support copies, online adaptation every
    ``online_adapt_step`` frames (0 = off) for ``online_adapt_epochs``
    steps with pseudo-GT confidence ``online_adapt_min_prop``, the loss,
    the early-stop patience (0 = off) and the mask threshold.

    ``ona_window_bucket`` > 0 pads the fused loop's window count up to a
    multiple of it (replicated windows, no refit past the real ones);
    cropped outputs are the same. ``pad_multiple`` > 0 zero-pads frames to
    the next multiple of it (the resolution bucket); scoring runs on the
    original geometry."""

    num_epochs: int = 10
    batch_size: int = 3
    loss_func: str = "dice"
    early_stop_patience: int = 0
    online_adapt_step: int = 0
    online_adapt_epochs: int = 10
    online_adapt_min_prop: float = 0.75
    threshold: float = 0.5
    normalize_mode: str = "davis"
    ona_window_bucket: int = 0
    pad_multiple: int = 0
    augment: transforms.AugmentConfig = dataclasses.field(
        default_factory=transforms.AugmentConfig)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


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


def stack_windows(frames_rest: torch.Tensor, step: int, bucket: int = 0
                  ) -> Tuple[torch.Tensor, int, int]:
    """``[R, H, W, 3]`` → ``[Wn, step, H, W, 3]``, the tail padded by
    replicating the last real frame. ``bucket`` > 0 pads the window count
    up to a multiple of it with whole replicated windows. Returns
    ``(windows, R, wn_real)``, ``wn_real`` the count before bucketing."""
    r = frames_rest.shape[0]
    wn_real = -(-r // step)
    wn = -(-wn_real // bucket) * bucket if bucket else wn_real
    pad = wn * step - r
    if pad:
        tail = frames_rest[-1:].expand((pad,) + tuple(frames_rest.shape[1:]))
        frames_rest = torch.cat([frames_rest, tail], 0)
    return (frames_rest.reshape((wn, step) + tuple(frames_rest.shape[1:])),
            r, wn_real)


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


def one_shot_packed(model_apply: Callable, meta_cfg: MetaOptimConfig,
                    cfg: OneShotConfig, meta_params: MetaParams,
                    generator: torch.Generator, support_img: torch.Tensor,
                    support_label: torch.Tensor, frames: torch.Tensor,
                    init_params: Params = None) -> torch.Tensor:
    """e-OSVOS serving without online adaptation: fine-tune → segment
    ``frames`` → threshold → bit-pack. Returns uint8 ``[T, H, ceil(W/8)]``
    for the frames given."""
    params, _ = fine_tune_on_support(model_apply, meta_cfg, cfg, meta_params,
                                     generator, support_img, support_label,
                                     init_params)
    probs = segment_frames(model_apply, cfg, params, frames)
    return pack_mask_bits(probs >= cfg.threshold)


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


def _fine_tune_objects(model_apply: Callable, meta_cfg: MetaOptimConfig,
                       cfg: OneShotConfig, meta_params: MetaParams, seed: int,
                       support_img: torch.Tensor, labels: torch.Tensor,
                       init_params: Params) -> Iterator[Params]:
    """Each object's fine-tuned params in turn, object i (label
    ``labels[i]``) drawing from ``fold_in(seed, i)``: the schedule of the
    per-object evaluation, so stream results equal ``eval_sequence``'s.
    Yields, so one object's params can be dropped before the next
    fine-tune."""
    for i in range(labels.shape[0]):
        yield fine_tune_on_support(model_apply, meta_cfg, cfg, meta_params,
                                   _generator(fold_in(seed, i)), support_img,
                                   labels[i], init_params)[0]


def merge_objects(probs: torch.Tensor, threshold: float = 0.5
                  ) -> torch.Tensor:
    """Per-pixel argmax over object probability maps ``[O, ...]`` with a
    background plane at ``threshold`` → int32 label map (0 = background,
    k+1 = object k; ties go to the lower label)."""
    bg = torch.full((1,) + tuple(probs.shape[1:]), threshold,
                    dtype=probs.dtype, device=probs.device)
    return torch.cat([bg, probs], 0).argmax(0).to(torch.int32)


def _pack_merged_planes(merged: torch.Tensor, num_objects: int
                        ) -> torch.Tensor:
    """``[T, H, W]`` merged labels → uint8 ``[O, T, H, ceil(W/8)]`` bit
    planes, plane o being ``merged == o+1``. The planes are disjoint, so the
    host rebuilds the label map exactly from O/8 bytes a pixel."""
    ids = torch.arange(1, num_objects + 1, dtype=merged.dtype,
                       device=merged.device)
    return pack_mask_bits(merged[None] == ids[:, None, None, None])


def _planes_to_labels(planes: np.ndarray) -> np.ndarray:
    """Disjoint ``{0, 1}`` planes ``[O, ...]`` → uint8 label map (plane o →
    o+1). Unpacked planes are uint8: cast to bool, or the indexing below
    becomes integer indexing and writes the wrong pixels."""
    planes = planes.astype(bool)
    labels = np.zeros(planes.shape[1:], np.uint8)
    for o in range(planes.shape[0]):
        labels[planes[o]] = o + 1
    return labels


def _merged_to_host(merged: torch.Tensor, num_objects: int) -> np.ndarray:
    """A merged label map on the host as uint8, carried as packed planes."""
    packed = _pack_merged_planes(merged, num_objects).cpu().numpy()
    return _planes_to_labels(unpack_mask_bits(packed, merged.shape[-1]))


def one_shot_packed_objects(model_apply: Callable, meta_cfg: MetaOptimConfig,
                            cfg: OneShotConfig, meta_params: MetaParams,
                            seed: int, support_img: torch.Tensor,
                            labels: torch.Tensor, frames: torch.Tensor,
                            init_params: Params = None) -> torch.Tensor:
    """Multi-object serving without online adaptation: each object
    fine-tuned and ``frames`` segmented in turn, argmax merge, per-object
    bit planes. ``labels [O, H, W]`` in {0, 1, 255}. Returns uint8
    ``[O, T, H, ceil(W/8)]`` for the frames given."""
    probs = torch.stack([
        segment_frames(model_apply, cfg, params, frames)
        for params in _fine_tune_objects(
            model_apply, meta_cfg, cfg, meta_params, seed, support_img,
            labels, init_params)])
    return _pack_merged_planes(merge_objects(probs, cfg.threshold),
                               labels.shape[0])


def one_shot_packed_objects_ona(model_apply: Callable,
                                meta_cfg: MetaOptimConfig, cfg: OneShotConfig,
                                orig_hw, meta_params: MetaParams, seed: int,
                                support_img: torch.Tensor,
                                labels: torch.Tensor, windows: torch.Tensor,
                                wn_real: int, init_params: Params = None
                                ) -> torch.Tensor:
    """Multi-object OnA serving: each object fine-tuned and propagated
    through the fused windows in turn, argmax merge, per-object bit planes.
    Returns uint8 ``[O, Wn*step, H, ceil(W/8)]`` for the frames after the
    shared support frame."""
    w_flat = torch.stack([
        propagate_windows(model_apply, meta_cfg, cfg, orig_hw, meta_params,
                          support_img, labels[i], windows, params,
                          wn_real)[0]
        for i, params in enumerate(_fine_tune_objects(
            model_apply, meta_cfg, cfg, meta_params, seed, support_img,
            labels, init_params))])
    return _pack_merged_planes(merge_objects(w_flat, cfg.threshold),
                               labels.shape[0])


def build_gt_stack(index, seq_name: str, seq, T: int, hw):
    """Host-side GT for device scoring (``metrics.sequence_scores``): the
    raw id maps stacked uint8 ``[T, h, w]`` (255 for frame 0 and for frames
    without annotation), the per-frame annotated flags, and each group's
    object ids ``[O, M]`` int32, padded with -1."""
    gt_stack = np.full((T,) + tuple(hw), 255, np.uint8)
    has_gt = np.zeros((T,), bool)
    for t in range(1, T):
        gt = index.get_label(seq_name, t)
        if gt is None:
            continue
        gt_stack[t] = gt
        has_gt[t] = True
    n_ids = max(1, max((len(g.object_ids) for g in seq.object_groups),
                       default=1))
    ids = np.full((len(seq.object_groups), n_ids), -1, np.int32)
    for gi, g in enumerate(seq.object_groups):
        ids[gi, :len(g.object_ids)] = g.object_ids
    return gt_stack, has_gt, ids


def score_merged_device(index, seq_name: str, seq, merged: torch.Tensor):
    """Per-object J/F means of a merged label map, scored on the merged
    map's device; only the ``[O, T]`` J and F cross to the host. Frames 1 to
    T-1 with annotations count. Returns ``(j_means, f_means, has_gt)``."""
    T = merged.shape[0]
    gt_stack, has_gt, ids = build_gt_stack(index, seq_name, seq, T,
                                           merged.shape[1:])
    J, F = metric_ops.sequence_scores(
        merged, upload(gt_stack, merged.device), upload(ids, merged.device))
    J, F = J.cpu().numpy(), F.cpu().numpy()
    groups = range(len(seq.object_groups))
    if not has_gt.any():
        nan = [float("nan")] * len(groups)
        return nan, list(nan), has_gt
    j_means = [float(np.mean(J[gi, has_gt])) for gi in groups]
    f_means = [float(np.mean(F[gi, has_gt])) for gi in groups]
    return j_means, f_means, has_gt


def _pad_frame_np(img: np.ndarray, hw) -> np.ndarray:
    """Zero-pad one ``[H, W, 3]`` host frame bottom/right to ``hw``."""
    th, tw = hw
    if img.shape[:2] == (th, tw):
        return img
    return np.pad(img, ((0, th - img.shape[0]), (0, tw - img.shape[1]),
                        (0, 0)))


def _nanmean(values: List[float]) -> float:
    return float(np.nanmean(values)) if values else float("nan")


def stage_sequence(index, seq_name: str, device: torch.device,
                   pad_multiple: int = 0):
    """A sequence's frames on ``device``, zero-padded to the resolution
    bucket of ``pad_multiple``, with each support frame uploaded first on
    its own, so a fine-tune can start while the stack streams up. Returns
    ``(frames, {support frame: image}, (T, h0, w0))``."""
    frames_np = load_frames(index, seq_name)
    T, h0, w0 = frames_np.shape[:3]
    hw_dev = (transforms.bucket_hw(h0, w0, pad_multiple) if pad_multiple
              else (h0, w0))
    support = {sf: upload(_pad_frame_np(frames_np[sf], hw_dev), device)
               for sf in {g.support_frame
                          for g in index.sequences[seq_name].object_groups}}
    frames = upload(frames_np, device)
    if pad_multiple:
        frames = transforms.pad_frames_to_multiple(frames, pad_multiple)
    return frames, support, (T, h0, w0)


class OneShotEvaluator:
    """Drives one-shot evaluation of the sequences of a dataset index.

    ``model_apply(params, imgs [B, H, W, 3]) -> logits [B, H, W, 1]``
    (``models.functional_apply``). ``device`` is where frames and labels
    live: ``cuda`` unless the caller asks for another. ``fused_ona`` picks
    the fused window loop (off by default, as in the JAX package).
    ``on_phase(name)``, when given, is called as each phase ends
    (``"fine_tune"`` and ``"propagate"`` of each object group, then
    ``"score"`` of a sequence), e.g. to record a CUDA event there; it never
    synchronizes the device."""

    def __init__(self, model_apply: Callable, meta_cfg: MetaOptimConfig,
                 cfg: OneShotConfig, device=None,
                 on_phase: Optional[Callable[[str], None]] = None,
                 fused_ona: bool = False):
        self.model_apply = model_apply
        self.meta_cfg = meta_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.on_phase = on_phase
        self.fused_ona = fused_ona and cfg.online_adapt_step > 0

    def _phase_done(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    # ---- per-sequence drivers ----

    def eval_sequence(self, index, seq_name: str, meta_params: MetaParams,
                      seed: int, init_params: Params = None
                      ) -> Dict[str, Any]:
        """Fine-tune and propagate every object group of one sequence, merge
        and score. Group gi draws from ``fold_in(seed, gi)``. Returns the
        merged uint8 labels ``[T, H, W]``, the probabilities ``[O, T, H, W]``
        and the J/F means per object and over objects."""
        seq = index.sequences[seq_name]
        groups = seq.object_groups
        frames, support, (T, h0, w0) = stage_sequence(
            index, seq_name, self.device, self.cfg.pad_multiple)
        # each group's params are dropped before the next group starts
        probs = torch.stack([
            self._eval_object_group(
                index, seq, frames, g, meta_params,
                _generator(fold_in(seed, gi)), init_params,
                orig_hw=(h0, w0), support_img=support[g.support_frame])
            for gi, g in enumerate(groups)])
        probs = probs[..., :h0, :w0]  # crop the bucket padding
        merged = merge_objects(probs, self.cfg.threshold)
        j_means, f_means, _ = score_merged_device(index, seq_name, seq, merged)
        self._phase_done("score")
        return {
            "seq": seq_name,
            "merged": _merged_to_host(merged, len(groups)),
            "probs": probs.cpu().numpy(),
            "J_per_object": j_means,
            "F_per_object": f_means,
            "J_mean": _nanmean(j_means),
            "F_mean": _nanmean(f_means),
        }

    def eval_stream(self, index, seq_names, meta_params: MetaParams,
                    seed: int, init_params: Params = None
                    ) -> Dict[str, np.ndarray]:
        """One-shot segmentation of many sequences (serving): every
        sequence's fine-tune, windows and merge are issued before any
        result is fetched, frames go up from pinned memory, and only packed
        masks (one bit plane per object) come back, drained in order.

        Sequence i runs on the seed ``fold_in(seed, i)`` along the schedule
        of ``eval_sequence``, whose fused path (``fused_ona=True``) it
        follows, so its row equals ``eval_sequence(fold_in(seed, i))``'s
        merged map. Only the frames after the support frame are segmented.
        A sequence whose groups have different support frames goes through
        ``eval_sequence``.

        Returns ``{name: uint8 [T, H, W]}`` label maps with the support row
        from the GT and the frames before it 0."""
        cfg = self.cfg
        pend: List[Tuple] = []
        for i, name in enumerate(seq_names):
            seq = index.sequences[name]
            groups = seq.object_groups
            seed_i = fold_in(seed, i)
            multi = len(groups) > 1
            if len({g.support_frame for g in groups}) > 1:
                res = self.eval_sequence(index, name, meta_params, seed_i,
                                         init_params)
                pend.append(("done", name, res["merged"]))
                continue
            frames, support, (T, h0, w0) = stage_sequence(
                index, name, self.device, cfg.pad_multiple)
            sf = groups[0].support_frame
            sup = support[sf]
            gt = index.get_label(name, sf)
            gt_bins = np.stack([binarize_label(gt, g.object_ids)
                                for g in groups])
            labels = transforms.pad_label_to(
                upload(gt_bins.astype(np.int32), self.device),
                tuple(frames.shape[1:3]))
            rest = frames[sf + 1:]
            packed = None
            if len(rest) and cfg.online_adapt_step > 0:
                windows, r, wn_real = stack_windows(
                    rest, cfg.online_adapt_step, cfg.ona_window_bucket)
                if multi:
                    packed = one_shot_packed_objects_ona(
                        self.model_apply, self.meta_cfg, cfg, (h0, w0),
                        meta_params, seed_i, sup, labels, windows, wn_real,
                        init_params)[:, :r]
                else:
                    packed = one_shot_packed_ona(
                        self.model_apply, self.meta_cfg, cfg, (h0, w0),
                        meta_params, _generator(fold_in(seed_i, 0)),
                        sup, labels[0], windows, wn_real, init_params)[:r]
            elif len(rest):
                if multi:
                    packed = one_shot_packed_objects(
                        self.model_apply, self.meta_cfg, cfg, meta_params,
                        seed_i, sup, labels, rest, init_params)
                else:
                    packed = one_shot_packed(
                        self.model_apply, self.meta_cfg, cfg, meta_params,
                        _generator(fold_in(seed_i, 0)), sup, labels[0],
                        rest, init_params)
            pend.append(("multi" if multi else "single", name,
                         (sf, gt_bins, (T, h0, w0), packed)))

        out = {}
        for tag, name, payload in pend:
            if tag == "done":
                out[name] = payload
                continue
            sf, gt_bins, (T, h0, w0), packed = payload
            mask = np.zeros((T, h0, w0), np.uint8)
            if packed is not None:
                bits = unpack_mask_bits(packed.cpu().numpy(), w0)
                if tag == "single":
                    mask[sf + 1:] = bits[:, :h0]
                else:
                    mask[sf + 1:] = _planes_to_labels(bits[:, :, :h0])
            mask[sf] = _planes_to_labels(gt_bins == 1)
            out[name] = mask
        return out

    def eval_sequence_init(self, index, seq_name: str,
                           meta_params: MetaParams, init_params: Params = None
                           ) -> Dict[str, Any]:
        """J/F of the un-fine-tuned initialization over a sequence, the
        reference's init_J baseline. Without adaptation the model cannot
        tell objects apart, so ties go to the first group."""
        seq = index.sequences[seq_name]
        frames, _, (T, h0, w0) = stage_sequence(
            index, seq_name, self.device, self.cfg.pad_multiple)
        params = (init_params if init_params is not None
                  else meta_params.model_init)
        if params is None:
            raise ValueError("eval_sequence_init needs init_params when the "
                             "meta-parameters have no learned init")
        probs = segment_frames(self.model_apply, self.cfg, params,
                               frames)[..., :h0, :w0]
        probs_o = probs[None].expand((len(seq.object_groups),)
                                     + tuple(probs.shape))
        merged = merge_objects(probs_o, self.cfg.threshold)
        j_means, f_means, _ = score_merged_device(index, seq_name, seq, merged)
        return {"seq": seq_name, "init_J_mean": _nanmean(j_means),
                "init_F_mean": _nanmean(f_means)}

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
        support_label = transforms.pad_label_to(upload(
            binarize_label(gt, group.object_ids).astype(np.int32),
            self.device), hw)

        params, _ = fine_tune_on_support(
            self.model_apply, self.meta_cfg, cfg, meta_params, generator,
            support_img, support_label, init_params)
        self._phase_done("fine_tune")

        probs = torch.zeros((T,) + hw, dtype=torch.float32,
                            device=self.device)
        # support frame gets its GT (void pixels are not foreground); frames
        # before it stay 0
        probs[sf] = (support_label == 1).float()
        if self.fused_ona and sf + 1 < T:
            windows, r, wn_real = stack_windows(
                frames[sf + 1:], cfg.online_adapt_step, cfg.ona_window_bucket)
            w_flat, _ = propagate_windows(
                self.model_apply, self.meta_cfg, cfg, orig_hw, meta_params,
                support_img, support_label, windows, params, wn_real)
            probs[sf + 1:] = w_flat[:r]
        else:
            # the host loop: windows of `step` frames (one window of the
            # rest without OnA), a ragged tail, a refit while frames remain
            ona = cfg.online_adapt_step > 0
            step = cfg.online_adapt_step if ona else T
            k = min(step, cfg.batch_size)
            refit = make_ona_refit_fn(self.model_apply, self.meta_cfg, cfg)
            for start in range(sf + 1, T, step):
                end = min(start + step, T)
                window = frames[start:end]
                w_probs = segment_frames(self.model_apply, cfg, params, window)
                probs[start:end] = w_probs
                if ona and end < T:
                    pseudo = build_pseudo_gt(
                        w_probs[-k:], cfg.online_adapt_min_prop, orig_hw)
                    params = refit(meta_params, support_img, support_label,
                                   window[-k:], pseudo, params)
        self._phase_done("propagate")
        return probs
