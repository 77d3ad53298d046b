"""Mask R-CNN configurations: the port's ``DetectionOneShotEvaluator`` as
the system under test (one object group a sequence, one detection a
frame), and the plain reference's Mask R-CNN (``plainref``) to judge what
it produced.

The reference follows the program from the program's own state, as for
DeepLab (``families/deeplabv3plus.py``), and also takes each frame's
tracking prior from the program's output: the box carried into frame t is
the box of the program's mask of frame t - 1 (``>= 0.5``), or the carry
before it where that mask is empty, starting from the support label's box
(with one detection a frame the program's probability map is its one
detection's mask, zero where the detection is not kept). It works out
again every random number of the path from the sequence's seed, along
the port's schedule (``sample_draws`` on the object's CPU generator
seeded ``fold_in(seed, 0)``): the fine-tune's anchor and box sampling
uniforms, then its augmentation draws, then for each window of the fused
loop the tracking prior's jitter uniforms and, but after the last real
window, the refit's sampling uniforms.
"""

from __future__ import annotations

import types
from typing import Dict, Tuple

import numpy as np
import torch

from harness.seeds import fold_in
from families.deeplabv3plus import (
    SeqInputs,
    _dtype,
    learned_sgd_delta,
    passes as _passes,
    windows,
)

HOOK = [("e_osvos_torch.engine.one_shot_detection", "fine_tune")]

# anchor and RoI sampling, proposal top-k and NMS decide on thresholds and
# near-ties, and rounding can flip one of them in a training step (one step
# in 3 of 16 seeds on the card, PERF.md): the comparison reads the median
# over the checked steps
STEP_STATISTIC = "median"
# a frame's proposal top-k, Fast NMS and detection pick turn on near-ties
# as well, and a flip moves that frame's mask (one frame reads up to 0.09
# where the others read 1e-3, PERF.md): the median over the frames is read
FRAME_STATISTIC = "median"

passes = _passes


# -- the system under test ----------------------------------------------------


def build_model(cfg: dict, device):
    from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig

    m = cfg["model"]
    return MaskRCNN(arch=m["arch"], backbone_norm=m["backbone_norm"],
                    dtype=_dtype(m["dtype"]), rpn=RPNConfig(**m["rpn"]),
                    roi=RoIConfig(**m["roi"]), seed=0, device=device)


def build_evaluator(cfg: dict, model, device, num_epochs: int = None):
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import (
        DetectionOneShotConfig, DetectionOneShotEvaluator,
    )
    from e_osvos_torch.meta_optim import MetaOptimConfig

    one = dict(cfg["one_shot"])
    if num_epochs is not None:
        one["num_epochs"] = num_epochs
    dcfg = DetectionOneShotConfig(augment=AugmentConfig(**cfg["augment"]),
                                  **one)
    return DetectionOneShotEvaluator(model, MetaOptimConfig(
        **cfg["meta_optim"]), dcfg, device=device,
        fused_ona=cfg["fused_ona"], batch_objects=True)


def expected_launches(cfg: dict, frames: int, n_gn: int, per_call: dict,
                      objects: int) -> Dict[str, int]:
    """Kernel launches one 1-object sequence implies in the fused loop
    (``chip_smoke.expected_detection_launches``): the backbone GroupNorms
    a training step and an inferred frame (padded tail included), K3 a
    frame in the detection head on route S, and with the greedy RPN once
    a forward on route L."""
    one = cfg["one_shot"]
    step = one["online_adapt_step"]
    wins = -(-(frames - 1) // step)
    steps = one["num_epochs"] + (wins - 1) * one["online_adapt_epochs"]
    inferred = wins * step
    calls = {"group_stats": steps + inferred, "affine_apply": steps + inferred,
             "group_grad_coeffs": steps, "affine_dx": steps}
    want = {k: v * n_gn * per_call[k] for k, v in calls.items()}
    rpn = 0 if cfg["model"]["rpn"]["use_fast_nms"] else steps + inferred
    want.update(greedy_nms=inferred + rpn, greedy_nms_s=inferred,
                greedy_nms_l=rpn)
    return want


def flop_passes(cfg: dict, frames: int, objects: int):
    one = cfg["one_shot"]
    wins = windows(cfg, frames)
    refit_batch = 1 + min(one["online_adapt_step"], one["batch_size"])
    return [("train", one["batch_size"], one["num_epochs"]),
            ("train", refit_batch,
             (len(wins) - 1) * one["online_adapt_epochs"]),
            ("infer", 1, len(wins) * one["online_adapt_step"])]


# -- the reference ------------------------------------------------------------


def carried_boxes(program_probs: np.ndarray, support_label: np.ndarray,
                  thresh: float) -> Tuple[np.ndarray, np.ndarray]:
    """The box and validity ``[T, 4]``, ``[T]`` carried into each frame t
    (row 0 unused): the box of the program's mask of frame t - 1, or the
    carry before it where that mask is empty; frame 1 gets the support
    label's box."""
    T = program_probs.shape[0]
    boxes, valid = np.zeros((T, 4), np.float32), np.zeros((T,), bool)

    def box(mask):
        ys, xs = np.nonzero(mask)
        if ys.size == 0:
            return None
        return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                        np.float32)

    carry = box(support_label == 1)
    carry_ok = carry is not None
    if carry is None:
        carry = np.zeros(4, np.float32)
    for t in range(1, T):
        boxes[t], valid[t] = carry, carry_ok
        new = box(program_probs[t] >= thresh)
        if new is not None:
            carry, carry_ok = new, True
    return boxes, valid


class Reference:
    """The plain Mask R-CNN at ``mode`` ``"reference"`` (float32, TF32 off)
    or ``"control"`` (the configuration's ``control`` block)."""

    def __init__(self, cfg: dict, objects: int, device, mode: str):
        from plainref import deeplab, mask_rcnn, oneshot, resnet, rpn
        from plainref import transforms

        if objects != 1:
            raise ValueError("the Mask R-CNN reference tracks one object")
        self.cfg, self.objects, self.device = cfg, objects, device
        low = cfg["control"] if mode == "control" else {
            "model_dtype": "float32", "operand_dtype": None,
            "augment_compute_dtype": "float32", "tf32": False}
        self.tf32 = bool(low["tf32"])
        m = cfg["model"]
        self.model = mask_rcnn.MaskRCNN(
            arch=m["arch"], backbone_norm=m["backbone_norm"],
            dtype=_dtype(low["model_dtype"]), rpn=rpn.RPNConfig(**m["rpn"]),
            roi=mask_rcnn.RoIConfig(**m["roi"]), device=device)
        operand = low["operand_dtype"]
        for mod in self.model.modules():
            if isinstance(mod, (resnet.Conv, resnet.Dense,
                                resnet.ConvTranspose)):
                mod.operand_dtype = None if operand is None \
                    else _dtype(operand)
        self.apply = deeplab.functional_apply(self.model)
        self.TrainDraws = mask_rcnn.TrainDraws
        aug = dict(cfg["augment"],
                   compute_dtype=low["augment_compute_dtype"])
        one = cfg["one_shot"]
        self.oscfg = types.SimpleNamespace(
            normalize_mode="davis", augment=transforms.AugmentConfig(**aug),
            proposal_aug_mode=one["proposal_aug_mode"])
        self.transforms = transforms
        self.oneshot = oneshot
        self.replayed = None

    def module(self):
        return self.model

    def replay(self, seq: SeqInputs, ft_steps, refit_steps) -> None:
        """Every draw of the sequence's object, along the port's schedule;
        keeps the fine-tune steps ``ft_steps``, the refit steps
        ``refit_steps`` (``(call, step)``) and every frame's jitter
        uniforms."""
        one = self.cfg["one_shot"]
        gen = torch.Generator(device="cpu").manual_seed(fold_in(seq.seed, 0))
        hw = tuple(seq.frames.shape[1:3])

        def uniforms(count, shape):
            return torch.rand((count,) + tuple(shape), generator=gen)

        n_ft, batch = one["num_epochs"], one["batch_size"]
        train = [uniforms(n_ft, s) for s in
                 self.model.draw_shapes(hw, batch, num_objects=1)]
        ft = {k: self.TrainDraws(*(t[k] for t in train)) for k in ft_steps}
        del train
        aug = self.transforms.sample_augment_draws(gen, self.oscfg.augment,
                                                   (n_ft, batch))
        step = one["online_adapt_step"]
        wins = windows(self.cfg, seq.frames.shape[0])
        refit_batch = 1 + min(step, batch)
        (jshape,) = self.model.draw_shapes(hw, 1, train=False)
        jitter, refit = [], {}
        for i in range(len(wins)):
            jitter.append(uniforms(step, jshape))
            if i < len(wins) - 1:
                fields = [uniforms(one["online_adapt_epochs"], s) for s in
                          self.model.draw_shapes(hw, refit_batch,
                                                 num_objects=1)]
                for c, s in refit_steps:
                    if c == i + 1:
                        refit[c, s] = self.TrainDraws(*(t[s] for t in fields))
        self.replayed = {"ft": ft, "aug": aug, "jitter": jitter,
                         "refit": refit}

    def fine_tune_step(self, theta, lrs, seq: SeqInputs, k: int):
        img, label = seq.support()
        draws = self.replayed["ft"][k].to(self.device)
        aug = self.replayed["aug"].select(k).to(self.device)

        def loss_fn(params, batch):
            return self.oneshot.detection_support_loss(
                self.apply, self.oscfg, params, batch)

        return learned_sgd_delta(loss_fn, theta, lrs,
                                 (img, label, aug, draws))

    def refit_step(self, theta, lrs, seq: SeqInputs, c: int, s: int,
                   program_probs: np.ndarray):
        one = self.cfg["one_shot"]
        start, stop = windows(self.cfg, seq.frames.shape[0])[c - 1]
        k = min(one["online_adapt_step"], one["batch_size"])
        probs = torch.from_numpy(program_probs[0, stop - k:stop]).to(
            self.device)
        pseudo = self.oneshot.build_pseudo_gt(
            probs, one["online_adapt_min_prop"], tuple(probs.shape[-2:]))
        frames = seq.window_frames(start, stop, one["online_adapt_step"])
        img, label = seq.support()
        draws = self.replayed["refit"][c, s].to(self.device)

        def loss_fn(params, batch):
            return self.oneshot.detection_pseudo_gt_loss(
                self.apply, self.oscfg, params, batch)

        return learned_sgd_delta(loss_fn, theta, lrs,
                                 (img, label, frames[-k:], pseudo, draws))

    @torch.no_grad()
    def window_probs(self, theta, seq: SeqInputs, c: int,
                     program_probs: np.ndarray) -> torch.Tensor:
        start, stop = windows(self.cfg, seq.frames.shape[0])[c]
        n = stop - start
        boxes, valid = carried_boxes(
            program_probs[0], (seq.labels[0] == 1),
            self.cfg["one_shot"].get("box_from_mask_thresh", 0.5))
        k = self.model.roi.detections_per_img
        prev = torch.from_numpy(boxes[start:stop]).to(self.device)
        prev_ok = torch.from_numpy(valid[start:stop]).to(self.device)
        frames = torch.from_numpy(seq.frames[start:stop]).to(self.device)
        imgs = self.transforms.normalize(frames.float(), "davis")
        jitter = self.replayed["jitter"][c][:n, 0].to(self.device)
        det = self.apply(theta, imgs,
                         prev_boxes=prev[:, None].expand(n, k, 4),
                         prev_valid=prev_ok[:, None].expand(n, k),
                         proposal_aug_mode=self.oscfg.proposal_aug_mode,
                         draws=jitter)
        return det.masks.float().amax(1)[None]  # [1, n, H, W]
