"""DeepLabV3+ configurations: the port's ``OneShotEvaluator`` as the
system under test, and the plain reference's DeepLabV3+ (``plainref``)
to judge what it produced.

The reference follows the program from the program's own state: each
checked step starts from the program's parameters before it, each checked
window is segmented with the parameters the program segmented it with,
and a refit's pseudo ground truth is built from the program's own
probabilities of the window before it. It works out again everything the
program derived: the augmentation draws from the sequence's seed (the
port's schedule: object i's CPU generator seeded ``fold_in(seed, i)``, one
``[num_epochs, batch_size]`` draw up front), the augmented batches, the
object-stacked model and its learning rates, the pseudo ground truth, the
losses and the learned-SGD update ``p - lr * grad``.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from harness.seeds import fold_in

HOOK = [("e_osvos_torch.engine.one_shot", "fine_tune")]

# a dense per-pixel loss and a dense inference take no discrete decision,
# so the comparison reads the largest gap over the checked steps and over
# the frames
STEP_STATISTIC = "max"
FRAME_STATISTIC = "max"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# -- the system under test ----------------------------------------------------


def build_model(cfg: dict, device):
    from e_osvos_torch.models import DeepLabV3Plus

    m = cfg["model"]
    return DeepLabV3Plus(num_classes=1, arch=m["arch"],
                         backbone_norm=m["backbone_norm"],
                         head_norm=m["head_norm"],
                         output_stride=m["output_stride"],
                         dtype=_dtype(m["dtype"]), seed=0, device=device)


def build_evaluator(cfg: dict, model, device, num_epochs: int = None):
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import OneShotConfig, OneShotEvaluator
    from e_osvos_torch.meta_optim import MetaOptimConfig
    from e_osvos_torch.models import functional_apply

    one = dict(cfg["one_shot"])
    if num_epochs is not None:
        one["num_epochs"] = num_epochs
    oscfg = OneShotConfig(augment=AugmentConfig(**cfg["augment"]), **one)
    return OneShotEvaluator(functional_apply(model),
                            MetaOptimConfig(**cfg["meta_optim"]), oscfg,
                            device=device, fused_ona=cfg["fused_ona"],
                            batch_objects=True)


def expected_launches(cfg: dict, frames: int, n_gn: int, per_call: dict,
                      objects: int) -> Dict[str, int]:
    """GroupNorm kernel launches one sequence implies, objects batched:
    ``chip_smoke.expected_launches`` (the padded tail window included)."""
    one = cfg["one_shot"]
    windows = -(-(frames - 1) // one["online_adapt_step"])
    backwards = one["num_epochs"] + (windows - 1) * one["online_adapt_epochs"]
    forwards = backwards + windows
    calls = {"group_stats": forwards, "affine_apply": forwards,
             "group_grad_coeffs": backwards, "affine_dx": backwards}
    want = {k: v * n_gn * per_call[k] for k, v in calls.items()}
    want.update(greedy_nms=0, greedy_nms_s=0, greedy_nms_l=0)
    return want


# -- the shape of a sequence's work ---------------------------------------------


def windows(cfg: dict, frames: int) -> List[Tuple[int, int]]:
    """The frames ``[start, stop)`` each window of the fused loop
    segments (support frame 0; the tail window's replicated frames
    dropped); a refit follows every window but the last."""
    step = cfg["one_shot"]["online_adapt_step"]
    return [(s, min(s + step, frames)) for s in range(1, frames, step)]


def passes(cfg: dict, frames: int) -> List[int]:
    """Learned-SGD steps of each fine_tune call of a sequence."""
    one = cfg["one_shot"]
    return [one["num_epochs"]] + [one["online_adapt_epochs"]] * (
        len(windows(cfg, frames)) - 1)


def flop_passes(cfg: dict, frames: int, objects: int):
    """The passes of one sequence as ``(kind, batch, count)``: training
    steps (forward and backward) and inferences (forward)."""
    one = cfg["one_shot"]
    wins = windows(cfg, frames)
    refit_batch = 1 + min(one["online_adapt_step"], one["batch_size"])
    return [("train", one["batch_size"], one["num_epochs"]),
            ("train", refit_batch,
             (len(wins) - 1) * one["online_adapt_epochs"]),
            ("infer", one["online_adapt_step"], len(wins))]


# -- the reference ------------------------------------------------------------


@dataclasses.dataclass
class SeqInputs:
    """Sequence 0 of the window as the benchmark made it."""

    frames: np.ndarray  # [T, H, W, 3] uint8
    labels: np.ndarray  # [T, H, W] uint8 ids
    objects: int
    seed: int  # the evaluator's seed of the sequence
    device: torch.device

    def support(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The support frame and its {0, 1} label, ``[H, W]`` or
        ``[O, H, W]``."""
        img = torch.from_numpy(self.frames[0]).to(self.device)
        lab = torch.from_numpy(np.stack([
            (self.labels[0] == k + 1).astype(np.int32)
            for k in range(self.objects)])).to(self.device)
        return img, (lab[0] if self.objects == 1 else lab)

    def window_frames(self, start: int, stop: int, step: int
                      ) -> torch.Tensor:
        """Frames ``[start, stop)``, replicated at the tail to ``step``."""
        idx = list(range(start, stop)) + [stop - 1] * (step - (stop - start))
        return torch.from_numpy(self.frames[idx]).to(self.device)


def learned_sgd_delta(loss_fn: Callable, theta: Dict[str, torch.Tensor],
                      lrs: Dict[str, torch.Tensor], batch
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One step ``p - lr * grad(loss)`` from ``theta``: its change of every
    parameter with a learning rate, and the loss (one an object)."""
    params = {k: v.detach().clone().requires_grad_(k in lrs)
              for k, v in theta.items()}
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss.sum(), [params[k] for k in lrs])
    return ({k: -(lrs[k] * g) for k, g in zip(lrs, grads)},
            loss.detach().float().reshape(-1))


class Reference:
    """The plain DeepLabV3+ at ``mode`` ``"reference"`` (float32, TF32 off)
    or ``"control"`` (the configuration's ``control`` block: one precision
    below the configuration's)."""

    def __init__(self, cfg: dict, objects: int, device, mode: str):
        from plainref import deeplab, oneshot, resnet, stacked, transforms

        self.cfg, self.objects, self.device = cfg, objects, device
        low = cfg["control"] if mode == "control" else {
            "model_dtype": "float32", "operand_dtype": None,
            "augment_compute_dtype": "float32", "tf32": False}
        self.tf32 = bool(low["tf32"])
        m = cfg["model"]
        model = deeplab.DeepLabV3Plus(
            num_classes=1, arch=m["arch"], backbone_norm=m["backbone_norm"],
            head_norm=m["head_norm"], output_stride=m["output_stride"],
            dtype=_dtype(low["model_dtype"]), device=device)
        operand = low["operand_dtype"]
        for mod in model.modules():
            if isinstance(mod, (resnet.Conv, resnet.Dense,
                                resnet.ConvTranspose)):
                mod.operand_dtype = None if operand is None \
                    else _dtype(operand)
        apply = deeplab.functional_apply(model)
        self.apply = (apply if objects == 1
                      else stacked.object_stacked_apply(apply, objects))
        self.stack_lrs = stacked.stack_lrs
        aug = dict(cfg["augment"],
                   compute_dtype=low["augment_compute_dtype"])
        one = cfg["one_shot"]
        self.oscfg = types.SimpleNamespace(
            normalize_mode="davis", loss_func=one["loss_func"],
            augment=transforms.AugmentConfig(**aug))
        self.transforms = transforms
        self.support_loss = oneshot.make_support_loss_fn(self.apply,
                                                         self.oscfg)
        self.pseudo_loss = oneshot.make_pseudo_gt_loss_fn(self.apply,
                                                          self.oscfg)
        self.build_pseudo_gt = oneshot.build_pseudo_gt
        self.draws = None

    def lrs(self, lrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return lrs if self.objects == 1 else self.stack_lrs(lrs, self.objects)

    def _augment_draws(self, seq: SeqInputs):
        """Every object's fine-tune draws, from the sequence's seed."""
        if self.draws is None:
            one = self.cfg["one_shot"]
            shape = (one["num_epochs"], one["batch_size"])
            self.draws = [self.transforms.sample_augment_draws(
                torch.Generator(device="cpu").manual_seed(fold_in(seq.seed, i)),
                self.oscfg.augment, shape).to(self.device)
                for i in range(self.objects)]
        return self.draws

    def fine_tune_step(self, theta, lrs, seq: SeqInputs, k: int):
        img, label = seq.support()
        draws = [d.select(k) for d in self._augment_draws(seq)]
        batch = (img, label, draws[0] if self.objects == 1 else draws)
        return learned_sgd_delta(self.support_loss, theta, self.lrs(lrs),
                                 batch)

    def refit_step(self, theta, lrs, seq: SeqInputs, c: int, s: int,
                   program_probs: np.ndarray):
        """Step ``s`` of the refit after window ``c - 1``, its pseudo
        ground truth from the program's probabilities ``[O, T, H, W]`` of
        that window's last frames (every step of a refit takes the same
        batch, as the port's ``[batch] * online_adapt_epochs``)."""
        one = self.cfg["one_shot"]
        start, stop = windows(self.cfg, seq.frames.shape[0])[c - 1]
        k = min(one["online_adapt_step"], one["batch_size"])
        probs = torch.from_numpy(program_probs[:, stop - k:stop]).to(
            self.device)
        pseudo = self.build_pseudo_gt(probs, one["online_adapt_min_prop"],
                                      tuple(probs.shape[-2:]))
        frames = seq.window_frames(start, stop, one["online_adapt_step"])
        img, label = seq.support()
        batch = (img, label, frames[-k:],
                 pseudo[0] if self.objects == 1 else pseudo)
        return learned_sgd_delta(self.pseudo_loss, theta, self.lrs(lrs),
                                 batch)

    @torch.no_grad()
    def window_probs(self, theta, seq: SeqInputs, c: int,
                     program_probs: np.ndarray) -> torch.Tensor:
        """``[O, n, H, W]`` probabilities of window ``c``'s real frames."""
        start, stop = windows(self.cfg, seq.frames.shape[0])[c]
        frames = seq.window_frames(start, stop,
                                   self.cfg["one_shot"]["online_adapt_step"])
        imgs = self.transforms.normalize(frames, "davis")
        logits = self.apply(theta, imgs)  # [n, H, W, O]
        return torch.sigmoid(logits.float().movedim(-1, 0))[:, :stop - start]

    def module(self):
        """The reference's ``nn.Module`` (the object-stacked one for
        several objects)."""
        return self.apply.model
