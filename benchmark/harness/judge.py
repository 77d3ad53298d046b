"""The comparison that decides ``correct``.

What is compared is what the window's first sequence produced through
the timed path, at the timed sizes: its parameters at a sample of
learned-SGD steps drawn from the seed (the fine-tune's first step and
more drawn from all its steps, and steps drawn from all the steps of
every refit), every propagated frame's probabilities, the merged label
map, and the passes of every sequence.
The reference (``families/<family>.py`` over ``plainref``) starts each
checked step and window from the program's own state and works out
again everything the program derived from the inputs.

Numbers, each with its limit from the configuration's ``limits``:

* ``step_gap``: over the checked steps (by the family's
  ``STEP_STATISTIC``: their largest, or for a family whose training step
  takes discrete decisions, their median; taken over the fine-tune's
  steps and over the refits' steps apart, and the larger of the two, so
  that a fault in the refits alone shows), of the parameters with a
  learning rate, the largest ``| |after_p - before| - |after_r - before| |
  / max(|after_r - before|, the median parameter's |after_r - before|)``
  (norms over each parameter), where ``before`` is the program's
  parameters before the step, ``after_p`` its parameters after it and
  ``after_r = before - lr * grad_r`` the reference's step from
  ``before``, rounded to float32 as the program's is. A step left out
  reads 1, a step taken twice 1; rounding noise in the gradient, which
  adds to a step's norm in quadrature, reads far less than it does in
  the norm of the difference (printed beside it as
  ``step_diff_median``, the median parameter's ``|after_p - after_r|``
  on the same scale);
* ``step_angle``: over the checked steps, by the same statistic, ``1 -
  cos`` of the angle between the program's step ``after_p - before`` and
  the reference's, each the concatenation of every parameter with a
  learning rate (1 where the program's step is zero): rounding noise
  enters it squared, a step on another batch or loss at first order;
* ``loss_gap``: over the checked steps, by the same statistic,
  ``|loss_p - loss_r| / |loss_r|`` (the largest over objects);
* ``frame_gap``: every propagated frame's mean gap of logits,
  ``|logit(p) - logit(r)|``, over the pixels where the reference is
  uncertain (``0.01 < r < 0.99``; 0 where there are none), the
  program's probability clamped to [1e-6, 1 - 1e-6]: the logit error,
  whatever share of the frame is saturated; over the frames by the
  family's ``FRAME_STATISTIC``, their largest, or for a family whose
  inference takes discrete decisions their median (``frame_gap_prob``,
  printed beside it, is the mean ``|p - r|`` over the mean ``r(1 - r)``);
* ``merged_off``: pixels where the program's merged label map differs
  from the merge of its own probabilities (exact, 0);
* ``passes_off``: fine-tune and refit calls, over every sequence of the
  window, whose count of steps differs from the configuration's, plus
  calls missing or extra (exact, 0).

The control puts the reference one precision below the configuration's
(its ``control`` block) in the program's place at the same points; it
has to fail one of the numbers.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from harness import program as prog

COMPARED = ("step_gap", "step_angle", "loss_gap", "frame_gap", "merged_off",
            "passes_off")
STATISTICS = {"max": max, "median": statistics.median}
# checked learned-SGD steps of the window's first sequence: the fine-tune's
# step 0 and more drawn from the rest of its steps, and (refit, step) pairs
# drawn from all the steps of every refit
FINE_TUNE_STEPS = 3
REFIT_STEPS = 3


def decide(program: Dict[str, float], limits: Dict[str, float]
           ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and the numbers compared, each beside its limit: those
    the cell's limits name, in the order of ``COMPARED``."""
    checks = {k: {"value": float(program[k]), "limit": limits[k]}
              for k in COMPARED if k in limits}
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values()), checks


def decide_control(control: Dict[str, float], limits: Dict[str, float]
                   ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``decide`` for the control's readings, on the numbers it has; its
    ``correct`` has to come out false."""
    return decide(control, {k: v for k, v in limits.items() if k in control})


def plan(cfg: dict, family, frames: int, seed: int
         ) -> Tuple[List[int], List[Tuple[int, int]], Set[Tuple[int, int]]]:
    """The checked fine-tune steps (step 0 and a sample), the checked
    refit steps as ``(call, step)`` and every capture point they and the
    windows need."""
    steps = family.passes(cfg, frames)
    rng = np.random.default_rng(seed)
    ft = [0] + sorted(int(s) for s in rng.choice(
        np.arange(1, steps[0]), size=min(FINE_TUNE_STEPS - 1, steps[0] - 1),
        replace=False))
    pairs = [(c, s) for c in range(1, len(steps)) for s in range(steps[c])]
    picked = rng.choice(len(pairs), size=min(REFIT_STEPS, len(pairs)),
                        replace=False)
    refits = sorted(pairs[int(i)] for i in picked)
    points = {(c, n) for c, n in enumerate(steps)}
    for c, s in [(0, s) for s in ft] + refits:
        points |= {(c, s), (c, s + 1)}
    return ft, refits, points


def passes_off(want: Sequence[int], got: Sequence[Sequence[int]]) -> int:
    off = 0
    for calls in got:
        off += abs(len(calls) - len(want))
        off += sum(a != b for a, b in zip(calls, want))
    return off


def merged_off(probs: np.ndarray, merged: np.ndarray, threshold: float
               ) -> int:
    from plainref.oneshot import merge_objects

    want = merge_objects(torch.from_numpy(probs), threshold).numpy()
    return int((want.astype(np.int64) != merged.astype(np.int64)).sum())


def step_gap(before, after_p, delta_r) -> Tuple[float, float]:
    """(worst leaf's gap of step norms, median leaf's norm of the
    difference), each over ``max(the leaf's reference step, the median
    leaf's)``."""
    norm = torch.linalg.vector_norm
    gaps, diffs, norms = [], [], []
    for k, d in delta_r.items():
        after_r = (before[k] + d).float()
        ref = float(norm(after_r - before[k]))
        gaps.append(abs(float(norm(after_p[k] - before[k])) - ref))
        diffs.append(float(norm(after_p[k] - after_r)))
        norms.append(ref)
    floor = max(statistics.median(norms), 1e-30)
    scale = [max(n, floor) for n in norms]
    return (max(g / s for g, s in zip(gaps, scale)),
            statistics.median([d / s for d, s in zip(diffs, scale)]))


def step_angle(before, after_p, delta_r) -> float:
    """``1 - cos`` between the program's whole step and the reference's."""
    dot = norm_p = norm_r = 0.0
    for k, d in delta_r.items():
        after_r = (before[k] + d).float()
        sp, sr = (after_p[k] - before[k]).double(), (after_r - before[k]).double()
        dot += float((sp * sr).sum())
        norm_p += float((sp * sp).sum())
        norm_r += float((sr * sr).sum())
    if norm_p == 0.0 or norm_r == 0.0:
        return 1.0
    return 1.0 - dot / (norm_p ** 0.5 * norm_r ** 0.5)


def frame_gaps(got: torch.Tensor, want: torch.Tensor
               ) -> Tuple[List[float], List[float]]:
    """(logit gap, probability gap over the uncertain mass) of each frame
    of ``[O, n, H, W]`` probabilities."""
    got, want = got.double(), want.double()
    prob = (got - want).abs().mean(dim=(0, 2, 3)) / (
        want * (1 - want)).mean(dim=(0, 2, 3)).clamp_min(1e-4)
    unsure = (want > 0.01) & (want < 0.99)
    lg = torch.logit(got.clamp(1e-6, 1 - 1e-6)) - torch.logit(
        want.clamp(1e-6, 1 - 1e-6))
    count = unsure.sum(dim=(0, 2, 3))
    logit = torch.where(unsure, lg.abs(), 0).sum(dim=(0, 2, 3)) \
        / count.clamp_min(1)
    return logit.tolist(), prob.tolist()


def loss_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().reshape(-1).cpu(), want.float().reshape(-1).cpu()
    return float(((got - want).abs() / want.abs().clamp_min(1e-12)).max())


class Judge:
    """Readings of the program (``mode="program"``) or of the control
    against the reference, at the points the hook captured."""

    def __init__(self, family, cfg: dict, seq, lrs, snaps, losses,
                 program_probs: np.ndarray, ft: List[int],
                 refits: List[Tuple[int, int]], device):
        self.family, self.cfg, self.seq = family, cfg, seq
        self.lrs, self.snaps, self.losses = lrs, snaps, losses
        self.probs, self.ft, self.refits = program_probs, ft, refits
        self.device = device
        self.steps = family.passes(cfg, seq.frames.shape[0])
        self.ref = family.Reference(cfg, seq.objects, device, "reference")
        self.control = family.Reference(cfg, seq.objects, device, "control")
        for r in (self.ref, self.control):
            if hasattr(r, "replay"):
                r.replay(seq, ft, refits)

    def _theta(self, point):
        if point not in self.snaps:
            raise KeyError(f"the program never reached point {point}: "
                           "no parameters to compare there")
        return {k: v.to(self.device, non_blocking=True)
                for k, v in self.snaps[point].items()}

    def _steps(self):
        """(label, before point, after point, program loss, call, kind)."""
        for s in self.ft:
            yield (f"fine-tune step {s}", (0, s), (0, s + 1),
                   self.losses[0][s], 0, s)
        for c, s in self.refits:
            yield (f"refit {c} step {s}", (c, s), (c, s + 1),
                   self.losses[c][s], c, s)

    def _step(self, ref, theta, c, s):
        with prog.tf32(ref.tf32):
            if c == 0:
                return ref.fine_tune_step(theta, self.lrs, self.seq, s)
            return ref.refit_step(theta, self.lrs, self.seq, c, s,
                                  self.probs)

    def readings(self, log) -> Dict[str, Dict[str, float]]:
        out = {m: {} for m in ("program", "control")}
        per_step = {m: {k: ([], []) for k in ("step_gap", "step_angle",
                                              "loss_gap", "step_diff_median")}
                    for m in ("program", "control")}
        for label, pre, post, loss_p, c, s in self._steps():
            before = self._theta(pre)
            after_p = self._theta(post)
            d_ref, loss_r = self._step(self.ref, before, c, s)
            d_ctl, loss_c = self._step(self.control, before, c, s)
            after_c = {k: before[k] + d for k, d in d_ctl.items()}
            for mode, after, loss in (("program", after_p, loss_p),
                                      ("control", after_c, loss_c)):
                sg, diff = step_gap(before, after, d_ref)
                sa = step_angle(before, after, d_ref)
                lg = loss_gap(loss, loss_r)
                for k, v in (("step_gap", sg), ("step_angle", sa),
                             ("loss_gap", lg), ("step_diff_median", diff)):
                    per_step[mode][k][int(c > 0)].append(v)
                log(f"{mode} {label}: step gap {sg:.4g} (difference, "
                    f"median leaf {diff:.4g}), step angle {sa:.4g}, loss "
                    f"gap {lg:.4g}")
            del before, after_p, after_c, d_ref, d_ctl
        stat = STATISTICS[self.family.STEP_STATISTIC]
        for mode, lists in per_step.items():
            for k, parts in lists.items():
                out[mode][k] = max(float(stat(v)) for v in parts if v)
        per_frame = {m: ([], []) for m in ("program", "control")}
        n_win = len(self.steps)
        for c in range(n_win):
            theta = self._theta((c, self.steps[c]))
            start, stop = self.family.windows(self.cfg,
                                              self.seq.frames.shape[0])[c]
            got = torch.from_numpy(self.probs[:, start:stop]).to(self.device)
            with prog.tf32(False):
                want = self.ref.window_probs(theta, self.seq, c, self.probs)
            with prog.tf32(self.control.tf32):
                ctl = self.control.window_probs(theta, self.seq, c,
                                                self.probs)
            for mode, p in (("program", got), ("control", ctl)):
                logit, prob = frame_gaps(p, want)
                per_frame[mode][0].extend(logit)
                per_frame[mode][1].extend(prob)
            del theta
        stat = STATISTICS[self.family.FRAME_STATISTIC]
        for mode, (logit, prob) in per_frame.items():
            o = out[mode]
            o["frame_gap"] = float(stat(logit))
            o["frame_gap_prob"] = float(stat(prob))
            o["frame_gap_max"] = float(max(logit))
            o["frame_gap_median"] = float(statistics.median(logit))
        return out
