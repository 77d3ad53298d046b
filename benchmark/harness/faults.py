"""Faults planted in the program, to show that the comparison catches
each kind the cells can have (``tests/test_faults.py`` on the CPU,
``tools/sweep.py --fault`` on the card). Each is a context manager that
replaces one name in the port for its duration:

* ``unchanged``: every learned-SGD step computes its loss and returns
  the parameters unchanged;
* ``refit_unchanged``: in every refit (the calls that pass ``reset``),
  each step after the first computes its loss and leaves the parameters
  unchanged (its loss enters the gradient times zero);
* ``half_batch``: every training loss leaves out half of its batch (the
  later ``B // 2`` images) and takes the mean over the rest;
* ``answer``: the merged label map, the answer a user gets, has a block
  of pixels of its last frame set to another object.

There is one chip a cell, so no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = ("unchanged", "refit_unchanged", "half_batch", "answer")


@contextlib.contextmanager
def _replaced(module: str, name: str, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _keep(batch: int) -> int:
    return batch - batch // 2


def _unchanged(orig):
    def inner_sgd_step(loss_fn, params, lrs, batch, grad_sum=None):
        loss = loss_fn(params, batch)
        return params, loss.detach()

    return inner_sgd_step


def _refit_frozen_after_first(orig):
    def fine_tune(cfg, loss_fn, *args, **kwargs):
        if "reset" not in kwargs:  # the fine-tune on the support frame
            return orig(cfg, loss_fn, *args, **kwargs)
        taken = [0]

        def frozen(params, batch):
            loss = loss_fn(params, batch)
            taken[0] += 1
            return loss if taken[0] == 1 else loss.detach() + 0 * loss

        return orig(cfg, frozen, *args, **kwargs)

    return fine_tune


def _half_loss_on(orig):
    def _loss_on(model_apply, cfg, params, imgs, labels):
        k = _keep(labels.shape[-3])
        return orig(model_apply, cfg, params, imgs[..., :k, :, :, :],
                    labels[..., :k, :, :])

    return _loss_on


def _half_detection_loss(orig):
    def _detection_loss(self, params, imgs, labels, draws):
        k = _keep(labels.shape[-3])
        draws = type(draws)(*(t[..., :k, :] if t.dim() > 2 and
                              labels.dim() == 4 else t[:k] for t in draws))
        return orig(self, params, imgs[..., :k, :, :, :],
                    labels[..., :k, :, :], draws)

    return _detection_loss


def _altered_merge(orig):
    def merge_objects(probs, threshold=0.5):
        merged = orig(probs, threshold).clone()
        block = merged[-1, :16, :16]
        merged[-1, :16, :16] = torch.where(block == 1, 0, 1).to(merged.dtype)
        return merged

    return merge_objects


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, for the block's duration."""
    with contextlib.ExitStack() as stack:
        if fault == "unchanged":
            stack.enter_context(_replaced(
                "e_osvos_torch.meta_optim.meta_optimizer", "inner_sgd_step",
                _unchanged))
        elif fault == "refit_unchanged":
            for module in ("e_osvos_torch.engine.one_shot",
                           "e_osvos_torch.engine.one_shot_detection"):
                stack.enter_context(_replaced(module, "fine_tune",
                                              _refit_frozen_after_first))
        elif fault == "half_batch":
            stack.enter_context(_replaced(
                "e_osvos_torch.engine.one_shot", "_loss_on", _half_loss_on))
            det = importlib.import_module(
                "e_osvos_torch.engine.one_shot_detection")
            orig = det.DetectionOneShotEvaluator._detection_loss
            det.DetectionOneShotEvaluator._detection_loss = \
                _half_detection_loss(orig)
            stack.callback(setattr, det.DetectionOneShotEvaluator,
                           "_detection_loss", orig)
        elif fault == "answer":
            for module in ("e_osvos_torch.engine.one_shot",
                           "e_osvos_torch.engine.one_shot_detection"):
                stack.enter_context(_replaced(module, "merge_objects",
                                              _altered_merge))
        elif fault != "none":
            raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
        yield
