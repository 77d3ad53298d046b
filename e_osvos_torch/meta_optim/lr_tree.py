"""Learning-rate dicts for the learned optimizer, port of
``e_osvos_tpu/meta_optim/lr_tree.py``.

The learning rates are a dict keyed like the model's ``named_parameters()``,
with shapes chosen per granularity so a plain broadcast multiply applies
them. Torch layouts put the output-feature axis FIRST (OIHW conv weights), so
"neuron" granularity keeps dim 0 and collapses the rest: a conv weight's
neuron lr is ``[O, 1, 1, 1]`` (flax keeps that axis last, ``(1, 1, 1, O)``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import torch

# log-lr floor of the reference's clamp ([e^-33, max_lr])
LOG_LR_MIN = -33.0

HIERARCHY_LEVELS = ("single", "tensor", "neuron", "param")

LrDict = Dict[str, torch.Tensor]


def _lr_shape(level: str, shape: torch.Size) -> tuple:
    if level == "tensor" or len(shape) == 0:
        return ()
    if level == "neuron":
        return (shape[0],) + (1,) * (len(shape) - 1)
    if level == "param":
        return tuple(shape)
    raise ValueError(f"unknown lr hierarchy level {level!r}")


def init_lr_tree(params: Mapping[str, torch.Tensor],
                 hierarchy_level: str = "neuron", init_lr: float = 1e-3,
                 use_log: bool = True) -> LrDict:
    """One learnable lr tensor per parameter (``single`` stores one scalar
    per parameter, as the JAX package does)."""
    if hierarchy_level not in HIERARCHY_LEVELS:
        raise ValueError(f"unknown lr hierarchy level {hierarchy_level!r}")
    value = math.log(init_lr) if use_log else init_lr
    level = "tensor" if hierarchy_level == "single" else hierarchy_level
    return {
        name: torch.full(_lr_shape(level, p.shape), value,
                         dtype=torch.float32, device=p.device)
        for name, p in params.items()
    }


def materialize_lrs(lr_tree: LrDict, use_log: bool = True) -> LrDict:
    """log-lrs → positive lrs (exp), or identity when linear-space."""
    if not use_log:
        return lr_tree
    return {k: torch.exp(v) for k, v in lr_tree.items()}


def clamp_lr_tree(lr_tree: LrDict, use_log: bool = True, max_lr: float = 1.0,
                  allow_zero: bool = False) -> LrDict:
    """Clamp lrs into [e^-33, max_lr] (log space: [-33, log max_lr]);
    linear-space lrs may reach 0 when ``allow_zero``."""
    if use_log:
        lo, hi = LOG_LR_MIN, math.log(max_lr)
    else:
        lo, hi = (0.0 if allow_zero else math.exp(LOG_LR_MIN)), max_lr
    return {k: v.clamp(lo, hi) for k, v in lr_tree.items()}


def _matches_path(name: str, substrings: Sequence[str]) -> bool:
    return any(s.lower() in name.lower() for s in substrings)


def mask_lrs_by_path(lrs: LrDict, substrings: Sequence[str],
                     keep_matching: bool = True, zero_value: float = 0.0
                     ) -> LrDict:
    """Set to ``zero_value`` the lrs of every parameter whose name does
    (``keep_matching=False``) or does not (True) contain one of
    ``substrings``, case-insensitively: the reference's partial-update
    switches as lr masks (``only_box_head`` keeps ``box_head``/``roi``;
    encoder freezing drops the backbone). ``zero_value`` is ``LOG_LR_MIN``
    for log lrs."""
    return {k: v if _matches_path(k, substrings) == keep_matching
            else torch.full_like(v, zero_value) for k, v in lrs.items()}


def select_lrs_by_path(lrs: LrDict, substrings: Sequence[str]) -> LrDict:
    """The lrs of the parameters whose name contains one of ``substrings``
    (the entries ``mask_lrs_by_path`` keeps): an inner loop over this tree
    updates only those parameters, as over the masked tree, and takes no
    gradient of the others."""
    return {k: v for k, v in lrs.items() if _matches_path(k, substrings)}


def lr_stats(lr_tree: LrDict, use_log: bool = True) -> Dict[str, torch.Tensor]:
    """Mean, standard deviation (population), min and max of every
    materialized lr: the reference's init-lr curves."""
    flat = torch.cat([v.reshape(-1).float()
                      for v in materialize_lrs(lr_tree, use_log).values()])
    return {"mean": flat.mean(), "std": flat.std(correction=0),
            "min": flat.min(), "max": flat.max()}


def lr_per_tensor(lr_tree: LrDict, use_log: bool = True) -> Dict[str, float]:
    """Mean materialized lr of each parameter, by name: the reference's
    per-tensor init-lr curves. One host transfer for all of them."""
    lrs = materialize_lrs(lr_tree, use_log)
    means = torch.stack([v.float().mean() for v in lrs.values()]).tolist()
    return dict(zip(lrs, means))
