"""What the families share in building the system under test: the
learning-rate shapes of a level, the meta-parameters made from the
benchmark's own weights, and the precision flags a configuration
states."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch

from harness import weights


def lr_shape(level: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The shape of one parameter's learning rate at ``level`` (the port's
    ``lr_tree`` rule: a neuron's is its tensor's dim 0)."""
    if level == "tensor" or len(shape) == 0:
        return ()
    if level == "neuron":
        return (shape[0],) + (1,) * (len(shape) - 1)
    if level == "param":
        return tuple(shape)
    raise ValueError(f"unknown lr hierarchy level {level!r}")


def seeded_meta(model: torch.nn.Module, meta_cfg: dict, seed: int, device
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The learned init (every parameter and buffer of ``model``, by name)
    and the linear learning rates of its parameters, from ``seed``."""
    if meta_cfg["use_log_init_lr"]:
        raise ValueError("the benchmark makes linear-space learning rates")
    params = dict(model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    shapes.update({k: tuple(v.shape) for k, v in model.named_buffers()})
    init = weights.seeded_state(shapes, seed, device)
    lr_shapes = {k: lr_shape(meta_cfg["lr_hierarchy_level"], tuple(v.shape))
                 for k, v in params.items()}
    lrs = weights.seeded_lrs(lr_shapes, meta_cfg["init_lr"], seed, device)
    return init, lrs


def param_count(model: torch.nn.Module) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())


def set_flags(precision: dict) -> Dict[str, bool]:
    """The TF32 flags a configuration states, set before any model is
    built; returns them as set."""
    torch.backends.cudnn.allow_tf32 = bool(precision["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(
        precision["matmul_allow_tf32"])
    return flags()


def flags() -> Dict[str, bool]:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@contextlib.contextmanager
def tf32(on: bool):
    """Both TF32 flags at ``on`` inside, as they were after."""
    before = flags()
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
