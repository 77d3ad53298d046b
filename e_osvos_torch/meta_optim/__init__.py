"""Learned optimizer of the PyTorch port (one-shot subset)."""

from e_osvos_torch.meta_optim.lr_tree import (
    LOG_LR_MIN,
    clamp_lr_tree,
    init_lr_tree,
    materialize_lrs,
)
from e_osvos_torch.meta_optim.meta_optimizer import (
    MetaOptimConfig,
    MetaParams,
    fine_tune,
    init_meta_params,
    inner_sgd_step,
    reset_params,
)

__all__ = [
    "LOG_LR_MIN", "MetaOptimConfig", "MetaParams", "clamp_lr_tree",
    "fine_tune", "init_lr_tree", "init_meta_params", "inner_sgd_step",
    "materialize_lrs", "reset_params",
]
