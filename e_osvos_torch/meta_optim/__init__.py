"""Learned optimizer of the PyTorch port: learned init and per-neuron
learning rates, the inner SGD loop, the truncated-BPTT meta-gradient and the
meta-task sampler."""

from e_osvos_torch.meta_optim.lr_tree import (
    LOG_LR_MIN,
    clamp_lr_tree,
    init_lr_tree,
    lr_per_tensor,
    lr_stats,
    mask_lrs_by_path,
    materialize_lrs,
)
from e_osvos_torch.meta_optim.meta_optimizer import (
    MetaOptimConfig,
    MetaParams,
    clamp_meta_params,
    fine_tune,
    init_meta_params,
    inner_sgd_step,
    meta_grads,
    meta_loss,
    reset_params,
)
from e_osvos_torch.meta_optim.tasksets import (
    MetaTaskset,
    MetaTasksetConfig,
    TaskBatch,
    TaskSpec,
    paste_distractor,
)

__all__ = [
    "LOG_LR_MIN", "MetaOptimConfig", "MetaParams", "MetaTaskset",
    "MetaTasksetConfig", "TaskBatch", "TaskSpec", "clamp_lr_tree",
    "clamp_meta_params", "fine_tune", "init_lr_tree", "init_meta_params",
    "inner_sgd_step", "lr_per_tensor", "lr_stats", "mask_lrs_by_path",
    "materialize_lrs", "meta_grads", "meta_loss", "paste_distractor",
    "reset_params",
]
