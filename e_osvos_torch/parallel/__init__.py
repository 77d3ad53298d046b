"""The meta-training step of the PyTorch port (one GPU)."""

from e_osvos_torch.parallel.meta_step import (
    MetaStep,
    MetaStepConfig,
    MetaStepOut,
    OuterOptimConfig,
    OuterRAdam,
    TaskDraws,
    TaskFns,
    detection_task_fns,
    make_meta_step,
    make_outer_optimizer,
)

__all__ = ["MetaStep", "MetaStepConfig", "MetaStepOut", "OuterOptimConfig",
           "OuterRAdam", "TaskDraws", "TaskFns", "detection_task_fns",
           "make_meta_step", "make_outer_optimizer"]
