"""Evaluation and meta-training engine of the PyTorch port."""

from e_osvos_torch.engine.one_shot import (
    OneShotConfig,
    OneShotEvaluator,
    build_gt_stack,
    build_pseudo_gt,
    fine_tune_on_support,
    fold_in,
    merge_objects,
    one_shot_packed,
    one_shot_packed_objects,
    one_shot_packed_objects_ona,
    one_shot_packed_ona,
    propagate_windows,
    pseudo_ignore_padding,
    score_merged_device,
    segment_frames,
    stack_windows,
)
from e_osvos_torch.engine.one_shot_detection import (
    DetectionOneShotConfig,
    DetectionOneShotEvaluator,
)
from e_osvos_torch.engine.meta_trainer import MetaTrainConfig, MetaTrainer
from e_osvos_torch.engine.parent_trainer import (
    FrameSampler,
    InstanceFrameSampler,
    ParentTrainConfig,
    ParentTrainer,
)

__all__ = [
    "DetectionOneShotConfig", "DetectionOneShotEvaluator", "FrameSampler",
    "InstanceFrameSampler", "MetaTrainConfig", "MetaTrainer",
    "ParentTrainConfig", "ParentTrainer", "OneShotConfig", "OneShotEvaluator", "build_gt_stack", "build_pseudo_gt",
    "fine_tune_on_support", "fold_in", "merge_objects", "one_shot_packed",
    "one_shot_packed_objects", "one_shot_packed_objects_ona",
    "one_shot_packed_ona", "propagate_windows", "pseudo_ignore_padding",
    "score_merged_device", "segment_frames", "stack_windows",
]
