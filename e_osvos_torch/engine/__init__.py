"""Evaluation engine of the PyTorch port."""

from e_osvos_torch.engine.one_shot import (
    OneShotConfig,
    OneShotEvaluator,
    build_pseudo_gt,
    fine_tune_on_support,
    one_shot_packed_ona,
    propagate_windows,
    segment_frames,
    stack_windows,
)
from e_osvos_torch.engine.one_shot_detection import (
    DetectionOneShotConfig,
    DetectionOneShotEvaluator,
)

__all__ = [
    "DetectionOneShotConfig", "DetectionOneShotEvaluator",
    "OneShotConfig", "OneShotEvaluator", "build_pseudo_gt",
    "fine_tune_on_support", "one_shot_packed_ona", "propagate_windows",
    "segment_frames", "stack_windows",
]
