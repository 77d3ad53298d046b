"""Data side of the PyTorch port: index types, the synthetic sequences,
frame loading and the on-device augmentation."""

from e_osvos_torch.data.datasets import ObjectGroup, VOSSequence, binarize_label
from e_osvos_torch.data.loader import load_frames
from e_osvos_torch.data.synthetic import SyntheticVOSIndex

__all__ = ["ObjectGroup", "SyntheticVOSIndex", "VOSSequence", "binarize_label",
           "load_frames"]
