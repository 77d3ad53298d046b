"""Segmentation models of the PyTorch port."""

from e_osvos_torch.models.deeplab import (
    ARCHITECTURES,
    ASPP,
    DeepLabV3,
    DeepLabV3Plus,
    build_model,
    functional_apply,
)
from e_osvos_torch.models.resnet import (
    Bottleneck,
    FrozenScaleBias,
    ResNet,
    make_norm,
)

__all__ = [
    "ARCHITECTURES", "ASPP", "Bottleneck", "DeepLabV3", "DeepLabV3Plus",
    "FrozenScaleBias", "ResNet", "build_model", "functional_apply",
    "make_norm",
]
