"""Segmentation and detection models of the PyTorch port."""

from e_osvos_torch.models.deeplab import (
    ARCHITECTURES,
    ASPP,
    DeepLabV3,
    DeepLabV3Plus,
    build_model,
    functional_apply,
)
from e_osvos_torch.models.mask_rcnn import (
    Detections,
    MaskRCNN,
    RoIConfig,
    TrainDraws,
)
from e_osvos_torch.models.resnet import (
    BatchNorm,
    Bottleneck,
    FrozenScaleBias,
    ResNet,
    make_norm,
)
from e_osvos_torch.models.rpn import RPNConfig

__all__ = [
    "ARCHITECTURES", "ASPP", "BatchNorm", "Bottleneck", "DeepLabV3",
    "DeepLabV3Plus", "Detections", "FrozenScaleBias", "MaskRCNN",
    "RPNConfig", "ResNet", "RoIConfig", "TrainDraws", "build_model",
    "functional_apply", "make_norm",
]
