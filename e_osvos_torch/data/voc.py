"""PASCAL VOC-2012 segmentation index for parent pre-training, port of
``e_osvos_tpu/data/voc.py``.

VOC pre-trains the parent network on binary foreground/background
segmentation. The index has the VOS indexes' interface (``sequences``,
``get_image``, ``get_label``) with every image a one-frame sequence, so
``engine.parent_trainer.FrameSampler`` takes it as it is. The 20 object
classes collapse to 1, the background to 0.

``void`` picks what VOC's 255 border label becomes:

  * ``"background"`` (default): background, the reference's stated intent.
    (Its pipeline divides the mask by 255 before comparing it with 255, so
    there the void pixels train as foreground; neither package copies
    that.)
  * ``"ignore"``: kept as 255, so the losses leave those pixels out.

The reference's VOC transform stack (flip, random scale-crop, Gaussian
blur) is ``transforms.VOC_PARENT_AUGMENT`` with ``normalize(mode="unit")``;
its validation protocol, scale the short edge then centre-crop, is
``fix_scale_crop``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from e_osvos_torch.data.datasets import (
    ObjectGroup,
    VOSSequence,
    load_image,
    load_label,
)

VOID_MODES = ("background", "ignore")


class VOC2012Index:
    """Layout: ``[VOCdevkit/VOC2012/]{JPEGImages, SegmentationClass,
    ImageSets/Segmentation/<split>.txt}``; names listed in the split file
    without both files are skipped."""

    def __init__(self, root: str, split: str = "train",
                 void: str = "background"):
        if void not in VOID_MODES:
            raise ValueError(f"void={void!r} not in {VOID_MODES}")
        self.void = void
        base = root
        if os.path.isdir(os.path.join(root, "VOCdevkit", "VOC2012")):
            base = os.path.join(root, "VOCdevkit", "VOC2012")
        self.base = base
        split_file = os.path.join(base, "ImageSets", "Segmentation",
                                  f"{split}.txt")
        with open(split_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        self.sequences: Dict[str, VOSSequence] = {}
        for name in names:
            img = os.path.join(base, "JPEGImages", f"{name}.jpg")
            lab = os.path.join(base, "SegmentationClass", f"{name}.png")
            if not (os.path.exists(img) and os.path.exists(lab)):
                continue
            self.sequences[name] = VOSSequence(
                name=name, image_paths=[img], label_paths=[lab],
                object_groups=[ObjectGroup(object_ids=(1,), support_frame=0)],
                num_objects=1)

    def get_image(self, seq: str, idx: int) -> np.ndarray:
        return load_image(self.sequences[seq].image_paths[idx])

    def get_label(self, seq: str, idx: int) -> Optional[np.ndarray]:
        raw = load_label(self.sequences[seq].label_paths[idx])
        fg = ((raw > 0) & (raw != 255)).astype(np.uint8)
        if self.void == "ignore":
            return np.where(raw == 255, np.uint8(255), fg)
        return fg


def fix_scale_crop(img: np.ndarray, label: np.ndarray, crop_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The VOC validation protocol: scale the short edge to ``crop_size``
    (bilinear image, nearest label), then centre-crop a ``crop_size``
    square. On the host, in numpy."""
    h, w = img.shape[:2]
    if w > h:
        oh, ow = crop_size, int(round(w * crop_size / h))
    else:
        ow, oh = crop_size, int(round(h * crop_size / w))
    ys = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
    y0i = np.floor(ys).astype(np.int64)
    x0i = np.floor(xs).astype(np.int64)
    y1i = np.minimum(y0i + 1, h - 1)
    x1i = np.minimum(x0i + 1, w - 1)
    wy = (ys - y0i)[:, None, None]
    wx = (xs - x0i)[None, :, None]
    im = img.astype(np.float32)
    out = (im[y0i][:, x0i] * (1 - wy) * (1 - wx)
           + im[y0i][:, x1i] * (1 - wy) * wx
           + im[y1i][:, x0i] * wy * (1 - wx)
           + im[y1i][:, x1i] * wy * wx)
    lab = label[np.round(ys).astype(np.int64)][:, np.round(xs).astype(np.int64)]
    y0 = int(round((oh - crop_size) / 2.0))
    x0 = int(round((ow - crop_size) / 2.0))
    out = out[y0:y0 + crop_size, x0:x0 + crop_size]
    lab = lab[y0:y0 + crop_size, x0:x0 + crop_size]
    return out.astype(img.dtype), lab
