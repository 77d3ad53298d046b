"""Indexed-PNG masks for DAVIS / YouTube-VOS submissions, port of
``e_osvos_tpu/utils/png.py``.

Predicted label maps are saved as palette PNGs whose palette indices are
the object ids, with the standard DAVIS palette (the Pascal-VOC bit-shuffle
colormap)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def davis_palette() -> np.ndarray:
    """256x3 Pascal-VOC/DAVIS colormap (bitwise label→color shuffle)."""
    palette = np.zeros((256, 3), np.uint8)
    for i in range(256):
        lab = i
        r = g = b = 0
        for j in range(8):
            r |= ((lab >> 0) & 1) << (7 - j)
            g |= ((lab >> 1) & 1) << (7 - j)
            b |= ((lab >> 2) & 1) << (7 - j)
            lab >>= 3
        palette[i] = (r, g, b)
    return palette


_PALETTE = davis_palette().flatten().tolist()


def save_indexed_png(path: str, label: np.ndarray) -> None:
    """Save an [H,W] uint8 id map as an indexed PNG with the DAVIS palette."""
    img = Image.fromarray(label.astype(np.uint8), mode="P")
    img.putpalette(_PALETTE)
    img.save(path)


def load_indexed_png(path: str) -> np.ndarray:
    return np.asarray(Image.open(path), dtype=np.uint8)
