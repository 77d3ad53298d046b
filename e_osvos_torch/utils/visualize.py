"""Debug overlays of predicted masks, port of ``e_osvos_tpu/utils/visualize.py``:
object colours and contours over a frame, and box drawing, in numpy."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from e_osvos_torch.utils.png import davis_palette


def mask_boundary(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a binary mask (4-neighbor difference)."""
    m = mask.astype(bool)
    b = np.zeros_like(m)
    b[1:, :] |= m[1:, :] != m[:-1, :]
    b[:, 1:] |= m[:, 1:] != m[:, :-1]
    return b & m


def overlay_masks(img: np.ndarray, label_map: np.ndarray, alpha: float = 0.4,
                  draw_contour: bool = True) -> np.ndarray:
    """Blend per-object colors over an RGB frame; object k uses DAVIS
    palette color k. img [H,W,3] uint8, label_map [H,W] int."""
    out = img.astype(np.float32).copy()
    palette = davis_palette()
    for k in np.unique(label_map):
        if k == 0 or k == 255:
            continue
        m = label_map == k
        color = palette[int(k)].astype(np.float32)
        out[m] = (1 - alpha) * out[m] + alpha * color
        if draw_contour:
            out[mask_boundary(m)] = color
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_boxes(img: np.ndarray, boxes: Sequence[Sequence[float]],
               color=(255, 255, 0), thickness: int = 2) -> np.ndarray:
    """Draw xyxy rectangles on an RGB frame (detection debug overlays)."""
    out = img.copy()
    h, w = out.shape[:2]
    c = np.asarray(color, np.uint8)
    for box in boxes:
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        x1, x2 = max(x1, 0), min(x2, w - 1)
        y1, y2 = max(y1, 0), min(y2, h - 1)
        if x2 <= x1 or y2 <= y1:
            continue
        t = thickness
        out[y1:y1 + t, x1:x2] = c
        out[max(y2 - t, 0):y2, x1:x2] = c
        out[y1:y2, x1:x1 + t] = c
        out[y1:y2, max(x2 - t, 0):x2] = c
    return out


def save_debug_overlay(path: str, img: np.ndarray, label_map: np.ndarray,
                       boxes: Optional[Sequence] = None) -> None:
    """Write one debug frame (mask overlay and optional boxes) as PNG."""
    out = overlay_masks(img, label_map)
    if boxes is not None:
        out = draw_boxes(out, boxes)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(out).save(path)
