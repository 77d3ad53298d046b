"""Sequence frame loading, port of the sequential path of
``e_osvos_tpu/data/loader.py``.

The JAX package decodes a JPEG-backed sequence in a native thread pool
(``data/native.py`` over ``cpp/vos_loader.cc``) and falls back to one
``index.get_image`` per frame otherwise. The native pool is not ported yet;
this module is the sequential path, which is what in-memory indexes (the
synthetic sequences) take on either side."""

from __future__ import annotations

import numpy as np


def load_frames(index, seq_name: str) -> np.ndarray:
    """``[T, H, W, 3]`` uint8 frame stack of one sequence, on the host."""
    seq = index.sequences[seq_name]
    return np.stack([index.get_image(seq_name, t) for t in range(len(seq))])
