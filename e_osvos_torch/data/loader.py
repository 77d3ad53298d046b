"""Sequence frame loading, port of ``e_osvos_tpu/data/loader.py``.

A sequence backed by JPEG files is decoded in the native thread pool
(``data/native.py`` over ``cpp/vos_loader.cc``) while the host stacks the
results; in-memory indexes (the synthetic sequences), other files, or a
missing native library take one ``index.get_image`` a frame."""

from __future__ import annotations

import os

import numpy as np

from e_osvos_torch.data import native


def load_frames(index, seq_name: str) -> np.ndarray:
    """``[T, H, W, 3]`` uint8 frame stack of one sequence, on the host."""
    seq = index.sequences[seq_name]
    T = len(seq)
    paths = getattr(seq, "image_paths", None)
    use_native = (
        paths is not None
        and native.available()
        and all(p.lower().endswith((".jpg", ".jpeg")) and os.path.exists(p)
                for p in paths))
    if not use_native:
        return np.stack([index.get_image(seq_name, t) for t in range(T)])

    # the first frame gives the slots' size
    first = native.decode_jpeg(paths[0])
    h, w = first.shape[:2]
    out = np.empty((T, h, w, 3), np.uint8)
    out[0] = first
    pool = native.PrefetchLoader(
        num_threads=min(8, 2 * (os.cpu_count() or 1)),
        num_slots=min(T, 32), max_hw=(h, w))
    try:
        free = list(range(pool.num_slots))
        pending: dict = {}  # frame index -> slot, in submission order
        for t in range(1, T):
            if not free:
                # drain the oldest frame in flight to recycle its slot
                t0, s0 = next(iter(pending.items()))
                out[t0] = pool.wait(s0)
                del pending[t0]
                free.append(s0)
            slot = free.pop()
            pool.submit(slot, paths[t], kind=0)
            pending[t] = slot
        for t0, s0 in pending.items():
            out[t0] = pool.wait(s0)
    finally:
        pool.close()
    return out
