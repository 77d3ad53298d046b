"""Bit-packed binary masks, port of ``e_osvos_tpu/ops/bits.py``.

A 67-frame 480p mask sequence is ~27 MB as uint8; packed 8 pixels per byte
on the device it crosses to the host as ~3.4 MB and is unpacked there with
``np.unpackbits``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pack_mask_bits", "unpack_mask_bits"]

# np.unpackbits order: most significant bit first
_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """Pack a {0, 1} mask along its last axis, 8 pixels per byte.

    The last axis is zero-padded to a multiple of 8 (854 → 856). Returns
    uint8 ``[..., ceil(W/8)]`` in ``np.unpackbits`` bit order."""
    mask = mask.to(torch.uint8)
    pad = (-mask.shape[-1]) % 8
    if pad:
        mask = F.pad(mask, (0, pad))
    grouped = mask.reshape(mask.shape[:-1] + (-1, 8))
    weights = torch.tensor(_WEIGHTS, dtype=torch.uint8, device=mask.device)
    return (grouped * weights).sum(-1, dtype=torch.uint8)


def unpack_mask_bits(packed, width: int) -> np.ndarray:
    """Host-side inverse: uint8 ``[..., W/8]`` → uint8 mask ``[..., width]``."""
    bits = np.unpackbits(np.asarray(packed, np.uint8), axis=-1)
    return bits[..., :width]
