"""Feature Pyramid Network on the ResNet C2..C5 taps, port of
``e_osvos_tpu/models/fpn.py``: lateral 1x1 convs to ``out_ch`` channels,
top-down nearest 2x upsampling with additive merge, 3x3 output convs, and a
stride-2 subsampling extra level (P6) for the RPN.

Tensors are NCHW in ``torch.channels_last`` memory format.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from e_osvos_torch.models.resnet import Conv


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``[B, C, H, W]`` → ``[B, C, 2H, 2W]``, each pixel repeated
    2x2 (source index ``floor(i / 2)``)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class FPN(nn.Module):
    """C2..C5 (``in_channels`` wide) → [P2, P3, P4, P5, P6], all ``out_ch``
    channels."""

    def __init__(self, in_channels: Sequence[int], out_ch: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}",
                            Conv(c, out_ch, 1, use_bias=True, dtype=dtype))
            self.add_module(f"output{i + 2}",
                            Conv(out_ch, out_ch, 3, padding=1, use_bias=True,
                                 dtype=dtype))
        self.num_levels = len(in_channels)

    def forward(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral{i + 2}")(feats[f"C{i + 2}"])
                    for i in range(self.num_levels)]
        ps = [laterals[-1]]
        for lat in laterals[-2::-1]:
            # the crop keeps the lateral's size where the input was odd
            up = upsample2x_nearest(ps[0])[:, :, :lat.shape[2], :lat.shape[3]]
            ps.insert(0, lat + up)
        outs = [getattr(self, f"output{i + 2}")(p) for i, p in enumerate(ps)]
        # P6 (RPN only): max-pool with a 1x1 window and stride 2
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs
