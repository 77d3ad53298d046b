"""Conv and frozen-norm fusion, and the bilinear deconvolution init, port of
``e_osvos_tpu/models/fuse.py``.

``fuse_frozen_norms`` folds every frozen-BN scale into the convolution
before it (the reference's ``merge_batch_norms_with_convs``): on a
``state_dict`` with the port's names and OIHW kernels, for each module
``…convX`` followed by a ``…normX`` frozen-BN (``conv1``/``norm1``,
``stem_conv``/``stem_norm``, ``down_conv``/``down_norm``), weight ←
weight·scale per output channel and the norm's scale ← 1; a conv with its
own bias also takes the norm's shift (bias ← bias·scale + shift, the
norm's bias ← 0), else the norm keeps it. ``bilinear_upsample_kernel`` is
the reference's ``interp_surgery``: a transposed-convolution kernel that
upsamples each channel bilinearly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def bilinear_upsample_kernel(size: int, in_ch: int, out_ch: int
                             ) -> np.ndarray:
    """``[size, size, in_ch, out_ch]`` (HWIO, the JAX layout) kernel of a
    transposed convolution that upsamples each channel bilinearly:
    identity across channels, the bilinear filter within."""
    factor = (size + 1) // 2
    center = factor - 1 if size % 2 == 1 else factor - 0.5
    og = np.ogrid[:size, :size]
    filt = ((1 - abs(og[0] - center) / factor)
            * (1 - abs(og[1] - center) / factor))
    k = np.zeros((size, size, in_ch, out_ch), np.float32)
    for c in range(min(in_ch, out_ch)):
        k[:, :, c, c] = filt
    return k


def fuse_frozen_norms(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A copy of ``state`` with every frozen-BN scale folded into the
    convolution before it, by name (``…convX.weight`` and
    ``…normX.scale``/``…normX.bias``). The fused model computes the same
    function."""
    out = {k: v.clone() for k, v in state.items()}
    for name in state:
        if not name.endswith(".weight"):
            continue
        module = name[:-len(".weight")]
        parent, _, leaf = module.rpartition(".")
        if "conv" not in leaf:
            continue
        norm = (parent + "." if parent else "") + leaf.replace("conv", "norm")
        if f"{norm}.scale" not in state or state[name].dim() != 4:
            continue
        scale = state[f"{norm}.scale"]
        out[name] = state[name] * scale[:, None, None, None].to(
            state[name].dtype)
        out[f"{norm}.scale"] = torch.ones_like(scale)
        if f"{module}.bias" in state:
            out[f"{module}.bias"] = (state[f"{module}.bias"] * scale
                                     + state[f"{norm}.bias"])
            out[f"{norm}.bias"] = torch.zeros_like(scale)
    return out
