"""Weights, learned init and learning rates of one run, made from the
seed on the device in a few large calls.

Both sides get the same tensors: the program's evaluator takes them as
its meta-parameters (the learned init, frozen-BN constants included, and
the per-neuron learning rates) and the reference takes them as its
parameters. Rules, by the entry's name and shape:

* kernels (``*weight`` of two or more dims): lecun-normal, normal
  truncated at two standard deviations with variance 1/fan_in (flax's
  default, and the port's own init);
* ``*bias``: uniform in [-0.05, 0.05]; ``*scale``: uniform in [0.9, 1.1]
  (norm affines and frozen-BN constants), so that no bias or scale is an
  identity that a missing term would not show;
* BatchNorm running ``*mean`` 0 and ``*var`` 1;
* each learning rate: the configuration's ``init_lr`` times a uniform in
  [0.5, 1.5], one a neuron (its tensor's dim 0) at the ``neuron`` level.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

TRUNC_STD = 0.87962566103423978  # std of the unit normal cut to [-2, 2]


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) >= 2:
        return "kernel"
    if leaf in ("bias", "scale", "mean", "var"):
        return leaf
    raise ValueError(f"no weight rule for {name!r} of shape {tuple(shape)}")


def seeded_state(shapes: Mapping[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``shapes`` by the module's rules, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kinds = {k: _kind(k, s) for k, s in shapes.items()}
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    out: Dict[str, torch.Tensor] = {}

    kernels = [k for k in shapes if kinds[k] == "kernel"]
    n = sum(sizes[k] for k in kernels)
    flat = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    std = torch.tensor([math.sqrt(1.0 / math.prod(shapes[k][1:])) / TRUNC_STD
                        for k in kernels], device=device)
    flat *= std.repeat_interleave(torch.tensor([sizes[k] for k in kernels],
                                               device=device))
    for k, piece in zip(kernels, flat.split([sizes[k] for k in kernels])):
        out[k] = piece.view(shapes[k])

    affine = [k for k in shapes if kinds[k] in ("bias", "scale")]
    flat = torch.rand(sum(sizes[k] for k in affine), generator=gen,
                      device=device)
    for k, piece in zip(affine, flat.split([sizes[k] for k in affine])):
        u = piece.view(shapes[k])
        out[k] = (u - 0.5) * 0.1 if kinds[k] == "bias" else 0.9 + 0.2 * u
    for k in shapes:
        if kinds[k] in ("mean", "var"):
            out[k] = torch.full(shapes[k], 0.0 if kinds[k] == "mean" else 1.0,
                                device=device)
    return {k: out[k] for k in shapes}


def seeded_lrs(lr_shapes: Mapping[str, Tuple[int, ...]], init_lr: float,
               seed: int, device) -> Dict[str, torch.Tensor]:
    """Linear-space learning rates of ``lr_shapes`` around ``init_lr``."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    sizes = [math.prod(s) for s in lr_shapes.values()]
    flat = init_lr * (0.5 + torch.rand(sum(sizes), generator=gen,
                                       device=device))
    return {k: piece.view(s) for (k, s), piece
            in zip(lr_shapes.items(), flat.split(sizes))}
