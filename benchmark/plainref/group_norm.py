"""GroupNorm of the reference: the port's plain formulation
(``ops/group_norm.py::group_norm``), differentiated by autograd. The
module keeps the port's ``FusedGroupNorm`` name and parameters so
parameter names match; ``use_kernel`` is kept and ignored: no kernel
runs here. eps defaults to 1e-6, the flax default."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from plainref import plain_kernels as kernels


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-6, relu: bool = False
               ) -> torch.Tensor:
    """Plain GroupNorm over ``[N, ..., C]`` with f32 statistics; ``relu``
    folds the activation into the normalize pass."""
    n, c = x.shape[0], x.shape[-1]
    kernels.check_groups(c, num_groups)
    m = math.prod(x.shape[1:-1])
    xf = x.reshape(n, m, c).float()
    a, b, _, _ = kernels.group_stats_plain(xf, scale, bias, num_groups, eps)
    y = xf * a[:, None] + b[:, None]
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype).reshape(x.shape)


class FusedGroupNorm(nn.Module):
    """GroupNorm module over NCHW activations (``torch.channels_last`` keeps
    them physically ``[N, H, W, C]``, the kernels' layout).

    ``use_kernel`` is accepted and ignored: the plain ``group_norm`` always
    runs. Parameters ``scale`` and
    ``bias`` have shape ``[C]``, as in ``nn.GroupNorm`` of flax.
    """

    def __init__(self, num_channels: int, num_groups: int = 32,
                 epsilon: float = 1e-6, use_relu: bool = False,
                 use_kernel: bool = True):
        super().__init__()
        kernels.check_groups(num_channels, num_groups)
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.use_relu = use_relu
        self.use_kernel = use_kernel
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xl = x.movedim(1, -1)  # [N, H, W, C]; a view for channels_last
        y = group_norm(xl, self.scale, self.bias, self.num_groups,
                       self.epsilon, relu=self.use_relu)
        return y.movedim(-1, 1)
