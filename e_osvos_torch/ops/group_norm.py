"""GroupNorm without a grouped reshape of the activation.

Port of ``e_osvos_tpu/ops/group_norm.py`` and of the custom VJP in
``e_osvos_tpu/ops/pallas_group_norm.py``:

  1. per-channel spatial sums ``s, sq : [N, C]`` in f32;
  2. the group combine on the tiny ``[N, C]`` tensor;
  3. one ``y = x·a + b`` pass with per-(n, c) coefficients.

``group_norm`` is the plain formulation, differentiated by autograd.
``GroupNormFunction`` is the kernel formulation: its forward runs the stats
kernel (K1) and the apply pass, its backward the pair-sums kernel (K2) and
the ``dx = A·dy + B·x + D`` pass (``ops/cuda_group_norm.py``). It supports
one level of reverse-mode differentiation, as the JAX ``custom_vjp`` does.

eps defaults to 1e-6, the flax ``nn.GroupNorm`` default (torch's
``nn.GroupNorm`` uses 1e-5).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from e_osvos_torch.ops import cuda_group_norm as kernels


def _group_stats(s: torch.Tensor, sq: torch.Tensor, g: int, m_per_group: int,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel sums [N, C] → per-group (mean, rstd) [N, G]."""
    n, c = s.shape
    gs = s.view(n, g, c // g).sum(-1)
    gsq = sq.view(n, g, c // g).sum(-1)
    mean = gs / m_per_group
    # clamp: E[x^2]-E[x]^2 can cancel slightly negative in f32
    var = (gsq / m_per_group - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def _expand(t: torch.Tensor, c: int) -> torch.Tensor:
    """[N, G] → [N, C] per-channel broadcast."""
    return t.repeat_interleave(c // t.shape[-1], dim=-1)


def _coefficients(mean, rstd, scale, bias, c):
    a = _expand(rstd, c) * scale.float()[None]
    b = bias.float()[None] - _expand(mean, c) * a
    return a.contiguous(), b.contiguous()


def _check_groups(c: int, g: int) -> None:
    if c % g:
        raise ValueError(f"channels {c} not divisible by groups {g}")


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-6, relu: bool = False
               ) -> torch.Tensor:
    """Plain GroupNorm over ``[N, ..., C]`` with f32 statistics; ``relu``
    folds the activation into the normalize pass."""
    n, c = x.shape[0], x.shape[-1]
    _check_groups(c, num_groups)
    m = math.prod(x.shape[1:-1])
    xf = x.reshape(n, m, c).float()
    s, sq = xf.sum(1), (xf * xf).sum(1)
    mean, rstd = _group_stats(s, sq, num_groups, m * (c // num_groups), eps)
    a, b = _coefficients(mean, rstd, scale, bias, c)
    y = xf * a[:, None] + b[:, None]
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype).reshape(x.shape)


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm over ``x [N, M, C]`` through the K1/K2 kernels.

    ``forward`` returns ``(y, mean, rstd)``; mean and rstd ([N, G] f32) are
    the residuals the backward needs (the JAX ``_fwd`` saves the same
    ``(x, scale, mean, rstd)``) and are not differentiable.
    """

    @staticmethod
    def forward(x, scale, bias, num_groups: int, eps: float):
        n, m, c = x.shape
        _check_groups(c, num_groups)
        s, sq = kernels.channel_sums(x)
        mean, rstd = _group_stats(s, sq, num_groups, m * (c // num_groups), eps)
        a, b = _coefficients(mean, rstd, scale, bias, c)
        return kernels.affine_apply(x, a, b), mean, rstd

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _bias, num_groups, _eps = inputs
        _y, mean, rstd = output
        ctx.num_groups = num_groups
        ctx.mark_non_differentiable(mean, rstd)
        ctx.save_for_backward(x, scale, mean, rstd)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _dmean, _drstd):
        x, scale, mean, rstd = ctx.saved_tensors
        g = ctx.num_groups
        n, m, c = x.shape
        m_per_group = m * (c // g)
        s1, s2 = kernels.pair_sums(dy.contiguous(), x)  # Σdy, Σdy·x [N, C]

        mean_c = _expand(mean, c)
        rstd_c = _expand(rstd, c)
        gamma = scale.float()[None]
        sum_dy_xhat = rstd_c * (s2 - mean_c * s1)
        dgamma = sum_dy_xhat.sum(0).to(scale.dtype)
        dbeta = s1.sum(0).to(scale.dtype)

        c1 = (gamma * s1).view(n, g, c // g).sum(-1)  # Σ dy·γ per group
        c2 = (gamma * sum_dy_xhat).view(n, g, c // g).sum(-1)  # Σ dy·γ·x̂
        # dx = rstd·γ·dy − rstd/m·(c1 + x̂·c2) = A·dy + B·x + D
        A = (rstd_c * gamma).contiguous()
        B = _expand(-(rstd * rstd) * c2 / m_per_group, c).contiguous()
        D = _expand((rstd * rstd * c2 * mean - rstd * c1) / m_per_group,
                    c).contiguous()
        dx = kernels.affine_dx(dy.contiguous(), x, A, B, D)
        return dx, dgamma, dbeta, None, None


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over ``[N, ..., C]`` through ``GroupNormFunction``; the
    counterpart of ``pallas_group_norm``. On CPU tensors the kernels' plain
    twins run."""
    n, c = x.shape[0], x.shape[-1]
    x3 = x.reshape(n, -1, c).contiguous()
    y, _, _ = GroupNormFunction.apply(x3, scale, bias, num_groups, eps)
    return y.view(x.shape)


class FusedGroupNorm(nn.Module):
    """GroupNorm module over NCHW activations (``torch.channels_last`` keeps
    them physically ``[N, H, W, C]``, the kernels' layout).

    ``use_kernel`` mirrors the JAX module's ``use_pallas``: True runs
    ``GroupNormFunction`` (the kernels on the card, their plain twins on the
    CPU); False always takes the plain, arbitrarily differentiable
    ``group_norm`` (the ``*_xla`` norm variants). Parameters ``scale`` and
    ``bias`` have shape ``[C]``, as in ``nn.GroupNorm`` of flax.
    """

    def __init__(self, num_channels: int, num_groups: int = 32,
                 epsilon: float = 1e-6, use_relu: bool = False,
                 use_kernel: bool = True):
        super().__init__()
        _check_groups(num_channels, num_groups)
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.use_relu = use_relu
        self.use_kernel = use_kernel
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xl = x.movedim(1, -1)  # [N, H, W, C]; a view for channels_last
        if self.use_kernel:
            y = fused_group_norm(xl, self.scale, self.bias, self.num_groups,
                                 self.epsilon)
            if self.use_relu:
                y = F.relu(y)
        else:
            y = group_norm(xl, self.scale, self.bias, self.num_groups,
                           self.epsilon, relu=self.use_relu)
        return y.movedim(-1, 1)
