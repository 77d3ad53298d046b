"""GroupNorm without a grouped reshape of the activation.

Port of ``e_osvos_tpu/ops/group_norm.py`` and of the custom VJP in
``e_osvos_tpu/ops/pallas_group_norm.py``:

  1. per-channel spatial sums ``s, sq : [N, C]`` in f32;
  2. the group combine on the tiny ``[N, C]`` tensor;
  3. one ``y = x·a + b`` pass with per-(n, c) coefficients.

``group_norm`` is the plain formulation, differentiated by autograd.
``GroupNormFunction`` is the kernel formulation: its forward runs
``group_stats`` (K1 with steps 1-2, two launches) and the apply pass, its
backward ``group_grad_coeffs`` (K2 with the backward's algebra, two
launches) and the ``dx = A·dy + B·x + D`` pass (``ops/cuda_group_norm.py``),
three launches each with no tensor arithmetic between them. It supports one
level of reverse-mode differentiation, as the JAX ``custom_vjp`` does: its
backward raises under ``create_graph`` (second-order meta-gradients), where
a silently first-order result would be wrong.

eps defaults to 1e-6, the flax ``nn.GroupNorm`` default (torch's
``nn.GroupNorm`` uses 1e-5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from e_osvos_torch.ops import cuda_group_norm as kernels


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


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm over ``x [N, M, C]`` through the K1/K2 kernels.

    ``forward`` returns ``(y, mean, rstd)``; mean and rstd ([N, G] f32) are
    the residuals the backward needs (the JAX ``_fwd`` saves the same
    ``(x, scale, mean, rstd)``) and are not differentiable.
    """

    @staticmethod
    def forward(x, scale, bias, num_groups: int, eps: float):
        a, b, mean, rstd = kernels.group_stats(x, scale, bias, num_groups, eps)
        return kernels.affine_apply(x, a, b), mean, rstd

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _bias, num_groups, _eps = inputs
        _y, mean, rstd = output
        ctx.num_groups = num_groups
        ctx.mark_non_differentiable(mean, rstd)
        ctx.save_for_backward(x, scale, mean, rstd)

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, scale, mean, rstd = ctx.saved_tensors
        # a backward with create_graph=True that would have to differentiate
        # these kernels again
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (dy, x, scale)):
            raise RuntimeError(
                "the GroupNorm kernels support one level of differentiation; "
                "build the model with the *_xla norms for second-order "
                "gradients")
        dy = dy.contiguous()
        A, B, D, dgamma, dbeta = kernels.group_grad_coeffs(
            dy, x, scale, mean, rstd, ctx.num_groups)
        return kernels.affine_dx(dy, x, A, B, D), dgamma, dbeta, None, None


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
        kernels.check_groups(num_channels, num_groups)
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
