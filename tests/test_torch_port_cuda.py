"""The GroupNorm kernels on the card against their plain twins.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode) and run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

These tests import no JAX-side code, so they also run where only the port
is installed."""

import numpy as np
import pytest
import torch

from e_osvos_torch.ops import cuda_group_norm as kernels
from e_osvos_torch.ops.group_norm import FusedGroupNorm, group_norm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (N, M, C): ragged chunk tail, C not a multiple of 32, M = 1
SHAPES = [(2, 300, 64), (1, 257, 48), (3, 1, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_sums_match_twins(cuda, shape, dtype):
    """f32 sums: relative 1e-5 (fp32 inputs) / 1e-4 (bf16 inputs) of the
    sum of magnitudes."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen).to(cuda, dtype)
    dy = torch.randn(shape, generator=gen).to(cuda, dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    xf, dyf = x.float(), dy.float()
    pairs = [(kernels.channel_sums(x), kernels.channel_sums_plain(x),
              (xf.abs().sum(1), (xf * xf).sum(1))),
             (kernels.pair_sums(dy, x), kernels.pair_sums_plain(dy, x),
              (dyf.abs().sum(1), (dyf * xf).abs().sum(1)))]
    for got, want, mags in pairs:
        for g, w, mag in zip(got, want, mags):
            assert ((g - w).abs() <= tol * mag + 1e-6).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_module_forward_backward_fp32(cuda, shape):
    """FusedGroupNorm through the kernels == plain group_norm with autograd,
    fp32: values and gradients atol 1e-4; each wrapper called once."""
    n, m, c = shape
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, m, 1, c, generator=gen).to(cuda).permute(0, 3, 1, 2)
    w = torch.randn(n, m, 1, c, generator=gen).to(cuda).permute(0, 3, 1, 2)
    mod = FusedGroupNorm(c, 16).to(cuda)
    with torch.no_grad():
        mod.scale.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
        mod.bias.copy_(0.3 * torch.randn(c, generator=gen))
    kernels.reset_launch_counts()
    xk = x.clone().requires_grad_(True)
    yk = mod(xk)
    gk = torch.autograd.grad((yk * w).sum(), (xk, mod.scale, mod.bias))
    assert kernels.launch_counts() == kernels.LAUNCHES_PER_CALL
    xp = x.clone().requires_grad_(True)
    yp = group_norm(xp.movedim(1, -1), mod.scale, mod.bias, 16).movedim(-1, 1)
    gp = torch.autograd.grad((yp * w).sum(), (xp, mod.scale, mod.bias))
    torch.cuda.synchronize()
    np.testing.assert_allclose(yk.detach().cpu(), yp.detach().cpu(), atol=1e-4)
    for a, b in zip(gk, gp):
        np.testing.assert_allclose(a.cpu(), b.cpu(), atol=1e-4, rtol=1e-4)


def test_wrappers_reject_bad_operands(cuda):
    x = torch.zeros(2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kernels.channel_sums(x)
    y = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        kernels.channel_sums(y)
