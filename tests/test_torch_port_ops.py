"""Port ops (e_osvos_torch.ops) against the JAX package on the CPU:
GroupNorm (plain, module, and the kernel formulation against the Pallas
kernel in interpret mode), losses and mask bit-packing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.ops import bits as jbits
from e_osvos_tpu.ops import losses as jlosses
from e_osvos_tpu.ops.group_norm import group_norm as j_group_norm
from e_osvos_tpu.ops.pallas_group_norm import pallas_group_norm
from e_osvos_torch.ops import bits, losses
from e_osvos_torch.ops import cuda_group_norm as kernels
from e_osvos_torch.ops.group_norm import (
    FusedGroupNorm,
    fused_group_norm,
    group_norm,
)


def _gn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3.0 + 1.0).astype(np.float32)
    scale = (rng.randn(shape[-1]) + 1.0).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    return x, scale, bias


GN_CASES = [((2, 8, 10, 32), 4), ((1, 5, 7, 64), 32), ((3, 4, 4, 16), 16),
            ((2, 1, 1, 48), 16)]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_matches_jax(shape, groups, relu):
    """Plain group_norm, fp32: tolerance 1e-5 (f32 sums in another order)."""
    x, s, b = _gn_inputs(shape, 0)
    want = np.asarray(j_group_norm(x, s, b, groups, relu=relu))
    got = group_norm(torch.from_numpy(x), torch.from_numpy(s),
                     torch.from_numpy(b), groups, relu=relu).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_fused_group_norm_module_matches_jax(shape, groups, use_kernel):
    """FusedGroupNorm over NCHW channels_last == JAX group_norm over NHWC;
    fp32, tolerance 1e-5. On CPU tensors no kernel launches."""
    x, s, b = _gn_inputs(shape, 1)
    want = np.asarray(j_group_norm(x, s, b, groups, relu=True))
    mod = FusedGroupNorm(shape[-1], groups, use_relu=True,
                         use_kernel=use_kernel)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(s))
        mod.bias.copy_(torch.from_numpy(b))
    kernels.reset_launch_counts()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last view
    got = mod(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert kernels.launch_counts() == {k: 0 for k in kernels.WRAPPERS}


# (1, 13, 11, 8): 143 rows, a ragged tail tile in the Pallas grid
@pytest.mark.parametrize("shape,groups", [((2, 9, 10, 32), 4),
                                          ((2, 5, 6, 16), 4),
                                          ((1, 13, 11, 8), 2)])
def test_kernel_formulation_matches_pallas_interpret(shape, groups):
    """GroupNormFunction (the kernels' plain twins on the CPU) against
    pallas_group_norm(interpret=True): forward and VJP (dx, dscale, dbias),
    fp32, tolerance 1e-4."""
    x, s, b = _gn_inputs(shape, 2)
    w = np.random.RandomState(3).randn(*shape).astype(np.float32)

    def f(x, s, b):
        return jnp.sum(jnp.sin(pallas_group_norm(x, s, b, groups, 1e-6, True))
                       * w)

    y_j = pallas_group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                            groups, 1e-6, True)
    g_j = jax.grad(f, argnums=(0, 1, 2))(x, s, b)

    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, s, b))
    y_t = fused_group_norm(xt, st, bt, groups)
    (torch.sin(y_t) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-4, rtol=1e-4)
    for got, want in zip((xt.grad, st.grad, bt.grad), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_kernel_twins_match_direct_sums():
    """The wrappers take their plain twins on CPU tensors, and the twins
    compute the group statistics and coefficients from the per-channel sums
    the Pallas kernels define (fp32, tolerance 1e-5)."""
    rng = np.random.RandomState(4)
    n, m, c, g = 2, 37, 24, 4
    x = torch.from_numpy(rng.randn(n, m, c).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, m, c).astype(np.float32))
    scale = torch.from_numpy(rng.randn(c).astype(np.float32))
    bias = torch.from_numpy(rng.randn(c).astype(np.float32))
    a, b, mean, rstd = kernels.group_stats(x, scale, bias, g, 1e-6)
    xg = x.numpy().reshape(n, m, g, c // g)
    np.testing.assert_allclose(mean.numpy(), xg.mean((1, 3)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(xg.var((1, 3)) + 1e-6),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        a.numpy(), np.repeat(rstd.numpy(), c // g, 1) * scale.numpy(),
        rtol=1e-5, atol=1e-5)
    A, B, D, dgamma, dbeta = kernels.group_grad_coeffs(dy, x, scale, mean,
                                                       rstd, g)
    np.testing.assert_allclose(dbeta.numpy(), dy.numpy().sum((0, 1)),
                               rtol=1e-5, atol=1e-5)
    xhat = (x.numpy() * a.numpy()[:, None] + b.numpy()[:, None]
            - bias.numpy()) / scale.numpy()
    np.testing.assert_allclose(dgamma.numpy(), (dy.numpy() * xhat).sum((0, 1)),
                               rtol=1e-4, atol=1e-4)
    y = kernels.affine_apply(x.to(torch.bfloat16), a, b)
    assert y.dtype == torch.bfloat16
    dx = kernels.affine_dx(dy, x, A, B, D)
    assert dx.shape == x.shape
    assert kernels.launch_counts() == {k: 0 for k in kernels.WRAPPERS}


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("batch_average", [True, False])
def test_dice_and_bce_match_jax(use_valid, batch_average):
    """fp32, tolerance 1e-6."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 9, 11) * 3).astype(np.float32)
    labels = (rng.rand(3, 9, 11) > 0.5).astype(np.float32)
    valid = rng.rand(3, 9, 11) > 0.2 if use_valid else None
    want = jlosses.compute_loss("dice", logits, labels, valid,
                                batch_average=batch_average)
    got = losses.compute_loss(
        "dice", torch.from_numpy(logits), torch.from_numpy(labels),
        None if valid is None else torch.from_numpy(valid),
        batch_average=batch_average)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(
        losses.sigmoid_binary_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(labels)).numpy(),
        np.asarray(jlosses.sigmoid_binary_cross_entropy(logits, labels)),
        atol=1e-6, rtol=1e-6)


def test_compute_loss_rejects_unported_names():
    """Every JAX loss name is ported now (tests/test_torch_port_losses.py);
    a name neither package knows raises."""
    with pytest.raises(ValueError):
        losses.compute_loss("focal", torch.zeros(1, 2, 2),
                            torch.zeros(1, 2, 2))


@pytest.mark.parametrize("width", [8, 13, 854])
def test_pack_mask_bits_matches_jax(width):
    """Bit-exact against the JAX packer; unpack is the inverse."""
    mask = np.random.RandomState(width).rand(3, 5, width) > 0.5
    want = np.asarray(jbits.pack_mask_bits(mask))
    got = bits.pack_mask_bits(torch.from_numpy(mask)).numpy()
    assert got.dtype == np.uint8 and got.shape == (3, 5, -(-width // 8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bits.unpack_mask_bits(got, width),
                                  mask.astype(np.uint8))
