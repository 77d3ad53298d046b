"""Port losses (e_osvos_torch.ops.losses) against the JAX package on the
CPU: every ``compute_loss`` branch, the class-balanced BCE in both
reduction forms, and the multi-class Lovász-softmax, on the same seeded
numpy inputs with ignored pixels. Tolerance: 1e-5 relative to the loss
(at least 1e-6 absolute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.ops import losses as jl
from e_osvos_torch.ops import losses as tl

RTOL, ATOL = 1e-5, 1e-6


def _binary(seed, shape=(3, 12, 10)):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape) * 2.0).astype(np.float32)
    labels = (rng.rand(*shape) > 0.6).astype(np.float32)
    valid = rng.rand(*shape) > 0.15
    return logits, labels, valid


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch_average", [True, False])
@pytest.mark.parametrize("loss_func", sorted(jl.LOSS_FUNCS)
                         + ["cross_entropy_and_dice"])
def test_compute_loss_matches_jax(loss_func, batch_average, masked):
    logits, labels, valid = _binary(0)
    v = valid if masked else None
    want = jl.compute_loss(loss_func, jnp.asarray(logits), jnp.asarray(labels),
                           None if v is None else jnp.asarray(v),
                           batch_average=batch_average)
    got = tl.compute_loss(loss_func, torch.from_numpy(logits),
                          torch.from_numpy(labels),
                          None if v is None else torch.from_numpy(v),
                          batch_average=batch_average)
    assert got.shape == np.shape(want)
    _close(got, want)


def test_loss_funcs_keys_match_jax():
    assert set(tl.LOSS_FUNCS) == set(jl.LOSS_FUNCS)
    with pytest.raises(ValueError):
        tl.compute_loss("focal", torch.zeros(1, 2, 2), torch.zeros(1, 2, 2))


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("batch_average", [True, False])
def test_class_balanced_cross_entropy_matches_jax(batch_average,
                                                  size_average):
    """Soft labels (thresholded at 0.5 inside), ignored pixels, and one
    image with no valid pixel at all (the frequencies' floor of 1)."""
    logits, labels, valid = _binary(1)
    labels = labels * 0.7 + 0.2
    valid[1] = False
    want = jl.class_balanced_cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid),
        size_average=size_average, batch_average=batch_average)
    got = tl.class_balanced_cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(valid), size_average=size_average,
        batch_average=batch_average)
    assert got.shape == np.shape(want)
    _close(got, want)


def _multiclass(seed, shape=(2, 9, 7), c=4):
    rng = np.random.RandomState(seed)
    z = rng.randn(*shape, c).astype(np.float32) * 2.0
    probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    # class 3 absent: it must leave the class mean
    labels = rng.randint(0, c - 1, shape).astype(np.int32)
    valid = rng.rand(*shape) > 0.2
    return probs.astype(np.float32), labels, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_image", [False, True])
def test_lovasz_softmax_matches_jax(per_image, masked):
    probs, labels, valid = _multiclass(2)
    v = valid if masked else None
    want = jl.lovasz_softmax(jnp.asarray(probs), jnp.asarray(labels),
                             None if v is None else jnp.asarray(v),
                             per_image=per_image)
    got = tl.lovasz_softmax(torch.from_numpy(probs), torch.from_numpy(labels),
                            None if v is None else torch.from_numpy(v),
                            per_image=per_image)
    _close(got, want)


def test_lovasz_softmax_flat_matches_jax_and_is_zero_when_all_ignored():
    probs, labels, valid = _multiclass(3)
    p, lab, v = probs.reshape(-1, 4), labels.reshape(-1), valid.reshape(-1)
    want = jl.lovasz_softmax_flat(jnp.asarray(p), jnp.asarray(lab),
                                  jnp.asarray(v))
    got = tl.lovasz_softmax_flat(torch.from_numpy(p), torch.from_numpy(lab),
                                 torch.from_numpy(v))
    _close(got, want)
    none = tl.lovasz_softmax_flat(torch.from_numpy(p), torch.from_numpy(lab),
                                  torch.zeros(v.shape, dtype=torch.bool))
    assert float(none) == 0.0


def test_lovasz_softmax_gradient_matches_jax():
    """The gradient w.r.t. the probabilities (the sort's permutation routes
    it), atol 1e-6."""
    import jax

    probs, labels, valid = _multiclass(4)
    want = jax.grad(lambda p: jl.lovasz_softmax(
        p, jnp.asarray(labels), jnp.asarray(valid)))(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_(True)
    tl.lovasz_softmax(p, torch.from_numpy(labels),
                      torch.from_numpy(valid)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), atol=1e-6)
