"""Port data side (e_osvos_torch.data) against the JAX package on the CPU:
the packed warp's semantics on injected matrices, colour jitter and whole
support-batch augmentation with the JAX key's draws fed in, and the
synthetic sequences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data import transforms as jt
from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_torch.data import transforms as tt
from e_osvos_torch.data.datasets import binarize_label
from e_osvos_torch.data.synthetic import SyntheticVOSIndex

F32 = "float32"


def _frame(seed, h=24, w=30):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    label = rng.choice([0, 1, 255], size=(h, w), p=[0.5, 0.4, 0.1])
    return img, label.astype(np.int32)


def _jax_draws(key, cfg):
    """The factors ``augment_frame`` draws from ``key`` (same splits)."""
    k_color, k_geom, _, _ = jax.random.split(key, 4)
    k_s, k_r, k_f = jax.random.split(k_geom, 3)
    s = jax.random.uniform(k_s, (), minval=cfg.scale_min, maxval=cfg.scale_max)
    theta = jax.random.uniform(k_r, (), minval=-cfg.rot_deg,
                               maxval=cfg.rot_deg) * (jnp.pi / 180.0)
    flip = jax.random.bernoulli(k_f, cfg.flip_prob)
    k_b, k_c, k_sat = jax.random.split(k_color, 3)
    dt = jnp.dtype(cfg.compute_dtype)
    b, c, sat = (jax.random.uniform(k, (), dt, minval=1 - r, maxval=1 + r)
                 for k, r in ((k_b, cfg.brightness), (k_c, cfg.contrast),
                              (k_sat, cfg.saturation)))
    vals = [np.asarray(v) for v in (s, theta, flip, b, c, sat)]
    return tt.AugmentDraws(
        scale=torch.tensor(vals[0], dtype=torch.float32),
        theta=torch.tensor(vals[1], dtype=torch.float32),
        flip=torch.tensor(bool(vals[2])),
        brightness=torch.tensor(vals[3], dtype=torch.float32),
        contrast=torch.tensor(vals[4], dtype=torch.float32),
        saturation=torch.tensor(vals[5], dtype=torch.float32))


MATRICES = {
    "identity": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "flip": [[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "zoom_out_rotate": [[1.1, 0.31, 0.0], [-0.31, 1.1, 0.0]],
    "shift_past_border": [[0.8, -0.2, 7.3], [0.2, 0.8, -5.6]],
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_affine_warp_packed_matches_jax(name):
    """fp32: image atol 1e-3, labels and the inside mask exact."""
    img, label = _frame(0)
    m = np.asarray(MATRICES[name], np.float32)
    j_img, j_lab, j_in = jt.affine_warp_packed(img, label, m, jnp.float32)
    t_img, t_lab, t_in = tt.affine_warp_packed(
        torch.from_numpy(img), torch.from_numpy(label), torch.from_numpy(m),
        torch.float32)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-3)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))
    if name == "shift_past_border":
        assert (t_lab.numpy() == 255).sum() > (label == 255).sum()
        assert not t_in.numpy().all()


def test_nearest_label_ties_round_up():
    """A half-pixel shift puts every sample exactly between two columns:
    the packed warp takes the upper one (w >= 0.5), not round-half-even."""
    img, label = _frame(1, 6, 8)
    m = np.asarray([[1.0, 0.0, 0.5], [0.0, 1.0, 0.0]], np.float32)
    _, j_lab, _ = jt.affine_warp_packed(img, label, m, jnp.float32)
    _, t_lab, _ = tt.affine_warp_packed(
        torch.from_numpy(img), torch.from_numpy(label), torch.from_numpy(m),
        torch.float32)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    np.testing.assert_array_equal(t_lab.numpy()[:, :-1], label[:, 1:])


def test_scale_rotate_flip_matrix_with_jax_draws():
    cfg = jt.AugmentConfig(flip_prob=0.5, compute_dtype=F32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        _, k_geom, _, _ = jax.random.split(key, 4)
        want = np.asarray(jt.scale_rotate_flip_matrix(k_geom, cfg))
        d = _jax_draws(key, cfg)
        got = tt.scale_rotate_flip_matrix(d.scale, d.theta, d.flip).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_color_jitter_with_jax_draws():
    """compute_dtype float32, factors drawn by the JAX key: atol 1e-3."""
    cfg = jt.AugmentConfig(brightness=0.3, contrast=0.3, saturation=0.3,
                           compute_dtype=F32)
    img, _ = _frame(2)
    key = jax.random.PRNGKey(11)
    mean = jnp.asarray(97.5, jnp.float32)
    want = np.asarray(jt.color_jitter(key, jnp.asarray(img), cfg, mean=mean))
    k_b, k_c, k_s = jax.random.split(key, 3)
    b, c, s = (torch.tensor(np.asarray(jax.random.uniform(
        k, (), jnp.float32, minval=1 - r, maxval=1 + r))).reshape(1)
        for k, r in ((k_b, 0.3), (k_c, 0.3), (k_s, 0.3)))
    got = tt.color_jitter(torch.from_numpy(img)[None], b, c, s,
                          mean=torch.tensor([97.5]))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_augment_support_batch_with_jax_draws():
    """Whole support-batch augmentation (warp, then jitter anchored on the
    pre-warp mean, border zeroed): images atol 1e-2, labels exact."""
    cfg_kw = dict(compute_dtype=F32, flip_prob=0.5)
    jcfg = jt.AugmentConfig(**cfg_kw)
    tcfg = tt.AugmentConfig(**cfg_kw)
    img, label = _frame(3)
    key = jax.random.PRNGKey(5)
    j_imgs, j_labs = jt.augment_support_batch(key, jnp.asarray(img),
                                              jnp.asarray(label), 4, jcfg)
    draws = [_jax_draws(k, jcfg) for k in jax.random.split(key, 4)]
    batch = tt.AugmentDraws(*(torch.stack(f) for f in zip(*draws)))
    t_imgs, t_labs = tt.augment_support_batch(
        torch.from_numpy(img), torch.from_numpy(label), batch, tcfg)
    np.testing.assert_allclose(t_imgs.numpy(), np.asarray(j_imgs), atol=1e-2)
    np.testing.assert_array_equal(t_labs.numpy(), np.asarray(j_labs))
    one_img, one_lab = tt.augment_frame(torch.from_numpy(img),
                                        torch.from_numpy(label), draws[1],
                                        tcfg)
    np.testing.assert_array_equal(one_img.numpy(), t_imgs[1].numpy())
    np.testing.assert_array_equal(one_lab.numpy(), t_labs[1].numpy())


def test_sampler_ranges():
    cfg = tt.AugmentConfig()
    d = tt.sample_augment_draws(torch.Generator().manual_seed(0), cfg, (50, 3))
    assert d.scale.shape == (50, 3)
    assert 0.75 <= d.scale.min() and d.scale.max() <= 1.25
    assert d.theta.abs().max() <= np.pi / 6
    assert 0 < d.flip.float().mean() < 1
    assert d.select(4).scale.shape == (3,)


def test_normalize_and_pad_label_match_jax():
    img, label = _frame(4)
    np.testing.assert_allclose(
        tt.normalize(torch.from_numpy(img)).numpy(),
        np.asarray(jt.normalize(jnp.asarray(img))), atol=1e-5)
    np.testing.assert_array_equal(
        tt.pad_label_to(torch.from_numpy(label), (27, 32)).numpy(),
        np.asarray(jt.pad_label_to(jnp.asarray(label), (27, 32))))


@pytest.mark.parametrize("kwargs", [
    dict(num_sequences=2, num_frames=3, size=(40, 56), num_objects=2),
    dict(num_sequences=1, num_frames=4, size=(48, 48), num_objects=2,
         distractors=1, occluders=1, contrast=0.5, seed=3),
])
def test_synthetic_index_is_identical(kwargs):
    j = JSyntheticVOSIndex(**kwargs)
    t = SyntheticVOSIndex(**kwargs)
    assert list(j.sequences) == list(t.sequences)
    for name, seq in j.sequences.items():
        assert [g.object_ids for g in t.sequences[name].object_groups] == [
            g.object_ids for g in seq.object_groups]
        for f in range(len(seq)):
            np.testing.assert_array_equal(t.get_image(name, f),
                                          j.get_image(name, f))
            np.testing.assert_array_equal(t.get_label(name, f),
                                          j.get_label(name, f))
    gt = t.get_label(list(t.sequences)[0], 0)
    from e_osvos_tpu.data.datasets import binarize_label as j_binarize
    np.testing.assert_array_equal(binarize_label(gt, (2,)), j_binarize(gt, (2,)))
