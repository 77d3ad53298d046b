"""The rest of the port's augmentation (e_osvos_torch.data.transforms)
against the JAX package on the CPU, with the JAX keys' draws fed in: the
plain affine warp, the Gaussian blur, a whole frame augmentation with
translation and blur (the VOC parent stack), the per-task augmentation of
meta-training and the random crop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data import transforms as jt
from e_osvos_torch.data import transforms as tt

F32 = "float32"


def _frame(seed, h=20, w=26):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    label = rng.choice([0, 1, 255], size=(h, w), p=[0.5, 0.4, 0.1])
    return img, label.astype(np.int32)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def jax_frame_draws(key, cfg, color_key=None, flip=None):
    """The draws ``jt.augment_frame(key, ..., color_key, flip)`` makes, as
    scalar port draws (the same splits)."""
    k_color, k_geom, k_trans, k_blur = jax.random.split(key, 4)
    if color_key is not None:
        k_color = color_key
    k_s, k_r, k_f = jax.random.split(k_geom, 3)
    scale = jax.random.uniform(k_s, (), minval=cfg.scale_min,
                               maxval=cfg.scale_max)
    theta = jax.random.uniform(k_r, (), minval=-cfg.rot_deg,
                               maxval=cfg.rot_deg) * (jnp.pi / 180.0)
    if flip is None:
        flip = jax.random.bernoulli(k_f, cfg.flip_prob)
    dt = jnp.dtype(cfg.compute_dtype)
    k_b, k_c, k_sat = jax.random.split(k_color, 3)
    b, c, s = (jax.random.uniform(k, (), dt, minval=1 - r, maxval=1 + r)
               for k, r in ((k_b, cfg.brightness), (k_c, cfg.contrast),
                            (k_sat, cfg.saturation)))
    draws = tt.AugmentDraws(
        scale=_t(scale), theta=_t(theta), flip=_t(flip, torch.bool),
        brightness=_t(b), contrast=_t(c), saturation=_t(s))
    if cfg.trans_frac > 0:
        draws = draws._replace(trans=_t(jax.random.uniform(
            k_trans, (2,), minval=-cfg.trans_frac, maxval=cfg.trans_frac)))
    if cfg.blur_prob > 0:
        k_p, k_sig = jax.random.split(k_blur)
        draws = draws._replace(
            blur=_t(jax.random.bernoulli(k_p, cfg.blur_prob), torch.bool),
            sigma=_t(jax.random.uniform(k_sig, (), minval=0.0,
                                        maxval=cfg.blur_sigma_max)))
    return draws


def jax_task_draws(key, cfg, num_frames):
    """The draws ``jt.augment_task_frames(key, ...)`` makes, as port draws
    ``[num_frames]`` (support first)."""
    k_flip, k_color, k_geom = jax.random.split(key, 3)
    flip = jax.random.bernoulli(k_flip, cfg.flip_prob)
    frames = [jax_frame_draws(jax.random.fold_in(k_geom, i), cfg,
                              color_key=k_color, flip=flip)
              for i in range(num_frames)]
    return tt.AugmentDraws(*(None if f[0] is None else torch.stack(f)
                             for f in zip(*frames)))


def port_cfg(jcfg):
    return tt.AugmentConfig(**{f: getattr(jcfg, f)
                               for f in tt.AugmentConfig.__dataclass_fields__})


MATRICES = {
    "identity": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "zoom_out_rotate": [[1.1, 0.31, 0.0], [-0.31, 1.1, 0.0]],
    "shift_past_border": [[0.8, -0.2, 7.3], [0.2, 0.8, -5.6]],
    "half_pixel": [[1.0, 0.0, 0.5], [0.0, 1.0, -0.5]],
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_affine_warp_matches_jax(name):
    """fp32 image atol 1e-3 (with cval 7), labels exact (cval 255, the
    nearest pixel rounding half to even)."""
    img, label = _frame(0)
    m = np.asarray(MATRICES[name], np.float32)
    j_img, j_lab = jt.affine_warp(jnp.asarray(img), jnp.asarray(label),
                                  jnp.asarray(m), img_cval=7.0,
                                  label_cval=255)
    t_img, t_lab = tt.affine_warp(torch.from_numpy(img),
                                  torch.from_numpy(label),
                                  torch.from_numpy(m), img_cval=7.0,
                                  label_cval=255)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-3)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))


@pytest.mark.parametrize("seed", range(4))
def test_gaussian_blur_with_jax_draws(seed):
    """prob 0.5, sigma_max 2: blurred or not by the JAX draw, atol 1e-3 on
    [0, 255] values; edge-replicate borders included."""
    img, _ = _frame(seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jt.gaussian_blur(key, jnp.asarray(img), 0.5, 2.0))
    k_p, k_s = jax.random.split(key)
    do = _t(jax.random.bernoulli(k_p, 0.5), torch.bool).reshape(1)
    sigma = _t(jax.random.uniform(k_s, (), minval=0.0, maxval=2.0)).reshape(1)
    got = tt.gaussian_blur(torch.from_numpy(img)[None], do, sigma)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_gaussian_blur_batch_mixes_decisions():
    """One call over a batch: image 0 blurred, image 1 untouched."""
    img, _ = _frame(5)
    x = torch.from_numpy(np.stack([img, img]))
    out = tt.gaussian_blur(x, torch.tensor([True, False]),
                           torch.tensor([1.0, 1.0]))
    assert torch.equal(out[1], x[1])
    assert not torch.allclose(out[0], x[0])


@pytest.mark.parametrize("seed", range(3))
def test_augment_frame_with_translation_and_blur(seed):
    """The VOC parent stack (translation, blur) in float32 with a mild
    colour jitter: images atol 2e-2, labels exact."""
    jcfg = jt.AugmentConfig(**{**jt.VOC_PARENT_AUGMENT.__dict__,
                               "brightness": 0.1, "compute_dtype": F32})
    img, label = _frame(seed + 10)
    key = jax.random.PRNGKey(100 + seed)
    j_img, j_lab = jt.augment_frame(key, jnp.asarray(img), jnp.asarray(label),
                                    jcfg)
    draws = jax_frame_draws(key, jcfg)
    t_img, t_lab = tt.augment_frame(torch.from_numpy(img),
                                    torch.from_numpy(label), draws,
                                    port_cfg(jcfg))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=2e-2)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))


def test_voc_parent_augment_matches_jax():
    assert port_cfg(jt.VOC_PARENT_AUGMENT) == tt.VOC_PARENT_AUGMENT


@pytest.mark.parametrize("seed", range(3))
def test_augment_task_frames_with_jax_draws(seed):
    """Support and two queries of one task (shared flip and colour, a warp
    each), float32: images atol 2e-2, labels exact; the port's sampler
    shares the flip and colour draws the same way."""
    jcfg = jt.AugmentConfig(compute_dtype=F32)
    (s_img, s_lab), q0, q1 = _frame(seed), _frame(seed + 1), _frame(seed + 2)
    q_img = np.stack([q0[0], q1[0]])
    q_lab = np.stack([q0[1], q1[1]])
    key = jax.random.PRNGKey(7 + seed)
    want = jt.augment_task_frames(key, jnp.asarray(s_img), jnp.asarray(s_lab),
                                  jnp.asarray(q_img), jnp.asarray(q_lab),
                                  jcfg)
    draws = jax_task_draws(key, jcfg, 3)
    got = tt.augment_task_frames(
        torch.from_numpy(s_img), torch.from_numpy(s_lab),
        torch.from_numpy(q_img), torch.from_numpy(q_lab), draws,
        port_cfg(jcfg))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    own = tt.sample_task_draws(torch.Generator().manual_seed(seed),
                               port_cfg(jcfg), 3)
    for f in ("flip", "brightness", "contrast", "saturation"):
        v = getattr(own, f)
        assert torch.equal(v, v[:1].expand(3)), f
    assert len(set(own.scale.tolist())) == 3


@pytest.mark.parametrize("hw", [(20, 26), (12, 10)])
def test_random_crop_with_jax_draws(hw):
    """The JAX key's offsets fed in: crops equal; a crop as large as the
    frame has offset 0."""
    img, label = _frame(3, *hw)
    size = (12, 10)
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        j_img, j_lab = jt.random_crop(key, jnp.asarray(img),
                                      jnp.asarray(label), size)
        ky, kx = jax.random.split(key)
        y0 = int(jax.random.randint(ky, (), 0, max(hw[0] - size[0], 0) + 1))
        x0 = int(jax.random.randint(kx, (), 0, max(hw[1] - size[1], 0) + 1))
        t_img, t_lab = tt.random_crop(torch.from_numpy(img),
                                      torch.from_numpy(label), size, (y0, x0))
        np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
        np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    y0, x0 = tt.sample_crop_offset(torch.Generator().manual_seed(0), hw, size)
    assert 0 <= y0 <= hw[0] - size[0] and 0 <= x0 <= hw[1] - size[1]
    with pytest.raises(ValueError):
        tt.random_crop(torch.from_numpy(img), torch.from_numpy(label),
                       (hw[0] + 1, 4), (0, 0))


def test_default_draws_unchanged_by_the_new_steps():
    """Without translation or blur the sampler draws what it drew before
    (the evaluation path's draws do not move), and adds the new fields
    only when configured."""
    gen = torch.Generator().manual_seed(0)
    base = tt.sample_augment_draws(gen, tt.AugmentConfig(), (2, 3))
    assert base.trans is None and base.blur is None and base.sigma is None
    gen = torch.Generator().manual_seed(0)
    more = tt.sample_augment_draws(
        gen, tt.AugmentConfig(trans_frac=0.1, blur_prob=0.5), (2, 3))
    for a, b in zip(base[:6], more[:6]):
        assert torch.equal(a, b)
    assert more.trans.shape == (2, 3, 2) and more.sigma.shape == (2, 3)
    assert more.select(1).trans.shape == (3, 2)
