"""Port detection ops (e_osvos_torch.ops: boxes, nms, cuda_nms, roi_align,
the Mask R-CNN losses) against the JAX package on the CPU.

NMS selections must be identical, index for index, to the JAX oracle
(``ops/nms.py``) and to the Pallas kernel in interpret mode (the K3 kernel's
CPU reference, as ``tests/test_pallas_nms.py`` runs it). Float outputs are
f32 on both sides: tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.ops import boxes as jboxes
from e_osvos_tpu.ops import losses as jlosses
from e_osvos_tpu.ops import nms as jnms
from e_osvos_tpu.ops import roi_align as jroi
from e_osvos_tpu.ops.pallas_nms import nms_pallas
from e_osvos_torch.ops import boxes, cuda_nms, losses, nms, roi_align


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def random_boxes(rng, n, span=80.0, size=40.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(2, size, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---- boxes -------------------------------------------------------------------


def test_box_utils_match_jax():
    """area, IoU, clip, encode/decode, small-box mask: f32 elementwise,
    rtol 1e-6 / atol 1e-5; masks_to_boxes exactly."""
    rng = np.random.RandomState(0)
    a = random_boxes(rng, 7)
    b = random_boxes(rng, 5)
    b[0] = [3, 3, 3, 9]  # degenerate: zero width
    d = (rng.randn(7, 4) * 0.5).astype(np.float32)
    d[0, 2] = 9.0  # past the exp() clip
    pairs = [
        (boxes.box_area(_t(a)), jboxes.box_area(a)),
        (boxes.box_iou(_t(a), _t(b)), jboxes.box_iou(a, b)),
        (boxes.clip_boxes(_t(a), (50, 60)), jboxes.clip_boxes(a, (50, 60))),
        (boxes.encode_boxes(_t(a), _t(a[::-1].copy())),
         jboxes.encode_boxes(a, a[::-1])),
        (boxes.decode_boxes(_t(d), _t(a)), jboxes.decode_boxes(d, a)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)
    np.testing.assert_array_equal(
        boxes.remove_small_boxes_mask(_t(b), 3.0).numpy(),
        np.asarray(jboxes.remove_small_boxes_mask(b, 3.0)))

    masks = np.zeros((3, 12, 15), np.float32)
    masks[0, 2:5, 3:9] = 1
    masks[2, 11, 0] = 1  # one pixel at the corner; mask 1 empty
    got_b, got_v = boxes.masks_to_boxes(_t(masks))
    want_b, want_v = jboxes.masks_to_boxes(masks)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_jitter_with_jax_uniforms():
    """The JAX key's unit uniforms through ``uniform_to_noise`` give
    ``jitter_boxes(key, ...)``'s boxes: atol 1e-4 (f32, boxes ~100)."""
    rng = np.random.RandomState(1)
    bx = random_boxes(rng, 6)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, bx.shape))
    want = np.asarray(jboxes.jitter_boxes(key, bx, 0.1))
    got = boxes.jitter_boxes(_t(bx), boxes.uniform_to_noise(_t(u), 0.1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# ---- NMS -----------------------------------------------------------------------


def _nms_case(name):
    """(boxes, scores, valid, iou_threshold, max_out) of a named case."""
    rng = np.random.RandomState(len(name))
    if name == "random":
        n = 200
        return (random_boxes(rng, n), rng.uniform(size=n).astype(np.float32),
                np.ones(n, bool), 0.5, 32)
    if name == "ragged_masked":  # N not a multiple of 128, a third masked
        n = 77
        return (random_boxes(rng, n), rng.uniform(size=n).astype(np.float32),
                rng.uniform(size=n) > 0.33, 0.3, 40)
    if name == "all_invalid":
        n = 20
        return (random_boxes(rng, n), rng.uniform(size=n).astype(np.float32),
                np.zeros(n, bool), 0.5, 6)
    if name == "ties":  # exact score ties: the lowest index wins
        n = 60
        scores = rng.randint(0, 4, n).astype(np.float32) / 4
        return random_boxes(rng, n, span=30.0), scores, np.ones(n, bool), 0.4, 25
    if name == "minus_inf":  # -inf scores are never alive
        n = 10
        scores = rng.uniform(size=n).astype(np.float32)
        scores[::3] = -np.inf
        return random_boxes(rng, n), scores, np.ones(n, bool), 0.5, 10
    raise KeyError(name)


NMS_CASES = ["random", "ragged_masked", "all_invalid", "ties", "minus_inf"]


@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_matches_jax_and_pallas_interpret(case):
    """Greedy NMS (K3's twin): indices and keep flags identical to the JAX
    oracle and to the Pallas kernel run in interpret mode."""
    bx, sc, va, thr, max_out = _nms_case(case)
    got_i, got_k = nms.nms(_t(bx), _t(sc), thr, max_out, valid=_t(va))
    jb, js, jv = _j(bx, sc, va)
    ref_i, ref_k = jnms.nms(jb, js, thr, max_out, valid=jv)
    pal_i, pal_k = nms_pallas(jb, js, thr, max_out, valid=jv, interpret=True)
    assert got_i.dtype == torch.int32 and got_k.dtype == torch.bool
    for want_i, want_k in ((ref_i, ref_k), (pal_i, pal_k)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    if case == "all_invalid":
        assert (got_i.numpy() == -1).all() and not got_k.numpy().any()


def test_greedy_nms_twin_batches_images():
    """The kernel wrapper's CPU path over ``[B, N]`` equals the per-image
    twin; it checks operands as the kernel would see them."""
    cases = [_nms_case("random")[:3], _nms_case("ties")[:3]]
    n = 60
    bx = np.stack([c[0][:n] for c in cases])
    sc = np.stack([c[1][:n] for c in cases])
    va = np.stack([c[2][:n] for c in cases])
    idx, keep = cuda_nms.greedy_nms(_t(bx), _t(sc), _t(va), 0.45, 17)
    assert idx.shape == keep.shape == (2, 17)
    for i in range(2):
        want_i, want_k = jnms.nms(*_j(bx[i], sc[i]), 0.45, 17,
                                  valid=jnp.asarray(va[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(want_k))
    assert cuda_nms.greedy_nms.launches == 0  # the twin counts nothing
    with pytest.raises(ValueError):
        cuda_nms._check(_t(bx[0]), _t(sc), _t(va), 17)
    with pytest.raises(TypeError):
        cuda_nms._check(_t(bx).double(), _t(sc), _t(va), 17)
    with pytest.raises(ValueError):
        cuda_nms._check(_t(bx), _t(sc), _t(va), 0)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_batched_nms_matches_jax(case):
    """Class-aware greedy NMS by the coordinate offset: identical selections
    (the JAX package runs its XLA NMS off the TPU)."""
    bx, sc, va, thr, max_out = _nms_case(case)
    ids = np.random.RandomState(5).randint(0, 3, len(sc)).astype(np.int32)
    got_i, got_k = nms.batched_nms(_t(bx), _t(sc), _t(ids), thr, max_out,
                                   valid=_t(va))
    jb, js, ji, jv = _j(bx, sc, ids, va)
    want_i, want_k = jnms.batched_nms(jb, js, ji, thr, max_out, valid=jv)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


@pytest.mark.parametrize("case", NMS_CASES)
@pytest.mark.parametrize("with_ids", [False, True])
def test_fast_nms_matches_jax(case, with_ids):
    """One-pass Fast NMS: identical indices and keep flags, with and
    without level ids, including the overflow past ``max_out``."""
    bx, sc, va, thr, max_out = _nms_case(case)
    ids = (np.arange(len(sc)) % 3).astype(np.int32) if with_ids else None
    got_i, got_k = nms.fast_nms(_t(bx), _t(sc), thr, max_out, valid=_t(va),
                                ids=None if ids is None else _t(ids))
    jb, js, jv, ji = _j(bx, sc, va, ids)
    want_i, want_k = jnms.fast_nms(jb, js, thr, max_out, valid=jv, ids=ji)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


# ---- ROI-align -----------------------------------------------------------------


def _pyramid(rng, c=8):
    """P2..P5 of a 256x336 image."""
    shapes = [(64, 84), (32, 42), (16, 21), (8, 11)]
    return [rng.randn(h, w, c).astype(np.float32) for h, w in shapes]


def _rois(rng, n=8):
    """Random boxes from 16 to 600 px, some past the 256x336 image's
    border, and one box of each FPN level's size range."""
    xy = rng.uniform(-10, 200, (n, 2))
    wh = np.exp(rng.uniform(np.log(16), np.log(600), (n, 2)))
    fixed = [[0, 0, 40, 40], [10, 10, 170, 170], [0, 0, 300, 300],
             [0, 0, 500, 520]]
    return np.concatenate([np.concatenate([xy, xy + wh], -1), fixed]
                          ).astype(np.float32)


SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


def test_fpn_level_assignment_matches_jax():
    rng = np.random.RandomState(2)
    rois = _rois(rng, 20)
    got = roi_align.fpn_level_assignment(_t(rois), 4)
    want = jroi.fpn_level_assignment(rois, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) == 4


def test_roi_align_values_and_grads_match_jax():
    """Single-level ROI-align: values atol 1e-5; gradients of a weighted
    sum with respect to the features and the boxes atol 1e-4."""
    rng = np.random.RandomState(3)
    feat = rng.randn(12, 17, 5).astype(np.float32)
    rois = _rois(rng) / 16
    w = rng.randn(len(rois), 7, 7, 5).astype(np.float32)

    def jloss(f, b):
        return jnp.sum(jroi.roi_align(f, b, (7, 7), 0.5, 2) * w)

    want = np.asarray(jroi.roi_align(feat, rois, (7, 7), 0.5, 2))
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(rois))
    f_t = _t(feat).requires_grad_(True)
    b_t = _t(rois).requires_grad_(True)
    got = roi_align.roi_align(f_t, b_t, (7, 7), 0.5, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    tg = torch.autograd.grad((got * _t(w)).sum(), (f_t, b_t))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
def test_multiscale_roi_align_matches_jax(packed):
    """The port's FPN ROI-align against both JAX forms, the flat gather and
    the corner-packed buffer (a TPU gather layout of the same function):
    values atol 1e-5, feature gradients atol 1e-4 (f32)."""
    rng = np.random.RandomState(4)
    feats = _pyramid(rng)
    rois = _rois(rng)
    w = rng.randn(len(rois), 7, 7, 8).astype(np.float32)
    jfn = (jroi.multiscale_roi_align_packed if packed
           else jroi.multiscale_roi_align)

    def jloss(fs):
        return jnp.sum(jfn(fs, jnp.asarray(rois), (7, 7), SCALES) * w)

    want = np.asarray(jfn([jnp.asarray(f) for f in feats], rois, (7, 7),
                          SCALES))
    jg = jax.grad(jloss)([jnp.asarray(f) for f in feats])
    ft = [_t(f).requires_grad_(True) for f in feats]
    got = roi_align.multiscale_roi_align(ft, _t(rois), (7, 7), SCALES)
    assert got.shape == (len(rois), 7, 7, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    tg = torch.autograd.grad((got * _t(w)).sum(), ft)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert all(float(a.abs().sum()) > 0 for a in tg)  # every level pooled


def test_stack_roi_align_u8_matches_jax():
    """GT-mask crops from a {0, 1, 255} stack: values atol 1e-4 (the pooled
    255s reach 255)."""
    rng = np.random.RandomState(6)
    maps = rng.choice([0, 1, 255], size=(3, 40, 52), p=[0.6, 0.35, 0.05])
    maps = maps.astype(np.float32)
    rois = _rois(rng, 8) * 0.6
    idx = rng.randint(0, 3, len(rois)).astype(np.int32)
    got = roi_align.stack_roi_align_u8(_t(maps), _t(rois), _t(idx), (28, 28))
    want = jroi.stack_roi_align_u8(maps, rois, idx, (28, 28))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert got.numpy().max() > 200.0  # an ignore label survived pooling


# ---- losses --------------------------------------------------------------------


@pytest.mark.parametrize("per_image", [True, False])
def test_lovasz_hinge_with_ignore_matches_jax(per_image):
    """Binary Lovász hinge with 255-ignore pixels and error ties: loss rtol
    1e-5, logit gradients atol 1e-6."""
    rng = np.random.RandomState(7)
    logits = rng.randn(4, 28, 28).astype(np.float32)
    logits[0, :4] = 0.5  # ties in the sorted errors
    labels = rng.uniform(size=(4, 28, 28)) > 0.6
    valid = rng.uniform(size=(4, 28, 28)) > 0.1
    valid[3] = False  # a sample with nothing valid

    def jloss(lg):
        return jlosses.lovasz_hinge(lg, labels.astype(np.float32),
                                    valid=valid, per_image=per_image)

    want, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = _t(logits).requires_grad_(True)
    got = losses.lovasz_hinge(lt, _t(labels).float(), _t(valid),
                              per_image=per_image)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    (tg,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)


def test_cross_entropy_loss_matches_jax():
    """Plain BCE mean over the valid pixels and over all: rtol 1e-6."""
    rng = np.random.RandomState(8)
    logits = rng.randn(3, 9, 9).astype(np.float32)
    labels = (rng.uniform(size=(3, 9, 9)) > 0.5).astype(np.float32)
    valid = rng.uniform(size=(3, 9, 9)) > 0.2
    for v in (valid, None):
        got = losses.cross_entropy_loss(_t(logits), _t(labels),
                                        None if v is None else _t(v))
        want = jlosses.cross_entropy_loss(logits, labels, valid=v)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
