"""The port's J/F metrics (``e_osvos_torch/ops/metrics.py``) and its device
scoring of a merged label map (``engine/one_shot.py::score_merged_device``)
against the JAX package on the same seeded numpy masks: J exactly, F within
1e-6 (the same float32 operations, in another library).

Covers the scoring semantics that need care: 255-ignore pixels, a
mid-sequence frame without annotation (left out of the means), the frame-0
skip, multi-id groups with -1 id padding, masks empty on both sides (J = F =
1) and a sequence without object groups (empty results, held against a
hand-computed one: the JAX ``sequence_scores`` cannot take that case)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.engine import one_shot as j_one_shot
from e_osvos_tpu.ops import metrics as jm
from e_osvos_torch.data.datasets import ObjectGroup, VOSSequence
from e_osvos_torch.engine import one_shot
from e_osvos_torch.ops import metrics as tm

SIZES = [(32, 48), (37, 53)]
BOUND_TH = [0.008, 0.05, 1.0, 2.5]


def blob_masks(rng, n, h, w):
    """``n`` binary masks of smooth random blobs (boxes blurred by a few
    shifts), some of them empty."""
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        if i % 5 == 4:
            continue  # an empty mask
        for _ in range(rng.randint(1, 4)):
            y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
            y1 = min(h, y0 + rng.randint(3, h // 2))
            x1 = min(w, x0 + rng.randint(3, w // 2))
            out[i, y0:y1, x0:x1] = True
        out[i] ^= rng.rand(h, w) < 0.02  # a ragged boundary
    return out


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jaccard_matches_jax(hw):
    rng = np.random.RandomState(hw[0])
    preds, gts = blob_masks(rng, 10, *hw), blob_masks(rng, 10, *hw)
    gts[3] = preds[3]
    # the batched jaccard is the JAX package's jaccard_frames
    got = tm.jaccard(torch.from_numpy(preds), torch.from_numpy(gts))
    want = np.asarray(jm.jaccard_frames(jnp.asarray(preds), jnp.asarray(gts)))
    assert got.dtype == torch.float32 and got.shape == (10,)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (0, 3, 4):  # one frame at a time, as a 0-d result
        np.testing.assert_array_equal(
            tm.jaccard(torch.from_numpy(preds[i]),
                       torch.from_numpy(gts[i])).numpy(), want[i])


@pytest.mark.parametrize("bound_th", BOUND_TH)
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_boundary_f_matches_jax(hw, bound_th):
    rng = np.random.RandomState(7 + hw[1])
    preds, gts = blob_masks(rng, 10, *hw), blob_masks(rng, 10, *hw)
    # near misses: the prediction one or two pixels off the GT
    gts[1] = np.roll(preds[1], 1, axis=1)
    gts[2] = np.roll(preds[2], 2, axis=0)
    got = tm.boundary_f_measure(torch.from_numpy(preds),
                                torch.from_numpy(gts), bound_th)
    want = np.stack([np.asarray(jm.boundary_f_measure(
        jnp.asarray(p), jnp.asarray(g), bound_th))
        for p, g in zip(preds, gts)])
    assert got.shape == (10,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert 0.0 < want.min() and want.max() == 1.0  # some frames are exact
    assert (want < 1.0).any()


@pytest.mark.parametrize("radius", [0, 1, 3, 8])
def test_boundary_map_and_dilation_match_jax(radius):
    rng = np.random.RandomState(radius)
    mask = blob_masks(rng, 1, 37, 53)[0]
    b = tm._boundary_map(torch.from_numpy(mask))
    jb = np.asarray(jm._boundary_map(jnp.asarray(mask)))
    np.testing.assert_array_equal(b.numpy(), jb.astype(bool))
    np.testing.assert_array_equal(tm._disk_kernel(radius),
                                  jm._disk_kernel(radius))
    np.testing.assert_array_equal(
        tm._dilate(b, radius).numpy(),
        np.asarray(jm._dilate(jnp.asarray(jb), radius)).astype(bool))


def test_both_empty_is_one():
    empty = torch.zeros((3, 16, 24), dtype=torch.bool)
    assert tm.jaccard(empty, empty).tolist() == [1.0, 1.0, 1.0]
    assert tm.boundary_f_measure(empty, empty).tolist() == [1.0, 1.0, 1.0]
    full = torch.ones((16, 24), dtype=torch.bool)
    assert float(tm.jaccard(empty[0], full)) == 0.0
    assert float(tm.boundary_f_measure(empty[0], full)) == 0.0


def gt_sequence(rng, T, h, w):
    """Raw id maps ``[T, h, w]`` with objects 1..4 and 255-ignore pixels."""
    gt = np.zeros((T, h, w), np.uint8)
    for obj in range(1, 5):
        gt[blob_masks(rng, T, h, w)] = obj
    gt[rng.rand(T, h, w) < 0.03] = 255
    gt[:, :3, :5] = 255  # an ignore region
    return gt


class MemIndex:
    """An in-memory index of one sequence whose frame ``skip`` has no
    annotation (``get_label`` returns None)."""

    def __init__(self, gt, groups, skip):
        self.gt, self.skip = gt, skip
        T = len(gt)
        self.sequences = {"s": VOSSequence(
            name="s", image_paths=[""] * T, label_paths=[""] * T,
            object_groups=groups, num_objects=4)}

    def get_label(self, seq, t):
        return None if t == self.skip else self.gt[t]


# (object ids of each group): single ids, multi-id groups padded with -1,
# and a group whose ids never occur
GROUPS = [((1,), (2,)), ((1, 3), (2,), (4,)), ((3, 4, 1), (2,), (9,))]


@pytest.mark.parametrize("group_ids", GROUPS, ids=str)
def test_sequence_scores_match_jax(group_ids):
    rng = np.random.RandomState(len(group_ids))
    T, h, w = 6, 37, 53
    gt = gt_sequence(rng, T, h, w)
    merged = rng.randint(0, len(group_ids) + 1, (T, h, w)).astype(np.int32)
    # most pixels follow the GT, so the scores are not all near zero
    follow = rng.rand(T, h, w) < 0.9
    for gi, ids in enumerate(group_ids):
        merged[follow & np.isin(gt, ids)] = gi + 1
    merged[follow & (gt == 0)] = 0
    groups = [ObjectGroup(object_ids=ids, support_frame=0)
              for ids in group_ids]
    index = MemIndex(gt, groups, skip=3)
    seq = index.sequences["s"]

    gt_stack, has_gt, ids = one_shot.build_gt_stack(index, "s", seq, T,
                                                    (h, w))
    j_stack, j_has, j_ids = j_one_shot.build_gt_stack(index, "s", seq, T,
                                                      (h, w))
    np.testing.assert_array_equal(gt_stack, j_stack)
    np.testing.assert_array_equal(has_gt, j_has)
    np.testing.assert_array_equal(ids, j_ids)
    assert has_gt.tolist() == [False, True, True, False, True, True]
    assert (ids == -1).any() == (len({len(i) for i in group_ids}) > 1)

    J, F = tm.sequence_scores(torch.from_numpy(merged),
                              torch.from_numpy(gt_stack),
                              torch.from_numpy(ids))
    jJ, jF = jm._sequence_scores_jit(jnp.asarray(merged),
                                     jnp.asarray(gt_stack), jnp.asarray(ids))
    assert J.shape == F.shape == (len(group_ids), T)
    np.testing.assert_array_equal(J.numpy(), np.asarray(jJ))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=0, atol=1e-6)

    # the means over the annotated frames after frame 0
    j_means, f_means, got_has = one_shot.score_merged_device(
        index, "s", seq, torch.from_numpy(merged))
    jj_means, jf_means, _ = j_one_shot.score_merged_device(
        index, "s", seq, jnp.asarray(merged))
    np.testing.assert_array_equal(got_has, has_gt)
    assert j_means == jj_means
    np.testing.assert_allclose(f_means, jf_means, rtol=0, atol=1e-6)
    want = [float(np.mean(J.numpy()[gi, has_gt]))
            for gi in range(len(group_ids))]
    assert j_means == want
    if group_ids[-1] == (9,):  # an id absent from the GT: only empty-vs-
        # empty frames where the prediction is empty too score 1
        assert j_means[-1] < 1.0


def test_sequence_scores_ignore_pixels_do_not_count():
    """A prediction that is wrong only on 255 pixels scores 1."""
    gt = np.zeros((2, 16, 24), np.uint8)
    gt[:, 4:10, 5:15] = 1
    gt[:, 0:2, :] = 255
    merged = (gt == 1).astype(np.int32)
    merged[:, 0:2, :] = 1  # the prediction covers the ignore rows
    J, F = tm.sequence_scores(torch.from_numpy(merged), torch.from_numpy(gt),
                              torch.tensor([[1]], dtype=torch.int32))
    assert J.tolist() == [[1.0, 1.0]] and F.tolist() == [[1.0, 1.0]]


def test_zero_object_groups_give_empty_results():
    """No group: ``[0, T]`` scores and empty means (hand-computed)."""
    T, h, w = 4, 16, 24
    gt = np.zeros((T, h, w), np.uint8)
    index = MemIndex(gt, [], skip=-1)
    seq = index.sequences["s"]
    _, _, ids = one_shot.build_gt_stack(index, "s", seq, T, (h, w))
    assert ids.shape == (0, 1)
    J, F = tm.sequence_scores(torch.zeros((T, h, w), dtype=torch.int32),
                              torch.from_numpy(gt), torch.from_numpy(ids))
    assert J.shape == F.shape == (0, T)
    assert J.dtype == F.dtype == torch.float32
    j_means, f_means, has_gt = one_shot.score_merged_device(
        index, "s", seq, torch.zeros((T, h, w), dtype=torch.int32))
    assert j_means == [] and f_means == []
    assert has_gt.tolist() == [False, True, True, True]


@pytest.mark.parametrize("n", [0, 1, 3, 7, 20])
def test_db_statistics_match_jax(n):
    rng = np.random.RandomState(n)
    per_frame = rng.rand(n)
    if n > 3:
        per_frame[2] = np.nan
    got, want = tm.db_statistics(per_frame), jm.db_statistics(per_frame)
    assert set(got) == {"mean", "recall", "decay"}
    np.testing.assert_array_equal([got[k] for k in sorted(got)],
                                  [want[k] for k in sorted(want)])


@pytest.mark.parametrize("exclude", [True, False])
def test_evaluate_sequence_matches_jax(exclude):
    rng = np.random.RandomState(5)
    preds, gts = blob_masks(rng, 8, 37, 53), blob_masks(rng, 8, 37, 53)
    got = tm.evaluate_sequence(preds, gts, exclude_first_last=exclude)
    want = jm.evaluate_sequence(preds, gts, exclude_first_last=exclude)
    assert got["J_per_frame"] == want["J_per_frame"]
    np.testing.assert_allclose(got["F_per_frame"], want["F_per_frame"],
                               rtol=0, atol=1e-6)
    assert got["J"] == want["J"]
    for k in ("mean", "recall", "decay"):
        np.testing.assert_allclose(got["F"][k], want["F"][k], rtol=0,
                                   atol=1e-6)
