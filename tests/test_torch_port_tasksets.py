"""The port's meta-task sampler (e_osvos_torch.meta_optim.tasksets, a numpy
copy) against the JAX package's on the CPU: for the same seed, the same
task specs and bit-equal TaskBatches, over several batches and every task
randomization mode (single-object modes including the copy-paste
distractors, label flip, no-label, epsilon windows, object sub-groups,
padding and random crops)."""

import dataclasses

import numpy as np
import pytest

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.meta_optim import tasksets as jts
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.meta_optim import tasksets as tts

INDEXES = (
    dict(num_sequences=2, num_frames=5, size=(32, 40), num_objects=2,
         seed=0),
    dict(num_sequences=2, num_frames=4, size=(24, 28), num_objects=1,
         seed=1, name_prefix="solo"),
)

MODES = {
    "keep": dict(),
    "ignore": dict(single_obj_seq_mode="IGNORE"),
    "only": dict(single_obj_seq_mode="ONLY"),
    "augment_single": dict(single_obj_seq_mode="AUGMENT_SINGLE"),
    "augment_all": dict(single_obj_seq_mode="AUGMENT_ALL",
                        num_query_frames=2),
    "flip_no_label": dict(random_flip_label=True, random_no_label=True),
    "epsilon_subgroup": dict(random_frame_epsilon=1,
                             random_object_id_sub_group=True,
                             random_support_frame=False),
}


def _pair(mode, seed, crop):
    kw = dict(MODES[mode], crop_size=crop)
    j = jts.MetaTaskset([JSyntheticVOSIndex(**k) for k in INDEXES],
                        jts.MetaTasksetConfig(**kw), seed=seed)
    t = tts.MetaTaskset([SyntheticVOSIndex(**k) for k in INDEXES],
                        tts.MetaTasksetConfig(**kw), seed=seed)
    return j, t


@pytest.mark.parametrize("crop", [(24, 24), (36, 30)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_task_batches_bit_equal_to_jax(mode, crop):
    """Three batches of 4 tasks from two seeds; crop 36x30 pads the 32x40
    and 24x28 frames with ignore labels before cropping."""
    for seed in (0, 5):
        j, t = _pair(mode, seed, crop)
        assert len(j) == len(t)
        for _ in range(3):
            jb, tb = j.sample_batch(4), t.sample_batch(4)
            for f in jts.TaskBatch._fields:
                a, b = getattr(jb, f), getattr(tb, f)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                np.testing.assert_array_equal(b, a, err_msg=f)
            assert jb.support_img.shape == (4,) + crop + (3,)


def test_specs_equal_and_randomizations_happen():
    """The specs themselves match, and over 40 tasks the flip, no-label and
    donor draws each happen."""
    j, t = _pair("flip_no_label", 3, (24, 24))
    specs = [t.sample_spec() for _ in range(40)]
    assert [tuple(s) for s in specs] == [tuple(j.sample_spec())
                                         for _ in range(40)]
    assert any(s.flip_label for s in specs)
    assert any(s.no_label for s in specs)
    j, t = _pair("augment_all", 3, (24, 24))
    assert any(t.sample_spec().donor is not None for _ in range(10))


def test_paste_distractor_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (16, 16, 3)).astype(np.float32)
    label = np.zeros((16, 16), np.int32)
    label[3:11, 4:12] = 1
    donor_img = rng.randint(0, 256, (16, 16, 3)).astype(np.float32)
    donor_mask = np.zeros((16, 16), bool)
    donor_mask[2:6, 9:15] = True
    for args in ((img, label, donor_img, donor_mask),
                 (img, np.zeros_like(label), donor_img, donor_mask)):
        want = jts.paste_distractor(*args)
        got = tts.paste_distractor(*args)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(tts.MetaTasksetConfig)]
            == [f.name for f in dataclasses.fields(jts.MetaTasksetConfig)])
    with pytest.raises(ValueError):
        tts.MetaTaskset([SyntheticVOSIndex(**INDEXES[0])],
                        tts.MetaTasksetConfig(single_obj_seq_mode="ONLY"))
