"""The port's sequence-level evaluation (``OneShotEvaluator.eval_sequence``,
``eval_sequence_init``, ``eval_stream``, the object merge and the bucketing)
against the JAX package on the CPU, on the same weights, lrs and frames.

resnet10 frozen-BN backbone, group16 head, os16, fp32, 32x48, 6 frames (OnA
every 2 frames: windows of 2, 2 and a ragged 1), 2 objects; the augmentation
ranges are degenerate (scale 1, no rotation, jitter or flip, float32
arithmetic), so neither side's random draws change the result. The JAX side
runs its objects as a vmapped batch axis, the port runs them in turn. One
JAX evaluator is shared by the module: its compiles dominate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data import transforms as j_transforms
from e_osvos_tpu.data.loader import load_frames as j_load_frames
from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.engine import OneShotConfig as JOneShotConfig
from e_osvos_tpu.engine import OneShotEvaluator as JOneShotEvaluator
from e_osvos_tpu.engine import merge_objects as j_merge_objects
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_torch.data import load_frames, transforms
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import (
    OneShotConfig,
    OneShotEvaluator,
    fold_in,
    merge_objects,
    score_merged_device,
    stack_windows,
)
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams
from e_osvos_torch.models import DeepLabV3Plus, functional_apply
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from test_torch_port_models import randomized_variables

H, W, T = 32, 48, 6
MODEL_KW = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                head_norm="group16", output_stride=16)
AUG_KW = dict(scale_min=1.0, scale_max=1.0, rot_deg=0.0, brightness=0.0,
              contrast=0.0, saturation=0.0, flip_prob=0.0,
              compute_dtype="float32")
CFG_KW = dict(num_epochs=3, batch_size=3, loss_func="dice",
              online_adapt_step=2, online_adapt_epochs=2,
              online_adapt_min_prop=0.75)
INDEX_KW = dict(num_sequences=2, num_frames=T, size=(H, W), seed=2)
PAD_INDEX_KW = dict(num_sequences=1, num_frames=T, size=(30, 44),
                    num_objects=2, seed=5)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The JAX meta-parameters and the port's, on the same random weights
    and neuron lrs (the frozen constants get lr 0, as JAX init_meta_params
    gives them), and the port's model."""
    rng = np.random.RandomState(0)
    jmodel = JDeepLabV3Plus(**MODEL_KW)
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), 9)
    lrs = jax.device_get(j_init_lr_tree(variables, "neuron", use_log=False))
    lrs = {
        "params": jax.tree_util.tree_map(
            lambda l: rng.uniform(0.01, 0.1, np.shape(l)).astype(np.float32),
            lrs["params"]),
        "constants": jax.tree_util.tree_map(np.zeros_like, lrs["constants"]),
    }
    model = DeepLabV3Plus(device="cpu", **MODEL_KW)
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    names = {n for n, _ in model.named_parameters()}
    meta = MetaParams(model_init={k: v for k, v in sd.items() if k in names},
                      log_init_lr=lr_tree_from_jax(lrs))
    return {"jmodel": jmodel, "j_meta": JMetaParams(model_init=variables,
                                                    log_init_lr=lrs),
            "apply": functional_apply(model), "meta": meta}


@pytest.fixture(scope="module")
def jax_eval(pair):
    """The JAX evaluator's eval_sequence of the 2-object sequence (objects
    batched, the host window loop) and its init_J, shared by the module."""
    j_cfg = JOneShotConfig(augment=JAugmentConfig(**AUG_KW), **CFG_KW)
    j_ev = JOneShotEvaluator(pair["jmodel"].apply,
                             JMetaOptimConfig(use_log_init_lr=False), j_cfg,
                             batch_objects=True)
    index_j = JSyntheticVOSIndex(num_objects=2, **INDEX_KW)
    res = j_ev.eval_sequence(index_j, "seq00", pair["j_meta"],
                             jax.random.PRNGKey(4))
    init = j_ev.eval_sequence_init(index_j, "seq00", pair["j_meta"])
    # 30x44 frames bucketed to the same 32x48 programs: pad_multiple is read
    # only by eval_sequence's host code, so the compiled programs are reused
    j_ev.cfg = dataclasses.replace(j_cfg, pad_multiple=16)
    padded = j_ev.eval_sequence(JSyntheticVOSIndex(**PAD_INDEX_KW), "seq00",
                                pair["j_meta"], jax.random.PRNGKey(6))
    return res, init, padded


def evaluator(pair, **kw):
    cfg_kw = dict(CFG_KW)
    cfg_kw.update({k: kw.pop(k) for k in list(kw) if k in
                   ("online_adapt_step", "ona_window_bucket", "pad_multiple")})
    cfg = OneShotConfig(augment=AugmentConfig(**AUG_KW), **cfg_kw)
    return OneShotEvaluator(pair["apply"],
                            MetaOptimConfig(use_log_init_lr=False), cfg,
                            device="cpu", **kw)


def test_eval_sequence_matches_jax(pair, jax_eval):
    """Probabilities within 1e-4 (f32 convolutions and their gradients summed
    in another order, through 3 fine-tune steps and 2 refits); the JAX
    merged map scored by the port within 1e-6 of the JAX scores; J and F
    end to end within 1e-3."""
    want = jax_eval[0]
    index = SyntheticVOSIndex(num_objects=2, **INDEX_KW)
    phases = []
    ev = evaluator(pair, on_phase=phases.append)
    assert not ev.fused_ona  # the JAX default: the host window loop
    got = ev.eval_sequence(index, "seq00", pair["meta"], 4)
    assert phases == ["fine_tune", "propagate"] * 2 + ["score"]

    assert set(got) == set(want)
    assert got["seq"] == "seq00"
    assert got["probs"].shape == (2, T, H, W)
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]),
                               rtol=0, atol=1e-4)
    assert got["merged"].dtype == np.uint8 and got["merged"].shape == (T, H, W)
    sure = (np.abs(np.asarray(want["probs"]) - 0.5) > 1e-3).all(0)
    np.testing.assert_array_equal(got["merged"][sure],
                                  np.asarray(want["merged"])[sure])

    seq = index.sequences["seq00"]
    j_means, f_means, _ = score_merged_device(
        index, "seq00", seq,
        torch.from_numpy(np.asarray(want["merged"]).astype(np.int32)))
    np.testing.assert_allclose(j_means, want["J_per_object"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(f_means, want["F_per_object"], rtol=0,
                               atol=1e-6)
    for k in ("J_per_object", "F_per_object", "J_mean", "F_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
    # the objects were told apart: each is the merged map's argmax somewhere
    assert set(np.unique(got["merged"][1:])) == {0, 1, 2}


def test_eval_sequence_init_matches_jax(pair, jax_eval):
    """init_J / init_F of the un-fine-tuned init within 1e-3."""
    want = jax_eval[1]
    index = SyntheticVOSIndex(num_objects=2, **INDEX_KW)
    got = evaluator(pair).eval_sequence_init(index, "seq00", pair["meta"])
    assert got["seq"] == "seq00"
    np.testing.assert_allclose(got["init_J_mean"], want["init_J_mean"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["init_F_mean"], want["init_F_mean"],
                               rtol=0, atol=1e-3)
    with pytest.raises(ValueError):
        evaluator(pair).eval_sequence_init(
            index, "seq00", pair["meta"]._replace(model_init=None))


@pytest.mark.parametrize("num_objects", [1, 2])
def test_host_loop_matches_fused(pair, num_objects):
    """The host window loop (ragged tail) against the fused loop (tail
    padded by replication), at the JAX test's own tolerances
    (tests/test_one_shot.py:204-239): probabilities within 1e-4, J within
    1e-4, merged maps differing on under 0.5% of the pixels."""
    index = SyntheticVOSIndex(num_objects=num_objects, **INDEX_KW)
    host = evaluator(pair).eval_sequence(index, "seq01", pair["meta"], 3)
    fused = evaluator(pair, fused_ona=True).eval_sequence(
        index, "seq01", pair["meta"], 3)
    assert host["probs"].shape == fused["probs"].shape == (num_objects, T, H,
                                                            W)
    np.testing.assert_allclose(fused["probs"], host["probs"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(fused["J_mean"], host["J_mean"], rtol=0,
                               atol=1e-4)
    assert (fused["merged"] != host["merged"]).mean() < 0.005


def test_window_bucketing_is_bit_identical(pair):
    """5 frames after the support frame at step 2: 3 windows, padded to 4 by
    ``ona_window_bucket=4``; window i depends only on the refits before it,
    so the cropped probabilities are the same bits."""
    windows, r, wn_real = stack_windows(torch.zeros(5, 2, 2, 3), 2, bucket=4)
    assert windows.shape[:2] == (4, 2) and (r, wn_real) == (5, 3)
    index = SyntheticVOSIndex(num_objects=2, **INDEX_KW)
    exact = evaluator(pair, fused_ona=True).eval_sequence(
        index, "seq00", pair["meta"], 5)
    bucket = evaluator(pair, fused_ona=True, ona_window_bucket=4
                       ).eval_sequence(index, "seq00", pair["meta"], 5)
    np.testing.assert_array_equal(bucket["probs"], exact["probs"])


def test_pad_multiple_matches_jax(pair, jax_eval):
    """30x44 frames bucketed to 32x48 (``pad_multiple=16``) on both sides:
    probabilities within 1e-4 on the original geometry, J and F within
    1e-3."""
    want = jax_eval[2]
    index = SyntheticVOSIndex(**PAD_INDEX_KW)
    got = evaluator(pair, pad_multiple=16).eval_sequence(
        index, "seq00", pair["meta"], 6)
    assert got["probs"].shape == (2, T, 30, 44)
    assert got["merged"].shape == (T, 30, 44)
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]),
                               rtol=0, atol=1e-4)
    for k in ("J_per_object", "F_per_object"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)


def pixel_apply(params, imgs):
    """A per-pixel linear model (logits from each pixel's colour alone): it
    cannot see the bucket padding, so padding changes nothing but the sums'
    order, unless padded pixels leak into a loss."""
    return (imgs / 64.0) @ params["w"] + params["b"]


def test_pad_multiple_j_equals_unpadded():
    """Same frames with and without bucketing (30x44 → 32x48): equal J and F
    per object, probabilities within 1e-5. Padded pixels are 255 in the
    support label and in every pseudo-GT frame, so they move neither the
    fine-tune nor the refits, and scoring runs on the original geometry."""
    meta = MetaParams(
        model_init={"w": torch.tensor([[0.3], [-0.2], [0.1]]),
                    "b": torch.zeros(1)},
        log_init_lr={"w": torch.full((3, 1), 0.5), "b": torch.full((1,), 0.5)})
    index = SyntheticVOSIndex(**dict(PAD_INDEX_KW, seed=1))
    res = {}
    for pad in (0, 16):
        cfg = OneShotConfig(augment=AugmentConfig(**AUG_KW), pad_multiple=pad,
                            **dict(CFG_KW, num_epochs=30))
        res[pad] = OneShotEvaluator(
            pixel_apply, MetaOptimConfig(use_log_init_lr=False), cfg,
            device="cpu").eval_sequence(index, "seq00", meta, 6)
    assert res[16]["merged"].shape == res[0]["merged"].shape == (T, 30, 44)
    np.testing.assert_allclose(res[16]["probs"], res[0]["probs"], rtol=0,
                               atol=1e-5)
    assert res[16]["J_per_object"] == res[0]["J_per_object"]
    assert res[16]["F_per_object"] == res[0]["F_per_object"]
    assert 0.5 < min(res[0]["J_per_object"])  # the model found the objects


@pytest.mark.parametrize("ona", [True, False], ids=["ona", "no_ona"])
@pytest.mark.parametrize("num_objects", [1, 2])
def test_eval_stream_rows_equal_eval_sequence(pair, num_objects, ona):
    """Row i of ``eval_stream(seed)`` is ``eval_sequence(fold_in(seed, i))``'s
    merged map, bit for bit (the fused path, which the stream follows)."""
    index = SyntheticVOSIndex(num_objects=num_objects, **INDEX_KW)
    ev = evaluator(pair, fused_ona=True,
                   online_adapt_step=CFG_KW["online_adapt_step"] if ona else 0)
    names = ["seq00", "seq01"]
    masks = ev.eval_stream(index, names, pair["meta"], 11)
    assert list(masks) == names
    for i, name in enumerate(names):
        res = ev.eval_sequence(index, name, pair["meta"], fold_in(11, i))
        assert masks[name].dtype == np.uint8
        assert masks[name].shape == (T, H, W)
        np.testing.assert_array_equal(masks[name], res["merged"])
    fg = np.mean([(masks[name][1:] > 0).mean() for name in names])
    assert 0 < fg < 1  # not trivially all background or all foreground


def test_eval_stream_falls_back_for_distinct_support_frames(pair):
    """Groups with different support frames go through eval_sequence."""
    from e_osvos_torch.data.datasets import ObjectGroup

    index = SyntheticVOSIndex(num_objects=2, **INDEX_KW)
    seq = index.sequences["seq00"]
    seq.object_groups = [seq.object_groups[0],
                         ObjectGroup(object_ids=(2,), support_frame=1)]
    ev = evaluator(pair, fused_ona=True)
    masks = ev.eval_stream(index, ["seq00"], pair["meta"], 2)
    res = ev.eval_sequence(index, "seq00", pair["meta"], fold_in(2, 0))
    np.testing.assert_array_equal(masks["seq00"], res["merged"])
    assert not (res["probs"][1, 0] > 0).any()  # before its support frame


def test_merge_objects_matches_jax():
    rng = np.random.RandomState(0)
    probs = rng.rand(3, 4, 16, 24).astype(np.float32)
    probs[:, 0, :2] = 0.5  # exact ties with the background plane
    probs[1:, 1, :2] = probs[0, 1, :2]  # exact ties between objects
    probs[:, 2] = 0.1  # an all-background frame
    got = merge_objects(torch.from_numpy(probs), 0.5)
    want = np.asarray(j_merge_objects(jnp.asarray(probs), 0.5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[2] == 0).all() and (want[0, :2] == 0).all()
    np.testing.assert_array_equal(
        merge_objects(torch.full((2, 5, 5), 0.2)).numpy(), 0)
    np.testing.assert_array_equal(  # one frame [O, H, W], another threshold
        merge_objects(torch.from_numpy(probs[:, 3]), 0.7).numpy(),
        np.asarray(j_merge_objects(jnp.asarray(probs[:, 3]), 0.7)))


def test_bucket_helpers_match_jax():
    assert transforms.bucket_hw(30, 44, 16) == (32, 48)
    assert transforms.bucket_hw(32, 48, 16) == (32, 48)
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, (2, 30, 44, 3)).astype(np.uint8)
    label = rng.randint(0, 2, (30, 44)).astype(np.int32)
    got = transforms.pad_frames_to_multiple(torch.from_numpy(frames), 16)
    want = j_transforms.pad_frames_to_multiple(jnp.asarray(frames), 16)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(transforms.pad_to(torch.from_numpy(frames[0]),
                                      torch.from_numpy(label), (40, 50)),
                    j_transforms.pad_to(jnp.asarray(frames[0]),
                                        jnp.asarray(label), (40, 50))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        transforms.pad_to(torch.from_numpy(frames[0]),
                          torch.from_numpy(label), (20, 50))


def test_load_frames_and_fold_in():
    index = SyntheticVOSIndex(num_objects=2, **INDEX_KW)
    index_j = JSyntheticVOSIndex(num_objects=2, **INDEX_KW)
    got = load_frames(index, "seq01")
    assert got.dtype == np.uint8 and got.shape == (T, H, W, 3)
    np.testing.assert_array_equal(got, j_load_frames(index_j, "seq01"))
    seeds = [fold_in(7, i) for i in range(4)] + [fold_in(8, 0)]
    assert len(set(seeds)) == 5 and seeds[0] == fold_in(7, 0)
    assert fold_in(fold_in(7, 1), 0) not in seeds
