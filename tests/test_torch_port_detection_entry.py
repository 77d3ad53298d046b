"""The detection evaluator's remaining entry points against the JAX package
on the CPU: the host window loop (``fused_ona=False``, the JAX default: a
ragged tail window, refits while frames remain) over a sequence and an
``ona_only_box_head`` refit, on the same weights, lrs, frames and random
draws; such a refit leaves every parameter outside the box and mask heads
bit-unchanged; ``eval_stream`` gives ``eval_sequence``'s merged
maps.

The tiny model, configuration and degenerate augmentation of
``test_torch_port_detection_slice.py``; the JAX draws are handed to the port
by the generator's seed, as ``test_torch_port_detection_eval.py`` does. Six
frames, windows of 2: the host loop segments windows of 2, 2 and 1 and
refits after the first two."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.engine import (
    DetectionOneShotConfig as JDetectionOneShotConfig,
)
from e_osvos_tpu.engine import (
    DetectionOneShotEvaluator as JDetectionOneShotEvaluator,
)
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import (
    DetectionOneShotConfig,
    DetectionOneShotEvaluator,
    fold_in,
)
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from test_torch_port_detection_eval import draws_by_seed
from test_torch_port_detection_models import SIZE, tiny_pair
from test_torch_port_detection_slice import AUG_KW, CFG_KW, JaxDraws

T = 6
# the 2-object sequence of test_torch_port_detection_eval.py, one frame
# longer for the ragged tail
INDEX_KW = dict(num_sequences=1, num_frames=T, size=(SIZE, SIZE),
                num_objects=2, seed=4)
HEADS = ("box_head", "mask_head")


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
    return make_pair()


def make_pair():
    """The tiny JAX/port Mask R-CNN pair with its meta-parameters."""
    rng = np.random.RandomState(0)
    jmodel, variables, model = tiny_pair(detections_per_img=1)
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables["params"], "neuron")))
    sd = state_dict_from_jax(variables)
    names = {n for n, _ in model.named_parameters()}
    return {"jmodel": jmodel, "variables": variables, "model": model,
            "j_meta": JMetaParams(model_init=variables,
                                  log_init_lr={"params": lrs}),
            "meta": MetaParams(
                model_init={k: v for k, v in sd.items() if k in names},
                log_init_lr=lr_tree_from_jax(lrs))}


def _evaluators(pair, **cfg_kw):
    kw = dict(CFG_KW, **cfg_kw)
    j_ev = JDetectionOneShotEvaluator(
        pair["jmodel"], JMetaOptimConfig(use_log_init_lr=False),
        JDetectionOneShotConfig(augment=JAugmentConfig(**AUG_KW), **kw),
        batch_objects=False, fused_ona=False)
    ev = DetectionOneShotEvaluator(
        pair["model"], MetaOptimConfig(use_log_init_lr=False),
        DetectionOneShotConfig(augment=AugmentConfig(**AUG_KW), **kw),
        device="cpu", batch_objects=False)
    return j_ev, ev


def test_host_loop_matches_jax(pair):
    """Probabilities atol 1e-2 with a mean error under 1e-5, merged maps
    equal away from the threshold, J and F within 1e-3 (the tolerances of
    ``test_torch_port_detection_eval.py``); each object asks for the draws
    of windows of 2, 2 and 1 frames and of two refits."""
    j_ev, ev = _evaluators(pair)
    assert not ev.fused_ona
    key = jax.random.PRNGKey(11)
    want = j_ev.eval_sequence(JSyntheticVOSIndex(**INDEX_KW), "seq00",
                              pair["j_meta"], key)
    seed = 5
    draws = {fold_in(seed, gi): JaxDraws(pair["jmodel"], pair["variables"],
                                         jax.random.fold_in(key, gi), ev.cfg)
             for gi in range(2)}
    counts = []
    inner = draws_by_seed(draws)

    def sample(gen, kind, count, hw):
        counts.append((kind, count))
        return inner(gen, kind, count, hw)

    ev.sample_draws = sample
    got = ev.eval_sequence(SyntheticVOSIndex(**INDEX_KW), "seq00",
                           pair["meta"], seed)
    assert counts == 2 * [("fine_tune", 2), ("frames", 2), ("refit", 2),
                          ("frames", 2), ("refit", 2), ("frames", 1)]
    j_probs = np.asarray(want["probs"])
    probs = got["probs"].numpy()
    assert probs.shape == (2, T, SIZE, SIZE)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=1e-2)
    assert np.abs(probs - j_probs).mean() < 1e-5
    assert 0.0 < (j_probs[:, 1:] >= 0.5).mean() < 1.0
    sure = (np.abs(j_probs - 0.5) > 1e-2).all(0)
    np.testing.assert_array_equal(got["merged"][sure], want["merged"][sure])
    for k in ("J_per_object", "F_per_object", "J_mean", "F_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)


def _refit_inputs():
    index = SyntheticVOSIndex(**INDEX_KW)
    frames = np.stack([index.get_image("seq00", t) for t in range(T)])
    label = (index.get_label("seq00", 0) == 1).astype(np.int32)
    pseudo = np.stack([(index.get_label("seq00", t) == 1).astype(np.int32)
                       for t in (1, 2)])
    return frames, label, pseudo


def test_only_box_head_refit_matches_jax(pair):
    """One ``ona_only_box_head`` refit from the learned init on the same
    draws: every parameter within 1e-4 of its tensor's largest magnitude
    (``test_torch_port_detection_slice.py``'s refit tolerance), the JAX
    package's non-head parameters unchanged as well."""
    j_ev, ev = _evaluators(pair, ona_only_box_head=True)
    frames, label, pseudo = _refit_inputs()
    key = jax.random.PRNGKey(3)
    j_out, _ = j_ev._jit_ona_ft(
        pair["j_meta"], key, frames[0], label, frames[1:3], pseudo,
        jax.tree_util.tree_map(np.copy, pair["variables"]))
    want = state_dict_from_jax(jax.device_get(j_out))
    draws = JaxDraws(pair["jmodel"], pair["variables"], key, ev.cfg)
    ev.sample_draws = lambda gen, kind, count, hw: draws._train(
        jax.random.split(key, count), 3)
    params = {k: v.clone() for k, v in pair["meta"].model_init.items()}
    got = ev._ona_fine_tune(pair["meta"], torch.Generator(),
                            *(torch.from_numpy(a) for a in (
                                frames[0], label, frames[1:3], pseudo)),
                            params)
    init = pair["meta"].model_init
    for k, v in got.items():
        v = v.detach()
        scale = max(float(want[k].abs().max()), 1e-6)
        assert float((v - want[k]).abs().max()) <= 1e-4 * scale, k
        if not any(h in k for h in HEADS):
            assert torch.equal(want[k], init[k]), k


def test_only_box_head_refit_keeps_the_rest(pair):
    """After an ``ona_only_box_head`` refit every parameter outside the box
    and mask heads is bit-unchanged, the heads have moved, and the refit
    took no gradient of the rest (their tensors never require grad)."""
    _, ev = _evaluators(pair, ona_only_box_head=True)
    frames, label, pseudo = (torch.from_numpy(a) for a in _refit_inputs())
    params = {k: v.clone() for k, v in pair["meta"].model_init.items()}
    before = {k: v.clone() for k, v in params.items()}
    out = ev._ona_fine_tune(pair["meta"], torch.Generator().manual_seed(0),
                            frames[0], label, frames[1:3], pseudo, params)
    heads = [k for k in out if any(h in k for h in HEADS)]
    rest = [k for k in out if k not in heads]
    assert heads and rest
    for k in rest:
        assert torch.equal(out[k], before[k]), k
        assert not out[k].requires_grad, k
    assert all(not torch.equal(out[k], before[k]) for k in heads)
    assert set(ev._ona_meta_params(pair["meta"]).log_init_lr) == set(heads)


def test_eval_stream_matches_eval_sequence(pair):
    """Sequence i of ``eval_stream(seed)`` equals the first object group's
    mask of ``eval_sequence(fold_in(seed, i))`` on the fused loop, on the
    port's own CPU draws; on these 1-object sequences that mask is the
    merged map."""
    _, ev = _evaluators(pair)
    ev.fused_ona = True
    index = SyntheticVOSIndex(**dict(INDEX_KW, num_sequences=2,
                                     num_objects=1))
    names = ["seq01", "seq00"]
    got = ev.eval_stream(index, names, pair["meta"], 9)
    assert list(got) == names
    for i, name in enumerate(names):
        want = ev.eval_sequence(index, name, pair["meta"], fold_in(9, i))
        assert got[name].dtype == np.uint8 and got[name].shape == (
            T, SIZE, SIZE)
        np.testing.assert_array_equal(got[name], want["merged"])
        np.testing.assert_array_equal(
            got[name][0], index.get_label(name, 0))
    assert set(np.unique(got["seq00"])) <= {0, 1}


def test_eval_stream_matches_jax(pair):
    """On 2-object sequences the port's ``eval_stream`` row equals the JAX
    ``eval_stream`` row on the same weights and draws, exactly: the first
    object group's {0, 1} mask in the fused loop, its support row from the
    GT (the second object is not tracked). Group 0 of sequence i draws
    from the JAX key ``fold_in(fold_in(key, i), 0)``, handed to the port by
    its generator's seed ``fold_in(fold_in(seed, i), 0)``."""
    j_ev, ev = _evaluators(pair)
    key = jax.random.PRNGKey(11)
    kw = dict(INDEX_KW, num_sequences=4)
    # two sequences on which the JAX reference holds its masks under
    # weights x (1 ± 1e-6) at these stream positions; the other two move
    # there (scripts/parity_spread.py detection-stream): seq01 by 1 pixel
    # at position 1 and 19 at position 0, seq02 by 2 at position 0 and 34
    # at position 1, and the port's rows read 220-298 and 2-34 pixels
    # from JAX's there: chaos, not the path (seq03 moves by 1 at position 0)
    names = ["seq00", "seq03"]
    want = j_ev.eval_stream(JSyntheticVOSIndex(**kw), names, pair["j_meta"],
                            key)
    seed = 9
    draws = {fold_in(fold_in(seed, i), 0): JaxDraws(
        pair["jmodel"], pair["variables"],
        jax.random.fold_in(jax.random.fold_in(key, i), 0), ev.cfg)
        for i in range(len(names))}
    ev.sample_draws = draws_by_seed(draws)
    index = SyntheticVOSIndex(**kw)
    got = ev.eval_stream(index, names, pair["meta"], seed)
    assert list(got) == names
    for name in names:
        assert len(index.sequences[name].object_groups) == 2
        assert got[name].dtype == np.uint8
        assert got[name].shape == want[name].shape == (T, SIZE, SIZE)
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(
            got[name][0], index.get_label(name, 0) == 1)
    assert set(np.unique(got["seq00"])) == {0, 1}
    for d in draws.values():
        assert d.calls == {"fine_tune": 1, "frames": 3, "refit": 2}


def test_fused_flag_follows_online_adaptation(pair):
    """``fused_ona`` only means something with online adaptation."""
    _, ev = _evaluators(pair)
    assert not ev.fused_ona
    ev = DetectionOneShotEvaluator(
        pair["model"], MetaOptimConfig(use_log_init_lr=False),
        dataclasses.replace(ev.cfg, online_adapt_step=0), device="cpu",
        fused_ona=True)
    assert not ev.fused_ona
