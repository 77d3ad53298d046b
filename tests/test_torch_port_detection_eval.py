"""The port's Mask R-CNN sequence evaluation against the JAX package on the
CPU: ``DetectionOneShotEvaluator.eval_sequence`` on a 2-object sequence
(object groups in turn, the JAX side with ``batch_objects=False`` and the
fused window loop) and ``eval_sequence_init`` (tracking with the
un-fine-tuned init), on the same weights, lrs, frames and random draws.

The tiny model, configuration and degenerate augmentation of
``test_torch_port_detection_slice.py``. The JAX draws are handed to the
port per group: group gi's generator is seeded with ``fold_in(seed, gi)``,
and a stand-in for ``sample_draws`` picks the JAX draws of that group's key
(``jax.random.fold_in(key, gi)``) by the generator's seed."""

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
    score_merged_device,
)
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from test_torch_port_detection_models import SIZE, tiny_pair
from test_torch_port_detection_slice import AUG_KW, CFG_KW, JaxDraws

T = 5
INDEX_KW = dict(num_sequences=1, num_frames=T, size=(SIZE, SIZE),
                num_objects=2, seed=4)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def draws_by_seed(draws):
    """A ``sample_draws`` stand-in: the draws object of the generator's
    seed."""
    return lambda gen, kind, count, hw: draws[gen.initial_seed()](
        gen, kind, count, hw)


def test_detection_eval_sequence_matches_jax():
    """Probabilities of both objects atol 1e-2 with a mean error under
    1e-5 (the slice test's tolerances: the pasted masks move with their
    boxes); merged maps equal wherever the JAX probabilities are more than
    1e-2 from the threshold; the JAX merged map scored by the port within
    1e-6 of the JAX scores; J and F end to end within 1e-3. Then init_J and
    init_F within 1e-3."""
    rng = np.random.RandomState(0)
    jmodel, variables, model = tiny_pair(detections_per_img=1)
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables["params"], "neuron")))
    j_cfg = JDetectionOneShotConfig(augment=JAugmentConfig(**AUG_KW),
                                    **CFG_KW)
    j_meta = JMetaParams(model_init=variables, log_init_lr={"params": lrs})
    j_ev = JDetectionOneShotEvaluator(
        jmodel, JMetaOptimConfig(use_log_init_lr=False), j_cfg,
        batch_objects=False, fused_ona=True)
    index_j = JSyntheticVOSIndex(**INDEX_KW)
    key = jax.random.PRNGKey(11)
    want = j_ev.eval_sequence(index_j, "seq00", j_meta, key)
    want_init = j_ev.eval_sequence_init(index_j, "seq00", j_meta)

    sd = state_dict_from_jax(variables)
    names = {n for n, _ in model.named_parameters()}
    meta = MetaParams(model_init={k: v for k, v in sd.items() if k in names},
                      log_init_lr=lr_tree_from_jax(lrs))
    cfg = DetectionOneShotConfig(augment=AugmentConfig(**AUG_KW), **CFG_KW)
    ev = DetectionOneShotEvaluator(model, MetaOptimConfig(use_log_init_lr=False),
                                   cfg, fused_ona=True, device="cpu",
                                   batch_objects=False)
    seed = 3
    draws = {fold_in(seed, gi): JaxDraws(jmodel, variables,
                                         jax.random.fold_in(key, gi), cfg)
             for gi in range(2)}
    ev.sample_draws = draws_by_seed(draws)
    phases = []
    ev.on_phase = phases.append
    index = SyntheticVOSIndex(**INDEX_KW)
    got = ev.eval_sequence(index, "seq00", meta, seed)
    assert phases == ["fine_tune", "propagate"] * 2 + ["score"]
    wn = 2  # 4 frames after the support frame, windows of 2
    for d in draws.values():
        assert d.calls == {"fine_tune": 1, "frames": wn, "refit": wn - 1}

    assert set(got) == set(want)
    j_probs = np.asarray(want["probs"])
    probs = got["probs"]
    assert isinstance(probs, torch.Tensor) and probs.shape == (2, T, SIZE,
                                                               SIZE)
    probs = probs.numpy()
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=1e-2)
    assert np.abs(probs - j_probs).mean() < 1e-5
    assert 0.0 < (j_probs[:, 1:] >= 0.5).mean() < 1.0
    assert got["merged"].dtype == np.uint8
    sure = (np.abs(j_probs - 0.5) > 1e-2).all(0)
    np.testing.assert_array_equal(got["merged"][sure], want["merged"][sure])

    seq = index.sequences["seq00"]
    j_means, f_means, _ = score_merged_device(
        index, "seq00", seq, torch.from_numpy(want["merged"].astype(np.int32)))
    np.testing.assert_allclose(j_means, want["J_per_object"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(f_means, want["F_per_object"], rtol=0,
                               atol=1e-6)
    for k in ("J_per_object", "F_per_object", "J_mean", "F_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)

    # init_J: no fine-tune and no refit; group gi's frame draws come from
    # the JAX key fold_in(PRNGKey(0), gi), window w's from its fold_in w
    init_draws = {}
    for gi in range(2):
        d = JaxDraws(jmodel, variables, key, cfg)
        d.k_win = jax.random.fold_in(jax.random.PRNGKey(0), gi)
        init_draws[fold_in(0, gi)] = d
    ev.sample_draws = draws_by_seed(init_draws)
    got_init = ev.eval_sequence_init(index, "seq00", meta)
    for d in init_draws.values():
        assert d.calls == {"fine_tune": 0, "frames": wn, "refit": 0}
    assert got_init["seq"] == "seq00"
    for k in ("init_J_mean", "init_F_mean"):
        np.testing.assert_allclose(got_init[k], want_init[k], rtol=0,
                                   atol=1e-3)
