"""The port's parent training (e_osvos_torch.engine.parent_trainer) against
the JAX package's on the CPU:

  * ``FrameSampler`` and ``InstanceFrameSampler``: bit-equal batches from
    one seed;
  * three ``ParentTrainer`` steps of a tiny DeepLabV3+ (dense task,
    frozen-BN backbone, GN-16 head) and a tiny Mask R-CNN (detection task,
    2 instance slots) against the JAX trainer on a one-device mesh, with
    Adam and with SGD and momentum, weight decay on, the JAX keys' draws
    handed to the port (``ParentTrainer.sample_draws``): losses rtol 1e-4;
    each tensor's change within 1e-3 of its largest change plus two
    float32 ulps of the parameter. The dense steps run free. Detection
    training is chaotic on these tiny inputs (the JAX trainer alone, its
    weights scaled by 1 ± 1e-6, moves its third Adam loss by 0.6%: a
    proposal or a sampled RoI changes sides; scripts/parity_spread.py
    detection-parent), so each detection step
    starts from the JAX trainer's parameters and optimizer moments of the
    step before. Adam divides each gradient by its own
    magnitude, so an entry whose gradient is rounding noise on both sides
    moves by about ``lr`` in a direction neither side determines: those
    entries are counted (at most 1e-3 of all), as
    ``chip_smoke.step_change_excess`` counts them, not covered by a wider
    tolerance; so are the detection steps' entries that the Lovász mask
    loss moves when two of its sorted errors, equal to rounding, change
    places (250 of 19.7M after one SGD step). The dense SGD steps have none.
    Every tensor moves, the frozen-BN buffers included (the JAX step
    differentiates its whole variables tree);
  * ``run``: logging, snapshots and the loss falling on a fixed batch.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.engine.parent_trainer import FrameSampler as JFrameSampler
from e_osvos_tpu.engine.parent_trainer import (
    InstanceFrameSampler as JInstanceFrameSampler,
)
from e_osvos_tpu.engine.parent_trainer import (
    ParentTrainConfig as JParentTrainConfig,
)
from e_osvos_tpu.engine.parent_trainer import ParentTrainer as JParentTrainer
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.parallel import make_mesh
from e_osvos_tpu.utils import MetricsLogger as JMetricsLogger
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig, AugmentDraws
from e_osvos_torch.engine import (
    FrameSampler,
    InstanceFrameSampler,
    ParentTrainConfig,
    ParentTrainer,
)
from e_osvos_torch.models import DeepLabV3Plus
from e_osvos_torch.models.jax_weights import state_dict_from_jax
from e_osvos_torch.utils import MetricsLogger, load_checkpoint
from test_torch_port_augment import jax_frame_draws
from test_torch_port_detection_models import (
    SIZE as DET_SIZE,
    jax_train_draws,
    random_variables,
    tiny_pair,
)

DENSE_SIZE = (32, 32)
DENSE_KW = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                head_norm="group16", output_stride=16)
# Zoom-in, flips and colour only: a zoom-out or a rotation leaves a constant
# border whose equal activations tie in the stem's max-pool, and the warp's
# fringe pixels, which differ from JAX's by rounding (3e-5 of 255), then
# route the stem's gradient elsewhere: on one such batch the stem's weight
# gradient moved by 0.7% of its largest entry while the port's gradient on
# JAX's augmented frames stays within 1e-4 (scripts/parity_spread.py
# parent-border). The warp itself is held to JAX in
# test_torch_port_augment.py.
MILD = dict(scale_min=1.0, scale_max=1.2, rot_deg=0.0, brightness=0.05,
            contrast=0.05, saturation=0.05, flip_prob=0.5,
            compute_dtype="float32")
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the tier-1 command runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _index(cls, size, **kw):
    return cls(num_sequences=2, num_frames=3, size=size, **kw)


@pytest.mark.parametrize("kind, max_objects", [
    ("frames", None), ("instances", 1), ("instances", 2)])
def test_samplers_bit_equal_to_jax(kind, max_objects):
    """Two indexes (one of 2-object sequences, 20x28 frames under a 24x24
    crop, so the padding path runs), three batches from seed 5."""
    def indexes(cls):
        return [_index(cls, (20, 28), num_objects=2, seed=1),
                _index(cls, (40, 40), seed=2)]

    if kind == "frames":
        got = FrameSampler(indexes(SyntheticVOSIndex), (24, 24), seed=5)
        want = JFrameSampler(indexes(JSyntheticVOSIndex), (24, 24), seed=5)
    else:
        got = InstanceFrameSampler(indexes(SyntheticVOSIndex), (24, 24),
                                   max_objects=max_objects, seed=5)
        want = JInstanceFrameSampler(indexes(JSyntheticVOSIndex), (24, 24),
                                     max_objects=max_objects, seed=5)
    assert got.units == want.units
    seen = set()
    for _ in range(3):
        batch = got.sample_batch(6)
        for g, w in zip(batch, want.sample_batch(6)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        seen |= set(np.unique(batch[1]).tolist())
    if kind == "instances":
        assert seen <= {0, 1, 2, 255} and max_objects in seen


def jax_draws(trainer_cfg, jcfg, jmodel=None, variables=None):
    """A ``ParentTrainer.sample_draws`` stand-in: the JAX step's draws, frame
    i's augmentation from ``PRNGKey(seeds[i])`` and the detection sampling
    from ``fold_in(PRNGKey(cfg.seed), seeds[0])``."""

    def sample_draws(seeds, hw):
        per = [jax_frame_draws(jax.random.PRNGKey(np.uint32(s)), jcfg)
               for s in seeds]
        aug = AugmentDraws(*(None if f[0] is None else torch.stack(f)
                             for f in zip(*per)))
        if trainer_cfg.task != "detection":
            return aug, None
        key = jax.random.fold_in(jax.random.PRNGKey(trainer_cfg.seed),
                                 np.uint32(seeds[0]))
        return aug, jax_train_draws(jmodel, variables, key, len(seeds),
                                    num_objects=trainer_cfg.max_objects)

    return sample_draws


def change_excess(start, got, want, tol=1e-3):
    """Each entry's |Δ_got − Δ_want| against ``tol`` of its tensor's
    largest |Δ_want| plus two float32 ulps of the parameter: (entries over,
    entries)."""
    over = total = 0
    for k, s in start.items():
        s, g, w = (t.double() for t in (s, got[k], want[k]))
        mag = torch.maximum(s.abs(), w.abs()).float()
        ulp = (torch.nextafter(mag, torch.full_like(mag, np.inf)) - mag)
        d_want = w - s
        limit = tol * float(d_want.abs().max()) + 2 * ulp.double()
        over += int(((g - s - d_want).abs() > limit).sum())
        total += s.numel()
    return over, total


def _find(tree, field):
    """The optax state node (a NamedTuple) with ``field``."""
    if hasattr(tree, "_fields") and field in tree._fields:
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _find(t, field)
            if found is not None:
                return found
    return None


@torch.no_grad()
def load_jax_state(trainer, j_trainer):
    """The JAX trainer's parameters and optimizer state (Adam's moments and
    count, or SGD's momentum trace) copied into the port's trainer; returns
    copies of the parameters."""
    params = state_dict_from_jax(jax.device_get(j_trainer.params))
    for k, v in trainer.params.items():
        v.copy_(params[k])
    adam = _find(j_trainer.opt_state, "mu")
    if adam is not None:
        mu = state_dict_from_jax(jax.device_get(adam.mu))
        nu = state_dict_from_jax(jax.device_get(adam.nu))
        count = float(jax.device_get(adam.count))
        fill = {k: {"step": torch.tensor(count), "exp_avg": mu[k].clone(),
                    "exp_avg_sq": nu[k].clone()} for k in params}
    else:
        trace = state_dict_from_jax(jax.device_get(
            _find(j_trainer.opt_state, "trace").trace))
        fill = {k: {"momentum_buffer": trace[k].clone()} for k in params}
    for k, v in trainer.params.items():
        trainer.opt.state[v] = fill[k]
    return {k: v.clone() for k, v in params.items()}


def dense_setup():
    variables = random_variables(JDeepLabV3Plus(**DENSE_KW), 3,
                                 jax.random.PRNGKey(0),
                                 jnp.zeros((1,) + DENSE_SIZE + (3,)))
    model = DeepLabV3Plus(device="cpu", **DENSE_KW)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return JDeepLabV3Plus(**DENSE_KW), variables, model


CASES = {
    "dense_adam": dict(task="dense", optimizer="adam", lr=1e-3),
    "dense_sgd": dict(task="dense", optimizer="sgd", lr=1e-2),
    "detection_adam": dict(task="detection", optimizer="adam", lr=1e-4),
    "detection_sgd": dict(task="detection", optimizer="sgd", lr=1e-3),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_parent_steps_match_jax(case):
    c = dict(CASES[case])
    det = c["task"] == "detection"
    if det:
        jmodel, variables, model = tiny_pair()
        size = (DET_SIZE, DET_SIZE)
        c.update(max_objects=2, loss_func="dice")
    else:
        jmodel, variables, model = dense_setup()
        size = DENSE_SIZE
        c.setdefault("loss_func", "cross_entropy_and_dice")
    kw = dict(batch_size=2, weight_decay=1e-2, crop_size=size, seed=3,
              log_interval=100, snapshot_interval=100, **c)

    def indexes(cls):
        return [_index(cls, size, num_objects=2 if det else 1, seed=6)]

    sampler_kw = dict(max_objects=2) if det else {}
    j_sampler = (JInstanceFrameSampler if det else JFrameSampler)(
        indexes(JSyntheticVOSIndex), size, seed=0, **sampler_kw)
    sampler = (InstanceFrameSampler if det else FrameSampler)(
        indexes(SyntheticVOSIndex), size, seed=0, **sampler_kw)
    j_trainer = JParentTrainer(
        jmodel.apply, variables, j_sampler,
        JParentTrainConfig(augment=JAugmentConfig(**MILD), **kw),
        mesh=make_mesh(num_tasks=1, devices=jax.devices()[:1]),
        logger=JMetricsLogger(echo=False))
    cfg = ParentTrainConfig(augment=AugmentConfig(**MILD), **kw)
    trainer = ParentTrainer(model, sampler, cfg,
                            logger=MetricsLogger(echo=False), device="cpu")
    trainer.sample_draws = jax_draws(cfg, j_trainer.cfg.augment, jmodel,
                                     variables)
    first = {k: v.clone() for k, v in trainer.state_dict().items()}
    assert set(first) == set(state_dict_from_jax(variables))
    start = first
    for i in range(STEPS):
        if det and i:
            start = load_jax_state(trainer, j_trainer)
        want = j_trainer.run(1)["loss"]
        got = trainer.run(1)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"step {i}")
        if det or i == STEPS - 1:
            over, total = change_excess(
                start, trainer.state_dict(),
                state_dict_from_jax(jax.device_get(j_trainer.params)))
            assert over <= 1e-3 * total, (i, over, total)
            if c["optimizer"] == "sgd" and not det:
                assert over == 0, (i, over)
    got = trainer.state_dict()
    moved = [k for k in first if not torch.equal(first[k], got[k])]
    assert set(moved) == set(first)  # frozen-BN buffers included


def test_run_logs_snapshots_and_learns(tmp_path):
    """``run`` logs its first and every ``log_interval``-th step, writes a
    snapshot every ``snapshot_interval`` steps that loads back as the
    model's ``state_dict``, and on one repeated batch the loss falls."""
    _, _, model = dense_setup()

    class OneBatch(FrameSampler):
        def sample_batch(self, n):
            if not hasattr(self, "fixed"):
                self.fixed = super().sample_batch(n)
            return self.fixed

    sampler = OneBatch([_index(SyntheticVOSIndex, DENSE_SIZE, seed=2)],
                       DENSE_SIZE, seed=0)
    cfg = ParentTrainConfig(batch_size=2, lr=3e-3, crop_size=DENSE_SIZE,
                            log_interval=2, snapshot_interval=3,
                            save_dir=str(tmp_path),
                            augment=AugmentConfig(**MILD))
    trainer = ParentTrainer(model, sampler, cfg, device="cpu",
                            logger=MetricsLogger(
                                path=str(tmp_path / "m.jsonl"), echo=False))
    first = trainer.run(1)["loss"]
    last = trainer.run(5)["loss"]
    trainer.logger.close()
    assert np.isfinite([first, last]).all() and last < first
    steps = [json.loads(line)["step"]
             for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 4, 6]
    state, meta = load_checkpoint(str(tmp_path / "parent_6.ckpt"))
    assert meta == {"step": 6} and (tmp_path / "parent_3.ckpt").exists()
    model.load_state_dict(state, strict=True)
    for k, v in trainer.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
