"""Training with the ``batch`` norm in the port against the JAX package on
the CPU, and a JAX meta-training run resumed in the port:

  * a first-order meta step (``MetaTrainer.run``, ``batch`` backbone, GN-4
    head on the kernels' twins) and a second-order one (``batch`` backbone
    and head: no GroupNorm, so nothing needs an ``_xla`` form) against the
    JAX step with its draws handed to the port: losses rtol 1e-5, each
    tensor's change within 1e-3 of its largest change plus two float32
    ulps of the value (``chip_smoke.step_change_excess``), the running
    ``mean``/``var`` of the learned init moved (the outer RAdam and its
    weight decay reach them) and finite;
  * the JAX trainer's checkpoint after that step (``MetaTrainer.save``:
    flax msgpack ``{"meta_params", "opt_state"}`` and its JSON sidecar)
    restored by the port's ``MetaTrainer.restore``: meta-parameters,
    RAdam's ``mu``/``nu`` and each group's count equal to optax's exactly,
    ``meta_iter`` from the sidecar; the next step then matches the JAX
    trainer's next step on the same batch as above; ``cli.train_meta``
    with ``resume`` set to that checkpoint continues from it;
  * two parent Adam steps (dense task, ``batch`` backbone) against the JAX
    ``ParentTrainer``: losses rtol 1e-4, changes as
    ``test_torch_port_parent_trainer.py`` holds them, the statistics moved
    (the JAX step differentiates ``batch_stats``).

resnet10 DeepLabV3+ os16 at 32x32 in fp32, statistics drawn far from the
identity (``test_torch_port_batch_norm.with_batch_stats``)."""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import step_change_excess
from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.engine import MetaTrainConfig as JMetaTrainConfig
from e_osvos_tpu.engine import MetaTrainer as JMetaTrainer
from e_osvos_tpu.engine.parent_trainer import FrameSampler as JFrameSampler
from e_osvos_tpu.engine.parent_trainer import (
    ParentTrainConfig as JParentTrainConfig,
)
from e_osvos_tpu.engine.parent_trainer import ParentTrainer as JParentTrainer
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim import init_meta_params as j_init_meta_params
from e_osvos_tpu.meta_optim.tasksets import MetaTaskset as JMetaTaskset
from e_osvos_tpu.meta_optim.tasksets import MetaTasksetConfig as JTasksetCfg
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.parallel import MetaStepConfig as JMetaStepConfig
from e_osvos_tpu.parallel import OuterOptimConfig as JOuterOptimConfig
from e_osvos_tpu.parallel import make_mesh, make_meta_step as j_make_meta_step
from e_osvos_tpu.parallel import shard_task_batch
from e_osvos_tpu.utils import MetricsLogger as JMetricsLogger
from e_osvos_torch.cli import train_meta
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import (
    FrameSampler,
    MetaTrainConfig,
    MetaTrainer,
    ParentTrainConfig,
    ParentTrainer,
)
from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    MetaTaskset,
    MetaTasksetConfig,
)
from e_osvos_torch.models import DeepLabV3Plus, functional_apply
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.parallel import (
    MetaStepConfig,
    OuterOptimConfig,
    make_meta_step,
)
from e_osvos_torch.utils import MetricsLogger
from test_torch_port_batch_norm import deeplab_variables
from test_torch_port_meta_step import jax_draws_for
from test_torch_port_parent_trainer import change_excess, jax_draws

S = 32
TASKS = 2
MODEL_KW = dict(num_classes=1, arch="resnet10", backbone_norm="batch",
                head_norm="group4", output_stride=16)
INDEX_KW = dict(num_sequences=3, num_frames=4, size=(S, S), num_objects=1,
                seed=0)
STEP_KW = dict(num_epochs=2, bptt_epochs=1, train_batch_size=1)
AUG = dict(compute_dtype="float32")
OUTER_KW = dict(model_init_lr=1e-3, log_init_lr_lr=1e-3, grad_clip=0.5)
TRAIN_KW = dict(meta_batch_size=TASKS, vis_interval=100, seed=3)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 command runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(mp):
    """A port ``MetaParams`` as one list of tensors, field by field, in
    key order."""
    return [d[k] for d in mp for k in sorted(d or {})]


def _jax_flat(j_mp):
    return _flat(MetaParams(
        state_dict_from_jax(jax.device_get(j_mp.model_init)),
        lr_tree_from_jax(jax.device_get(j_mp.log_init_lr))))


def assert_step_matches(start, got, want, label):
    """The outer step's change ``got − start`` against ``want − start``
    entry by entry (``step_change_excess``, 1e-3), over every tensor of
    the learned init and the lrs."""
    worst, over, total = step_change_excess(start, got, start, want, 1e-3)
    assert over == 0, (label, worst, over, total)


def assert_statistics_moved(before, after, norms=17):
    """Every ``batch`` norm's running ``mean``/``var`` of the learned init
    moved in the outer step and stayed finite (resnet10's backbone has 17
    norms)."""
    stats = [k for k in after if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * norms
    for k in stats:
        assert not torch.equal(before[k], after[k]), k
        assert bool(torch.isfinite(after[k]).all()), k


# ---------------------------------------- first order, and the resumed run


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two iterations of the JAX ``MetaTrainer`` (log lrs: the
    ``batch_stats`` lrs sit at the floor e^-33, as the port's absent lrs
    leave the statistics), checkpointed after the first by its own
    ``save``. Returns the JAX variables, the checkpoint's path, the
    meta-parameters after each iteration, the optax state after the first
    and the losses of each."""
    d = tmp_path_factory.mktemp("jax_meta_run")
    variables, _ = deeplab_variables(JDeepLabV3Plus, MODEL_KW, 21, (S, S))
    j_step_cfg = JMetaStepConfig(remat=False, augment=JAugmentConfig(**AUG),
                                 **STEP_KW)
    trainer = JMetaTrainer(
        JDeepLabV3Plus(**MODEL_KW).apply, variables,
        JMetaTaskset([JSyntheticVOSIndex(**INDEX_KW)],
                     JTasksetCfg(crop_size=(S, S)), seed=0),
        meta_cfg=JMetaOptimConfig(), step_cfg=j_step_cfg,
        outer_cfg=JOuterOptimConfig(**OUTER_KW),
        train_cfg=JMetaTrainConfig(save_dir=str(d), **TRAIN_KW),
        mesh=make_mesh(num_tasks=1, devices=jax.devices()[:1]),
        logger=JMetricsLogger(echo=False))
    first = trainer.run(1)
    ckpt = trainer.save("last_meta_iter")
    out = {"variables": variables, "ckpt": ckpt,
           "aug": j_step_cfg.augment,
           "meta": [jax.device_get(trainer.meta_params)],
           "opt_state": jax.device_get(trainer.opt_state),
           "losses": [first["per_task_loss"]]}
    second = trainer.run(1)
    out["meta"].append(jax.device_get(trainer.meta_params))
    out["losses"].append(second["per_task_loss"])
    return out


def port_trainer(jax_run, save_dir=None):
    """The port's ``MetaTrainer`` on the JAX run's model and settings, the
    JAX step's draws handed to it."""
    model = DeepLabV3Plus(device="cpu", **MODEL_KW)
    model.load_state_dict(state_dict_from_jax(jax_run["variables"]),
                          strict=True)
    step_cfg = MetaStepConfig(augment=AugmentConfig(**AUG), **STEP_KW)
    trainer = MetaTrainer(
        functional_apply(model), model,
        MetaTaskset([SyntheticVOSIndex(**INDEX_KW)],
                    MetaTasksetConfig(crop_size=(S, S)), seed=0),
        meta_cfg=MetaOptimConfig(), step_cfg=step_cfg,
        outer_cfg=OuterOptimConfig(**OUTER_KW),
        train_cfg=MetaTrainConfig(save_dir=save_dir, **TRAIN_KW),
        logger=MetricsLogger(echo=False), device="cpu")
    trainer.step.task_draws = jax_draws_for(step_cfg, jax_run["aug"])
    return trainer


def test_first_order_meta_step_matches_jax(jax_run):
    """The first iteration from the same init: per-task meta-losses rtol
    1e-5 and the outer step's change of every meta-parameter, the running
    statistics included, as the JAX step's."""
    trainer = port_trainer(jax_run)
    start = [t.clone() for t in _flat(trainer.meta_params)]
    before = {k: v.clone() for k, v in trainer.meta_params.model_init.items()}
    out = trainer.run(1)
    np.testing.assert_allclose(out["per_task_loss"], jax_run["losses"][0],
                               rtol=1e-5)
    assert_step_matches(start, _flat(trainer.meta_params),
                        _jax_flat(jax_run["meta"][0]), "first step")
    assert_statistics_moved(before, trainer.meta_params.model_init)


def _optax_radam(opt_state, group):
    """The ``ScaleByRAdamState`` of ``group`` in the live optax state:
    ``multi_transform`` → ``masked`` → the chain's last link → radam's
    first."""
    return opt_state.inner_states[group].inner_state[-1][0]


def test_jax_checkpoint_resumes_in_port(jax_run):
    """The JAX trainer's checkpoint after one iteration, restored by the
    port: the meta-parameters, each group's RAdam count and every
    tensor's ``mu``/``nu`` equal the JAX state carried into the port's
    layout, exactly (``batch_stats`` lr moments dropped with their lrs);
    ``meta_iter`` is 1. The next iteration (the task sampler reseeded
    from ``seed + meta_iter`` on both sides) matches the JAX trainer's
    second: losses rtol 1e-5, the step's change as in the first test."""
    trainer = port_trainer(jax_run)
    trainer.restore(jax_run["ckpt"])
    assert trainer.meta_iter == 1
    want = jax_run["meta"][0]
    want_flat = _jax_flat(want)
    got_flat = _flat(trainer.meta_params)
    assert len(got_flat) == len(want_flat)
    assert all(torch.equal(g, w) for g, w in zip(got_flat, want_flat))
    opt = trainer.opt_state
    for group in opt.param_groups:
        name = group["name"]
        radam = _optax_radam(jax_run["opt_state"], name)
        assert group["count"] == int(radam.count) == 1
        convert = (state_dict_from_jax if name == "model_init"
                   else lr_tree_from_jax)
        tensors = getattr(trainer.meta_params, name)
        for field in ("mu", "nu"):
            moments = convert(getattr(getattr(radam, field), name))
            assert set(moments) == set(tensors)
            for k, p in tensors.items():
                assert torch.equal(opt.state[p][field], moments[k]), (
                    field, k)
    assert any(float(opt.state[p]["nu"].abs().max()) > 0
               for p in trainer.meta_params.model_init.values())

    start = [t.clone() for t in got_flat]
    before = {k: v.clone() for k, v in trainer.meta_params.model_init.items()}
    out = trainer.run(1)
    assert trainer.meta_iter == 2
    assert all(g["count"] == 2 for g in opt.param_groups)
    np.testing.assert_allclose(out["per_task_loss"], jax_run["losses"][1],
                               rtol=1e-5)
    assert_step_matches(start, _flat(trainer.meta_params),
                        _jax_flat(jax_run["meta"][1]), "resumed step")
    assert_statistics_moved(before, trainer.meta_params.model_init)


def test_cli_train_meta_resumes_jax_checkpoint(jax_run, tmp_path):
    """``cli.train_meta`` with ``resume`` set to the JAX checkpoint (the
    same model through the command line, on the Synthetic fixture): it
    starts from the checkpoint's meta-parameters and outer state at
    meta-iteration 1 and writes its own checkpoint at iteration 2."""
    argv = ["with", "Synthetic", "parent_model.encoder=resnet10",
            "parent_model.dtype=float32", "parent_model.backbone_norm=batch",
            "parent_model.decoder_norm_layer=group4",
            "parent_model.output_stride=16", "device=cpu",
            "meta_optim_cfg.use_log_init_lr=True", "meta_batch_size=2",
            "num_epochs.train=2", "bptt_epochs=1", "num_meta_iters=1",
            f"synthetic.size=[{S},{S}]",
            f"data_cfg.crop_sizes.train=[{S},{S}]",
            f"resume={jax_run['ckpt']}", f"save_dir={tmp_path}"]
    restored = {}
    original = MetaTrainer.run

    def run(self, n=None):
        restored["meta_iter"] = self.meta_iter
        restored["init"] = {k: v.clone() for k, v in
                            self.meta_params.model_init.items()}
        restored["counts"] = [g["count"] for g in self.opt_state.param_groups]
        return original(self, n)

    MetaTrainer.run = run
    try:
        trainer = train_meta.main(argv)
    finally:
        MetaTrainer.run = original
    assert restored["meta_iter"] == 1 and restored["counts"] == [1, 1]
    want = state_dict_from_jax(jax.device_get(jax_run["meta"][0].model_init))
    assert all(torch.equal(restored["init"][k], want[k]) for k in want)
    assert trainer.meta_iter == 2
    assert [g["count"] for g in trainer.opt_state.param_groups] == [2, 2]
    assert (tmp_path / "last_meta_iter.ckpt").exists()


# ------------------------------------------------------------ second order


def test_second_order_meta_step_matches_jax():
    """One second-order meta step of 2 tasks (2 inner steps, truncated
    after each) with ``batch`` norms in the backbone and the head, linear
    lrs drawn per neuron: losses rtol 1e-5, every meta-parameter's change
    as the JAX step's (1e-3 of its largest change plus two ulps), the
    statistics moved."""
    kw = dict(MODEL_KW, head_norm="batch")
    variables, model = deeplab_variables(JDeepLabV3Plus, kw, 22, (S, S))
    j_meta_cfg = JMetaOptimConfig(use_log_init_lr=False,
                                  second_order_gradients=True)
    j_meta = j_init_meta_params(j_meta_cfg, variables)
    rng = np.random.RandomState(2)
    lrs = dict(j_meta.log_init_lr)
    lrs["params"] = jax.tree_util.tree_map(
        lambda l: rng.uniform(0.01, 0.1, np.shape(l)).astype(np.float32),
        jax.device_get(lrs["params"]))
    j_meta = JMetaParams(variables, lrs)
    j_step_cfg = JMetaStepConfig(remat=False, augment=JAugmentConfig(**AUG),
                                 **STEP_KW)
    mesh = make_mesh(num_tasks=1, devices=jax.devices()[:1])
    j_step = j_make_meta_step(JDeepLabV3Plus(**kw).apply, j_meta_cfg,
                              j_step_cfg, JOuterOptimConfig(**OUTER_KW), mesh,
                              meta_batch_size=TASKS)
    j_tasks = JMetaTaskset([JSyntheticVOSIndex(**INDEX_KW)],
                           JTasksetCfg(crop_size=(S, S)), seed=0)
    j_out = j_step(j_meta, j_step.init(j_meta),
                   shard_task_batch(mesh, j_tasks.sample_batch(TASKS)))

    sd = state_dict_from_jax(variables)
    meta = MetaParams({k: v.clone() for k, v in sd.items()},
                      lr_tree_from_jax(lrs))
    step_cfg = MetaStepConfig(augment=AugmentConfig(**AUG), **STEP_KW)
    step = make_meta_step(
        functional_apply(model),
        MetaOptimConfig(use_log_init_lr=False, second_order_gradients=True),
        step_cfg, OuterOptimConfig(**OUTER_KW), TASKS, device="cpu")
    step.task_draws = jax_draws_for(step_cfg, j_step_cfg.augment)
    tasks = MetaTaskset([SyntheticVOSIndex(**INDEX_KW)],
                        MetaTasksetConfig(crop_size=(S, S)), seed=0)
    start = [t.clone() for t in _flat(meta)]
    out = step(meta, step.init(meta), tasks.sample_batch(TASKS))
    np.testing.assert_allclose(out.per_task_loss.numpy(),
                               np.asarray(j_out.per_task_loss), rtol=1e-5)
    np.testing.assert_allclose(out.train_losses.numpy(),
                               np.asarray(j_out.train_losses), rtol=1e-5)
    assert_step_matches(start, _flat(out.meta_params),
                        _jax_flat(j_out.meta_params), "second order")
    assert_statistics_moved(sd, out.meta_params.model_init, norms=17 + 9)


# ------------------------------------------------------------ parent steps


def test_parent_adam_steps_match_jax():
    """Two ``ParentTrainer`` Adam steps (lr 1e-3, weight decay 1e-2,
    batch 2, dense task, cross-entropy and dice) of the ``batch``-backbone
    DeepLabV3+ against the JAX trainer, the JAX keys' draws handed to the
    port: losses rtol 1e-4; each tensor's change within 1e-3 of its
    largest change plus two ulps, at most 1e-3 of the entries over (Adam
    moves an entry whose gradient is rounding noise by about lr in a
    direction neither side determines; ``test_torch_port_parent_trainer.py``
    counts them the same way); every tensor moved, the statistics too."""
    variables, model = deeplab_variables(JDeepLabV3Plus, MODEL_KW, 23,
                                         (S, S))
    kw = dict(batch_size=2, weight_decay=1e-2, crop_size=(S, S), seed=3,
              log_interval=100, snapshot_interval=100, task="dense",
              optimizer="adam", lr=1e-3, loss_func="cross_entropy_and_dice")
    aug = dict(scale_min=1.0, scale_max=1.2, rot_deg=0.0, brightness=0.05,
               contrast=0.05, saturation=0.05, flip_prob=0.5,
               compute_dtype="float32")
    index_kw = dict(num_sequences=2, num_frames=3, size=(S, S), seed=6)
    j_trainer = JParentTrainer(
        JDeepLabV3Plus(**MODEL_KW).apply, variables,
        JFrameSampler([JSyntheticVOSIndex(**index_kw)], (S, S), seed=0),
        JParentTrainConfig(augment=JAugmentConfig(**aug), **kw),
        mesh=make_mesh(num_tasks=1, devices=jax.devices()[:1]),
        logger=JMetricsLogger(echo=False))
    cfg = ParentTrainConfig(augment=AugmentConfig(**aug), **kw)
    trainer = ParentTrainer(
        model, FrameSampler([SyntheticVOSIndex(**index_kw)], (S, S), seed=0),
        cfg, logger=MetricsLogger(echo=False), device="cpu")
    trainer.sample_draws = jax_draws(cfg, j_trainer.cfg.augment)
    first = {k: v.clone() for k, v in trainer.state_dict().items()}
    for i in range(2):
        want = j_trainer.run(1)["loss"]
        got = trainer.run(1)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"step {i}")
    over, total = change_excess(
        first, trainer.state_dict(),
        state_dict_from_jax(jax.device_get(j_trainer.params)))
    assert over <= 1e-3 * total, (over, total)
    got = trainer.state_dict()
    assert all(not torch.equal(first[k], got[k]) for k in first)
    assert all(bool(torch.isfinite(got[k]).all()) for k in got
               if k.endswith(".var"))
