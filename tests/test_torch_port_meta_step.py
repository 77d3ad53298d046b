"""The port's meta-training step and trainer (e_osvos_torch.parallel,
e_osvos_torch.engine.meta_trainer) against the JAX package on the CPU:

  * the outer optimizer (clip → weight decay → RAdam per group) against
    optax over 14 steps, through a state_dict round trip, within 1e-7
    absolute;
  * two whole meta steps of a tiny DeepLabV3+ against the JAX ``MetaStep``
    on a one-device CPU mesh, in both augmentation modes, with the JAX
    keys' draws handed to the port: meta-parameters within 1e-4 of each
    tensor's largest magnitude, losses rtol 1e-5;
  * ``MetaTrainer.run`` with logging, the evaluation hook, a profile and a
    checkpoint round trip;
  * the GroupNorm kernel calls of a meta step against the formula
    ``chip_smoke.py`` holds the card's launch counts to.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim import init_meta_params as j_init_meta_params
from e_osvos_tpu.meta_optim.tasksets import MetaTaskset as JMetaTaskset
from e_osvos_tpu.meta_optim.tasksets import MetaTasksetConfig as JTasksetCfg
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.parallel import MetaStepConfig as JMetaStepConfig
from e_osvos_tpu.parallel import OuterOptimConfig as JOuterOptimConfig
from e_osvos_tpu.parallel import make_mesh, make_meta_step as j_make_meta_step
from e_osvos_tpu.parallel import make_outer_optimizer as j_make_outer
from e_osvos_tpu.parallel import shard_task_batch
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig, AugmentDraws
from e_osvos_torch.engine import MetaTrainConfig, MetaTrainer
from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    MetaTaskset,
    MetaTasksetConfig,
    init_meta_params,
)
from e_osvos_torch.models import DeepLabV3Plus, functional_apply
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.parallel import (
    MetaStepConfig,
    OuterOptimConfig,
    TaskDraws,
    make_meta_step,
    make_outer_optimizer,
)
from e_osvos_torch.utils import MetricsLogger
from test_torch_port_augment import jax_frame_draws, jax_task_draws
from test_torch_port_models import randomized_variables

S = 32
MODEL_KW = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                head_norm="group4", output_stride=16)
INDEX_KW = dict(num_sequences=3, num_frames=4, size=(S, S), num_objects=1,
                seed=0)
TASKS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 command runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ outer step


def _meta_pair(rng):
    """Small two-group meta-parameters: flax-shaped for optax, the port's
    dicts for torch (the same values)."""
    init = {"a": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    lrs = {"a": rng.randn(4, 1).astype(np.float32) - 3.0,
           "b": rng.randn(5).astype(np.float32) - 3.0}
    return (JMetaParams(init, lrs),
            MetaParams({k: torch.from_numpy(v.copy()) for k, v in init.items()},
                       {k: torch.from_numpy(v.copy()) for k, v in lrs.items()}))


def _grads(rng, j_mp):
    """Init grads of order 1 (up to 1.5, some clipped); lr grads of order
    1e-8, where sqrt(v) is comparable to RAdam's eps."""
    return JMetaParams(
        {k: (rng.randn(*np.shape(v)) * 0.75).astype(np.float32)
         for k, v in j_mp.model_init.items()},
        {k: (rng.randn(*np.shape(v)) * 1e-8).astype(np.float32)
         for k, v in j_mp.log_init_lr.items()})


def test_outer_optimizer_matches_optax(tmp_path):
    """14 steps of per-group clip(0.5) → weight decay 1e-3 (the init group)
    → RAdam(1e-3), with a state_dict saved, loaded into a fresh optimizer
    at step 7 and continued: params within 1e-7 absolute of optax at every
    step, past the rectification from step 6 (in fact equal).

    optax runs under ``jax.enable_x64`` (float32 params and state): then it
    takes its step scalars (β^t, ρ_t, r_t) in double, as the port does. In
    its default float32 mode ρ_t = ρ_∞ − 2t·β₂^t/(1 − β₂^t) cancels (1999
    − 1993 at t = 6), which moves r_t by about 1% and the params by about
    1e-6 over these steps; that is optax's rounding, not its formula.
    torch.optim.RAdam, which adds eps before the bias correction, leaves
    the bound on the lr group's 1e-8 gradients."""
    rng = np.random.RandomState(0)
    j_mp, mp = _meta_pair(rng)
    grads = [_grads(rng, j_mp) for _ in range(14)]
    cfg = dict(model_init_lr=1e-3, log_init_lr_lr=1e-3,
               model_init_weight_decay=1e-3, grad_clip=0.5)
    with jax.enable_x64(True):
        tx = j_make_outer(JOuterOptimConfig(**cfg), j_mp)
        j_state = tx.init(j_mp)
        want = []
        for g in grads:
            upd, j_state = tx.update(g, j_state, j_mp)
            j_mp = optax.apply_updates(j_mp, upd)
            want.append(jax.device_get(j_mp))
    assert want[-1].model_init["a"].dtype == np.float32

    opt = make_outer_optimizer(OuterOptimConfig(**cfg), mp)
    ref_p = [p.clone() for p in mp.log_init_lr.values()]
    ref = torch.optim.RAdam(ref_p, lr=1e-3)
    for step, (g, w) in enumerate(zip(grads, want)):
        for d_t, d_g in zip(mp, g):
            for k, p in d_t.items():
                p.grad = torch.from_numpy(d_g[k])
        opt.step()
        opt.zero_grad(set_to_none=True)
        for d_t, d_w in zip(mp, w):
            for k, p in d_t.items():
                np.testing.assert_allclose(p.numpy(), d_w[k], rtol=0,
                                           atol=1e-7,
                                           err_msg=f"step {step} {k}")
        for p, k in zip(ref_p, mp.log_init_lr):
            p.grad = torch.from_numpy(np.clip(g.log_init_lr[k], -0.5, 0.5))
        ref.step()
        if step == 6:
            path = tmp_path / "opt.pt"
            torch.save(opt.state_dict(), path)
            opt = make_outer_optimizer(OuterOptimConfig(**cfg), mp)
            opt.load_state_dict(torch.load(path, weights_only=True))
            assert opt.param_groups[0]["count"] == 7
    worst_ref = max(float(np.abs(p.numpy() - want[-1].log_init_lr[k]).max())
                    for p, k in zip(ref_p, mp.log_init_lr))
    assert worst_ref > 1e-7


def test_outer_optimizer_groups():
    """Two named groups; the init group decays, the lr group does not;
    no learned init gives the lr group alone."""
    _, mp = _meta_pair(np.random.RandomState(1))
    opt = make_outer_optimizer(OuterOptimConfig(), mp)
    assert [g["name"] for g in opt.param_groups] == ["model_init",
                                                     "log_init_lr"]
    assert opt.param_groups[0]["weight_decay"] == 1e-3
    assert opt.param_groups[1]["weight_decay"] == 0.0
    opt = make_outer_optimizer(OuterOptimConfig(),
                               MetaParams(None, mp.log_init_lr))
    assert [g["name"] for g in opt.param_groups] == ["log_init_lr"]


# ------------------------------------------------------------ meta step


def _variables_and_lrs():
    jmodel = JDeepLabV3Plus(**MODEL_KW)
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))), 21)
    j_meta = j_init_meta_params(JMetaOptimConfig(use_log_init_lr=False),
                                variables)
    rng = np.random.RandomState(2)
    lrs = dict(j_meta.log_init_lr)
    lrs["params"] = jax.tree_util.tree_map(
        lambda l: rng.uniform(0.01, 0.1, np.shape(l)).astype(np.float32),
        jax.device_get(lrs["params"]))
    return jmodel, variables, JMetaParams(variables, lrs)


def _stack(draws):
    return AugmentDraws(*(None if f[0] is None else torch.stack(f)
                          for f in zip(*draws)))


def jax_draws_for(step_cfg, jcfg):
    """A ``MetaStep.task_draws`` stand-in: the draws the JAX step makes
    from the task's seed (``PRNGKey(seed)`` split per inner step and per
    support copy, or the per-task key ``fold_in(key, 0x7A)``)."""

    def task_draws(seed, num_queries, hw=None):
        key = jax.random.PRNGKey(np.uint32(seed))
        if step_cfg.frame_transform_per_task:
            return TaskDraws(jax_task_draws(jax.random.fold_in(key, 0x7A),
                                            jcfg, 1 + num_queries))
        return TaskDraws(_stack([
            _stack([jax_frame_draws(kb, jcfg) for kb in
                    jax.random.split(k, step_cfg.train_batch_size)])
            for k in jax.random.split(key, step_cfg.num_epochs)]))

    return task_draws


@pytest.mark.parametrize("per_task", [False, True])
def test_meta_step_matches_jax(per_task):
    """Two meta steps of 2 tasks, 2 inner steps truncated after each
    (bptt 1), support batch 2 (per-step mode) or 1 (per-task mode), the
    default augmentation ranges in float32, outer clip 0.5."""
    jmodel, variables, j_meta = _variables_and_lrs()
    aug = dict(compute_dtype="float32")
    step_kw = dict(num_epochs=2, bptt_epochs=1,
                   train_batch_size=1 if per_task else 2,
                   frame_transform_per_task=per_task)
    outer_kw = dict(model_init_lr=1e-3, log_init_lr_lr=1e-3, grad_clip=0.5)
    j_step_cfg = JMetaStepConfig(remat=False, augment=JAugmentConfig(**aug),
                                 **step_kw)
    mesh = make_mesh(num_tasks=1, devices=jax.devices()[:1])
    j_step = j_make_meta_step(jmodel.apply,
                              JMetaOptimConfig(use_log_init_lr=False),
                              j_step_cfg, JOuterOptimConfig(**outer_kw), mesh,
                              meta_batch_size=TASKS)
    j_state = j_step.init(j_meta)
    j_tasks = JMetaTaskset([JSyntheticVOSIndex(**INDEX_KW)],
                           JTasksetCfg(crop_size=(S, S)), seed=0)

    model = DeepLabV3Plus(device="cpu", **MODEL_KW)
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    meta = MetaParams({k: v.clone() for k, v in sd.items()},
                      lr_tree_from_jax(j_meta.log_init_lr))
    step_cfg = MetaStepConfig(augment=AugmentConfig(**aug), **step_kw)
    step = make_meta_step(functional_apply(model),
                          MetaOptimConfig(use_log_init_lr=False), step_cfg,
                          OuterOptimConfig(**outer_kw), TASKS, device="cpu")
    step.task_draws = jax_draws_for(step_cfg, j_step_cfg.augment)
    opt = step.init(meta)
    tasks = MetaTaskset([SyntheticVOSIndex(**INDEX_KW)],
                        MetaTasksetConfig(crop_size=(S, S)), seed=0)

    phases = []
    step.on_phase = phases.append
    for it in range(2):
        batch = tasks.sample_batch(TASKS)
        j_out = j_step(j_meta, j_state, shard_task_batch(mesh,
                                                         j_tasks.sample_batch(TASKS)))
        j_meta, j_state = j_out.meta_params, j_out.opt_state
        out = step(meta, opt, batch)
        np.testing.assert_allclose(out.per_task_loss.numpy(),
                                   np.asarray(j_out.per_task_loss), rtol=1e-5)
        np.testing.assert_allclose(float(out.meta_loss),
                                   float(j_out.meta_loss), rtol=1e-5)
        np.testing.assert_allclose(out.train_losses.numpy(),
                                   np.asarray(j_out.train_losses), rtol=1e-5)
        want_init = state_dict_from_jax(jax.device_get(j_meta.model_init))
        want_lr = lr_tree_from_jax(jax.device_get(j_meta.log_init_lr))
        for want, got in ((want_init, out.meta_params.model_init),
                          (want_lr, out.meta_params.log_init_lr)):
            assert set(got) == set(want)
            for k, w in want.items():
                w = w.numpy()
                np.testing.assert_allclose(
                    got[k].numpy(), w, rtol=0,
                    atol=1e-4 * max(np.abs(w).max(), 1e-6),
                    err_msg=f"step {it} {k}")
    per = ["prepare"] + ["inner", "query"] * 2
    assert phases == (per * TASKS + ["outer"]) * 2
    moved = [k for k in meta.model_init
             if not torch.equal(meta.model_init[k], sd[k])]
    assert set(moved) == set(sd)  # constants included


def test_meta_step_rejects_foreign_opt_state():
    model = DeepLabV3Plus(device="cpu", **MODEL_KW)
    cfg = MetaOptimConfig(use_log_init_lr=False)
    step = make_meta_step(functional_apply(model), cfg, MetaStepConfig(),
                          OuterOptimConfig(), TASKS, device="cpu")
    opt = step.init(init_meta_params(cfg, model))
    tasks = MetaTaskset([SyntheticVOSIndex(**INDEX_KW)],
                        MetaTasksetConfig(crop_size=(S, S)))
    with pytest.raises(ValueError, match="opt_state"):
        step(init_meta_params(cfg, model), opt, tasks.sample_batch(TASKS))


# ------------------------------------------------------------ the trainer


def _trainer(tmp_path, **train_kw):
    model = DeepLabV3Plus(device="cpu", seed=4, **MODEL_KW)
    tasks = MetaTaskset([SyntheticVOSIndex(**INDEX_KW)],
                        MetaTasksetConfig(crop_size=(S, S)), seed=0)
    evals = []

    def eval_fn(mp, it):
        evals.append(it)
        return {"J_mean": float(it % 3)}

    return MetaTrainer(
        functional_apply(model), model, tasks,
        meta_cfg=MetaOptimConfig(use_log_init_lr=False),
        step_cfg=MetaStepConfig(num_epochs=2, bptt_epochs=2,
                                train_batch_size=1,
                                frame_transform_per_task=True,
                                augment=AugmentConfig(
                                    compute_dtype="float32")),
        outer_cfg=OuterOptimConfig(model_init_lr=1e-3, log_init_lr_lr=1e-3),
        train_cfg=MetaTrainConfig(meta_batch_size=TASKS, seed=3,
                                  save_dir=str(tmp_path), **train_kw),
        logger=MetricsLogger(path=str(tmp_path / "metrics.jsonl"),
                             echo=False),
        eval_fn=eval_fn, device="cpu"), evals


def test_meta_trainer_run_and_checkpoint_round_trip(tmp_path):
    """3 iterations, logged every 2 (and the first), evaluated every 2,
    profiled over [1, 2); then a fresh trainer restored from the last
    checkpoint continues exactly as the first one does."""
    tr, evals = _trainer(tmp_path, vis_interval=2, eval_interval=2,
                         profile_iters=(1, 2),
                         profile_dir=str(tmp_path / "prof"))
    out = tr.run(3)
    assert tr.meta_iter == 3 and evals == [2]
    assert np.isfinite(out["meta_loss"]) and len(out["per_task_loss"]) == TASKS
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["event"], r["step"]) for r in recs] == [
        ("meta_train", 1), ("meta_train", 2), ("eval", 2)]
    assert set(recs[1]["lr_per_tensor"]) == set(tr.meta_params.log_init_lr)
    assert recs[1]["lr_mean"] > 0 and recs[1]["lr_std"] >= 0
    assert (tmp_path / "last_meta_iter.ckpt").exists()
    assert (tmp_path / "best_meta_iter.ckpt").exists()
    assert list((tmp_path / "prof").glob("meta_iters_1_2.json"))

    # the checkpoint is of iteration 2: restore and replay iteration 3
    other, _ = _trainer(tmp_path / "b", vis_interval=100)
    other.restore(str(tmp_path / "last_meta_iter.ckpt"))
    # saved before iteration 2's evaluation, as the JAX trainer saves
    assert other.meta_iter == 2 and other.best_eval == -float("inf")
    again = other.run(1)
    np.testing.assert_allclose(again["meta_loss"], out["meta_loss"],
                               rtol=1e-6)
    for d0, d1 in zip(tr.meta_params, other.meta_params):
        for k in d0:
            torch.testing.assert_close(d1[k], d0[k], rtol=1e-6, atol=1e-9)
    bad, _ = _trainer(tmp_path / "c")
    bad.meta_params.log_init_lr.pop("classifier.bias")
    with pytest.raises(ValueError, match="does not match"):
        bad.restore(str(tmp_path / "last_meta_iter.ckpt"))


# ------------------------------------------------------------ launch counts


@pytest.mark.parametrize("per_task", [False, True])
def test_meta_step_gn_calls_match_the_smoke_formula(monkeypatch, per_task):
    """A tiny meta step on the CPU calls each GroupNorm kernel wrapper as
    often as ``chip_smoke.expected_meta_launches`` counts for the card:
    every kernel norm once per forward and backward, tasks × (inner steps +
    segments) of each."""
    import chip_smoke
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    calls = dict.fromkeys(K.LAUNCHES_PER_CALL, 0)
    for name in calls:
        def counting(*args, _name=name, _fn=getattr(K, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(K, name, counting)
    model = DeepLabV3Plus(device="cpu", **MODEL_KW)
    n_gn = sum(isinstance(m, FusedGroupNorm) and m.use_kernel
               for m in model.modules())
    cfg = MetaOptimConfig(use_log_init_lr=False)
    step_cfg = MetaStepConfig(num_epochs=4, bptt_epochs=2,
                              train_batch_size=1 if per_task else 2,
                              frame_transform_per_task=per_task)
    step = make_meta_step(functional_apply(model), cfg, step_cfg,
                          OuterOptimConfig(), TASKS, device="cpu")
    meta = init_meta_params(cfg, model)
    tasks = MetaTaskset([SyntheticVOSIndex(**INDEX_KW)],
                        MetaTasksetConfig(crop_size=(S, S)))
    step(meta, step.init(meta), tasks.sample_batch(TASKS))
    want = chip_smoke.expected_meta_launches(step_cfg, TASKS, n_gn,
                                             dict.fromkeys(calls, 1))
    assert calls == want
    assert calls["group_stats"] == TASKS * (4 + 2) * n_gn > 0


# ------------------------------------------------ the card-vs-CPU check


@pytest.mark.parametrize("planted", ["no update", "half update"])
def test_smoke_step_change_limit_rejects_a_wrong_outer_update(monkeypatch,
                                                              planted):
    """``chip_smoke.step_change_excess`` holds the card's small meta step
    to the CPU's by the outer step's change (1e-3 of each tensor's largest
    change plus two float32 ulps). Two CPU runs of that step pass it; a run
    whose outer update is planted as no update, or as half of it, fails
    it."""
    import chip_smoke
    from e_osvos_torch.parallel import meta_step as ms

    _, _, want_start, want_out = chip_smoke.small_meta_step("cpu")
    want_new = [t for d in want_out.meta_params for t in d.values()]
    _, _, start, out = chip_smoke.small_meta_step("cpu")
    worst, over, n = chip_smoke.step_change_excess(
        start, [t for d in out.meta_params for t in d.values()],
        want_start, want_new)
    assert over == 0 and worst <= 1.0, (worst, over)

    radam_step = ms.OuterRAdam.step

    @torch.no_grad()
    def planted_step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.clone() for p in params]
        if planted == "half update":
            radam_step(self)
        for p, b in zip(params, before):
            p.copy_((p + b) / 2)

    monkeypatch.setattr(ms.OuterRAdam, "step", planted_step)
    _, _, start, out = chip_smoke.small_meta_step("cpu")
    worst, over, n = chip_smoke.step_change_excess(
        start, [t for d in out.meta_params for t in d.values()],
        want_start, want_new)
    assert over > n // 2, (worst, over, n)
