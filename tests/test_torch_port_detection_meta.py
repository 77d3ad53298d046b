"""Detection meta-training of the port (Mask R-CNN) against the JAX package
on the CPU:

  * the training forward with several instances a frame (``gt_masks [B, O,
    H, W]``, O = 2) and with a box-coordinate permutation: the five losses
    rtol 1e-4, every parameter gradient within 1e-3 of its tensor's
    largest magnitude;
  * one ``MetaStep`` of 2 tasks with ``detection_task_fns`` against the
    JAX ``MetaStep`` with its ``detection_task_fns`` on a one-device mesh,
    the JAX keys' draws handed to the port (``MetaStep.task_draws``): with
    and without ``random_box_coord_perm``, both augmentation modes, first
    order and second order (the default ``roi_heads`` restriction, and the
    box and mask heads). The outer RAdam's first step is a plain step of
    its lr (ρ_1 < 5), so at lr 1 and no weight decay each meta-parameter's
    change is its meta-gradient: losses rtol 1e-4; each entry's change
    within 1e-3 of its tensor's largest change. The Lovász hinge's gradient
    depends on the order of its sorted errors (both sorts are stable): two
    errors within rounding of each other change places between the two
    implementations, or between thread counts, and move mask-head
    gradients by up to 0.8% of their tensor's largest entry (the per-task
    mode at two threads: 2174 of the mask head's 2.3M entries). Those
    entries are counted, not covered by a wider tolerance: none outside
    the mask head, at most 1% of the mask head's, each within 10 times its
    limit.

Tiny Mask R-CNN of ``test_torch_port_detection_models.py`` (resnet10,
GroupNorm-4, 64x64, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.meta_optim.tasksets import MetaTaskset as JMetaTaskset
from e_osvos_tpu.meta_optim.tasksets import MetaTasksetConfig as JTasksetCfg
from e_osvos_tpu.parallel import MetaStepConfig as JMetaStepConfig
from e_osvos_tpu.parallel import OuterOptimConfig as JOuterOptimConfig
from e_osvos_tpu.parallel import make_mesh, make_meta_step as j_make_meta_step
from e_osvos_tpu.parallel import shard_task_batch
from e_osvos_tpu.parallel.meta_step import (
    detection_task_fns as j_detection_task_fns,
)
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    MetaTaskset,
    MetaTasksetConfig,
)
from e_osvos_torch.models import functional_apply
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.parallel import (
    MetaStepConfig,
    OuterOptimConfig,
    TaskDraws,
    detection_task_fns,
    make_meta_step,
)
from test_torch_port_augment import jax_frame_draws, jax_task_draws
from test_torch_port_detection_models import (
    SIZE,
    jax_train_draws,
    tiny_pair,
)

TASKS = 2
INDEX_KW = dict(num_sequences=2, num_frames=3, size=(SIZE, SIZE), seed=9)
# The task sampler's seed. On seed 0's tasks the JAX step alone moves the
# second task's query loss by 2% (5.2454 → 5.1395) when its weights are
# scaled by 1 + 1e-6 (a proposal changes sides), so no comparison holds
# there; on seed 1's the same scaling moves the losses by at most 2.2e-5
# relative (per-step mode, first order; scripts/parity_spread.py
# detection-meta).
TASK_SEED = 1
AUG = dict(compute_dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the tier-1 command runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def two_objects(seed, batch=2):
    """Images with two bright rectangles each and their ``[B, 2, H, W]``
    {0, 1, 255} masks (a 255 ring around each object, in its own slot)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(batch, SIZE, SIZE, 3).astype(np.float32) * 20
    masks = np.zeros((batch, 2, SIZE, SIZE), np.float32)
    for i in range(batch):
        for o, (y, x) in enumerate(((6, 6), (34, 30))):
            y, x = y + rng.randint(0, 6), x + rng.randint(0, 6)
            h, w = rng.randint(12, 22, 2)
            imgs[i, y:y + h, x:x + w] += 50 + 30 * o
            masks[i, o, y - 1:y + h + 1, x - 1:x + w + 1] = 255
            masks[i, o, y:y + h, x:x + w] = 1
    return imgs, masks


@pytest.mark.parametrize("perm", [None, (2, 0, 3, 1)], ids=["eye", "perm"])
def test_multi_instance_train_forward_matches_jax(tiny, perm):
    """Two instances a frame, the second of image 1 absent (``gt_valid``
    False), with and without a box-coordinate permutation."""
    jmodel, variables, model = tiny
    imgs, masks = two_objects(1)
    gt_valid = np.array([[True, True], [True, False]])
    key = jax.random.PRNGKey(3)
    j_perm = None if perm is None else jnp.asarray(perm, jnp.int32)

    def jloss(params):
        return jmodel.apply(
            {"params": params}, jnp.asarray(imgs), jnp.asarray(masks),
            jnp.asarray(gt_valid), train=True, box_coord_perm=j_perm,
            rngs={"sample": key})

    (j_total, j_parts), j_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    draws = jax_train_draws(jmodel, variables, key, 2, num_objects=2)
    total, parts = model(
        torch.from_numpy(imgs), torch.from_numpy(masks),
        torch.from_numpy(gt_valid), train=True, draws=draws,
        box_coord_perm=None if perm is None else torch.tensor(perm))
    for name, v in j_parts.items():
        np.testing.assert_allclose(parts[name].item(), float(v), rtol=1e-4,
                                   err_msg=name)
        assert float(v) > 0, name
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in model.named_parameters()])
    want = state_dict_from_jax({"params": jax.device_get(j_grads)})
    for name, g in zip(names, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-8),
                                   err_msg=name)


def test_box_coord_perm_changes_the_box_loss():
    """The permutation reaches the box-regression loss and nothing else.
    (A low foreground threshold makes proposals positives: the GT boxes
    appended to the proposals have all-zero targets, which no permutation
    changes.)"""
    jmodel, variables, model = tiny_pair(fg_iou_thresh=0.05,
                                         bg_iou_thresh=0.05)
    imgs, masks = two_objects(2)
    gt_valid = np.ones((2, 2), bool)
    draws = jax_train_draws(jmodel, variables, jax.random.PRNGKey(5), 2,
                            num_objects=2)
    args = (torch.from_numpy(imgs), torch.from_numpy(masks),
            torch.from_numpy(gt_valid))
    with torch.no_grad():
        _, eye = model(*args, train=True, draws=draws)
        _, swapped = model(*args, train=True, draws=draws,
                           box_coord_perm=torch.tensor([1, 0, 3, 2]))
    assert float(swapped["loss_box_reg"]) != float(eye["loss_box_reg"])
    for name in eye:
        if name != "loss_box_reg":
            assert float(swapped[name]) == float(eye[name]), name


def jax_detection_draws(jmodel, variables, step_cfg, jcfg):
    """A ``MetaStep.task_draws`` stand-in: the draws the JAX detection step
    makes from the task's seed: ``split(PRNGKey(seed), E)`` per inner step
    (per-step mode: each split again into the augmentation and sampling
    keys), ``fold_in(key, 0x7A)`` for the per-task augmentation,
    ``fold_in(key, 0x71)`` for the query pass and ``fold_in(key, 0x42)``
    for the permutation."""

    def task_draws(seed, num_queries, hw):
        key = jax.random.PRNGKey(np.uint32(seed))
        keys = jax.random.split(key, step_cfg.num_epochs)
        perm = None
        if step_cfg.random_box_coord_perm:
            perm = torch.from_numpy(np.asarray(jax.random.permutation(
                jax.random.fold_in(key, 0x42), 4)).astype(np.int64))
        query = jax_train_draws(jmodel, variables,
                                jax.random.fold_in(key, 0x71), num_queries)
        if step_cfg.frame_transform_per_task:
            aug = jax_task_draws(jax.random.fold_in(key, 0x7A), jcfg,
                                 1 + num_queries)
            train = [jax_train_draws(jmodel, variables, k, 1) for k in keys]
        else:
            b = step_cfg.train_batch_size
            aug, train = [], []
            for k in keys:
                k_aug, k_s = jax.random.split(k)
                aug.append(_stack([jax_frame_draws(kb, jcfg)
                                   for kb in jax.random.split(k_aug, b)]))
                train.append(jax_train_draws(jmodel, variables, k_s, b))
            aug = _stack(aug)
        return TaskDraws(aug, _stack(train), query, perm)

    return task_draws


def _stack(draws):
    return type(draws[0])(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*draws)))


CASES = {
    "per_step": dict(per_task=False, perm=False, order=1),
    "per_task_perm": dict(per_task=True, perm=True, order=1),
    "second_order_roi_heads": dict(per_task=False, perm=True, order=2,
                                   subtrees=("roi_heads",)),
    "second_order_heads": dict(per_task=True, perm=False, order=2,
                               subtrees=("box_head", "mask_head")),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_detection_meta_step_matches_jax(tiny, case):
    """One meta step of 2 tasks, 2 inner steps in one truncation segment,
    support batch 2 (per-step mode) or 1 (per-task mode), the default
    augmentation ranges in float32."""
    c = CASES[case]
    jmodel, variables, model = tiny
    rng = np.random.RandomState(4)
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables["params"], "neuron")))
    step_kw = dict(num_epochs=2, bptt_epochs=2,
                   train_batch_size=1 if c["per_task"] else 2,
                   frame_transform_per_task=c["per_task"],
                   random_box_coord_perm=c["perm"])
    meta_kw = dict(use_log_init_lr=False,
                   second_order_gradients=c["order"] == 2,
                   second_order_subtrees=c.get("subtrees", ()))
    outer_kw = dict(model_init_lr=1.0, log_init_lr_lr=1.0,
                    model_init_weight_decay=0.0)

    j_step_cfg = JMetaStepConfig(remat=False, augment=JAugmentConfig(**AUG),
                                 **step_kw)
    mesh = make_mesh(num_tasks=1, devices=jax.devices()[:1])
    j_step = j_make_meta_step(
        jmodel.apply, JMetaOptimConfig(**meta_kw), j_step_cfg,
        JOuterOptimConfig(**outer_kw), mesh, meta_batch_size=TASKS,
        task_fns=j_detection_task_fns(jmodel, j_step_cfg))
    j_meta = JMetaParams(model_init=variables, log_init_lr={"params": lrs})
    j_tasks = JMetaTaskset([JSyntheticVOSIndex(**INDEX_KW)],
                           JTasksetCfg(crop_size=(SIZE, SIZE)),
                           seed=TASK_SEED)
    j_out = j_step(j_meta, j_step.init(j_meta),
                   shard_task_batch(mesh, j_tasks.sample_batch(TASKS)))

    sd = state_dict_from_jax(variables)
    meta = MetaParams({k: v.clone() for k, v in sd.items()},
                      lr_tree_from_jax(lrs))
    start = MetaParams(*({k: v.clone() for k, v in d.items()} for d in meta))
    step_cfg = MetaStepConfig(augment=AugmentConfig(**AUG), **step_kw)
    apply = functional_apply(model)
    step = make_meta_step(apply, MetaOptimConfig(**meta_kw), step_cfg,
                          OuterOptimConfig(**outer_kw), TASKS, device="cpu",
                          task_fns=detection_task_fns(model, step_cfg))
    step.task_draws = jax_detection_draws(jmodel, variables, step_cfg,
                                          j_step_cfg.augment)
    tasks = MetaTaskset([SyntheticVOSIndex(**INDEX_KW)],
                        MetaTasksetConfig(crop_size=(SIZE, SIZE)),
                        seed=TASK_SEED)
    out = step(meta, step.init(meta), tasks.sample_batch(TASKS))

    np.testing.assert_allclose(out.per_task_loss.numpy(),
                               np.asarray(j_out.per_task_loss), rtol=1e-4)
    np.testing.assert_allclose(out.train_losses.numpy(),
                               np.asarray(j_out.train_losses), rtol=1e-4)
    want_init = state_dict_from_jax(jax.device_get(j_out.meta_params.model_init))
    want_lr = lr_tree_from_jax(jax.device_get(j_out.meta_params.log_init_lr))
    moved = 0
    over = {"mask_head": 0, "rest": 0}
    total = {"mask_head": 0, "rest": 0}
    worst = 0.0
    for field, want in (("model_init", want_init), ("log_init_lr", want_lr)):
        got, s0 = getattr(out.meta_params, field), getattr(start, field)
        assert set(got) == set(want)
        for k, w in want.items():
            d_want = w.numpy().astype(np.float64) - s0[k].numpy()
            d_got = got[k].numpy().astype(np.float64) - s0[k].numpy()
            limit = 1e-3 * max(np.abs(d_want).max(), 1e-12)
            ratio = np.abs(d_got - d_want) / limit
            part = "mask_head" if k.startswith("mask_head.") else "rest"
            over[part] += int((ratio > 1).sum())
            total[part] += ratio.size
            worst = max(worst, float(ratio.max()))
            moved += bool(np.abs(d_want).max() > 0)
    assert over["rest"] == 0, (over, total)
    assert over["mask_head"] <= 1e-2 * total["mask_head"], (over, total)
    assert worst <= 10, worst
    assert moved > len(want_init)  # the init and the lrs took steps
