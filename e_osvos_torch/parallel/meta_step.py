"""One meta-training step on one GPU, port of
``e_osvos_tpu/parallel/meta_step.py``.

The JAX step is one SPMD program: tasks sharded over a mesh, each shard's
tasks in a ``lax.scan``, gradients reduced by ``psum``, the outer optax
update fused in. Here the tasks run in turn on the one device: each task's
meta-gradients (``meta_optim.meta_grads``) are summed, divided by the meta
batch size, and the outer step (elementwise clip → coupled weight decay →
RAdam, per group) and the lr clamp update the meta-parameters in place. The
task axis over several GPUs with ``torch.distributed`` is later work.

Two task families, as in the JAX step's ``task_fns``: the dense one
(DeepLab, the default) and the detection one (Mask R-CNN,
``detection_task_fns``), whose losses are the detector's summed training
losses over a mask target synthesised in the forward.

Each task's random draws come from device generators seeded from the task's
seed with ``fold_in``, following the JAX step's keys: inner step e's
support augmentations (and, for detection, its anchor and RoI sampling
uniforms) from ``fold_in(seed, e)``, the per-task augmentation of
``frame_transform_per_task`` from ``fold_in(seed, 0x7A)``, the detection
query pass's sampling uniforms from ``fold_in(seed, 0x71)`` and its
box-coordinate permutation from ``fold_in(seed, 0x42)``.
``MetaStep.task_draws`` is the one function that draws, so a caller can
hand in other draws.

The outer RAdam is optax's formula (``optax.radam``: ``r·m̂ / (sqrt(v̂) +
eps)``, rectified once ``ρ_t >= 5``), written with ``torch._foreach_*`` ops:
``torch.optim.RAdam`` adds eps before the bias correction and rectifies at
``ρ_t > 5``, and drifts from optax by about 1e-3 of an update from step 6.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from e_osvos_torch.data import transforms
from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    clamp_meta_params,
    meta_grads,
)
from e_osvos_torch.models.deeplab import functional_apply
from e_osvos_torch.models.mask_rcnn import TrainDraws
from e_osvos_torch.ops import losses as loss_ops
from e_osvos_torch.utils.device import resolve_device, upload
from e_osvos_torch.utils.seeds import fold_in

TASK_KEY = 0x7A  # per-task augmentation (frame_transform_per_task)
QUERY_KEY = 0x71  # the detection query pass's sampling draws
PERM_KEY = 0x42  # the detection box-coordinate permutation

# optax.radam's defaults
RADAM_B1 = 0.9
RADAM_B2 = 0.999
RADAM_EPS = 1e-8
RADAM_THRESHOLD = 5.0


@dataclasses.dataclass(frozen=True)
class OuterOptimConfig:
    """Outer (meta) optimizer: RAdam lrs of the two groups, weight decay of
    the learned init, elementwise gradient clip (None = off). ``lr`` is the
    configs' lr of further meta-parameters, of which there are none yet."""

    model_init_lr: float = 1e-5
    log_init_lr_lr: float = 1e-5
    lr: float = 1e-3
    model_init_weight_decay: float = 1e-3
    grad_clip: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MetaStepConfig:
    """Inner-loop shape of one meta step: ``num_epochs`` inner steps on
    ``train_batch_size`` support copies, truncated every ``bptt_epochs``.

    ``frame_transform_per_task`` (the reference's
    ``random_frame_transform_per_task``): one augmentation per task, the
    support warped once and reused every inner step as a batch of one,
    queries augmented with the task's flip and colour draws. False: fresh
    augmentations per copy and inner step, un-augmented queries.

    ``remat`` checkpoints the inner steps of second-order meta-gradients;
    first order keeps no activations across steps and ignores it.

    ``random_box_coord_perm`` (detection family): one random permutation
    of the box-regression targets' coordinates per task, shared by its
    inner steps and query pass."""

    num_epochs: int = 5
    bptt_epochs: int = 5
    train_batch_size: int = 3
    loss_func: str = "dice"
    normalize_mode: str = "davis"
    frame_transform_per_task: bool = False
    remat: bool = True
    augment: transforms.AugmentConfig = dataclasses.field(
        default_factory=transforms.AugmentConfig)
    random_box_coord_perm: bool = False


class OuterRAdam(torch.optim.Optimizer):
    """optax's ``chain(clip(grad_clip), add_decayed_weights(weight_decay),
    radam(lr))`` for each param group, over tensors whose ``.grad`` holds
    the meta-gradient. A group's step count lives in the group, so
    ``state_dict`` carries it."""

    def __init__(self, groups: List[dict]):
        super().__init__(groups, dict(lr=1e-3, weight_decay=0.0, clip=None,
                                      count=0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OuterRAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["clip"] is not None:
                grads = torch._foreach_clamp_min(grads, -group["clip"])
                torch._foreach_clamp_max_(grads, group["clip"])
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"mu": torch.zeros_like(p),
                                     "nu": torch.zeros_like(p)}
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            b1, b2 = RADAM_B1, RADAM_B2
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            group["count"] += 1
            t = group["count"]
            mu_hat = torch._foreach_div(mu, 1 - b1 ** t)
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            ro = ro_inf - 2 * t * b2 ** t / (1 - b2 ** t)
            if ro >= RADAM_THRESHOLD:
                r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                              / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** t))
                torch._foreach_add_(denom, RADAM_EPS)
                updates = torch._foreach_mul(mu_hat, r)
                torch._foreach_div_(updates, denom)
            else:
                updates = mu_hat
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)
        return None


def make_outer_optimizer(cfg: OuterOptimConfig, meta_params: MetaParams
                         ) -> OuterRAdam:
    """The per-group outer optimizer: ``model_init`` (the learned init,
    frozen-BN buffers included) with weight decay, ``log_init_lr`` without;
    both clipped elementwise when ``cfg.grad_clip`` is set."""
    groups = []
    if meta_params.model_init is not None:
        groups.append({"name": "model_init",
                       "params": list(meta_params.model_init.values()),
                       "lr": cfg.model_init_lr,
                       "weight_decay": cfg.model_init_weight_decay,
                       "clip": cfg.grad_clip})
    groups.append({"name": "log_init_lr",
                   "params": list(meta_params.log_init_lr.values()),
                   "lr": cfg.log_init_lr_lr, "weight_decay": 0.0,
                   "clip": cfg.grad_clip})
    return OuterRAdam(groups)


def _stack(draws):
    """Per-step draws (NamedTuples of tensors or None) stacked on a new
    leading axis."""
    return type(draws[0])(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*draws)))


class MetaStepOut(NamedTuple):
    meta_params: MetaParams
    opt_state: OuterRAdam
    meta_loss: torch.Tensor  # scalar mean over the meta batch
    per_task_loss: torch.Tensor  # [B]
    train_losses: torch.Tensor  # [B, num_epochs] inner train losses


class TaskFns(NamedTuple):
    """A task family's losses. ``train_loss_fn(params, (img, label, aug,
    sample, perm))`` augments one support frame on the device with the
    draws ``aug`` ([B] fields); ``query_loss_fn(params, (imgs, labels,
    sample, perm))`` takes its frames as they are. ``sample`` and ``perm``
    are the detection family's sampling uniforms (``TrainDraws``) and
    box-coordinate permutation (None for the dense family).
    ``sample_shapes(hw, batch)``, for the detection family, gives the
    shapes of one forward's sampling uniforms."""

    train_loss_fn: Callable
    query_loss_fn: Callable
    sample_shapes: Optional[Callable] = None


class TaskDraws(NamedTuple):
    """Every random draw of one task: ``aug`` per inner step ([E, B]
    fields) or, with ``frame_transform_per_task``, per frame ([1 + Q],
    support first); for the detection family ``train`` (``TrainDraws``
    [E, B or 1, ...]), ``query`` (``TrainDraws`` [Q, ...]) and ``perm``
    ([4] long, None without ``random_box_coord_perm``)."""

    aug: transforms.AugmentDraws
    train: Optional[TrainDraws] = None
    query: Optional[TrainDraws] = None
    perm: Optional[torch.Tensor] = None

    def to(self, device) -> "TaskDraws":
        return TaskDraws(*(None if t is None else t.to(device)
                           for t in self))


def _task_fns(model_apply: Callable, cfg: MetaStepConfig) -> TaskFns:
    """The dense family's losses."""

    def loss_on(params, imgs, labels):
        imgs = transforms.normalize(imgs, cfg.normalize_mode)
        valid = labels != 255
        gts = torch.where(valid, labels, 0).float()
        logits = model_apply(params, imgs)[..., 0]
        return loss_ops.compute_loss(cfg.loss_func, logits, gts, valid)

    def train_loss_fn(params, batch):
        img, label, draws = batch[:3]
        imgs, labels = transforms.augment_support_batch(img, label, draws,
                                                        cfg.augment)
        return loss_on(params, imgs, labels)

    def query_loss_fn(params, batch):
        return loss_on(params, *batch[:2])

    return TaskFns(train_loss_fn, query_loss_fn)


def detection_task_fns(model, cfg: MetaStepConfig) -> TaskFns:
    """The detection family's losses of a ``MaskRCNN`` (the reference's
    default architecture): the detector's summed training losses on the
    normalized images, one object a frame, the 255 label carried into the
    mask target and ``gt_valid`` where the object has a pixel."""
    model_apply = functional_apply(model)

    def detection_loss(params, imgs, labels, sample, perm):
        imgs = transforms.normalize(imgs, cfg.normalize_mode)
        gt_masks = torch.where(labels == 255, 255.0, labels.float())[:, None]
        gt_valid = (gt_masks == 1).any(dim=(2, 3))
        total, _ = model_apply(params, imgs, gt_masks, gt_valid, train=True,
                               draws=sample, box_coord_perm=perm)
        return total

    def train_loss_fn(params, batch):
        img, label, aug, sample, perm = batch
        imgs, labels = transforms.augment_support_batch(img, label, aug,
                                                        cfg.augment)
        return detection_loss(params, imgs, labels, sample, perm)

    def query_loss_fn(params, batch):
        imgs, labels, sample, perm = batch
        return detection_loss(params, imgs.float(), labels, sample, perm)

    def sample_shapes(hw, batch):
        return model.draw_shapes(hw, batch, num_objects=1)

    return TaskFns(train_loss_fn, query_loss_fn, sample_shapes)


class MetaStep:
    """One meta step: ``init(meta_params)`` gives the outer optimizer (the
    counterpart of the JAX step's opt state); calling the step with
    ``(meta_params, opt_state, task_batch)`` runs the batch's tasks in turn
    and updates the meta-parameters in place.

    ``on_phase``, when set, is called with the name of each phase as it
    ends: per task ``prepare`` (upload, draws, per-task augmentation), then
    per segment ``inner`` and ``query`` (``meta_grads``); ``outer`` after
    the outer update and the clamp.

    ``task_fns`` picks the task family: the dense one by default,
    ``detection_task_fns(...)`` for Mask R-CNN."""

    def __init__(self, model_apply: Callable, meta_cfg: MetaOptimConfig,
                 step_cfg: MetaStepConfig, outer_cfg: OuterOptimConfig,
                 meta_batch_size: int, device=None,
                 task_fns: Optional[TaskFns] = None):
        if step_cfg.random_box_coord_perm and (
                task_fns is None or task_fns.sample_shapes is None):
            raise ValueError("random_box_coord_perm belongs to the detection "
                             "task family (detection_task_fns)")
        self.meta_cfg = meta_cfg
        self.step_cfg = step_cfg
        self.outer_cfg = outer_cfg
        self.meta_batch_size = meta_batch_size
        self.device = resolve_device(device)
        self.task_fns = task_fns or _task_fns(model_apply, step_cfg)
        self.on_phase: Optional[Callable[[str], None]] = None

    def init(self, meta_params: MetaParams) -> OuterRAdam:
        return make_outer_optimizer(self.outer_cfg, meta_params)

    def _mark(self, phase: str) -> None:
        if self.on_phase is not None:
            self.on_phase(phase)

    def task_draws(self, seed: int, num_queries: int,
                   hw: Tuple[int, int]) -> TaskDraws:
        """Every random draw of one task of ``hw`` frames, on the device:
        per inner step e the ``train_batch_size`` support augmentations
        (fields ``[E, B]``), or with ``frame_transform_per_task`` the
        task's frame draws (fields ``[1 + num_queries]``, support first);
        for the detection family also the sampling uniforms of each inner
        step (its batch: ``train_batch_size``, or 1 with
        ``frame_transform_per_task``) and of the query pass, and the
        box-coordinate permutation."""
        cfg = self.step_cfg
        dev = self.device

        def gen(i):
            return torch.Generator(device=dev).manual_seed(fold_in(seed, i))

        def sample(g, batch):
            return TrainDraws(*(torch.rand(s, generator=g, device=dev)
                                for s in self.task_fns.sample_shapes(
                                    hw, batch)))

        detection = self.task_fns.sample_shapes is not None
        steps = [gen(e) for e in range(cfg.num_epochs)]
        if cfg.frame_transform_per_task:
            aug = transforms.sample_task_draws(gen(TASK_KEY), cfg.augment,
                                               1 + num_queries)
        else:
            aug = _stack([transforms.sample_augment_draws(
                g, cfg.augment, cfg.train_batch_size) for g in steps])
        if not detection:
            return TaskDraws(aug)
        batch = 1 if cfg.frame_transform_per_task else cfg.train_batch_size
        perm = (torch.randperm(4, generator=gen(PERM_KEY), device=dev)
                if cfg.random_box_coord_perm else None)
        return TaskDraws(aug, _stack([sample(g, batch) for g in steps]),
                         sample(gen(QUERY_KEY), num_queries), perm)

    def task_grads(self, meta_params: MetaParams, s_img, s_label, q_imgs,
                   q_labels, seed: int):
        """``(loss, grads, train losses)`` of one task on the device."""
        cfg = self.step_cfg
        fns = self.task_fns
        draws = self.task_draws(seed, q_imgs.shape[0],
                                tuple(s_img.shape[:2]))

        def step_sample(e):
            return None if draws.train is None else draws.train.select(e)

        if cfg.frame_transform_per_task:
            a_img, a_label, aq_imgs, aq_labels = (
                transforms.augment_task_frames(s_img, s_label, q_imgs,
                                               q_labels, draws.aug,
                                               cfg.augment))
            train_batches = [(a_img[None], a_label[None], step_sample(e),
                              draws.perm) for e in range(cfg.num_epochs)]
            inner_fn = fns.query_loss_fn
            query_batch = (aq_imgs, aq_labels, draws.query, draws.perm)
        else:
            train_batches = [(s_img, s_label, draws.aug.select(e),
                              step_sample(e), draws.perm)
                             for e in range(cfg.num_epochs)]
            inner_fn = fns.train_loss_fn
            query_batch = (q_imgs, q_labels, draws.query, draws.perm)
        self._mark("prepare")
        return meta_grads(self.meta_cfg, inner_fn, fns.query_loss_fn,
                          meta_params, train_batches, query_batch,
                          bptt_epochs=cfg.bptt_epochs, remat=cfg.remat,
                          on_phase=self.on_phase)

    def __call__(self, meta_params: MetaParams, opt_state: OuterRAdam,
                 task_batch) -> MetaStepOut:
        tensors = [t for d in meta_params if d is not None for t in d.values()]
        held = [p for g in opt_state.param_groups for p in g["params"]]
        if len(held) != len(tensors) or any(
                a is not b for a, b in zip(held, tensors)):
            raise ValueError("opt_state was not made by init() from these "
                             "meta_params")
        b = task_batch.seeds.shape[0]
        if b != self.meta_batch_size:
            raise ValueError(f"task batch of {b}, meta_batch_size "
                             f"{self.meta_batch_size}")
        dev = self.device
        s_imgs = upload(task_batch.support_img.astype(np.float32), dev)
        s_labels = upload(task_batch.support_label.astype(np.int32), dev)
        q_imgs = upload(task_batch.query_imgs.astype(np.float32), dev)
        q_labels = upload(task_batch.query_labels.astype(np.int32), dev)
        loss_sum, grad_sum, per_task, train = None, None, [], []
        for i in range(b):
            loss, grads, tr = self.task_grads(
                meta_params, s_imgs[i], s_labels[i], q_imgs[i], q_labels[i],
                int(task_batch.seeds[i]))
            flat = [g for d in grads if d is not None for g in d.values()]
            if grad_sum is None:
                loss_sum, grad_sum = loss, flat
            else:
                loss_sum = loss_sum + loss
                torch._foreach_add_(grad_sum, flat)
            per_task.append(loss)
            train.append(tr)
        torch._foreach_mul_(grad_sum, 1.0 / b)
        for p, g in zip(tensors, grad_sum):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        clamp_meta_params(self.meta_cfg, meta_params)
        self._mark("outer")
        return MetaStepOut(meta_params=meta_params, opt_state=opt_state,
                           meta_loss=loss_sum * (1.0 / b),
                           per_task_loss=torch.stack(per_task),
                           train_losses=torch.stack(train))


def make_meta_step(model_apply: Callable, meta_cfg: MetaOptimConfig,
                   step_cfg: MetaStepConfig, outer_cfg: OuterOptimConfig,
                   meta_batch_size: int, device=None,
                   task_fns: Optional[TaskFns] = None) -> MetaStep:
    """The meta step on ``device`` (``cuda`` unless asked otherwise)."""
    return MetaStep(model_apply, meta_cfg, step_cfg, outer_cfg,
                    meta_batch_size, device=device, task_fns=task_fns)
