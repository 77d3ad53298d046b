"""Parent (pre-)training: supervised training of the segmentation network
before meta-training, port of ``e_osvos_tpu/engine/parent_trainer.py``.

Two tasks: ``dense`` trains the DeepLab family on binary foreground /
background segmentation of all annotated objects; ``detection`` trains
Mask R-CNN on instance masks (the counterpart of the COCO pre-training the
reference takes from torchvision), instance slots beyond ``max_objects``
ignored. A step samples a frame batch on the host (``FrameSampler``,
``InstanceFrameSampler``: numpy, bit-equal to the JAX package's from one
seed), augments each frame on the device with draws from its own seed,
and takes one optimizer step: Adam or SGD with momentum, with optax's
coupled weight decay (``add_decayed_weights`` before the optimizer) when
``weight_decay`` is set.

As in the JAX package, the optimizer updates every tensor of the model's
variables, the buffers included (frozen-BN constants, ``batch`` norms'
running statistics): the JAX step differentiates its whole ``variables``
tree, ``constants`` and ``batch_stats`` collections and all, so Adam moves
those buffers by about ``lr`` a step however small their gradient.

Over several GPUs (``mesh`` from ``parallel.make_mesh`` under a process
group) every rank samples the whole batch from the same seeded sampler and
takes its task shard's contiguous frames; each rank's loss is over its own
frames, and the loss and the gradients are averaged over the task axis by
one ``all_reduce`` of a flat buffer before the optimizer steps, as the JAX
step's ``pmean``. So the result depends on the shard count, as in JAX: a
dice over half the batch is not half the dice over the whole batch, and
the detection sampling draws come from each shard's first seed. The
gradients live in a functional parameter dict that holds the frozen-BN
buffers too, so the reduction is explicit rather than
``DistributedDataParallel``'s module hooks. Rank 0 alone logs and writes
snapshots.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from e_osvos_torch.data import transforms
from e_osvos_torch.data.datasets import binarize_label
from e_osvos_torch.models.deeplab import functional_apply
from e_osvos_torch.models.mask_rcnn import TrainDraws
from e_osvos_torch.ops import losses as loss_ops
from e_osvos_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    make_mesh,
    task_sharding,
)
from e_osvos_torch.utils import MetricsLogger, resolve_device, save_checkpoint
from e_osvos_torch.utils.device import to_host, upload
from e_osvos_torch.utils.seeds import fold_in

TASKS = ("dense", "detection")


@dataclasses.dataclass
class ParentTrainConfig:
    """``task``: ``dense`` (binary segmentation) or ``detection`` (Mask
    R-CNN on instance masks, ``max_objects`` slots a frame)."""

    num_iters: int = 10000
    batch_size: int = 8
    lr: float = 1e-4
    weight_decay: float = 0.0
    optimizer: str = "adam"  # or "sgd" (with ``momentum``)
    momentum: float = 0.9
    loss_func: str = "cross_entropy_and_dice"
    crop_size: tuple = (480, 480)
    normalize_mode: str = "davis"
    log_interval: int = 50
    snapshot_interval: int = 1000
    save_dir: Optional[str] = None
    seed: int = 0
    augment: transforms.AugmentConfig = dataclasses.field(
        default_factory=transforms.AugmentConfig)
    task: str = "dense"
    max_objects: int = 3


def _crop(rng, img, label, crop):
    """A random ``crop`` of a frame, padded (image 0, label 255) where the
    frame is smaller."""
    th, tw = crop
    h, w = img.shape[:2]
    if h < th or w < tw:
        img = np.pad(img, ((0, max(th - h, 0)), (0, max(tw - w, 0)), (0, 0)))
        label = np.pad(label, ((0, max(th - h, 0)), (0, max(tw - w, 0))),
                       constant_values=255)
        h, w = img.shape[:2]
    y0 = rng.randint(0, h - th + 1)
    x0 = rng.randint(0, w - tw + 1)
    return img[y0:y0 + th, x0:x0 + tw], label[y0:y0 + th, x0:x0 + tw]


class FrameSampler:
    """Random annotated frames of one or more indexes, on the host: the
    image, the binary label of all its objects (ignore kept) and a seed a
    frame, from a numpy ``RandomState(seed)``."""

    def __init__(self, indexes: Sequence, crop_size, seed: int = 0):
        self.indexes = list(indexes)
        self.crop = tuple(crop_size)
        self.rng = np.random.RandomState(seed)
        self.units = [(ii, name, t)
                      for ii, index in enumerate(self.indexes)
                      for name, seq in index.sequences.items()
                      for t in range(len(seq))
                      if seq.label_paths[t] is not None]
        if not self.units:
            raise ValueError("no annotated frames")

    def _label(self, gt: np.ndarray) -> np.ndarray:
        ids = [k for k in np.unique(gt) if k not in (0, 255)]
        return binarize_label(gt, ids).astype(np.int32)

    def sample_batch(self, n: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(imgs [n, H, W, 3] float32, labels [n, H, W] int32, seeds [n]
        uint32)``."""
        th, tw = self.crop
        imgs = np.zeros((n, th, tw, 3), np.float32)
        labels = np.full((n, th, tw), 255, np.int32)
        for i in range(n):
            ii, name, t = self.units[self.rng.randint(len(self.units))]
            index = self.indexes[ii]
            img = index.get_image(name, t).astype(np.float32)
            label = self._label(index.get_label(name, t))
            imgs[i], labels[i] = _crop(self.rng, img, label, self.crop)
        seeds = self.rng.randint(0, 2**31 - 1, size=(n,)).astype(np.uint32)
        return imgs, labels, seeds


class InstanceFrameSampler(FrameSampler):
    """The detection task's sampler: labels keep an instance slot per
    object (1..K, in the order of the frame's ids); objects beyond
    ``max_objects`` become 255 (ignored, never background)."""

    def __init__(self, indexes: Sequence, crop_size, max_objects: int = 3,
                 seed: int = 0):
        super().__init__(indexes, crop_size, seed=seed)
        self.max_objects = max_objects

    def _label(self, gt: np.ndarray) -> np.ndarray:
        gt = gt.astype(np.int32)
        ids = [k for k in np.unique(gt) if k not in (0, 255)]
        label = np.where(gt == 255, 255, 0).astype(np.int32)
        for slot, k in enumerate(ids, start=1):
            label[gt == k] = slot if slot <= self.max_objects else 255
        return label


def _finalize(pending) -> Dict[str, float]:
    """A step's loss once its copy to the host is done, and the seconds
    from its issue to then."""
    host, event, t0 = pending
    if event is not None:
        event.synchronize()
    return {"loss": float(host), "step_s": time.perf_counter() - t0}


class ParentTrainer:
    """Supervised training of ``model`` on ``sampler``'s frames, on this
    rank's device (``cuda`` unless the caller asks for another), the frame
    batch spread over ``mesh``'s task shards (``parallel.make_mesh()`` by
    default).

    The trained tensors are ``params``: the model's parameters and buffers
    by ``state_dict`` name, in f32, separate from the module's own;
    ``state_dict()`` gives them detached. ``sample_draws`` draws every
    random number of a step."""

    def __init__(self, model: nn.Module, sampler: FrameSampler,
                 cfg: ParentTrainConfig = ParentTrainConfig(),
                 logger: Optional[MetricsLogger] = None, device=None,
                 mesh: Optional[Mesh] = None):
        if cfg.task not in TASKS:
            raise ValueError(f"unknown parent task {cfg.task!r}")
        self.mesh = mesh if mesh is not None else make_mesh()
        if cfg.batch_size % self.mesh.num_tasks != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by the task-axis "
                f"size {self.mesh.num_tasks}")
        self.main = self.mesh.rank == 0
        self.cfg = cfg
        self.sampler = sampler
        self.device = resolve_device(device)
        self.model = model
        self.apply = functional_apply(model)
        self.logger = logger or MetricsLogger(
            path=f"{cfg.save_dir}/parent_metrics.jsonl"
            if cfg.save_dir and self.main else None)
        self.params = {k: v.detach().to(self.device).clone()
                       .requires_grad_(True)
                       for k, v in model.state_dict().items()}
        leaves = list(self.params.values())
        if cfg.optimizer == "adam":
            self.opt = torch.optim.Adam(leaves, lr=cfg.lr,
                                        weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "sgd":
            self.opt = torch.optim.SGD(leaves, lr=cfg.lr,
                                       momentum=cfg.momentum,
                                       weight_decay=cfg.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.step_num = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.params.items()}

    def sample_draws(self, seeds: np.ndarray, hw: Tuple[int, int]
                     ) -> Tuple[transforms.AugmentDraws,
                                Optional[TrainDraws]]:
        """The step's draws on the device: frame i's augmentation from a
        generator seeded with ``seeds[i]`` (fields ``[B]``) and, for the
        detection task, the anchor and RoI sampling uniforms of the batch
        from one seeded with ``fold_in(cfg.seed, seeds[0])``."""
        cfg = self.cfg
        dev = self.device

        def gen(seed):
            return torch.Generator(device=dev).manual_seed(int(seed))

        per = [transforms.sample_augment_draws(gen(s), cfg.augment, ())
               for s in seeds]
        aug = transforms.AugmentDraws(*(None if f[0] is None
                                        else torch.stack(f)
                                        for f in zip(*per)))
        if cfg.task != "detection":
            return aug, None
        g = gen(fold_in(cfg.seed, int(seeds[0])))
        shapes = self.model.draw_shapes(hw, len(seeds),
                                        num_objects=cfg.max_objects)
        return aug, TrainDraws(*(torch.rand(s, generator=g, device=dev)
                                 for s in shapes))

    def loss(self, params, imgs: torch.Tensor, labels: torch.Tensor,
             aug: transforms.AugmentDraws,
             sample: Optional[TrainDraws]) -> torch.Tensor:
        """The training loss of a raw batch ``imgs [B, H, W, 3]``, ``labels
        [B, H, W]``: each frame augmented with its draws, normalized, then
        the segmentation loss (dense) or the detector's summed losses over
        per-slot masks with the ignore label in every slot (detection)."""
        cfg = self.cfg
        pairs = [transforms.augment_frame(imgs[i], labels[i], aug.select(i),
                                          cfg.augment)
                 for i in range(imgs.shape[0])]
        imgs = transforms.normalize(torch.stack([p[0] for p in pairs]),
                                    cfg.normalize_mode)
        labels = torch.stack([p[1] for p in pairs])
        if cfg.task == "detection":
            oid = torch.arange(1, cfg.max_objects + 1,
                               device=labels.device)[None, :, None, None]
            lab = labels[:, None]
            gt_masks = torch.where(lab == 255, 255.0, (lab == oid).float())
            gt_valid = (gt_masks == 1.0).any(dim=(2, 3))
            total, _ = self.apply(params, imgs, gt_masks, gt_valid,
                                  train=True, draws=sample)
            return total
        valid = labels != 255
        gts = torch.where(valid, labels, 0).float()
        logits = self.apply(params, imgs)[..., 0]
        return loss_ops.compute_loss(cfg.loss_func, logits, gts, valid)

    def step(self, imgs: np.ndarray, labels: np.ndarray, seeds: np.ndarray
             ) -> torch.Tensor:
        """One optimizer step on a host batch of ``batch_size`` frames, of
        which this rank runs its task shard's; returns the loss averaged
        over the shards (on the device, not waited for)."""
        rows = task_sharding(self.mesh, len(seeds))
        imgs, labels, seeds = imgs[rows], labels[rows], seeds[rows]
        dev = self.device
        imgs_d = upload(imgs.astype(np.float32), dev)
        labels_d = upload(labels.astype(np.int32), dev)
        aug, sample = self.sample_draws(seeds, tuple(imgs.shape[1:3]))
        loss = self.loss(self.params, imgs_d, labels_d, aug, sample)
        loss.backward()
        if self.mesh.group is not None:
            # the JAX step's pmean over the task axis; a tensor no loss
            # reached on this rank adds zeros
            leaves = list(self.params.values())
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in leaves]
            loss, *grads = all_reduce_sum(self.mesh, [loss, *grads])
            inv = 1.0 / self.mesh.num_tasks
            loss = loss * inv
            torch._foreach_mul_(grads, inv)
            for p, g in zip(leaves, grads):
                p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step_num += 1
        return loss.detach()

    def run(self, num_iters: Optional[int] = None) -> Dict[str, float]:
        """``num_iters`` steps (default ``cfg.num_iters``), pipelined one
        deep: step k's loss is read only after step k+1 is issued, so the
        host samples and uploads while the card computes. Logged and
        snapshot steps are read at once, so their values are their own.
        Rank 0 writes the snapshots, to ``<save_dir>/parent_<step>.ckpt``.
        Returns the last step's loss and seconds."""
        cfg = self.cfg
        n = num_iters if num_iters is not None else cfg.num_iters
        last: Dict[str, float] = {}
        pending = None
        for _ in range(n):
            imgs, labels, seeds = self.sampler.sample_batch(cfg.batch_size)
            t0 = time.perf_counter()
            loss = self.step(imgs, labels, seeds)
            if pending is not None:
                last = _finalize(pending)
            pending = (*to_host(loss), t0)
            log_now = (self.step_num % cfg.log_interval == 0
                       or self.step_num == 1)
            snap_now = bool(cfg.save_dir
                            and self.step_num % cfg.snapshot_interval == 0)
            if log_now or snap_now:
                last = _finalize(pending)
                pending = None
            if log_now and self.main:
                self.logger.log("parent_train", step=self.step_num, **last)
            if snap_now and self.main:
                save_checkpoint(f"{cfg.save_dir}/parent_{self.step_num}.ckpt",
                                self.state_dict(),
                                metadata={"step": self.step_num})
        if pending is not None:
            last = _finalize(pending)
        return last
