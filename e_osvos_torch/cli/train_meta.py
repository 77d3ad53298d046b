"""Meta-training command line, port of ``e_osvos_tpu/cli/train_meta.py``.

    python -m e_osvos_torch.cli.train_meta with DAVIS-2017 \\
        datasets.train.root=data/DAVIS-2017 num_meta_iters=1000 [device=cpu]
    python -m e_osvos_torch.cli.train_meta with DAVIS-2017 \\
        parent_model.architecture=MaskRCNN parent_model.backbone_norm=group \\
        parent_model.checkpoint=models/parent/parent_final.ckpt

The architecture picks the task family: Mask R-CNN meta-trains on the
detector's training losses (``parallel.detection_task_fns``, with
``random_box_coord_perm``), the DeepLab family on its segmentation loss.

Over N GPUs of a node, one process each, the meta batch's tasks spread
over the ranks (``meta_batch_size`` must divide by N)::

    torchrun --nproc_per_node=N -m e_osvos_torch.cli.train_meta with \\
        DAVIS-2017 datasets.train.root=data/DAVIS-2017

Samples meta-tasks from ``datasets.train``, runs ``MetaTrainer`` (one
device, or under ``torchrun`` this rank's, rank 0 alone writing), logs to
``<save_dir>[/<env_suffix>]/metrics.jsonl`` and checkpoints
``last_meta_iter.ckpt`` (``best_meta_iter.ckpt`` on the best interleaved
evaluation, every ``eval_interval`` iterations over the first
``datasets.val`` index). ``meta_optim_model_file`` starts from saved
meta-parameters (the port's, the JAX package's or a reference ``.model``);
``resume`` continues a run of the port or of the JAX package (its
``last_meta_iter.ckpt``: meta-parameters, the outer RAdam's step counts and
moments, ``meta_iter`` and ``best_eval``), or starts from a reference
``.model``'s meta-parameters with a fresh outer optimizer.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from e_osvos_torch import config as cfglib
from e_osvos_torch.cli.common import (
    TORCH_FILES,
    build_indexes,
    build_parent_model,
    distributed_mesh,
    init_model_params,
    resolve_meta_params,
)
from e_osvos_torch.cli.evaluate import build_evaluator
from e_osvos_torch.engine.meta_trainer import MetaTrainer
from e_osvos_torch.meta_optim.tasksets import MetaTaskset
from e_osvos_torch.models import functional_apply
from e_osvos_torch.parallel import detection_task_fns
from e_osvos_torch.utils import MetricsLogger


def make_eval_fn(cfg, model, index):
    """The interleaved evaluation: J/F over every sequence of ``index`` on
    the seed of the meta-iteration, and the un-fine-tuned init's J once, at
    the first call."""
    evaluator = build_evaluator(cfg, model)
    init_j_done = []

    def eval_fn(meta_params, meta_iter):
        out = {}
        if not init_j_done:
            out["init_J_mean"] = float(np.nanmean([
                evaluator.eval_sequence_init(index, name, meta_params)[
                    "init_J_mean"] for name in index.sequences]))
            init_j_done.append(True)
        results = [evaluator.eval_sequence(index, name, meta_params,
                                           meta_iter)
                   for name in index.sequences]
        out.update({
            "J_mean": float(np.nanmean([r["J_mean"] for r in results])),
            "F_mean": float(np.nanmean([r["F_mean"] for r in results])),
            "per_seq_J": {r["seq"]: r["J_mean"] for r in results},
        })
        return out

    return eval_fn


def main(argv=None) -> MetaTrainer:
    """Run meta-training; returns the trainer."""
    cfg = cfglib.parse_cli(argv if argv is not None else sys.argv[1:])
    save_dir = cfg.get("save_dir") or "models"
    if cfg.get("env_suffix"):
        save_dir = os.path.join(save_dir, str(cfg["env_suffix"]))
    cfg["save_dir"] = save_dir
    resume = cfg.get("resume")
    # a reference ``.model`` carries meta-parameters and no outer optimizer
    # state: it seeds the meta-parameters, the optimizer starts
    reference = bool(resume) and str(resume).endswith(TORCH_FILES)

    mesh = distributed_mesh(cfg)
    model = init_model_params(cfg, build_parent_model(cfg))
    step_cfg = cfglib.to_meta_step_config(cfg)
    apply = functional_apply(model)
    task_fns = None
    if cfg.get("parent_model", {}).get("architecture") == "MaskRCNN":
        task_fns = detection_task_fns(model, step_cfg)
    taskset = MetaTaskset(build_indexes(cfg, "train"),
                          cfglib.to_taskset_config(cfg),
                          seed=int(cfg.get("seed", 1)))
    eval_fn = None
    val_indexes = build_indexes(cfg, "val")
    if val_indexes and cfg.get("eval_interval"):
        eval_fn = make_eval_fn(cfg, model, val_indexes[0])

    main_rank = mesh is None or mesh.rank == 0
    trainer = MetaTrainer(
        apply, model, taskset,
        meta_cfg=cfglib.to_meta_optim_config(cfg),
        step_cfg=step_cfg,
        outer_cfg=cfglib.to_outer_optim_config(cfg),
        train_cfg=cfglib.to_meta_train_config(cfg),
        logger=MetricsLogger(path=os.path.join(save_dir, "metrics.jsonl")
                             if main_rank else None),
        eval_fn=eval_fn, device=cfglib.device_of(cfg), task_fns=task_fns,
        mesh=mesh)
    # in place: the outer optimizer holds the trainer's tensors; ``resume``
    # is read once, by ``trainer.restore``
    with torch.no_grad():
        for mine, loaded in zip(trainer.meta_params, resolve_meta_params(
                cfg if reference else dict(cfg, resume=None), model)):
            for k, v in (mine or {}).items():
                v.copy_(loaded[k])
    if resume and os.path.exists(resume) and not reference:
        trainer.restore(resume)
    try:
        trainer.run()
        trainer.save("last_meta_iter")
    finally:
        trainer.logger.close()
        if mesh is not None:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
