"""Parent pre-training command line, port of
``e_osvos_tpu/cli/train_parent.py``.

    python -m e_osvos_torch.cli.train_parent with DAVIS-2017 \\
        datasets.train.root=data/DAVIS-2017 parent.num_iters=5000
    python -m e_osvos_torch.cli.train_parent with DAVIS-2017 \\
        parent_model.architecture=MaskRCNN parent_model.backbone_norm=group \\
        parent.batch_size=4 parent.max_objects=2 [device=cpu]

Trains the ``parent_model`` on ``datasets.train`` with ``ParentTrainer``
(the DeepLab family on binary segmentation, Mask R-CNN on instance masks),
logs to ``<save_dir>/parent_metrics.jsonl``, snapshots
``parent_<step>.ckpt`` every ``parent.snapshot_interval`` steps and writes
``parent_final.ckpt``: the model's ``state_dict``, which ``cli.evaluate``
and ``cli.train_meta`` read as ``parent_model.checkpoint``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

from e_osvos_torch import config as cfglib
from e_osvos_torch.cli.common import (
    build_indexes,
    build_parent_model,
    init_model_params,
)
from e_osvos_torch.engine.parent_trainer import (
    FrameSampler,
    InstanceFrameSampler,
    ParentTrainConfig,
    ParentTrainer,
)
from e_osvos_torch.utils import MetricsLogger, save_checkpoint


def to_parent_config(cfg: Dict) -> ParentTrainConfig:
    """The ``parent`` subtree (with the crop, normalization, seed and
    augmentation of the rest of the config) as a ``ParentTrainConfig``;
    Mask R-CNN trains the detection task."""
    p = cfg.get("parent", {})
    crop = (cfg.get("data_cfg", {}).get("crop_sizes", {}).get("train")
            or (480, 480))
    if isinstance(crop, int):
        crop = (crop, crop)
    arch = cfg.get("parent_model", {}).get("architecture", "DeepLabV3Plus")
    return ParentTrainConfig(
        task="detection" if arch == "MaskRCNN" else "dense",
        max_objects=int(p.get("max_objects", 3)),
        num_iters=int(p.get("num_iters", 10000)),
        batch_size=int(p.get("batch_size", 8)),
        lr=float(p.get("lr", 1e-4)),
        weight_decay=float(p.get("weight_decay", 0.0)),
        optimizer=str(p.get("optimizer", "adam")),
        loss_func=str(p.get("loss_func", cfg.get("loss_func",
                                                 "cross_entropy_and_dice"))),
        crop_size=tuple(crop),
        normalize_mode=("unit" if cfg.get("data_cfg", {}).get("normalize")
                        else "davis"),
        log_interval=int(p.get("log_interval", 50)),
        snapshot_interval=int(p.get("snapshot_interval", 1000)),
        save_dir=cfg.get("save_dir"),
        seed=int(cfg.get("seed", 0)),
        augment=cfglib.to_augment_config(cfg),
    )


def main(argv=None) -> ParentTrainer:
    """Run parent training; returns the trainer."""
    cfg = cfglib.parse_cli(argv if argv is not None else sys.argv[1:])
    save_dir = cfg.get("save_dir") or "models"
    cfg["save_dir"] = save_dir
    model = init_model_params(cfg, build_parent_model(cfg))
    pcfg = to_parent_config(cfg)
    indexes = build_indexes(cfg, "train")
    if pcfg.task == "detection":
        sampler = InstanceFrameSampler(indexes, pcfg.crop_size,
                                       max_objects=pcfg.max_objects,
                                       seed=pcfg.seed)
    else:
        sampler = FrameSampler(indexes, pcfg.crop_size, seed=pcfg.seed)
    trainer = ParentTrainer(
        model, sampler, pcfg,
        logger=MetricsLogger(path=os.path.join(save_dir,
                                               "parent_metrics.jsonl")),
        device=cfglib.device_of(cfg))
    try:
        trainer.run()
        save_checkpoint(os.path.join(save_dir, "parent_final.ckpt"),
                        trainer.state_dict(),
                        metadata={"step": trainer.step_num})
    finally:
        trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
