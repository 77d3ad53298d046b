"""One-shot evaluation command line, port of ``e_osvos_tpu/cli/evaluate.py``.

    python -m e_osvos_torch.cli.evaluate with DAVIS-2017 e-OSVOS-OnA \\
        num_epochs.eval=50 datasets.val.root=data/DAVIS-2017 \\
        meta_optim_model_file=models/best.ckpt [device=cpu]

Evaluates every sequence of the ``datasets.val`` split and writes one
``eval_seq`` line a sequence (J, F, seconds a frame, fps; on a card also the
sequence's peak device memory) and an ``eval_total`` line to
``<save_dir>/eval_metrics.jsonl``; with ``eval_init_j`` an ``init_eval_seq``
line first (the un-fine-tuned init's J/F). ``save_preds=<dir>`` writes the
merged label maps as DAVIS-palette PNGs (``<dir>/<seq>/<frame>.png``, the
submission format), ``save_debug=<dir>`` mask overlays on the frames.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from e_osvos_torch import config as cfglib
from e_osvos_torch.cli.common import (
    build_indexes,
    build_parent_model,
    build_parent_state_selector,
    init_model_params,
    resolve_meta_params,
)
from e_osvos_torch.engine import (
    DetectionOneShotConfig,
    DetectionOneShotEvaluator,
    OneShotEvaluator,
)
from e_osvos_torch.models import functional_apply
from e_osvos_torch.utils import MetricsLogger, Timer
from e_osvos_torch.utils.png import save_indexed_png
from e_osvos_torch.utils.visualize import save_debug_overlay


def build_evaluator(cfg: Dict, model):
    """The DeepLab ``OneShotEvaluator`` or the Mask R-CNN
    ``DetectionOneShotEvaluator``, by ``parent_model.architecture``, on the
    config's device, with the window loop of ``eval_fused_ona``."""
    if cfg.get("eval_frame_parallel"):
        raise NotImplementedError(
            "eval_frame_parallel (evaluation over several GPUs) is not ported "
            "yet (ROADMAP E1)")
    meta_cfg = cfglib.to_meta_optim_config(cfg)
    one_shot_cfg = cfglib.to_one_shot_config(cfg)
    device = cfglib.device_of(cfg)
    fused = bool(cfg.get("eval_fused_ona", True))
    pm = cfg.get("parent_model", {})
    if pm.get("architecture", "DeepLabV3Plus") == "MaskRCNN":
        ona = cfg.get("eval_online_adapt", {})
        det_cfg = DetectionOneShotConfig(
            **{f.name: getattr(one_shot_cfg, f.name)
               for f in dataclasses.fields(one_shot_cfg)},
            proposal_aug_mode=pm.get("eval_augment_rpn_proposals_mode",
                                     "EXTEND") or "NONE",
            ona_reset_mode=str(ona.get("reset_model_mode", "FIRST_STEP")),
            ona_only_box_head=bool(ona.get("only_box_head", False)))
        return DetectionOneShotEvaluator(model, meta_cfg, det_cfg,
                                         device=device, fused_ona=fused)
    return OneShotEvaluator(functional_apply(model), meta_cfg, one_shot_cfg,
                            device=device, fused_ona=fused)


def save_maps(cfg: Dict, index, name: str, merged: np.ndarray) -> None:
    """A sequence's merged label maps as palette PNGs under ``save_preds``
    and as overlays on its frames under ``save_debug``, where configured."""
    for key in ("save_preds", "save_debug"):
        if not cfg.get(key):
            continue
        out = os.path.join(str(cfg[key]), name)
        os.makedirs(out, exist_ok=True)
        for t in range(merged.shape[0]):
            path = os.path.join(out, f"{t:05d}.png")
            if key == "save_preds":
                save_indexed_png(path, merged[t].astype(np.uint8))
            else:
                save_debug_overlay(path, index.get_image(name, t), merged[t])


def main(argv=None) -> List[Dict]:
    """Run the evaluation; returns the logged records."""
    cfg = cfglib.parse_cli(argv if argv is not None else sys.argv[1:])
    model = init_model_params(cfg, build_parent_model(cfg))
    meta_params = resolve_meta_params(cfg, model)
    evaluator = build_evaluator(cfg, model)
    on_card = evaluator.device.type == "cuda"
    indexes = build_indexes(cfg, "val")
    # leave-one-out parents: each sequence starts from the parent whose
    # val split holds it
    selector = build_parent_state_selector(cfg, "val", model)
    seed = int(cfg.get("seed", 1))
    timer = Timer()
    save_dir = cfg.get("save_dir") or "models"
    logger = MetricsLogger(path=os.path.join(save_dir, "eval_metrics.jsonl"))
    records: List[Dict] = []

    def log(event, **metrics):
        records.append(logger.log(event, **metrics))

    all_j, all_f = [], []
    try:
        for index in indexes:
            for name, seq in index.sequences.items():
                init = selector.select(name) if selector else None
                if cfg.get("eval_init_j"):
                    log("init_eval_seq", **evaluator.eval_sequence_init(
                        index, name, meta_params, init_params=init))
                if on_card:
                    torch.cuda.reset_peak_memory_stats(evaluator.device)
                timer.start("seq")
                res = evaluator.eval_sequence(index, name, meta_params, seed,
                                              init_params=init)
                tpf = timer.stop("seq") / max(len(seq), 1)
                extra = ({"peak_mem_gib": torch.cuda.max_memory_allocated(
                    evaluator.device) / 2**30} if on_card else {})
                log("eval_seq", seq=name, J_mean=res["J_mean"],
                    F_mean=res["F_mean"], time_per_frame=tpf,
                    fps=1.0 / tpf if tpf > 0 else float("inf"), **extra)
                all_j.append(res["J_mean"])
                all_f.append(res["F_mean"])
                save_maps(cfg, index, name, res["merged"])
        log("eval_total",
            J_mean=float(np.nanmean(all_j)) if all_j else float("nan"),
            F_mean=float(np.nanmean(all_f)) if all_f else float("nan"),
            num_sequences=len(all_j))
    finally:
        logger.close()
    return records


if __name__ == "__main__":
    main()
