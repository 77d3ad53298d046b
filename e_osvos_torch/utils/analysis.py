"""Runtime against quality: J&F and seconds a frame over the number of
fine-tune steps, port of ``e_osvos_tpu/utils/analysis.py``.

The reference's paper figure (fps and J&F for T in {1, 5, 10, 20, 50, 100,
500} fine-tune steps, the e-OSVOS-T runtime curve) as rows any plotting
tool reads; ``MetricsLogger`` writes them as jsonl.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from e_osvos_torch.utils.logging import MetricsLogger


def sweep_fine_tune_steps(make_evaluator: Callable[[int], Any], index,
                          seq_names: Sequence[str], meta_params, seed: int,
                          steps: Sequence[int] = (1, 5, 10, 20, 50, 100),
                          logger: Optional[MetricsLogger] = None
                          ) -> List[Dict[str, float]]:
    """For each T of ``steps``: an evaluator with ``num_epochs=T`` from
    ``make_evaluator(T)`` runs ``eval_sequence`` on each sequence with the
    seed ``seed``; a row holds the J/F means and the time a frame (each
    sequence's wall clock over its frames, summed)."""
    rows = []
    for T in steps:
        ev = make_evaluator(T)
        js, fs, total_time, total_frames = [], [], 0.0, 0
        for name in seq_names:
            t0 = time.perf_counter()
            res = ev.eval_sequence(index, name, meta_params, seed)
            total_time += time.perf_counter() - t0
            total_frames += res["merged"].shape[0]
            js.append(res["J_mean"])
            fs.append(res["F_mean"])
        row = {
            "fine_tune_steps": int(T),
            "J_mean": float(np.nanmean(js)),
            "F_mean": float(np.nanmean(fs)),
            "JF_mean": float((np.nanmean(js) + np.nanmean(fs)) / 2),
            "time_per_frame": total_time / max(total_frames, 1),
            "fps": total_frames / max(total_time, 1e-9),
        }
        rows.append(row)
        if logger is not None:
            logger.log("sweep_T", **row)
    return rows
