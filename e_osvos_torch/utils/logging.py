"""Structured metrics logging (jsonl and stdout) and a wall-clock phase
timer, port of ``e_osvos_tpu/utils/logging.py``. The metric vocabulary is
the reference's (meta_loss, J/F, lr statistics), so runs stay comparable
with its plots."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_jsonable(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class MetricsLogger:
    """Append-only jsonl metrics stream with optional stdout echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, event: str, step: Optional[int] = None, **metrics) -> Dict:
        rec = {"ts": time.time(), "event": event}
        if step is not None:
            rec["step"] = int(step)
        rec.update({k: _to_jsonable(v) for k, v in metrics.items()})
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class Timer:
    """Wall-clock phase timer: totals and counts per phase name."""

    def __init__(self):
        self._start: Dict[str, float] = {}
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def start(self, phase: str):
        self._start[phase] = time.perf_counter()

    def stop(self, phase: str) -> float:
        dt = time.perf_counter() - self._start.pop(phase)
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        self.counts[phase] = self.counts.get(phase, 0) + 1
        return dt

    def __getitem__(self, phase: str) -> float:
        return self.totals.get(phase, 0.0)
