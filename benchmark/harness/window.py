"""The measured window: one client walking the pool, whole sequences back
to back through the evaluator's public ``eval_sequence`` (staging,
fine-tune, the OnA window loop, merge, J/F on the device, the fetch to
the host). A sequence starts only while the window is open; the one in
flight at the deadline is finished and counted. The window's time runs
from its start to the end of its last sequence, so every frame it
produced and every second it took are in ``seq_fps``."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from harness.seeds import fold_in


class Mark:
    """A point on the device's timeline (a CUDA event), or on the host's
    clock where there is no card (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.host = time.perf_counter()

    def seconds_to(self, later: "Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event) / 1e3
        return later.host - self.host


class Sequence(NamedTuple):
    j: int
    name: str
    frames: int
    end_s: float  # host clock, from the window's start
    marks: Dict[str, Mark]  # start, fine_tune, propagate, score
    finite: bool


class Window(NamedTuple):
    sequences: List[Sequence]
    seconds: float
    peak_bytes: int
    first_probs: np.ndarray  # [O, T, H, W] of sequence 0
    first_merged: np.ndarray  # [T, H, W] of sequence 0
    launches: Dict[str, int]  # program's kernel launches in sequence 0

    @property
    def frames(self) -> int:
        return sum(s.frames for s in self.sequences)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def run(evaluator, index, meta_params, eval_seed: int, seconds: float,
        hook, device: torch.device, launch_counts: Callable[[], Dict],
        reset_launches: Callable[[], None]) -> Window:
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    seqs: List[Sequence] = []
    first = None
    t0 = time.perf_counter()
    j = 0
    while j == 0 or time.perf_counter() - t0 < seconds:
        name = index.names[j % len(index.names)]
        marks = {"start": Mark(device)}
        evaluator.on_phase = lambda p, m=marks: m.setdefault(p, Mark(device))
        hook.begin_sequence(armed=j == 0)
        if j == 0:
            reset_launches()
        res = evaluator.eval_sequence(index, name, meta_params,
                                      fold_in(eval_seed, j))
        end_s = time.perf_counter() - t0
        hook.end_sequence()
        finite = bool(np.isfinite(res["J_mean"]) and np.isfinite(res["F_mean"]))
        if j == 0:
            first = (_host(res["probs"]), np.asarray(res["merged"]),
                     dict(launch_counts()))
        del res
        seqs.append(Sequence(j, name, len(index.sequences[name]), end_s,
                             marks, finite))
        j += 1
    evaluator.on_phase = None
    sync()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    return Window(seqs, seqs[-1].end_s, peak, *first)


def phase_seconds(window: Window, start: str, end: str) -> Optional[float]:
    """Mean seconds from mark ``start`` to mark ``end`` over the window's
    sequences, on the device's timeline."""
    got = [s.marks[start].seconds_to(s.marks[end]) for s in window.sequences
           if start in s.marks and end in s.marks]
    return float(np.mean(got)) if got else None
