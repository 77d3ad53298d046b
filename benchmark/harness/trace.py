"""The device trace of one sequence, reduced: device busy time as the
union of every operation's interval (kernels, copies, sets), the traced
window, kernel counts and device time by name, and the idle gaps labelled
by what the host was doing.

``scripts/torch_profile_one_shot.py`` in the repo sums kernel durations
for its busy time; that equals the union only while nothing overlaps, so
this takes the union.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

GAPS_LABELLED = 2000  # the longest idle gaps whose host activity is named
TOP = 10


class Trace(NamedTuple):
    window_s: float  # the traced window, host clock around the sequence
    busy_s: float  # union of device operations' intervals
    kernels: int  # device kernels (copies and sets not counted)
    kernel_s: Dict[str, float]  # device seconds by kernel name
    device_ops: List[Tuple[str, float]]  # the TOP operations by time
    idle_gaps: List[Tuple[str, float]]  # idle seconds by host activity


def _ns(e, what: str) -> int:
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


def _dur(e) -> int:
    if hasattr(e, "duration_ns"):
        return int(e.duration_ns())
    return int(e.duration_us() * 1000)


class _LazyNames:
    """Names of host events, fetched only for those a gap is labelled by."""

    def __init__(self, events):
        self.events = events

    def __getitem__(self, i):
        return self.events[i].name()


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of ``[starts, ends)``, sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_start = s[idx]
    m_end = np.append(run_end[idx[1:] - 1], run_end[-1]) if len(s) else s
    return m_start, m_end


def _label_gaps(gap_start: np.ndarray, gap_len: np.ndarray, cpu) -> Dict[str, float]:
    """Idle seconds by ``phase: innermost host operation`` at each gap's
    start, over the GAPS_LABELLED longest gaps."""
    names, c_start, c_end, user = cpu
    order = np.argsort(c_start, kind="stable")
    c_start, c_end, user = c_start[order], c_end[order], user[order]
    u_idx = np.flatnonzero(user)
    out: Dict[str, float] = defaultdict(float)
    for g in np.argsort(-gap_len)[:GAPS_LABELLED]:
        t = gap_start[g]
        i = int(np.searchsorted(c_start, t, side="right")) - 1
        inner = "(no host operation)"
        for j in range(i, max(i - 400, -1), -1):
            if c_end[j] > t and not user[j]:
                inner = names[order[j]]
                break
        phase = "frames, staging and score"
        for j in u_idx[::-1]:
            if c_start[j] <= t < c_end[j]:
                name = names[order[j]]
                if name.startswith("bench."):
                    phase = name[len("bench."):]
                    break
        out[f"{phase}: {inner}"] += gap_len[g] / 1e9
    return out


def traced(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Runs ``fn`` under ``torch.profiler`` (host and device activity) and
    reduces its trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts, record_shapes=False) as prof:
        w0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in events:
        (dev if e.device_type() == cuda else cpu).append(e)
    dev = [e for e in dev if not (e.is_user_annotation()
                                  or e.name().startswith("bench."))]
    dev_name = [e.name() for e in dev]
    dev_s = [_ns(e, "start") for e in dev]
    dev_e = [s + _dur(e) for s, e in zip(dev_s, dev)]
    cpu_s = np.asarray([_ns(e, "start") for e in cpu], np.int64)
    cpu_e = cpu_s + np.asarray([_dur(e) for e in cpu], np.int64)
    cpu_name = _LazyNames(cpu)
    cpu_user = np.asarray([e.is_user_annotation() for e in cpu], bool)
    del events
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    kernel_s: Dict[str, float] = defaultdict(float)
    kernels = 0
    for n, s, e in zip(dev_name, dev_s, dev_e):
        kernel_s[n] += (e - s) / 1e9
        kernels += not n.startswith(("Memcpy", "Memset"))
    busy_s, gaps = 0.0, {}
    if len(dev_s):
        m_s, m_e = _union(dev_s, dev_e)
        busy_s = float((m_e - m_s).sum()) / 1e9
        gap_start, gap_len = m_e[:-1], m_s[1:] - m_e[:-1]
        gaps = _label_gaps(gap_start, gap_len.astype(np.float64),
                           (cpu_name, cpu_s, cpu_e, cpu_user))
    print(f"trace: profiler stop {t1 - t0 - window_s:.1f} s, reduction "
          f"{time.perf_counter() - t1:.1f} s, {len(dev_name)} device and "
          f"{len(cpu_s)} host events", file=sys.stderr, flush=True)
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return out, Trace(window_s, busy_s, kernels, dict(kernel_s),
                      [(n[:160], s) for n, s in ops],
                      [(n[:160], s) for n, s in idle])
