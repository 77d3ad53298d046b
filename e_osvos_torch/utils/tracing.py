"""Spans and counters inside the port: where a sequence's time goes on the
host's clock and on the device's, with the kernel launches and the host
syncs of each part.

Off by default. ``tracing.enable()`` is the operator's switch::

    from e_osvos_torch.utils import tracing

    tracing.enable()
    evaluator.eval_sequence(index, name, meta_params, seed)
    records = tracing.collect()   # the finished spans; clears them
    tracing.disable()

The program opens spans with ``with tracing.span(name):`` at its layer
boundaries (``sequence`` > ``stage``, ``fine_tune``, ``propagate`` >
``segment``, ``pseudo_gt``, ``refit``, ``score``; ``fine_tune`` and
``refit`` > ``inner_step`` > ``forward``, ``backward``, ``update``). Off,
``span()`` hands out one shared no-op context: no allocation, no CUDA
event, no ``record_function``, no clock read, the sync-debug mode left
alone. On, each span keeps a ``Span`` record in memory:

* its name, id, the enclosing span (``parent``) and the outermost one
  (``root``: the identifier shared by one sequence's spans);
* host start and end (``time.perf_counter``) and device start and end: a
  pair of CUDA events recorded on the current stream without a sync,
  placed on the host's clock by ``collect()``. At a root span's start the
  tracer synchronises once, records an anchor event and reads the host
  clock; an event's time is the anchor's host time plus the anchor's
  ``elapsed_time`` to it. So a span's device interval and its host interval
  sit on one axis, and the gap between them is how far the device ran
  behind the host that issued the work. Without a card, device times are
  the host's;
* the GroupNorm and NMS kernel launches issued inside it (the change of
  ``ops.cuda_group_norm.launch_counts()`` and ``ops.cuda_nms.launch_counts()``
  between its ends; nested spans' launches are their parent's too);
* apart from the launches, the change of the program's own counts
  (``count(name)``, kept whether tracing is on or off, read by
  ``program_counts()``): a ``fine_tune`` span that let cuDNN time its
  convolutions' engines holds ``timed_conv_fine_tunes: 1`` in ``counts``
  (``engine/one_shot.py``);
* the host syncs counted on it and on no span inside it: within a root span
  the tracer sets ``torch.cuda.set_sync_debug_mode("warn")`` and counts
  PyTorch's "synchronizing CUDA operation" warnings on the innermost open
  span (a blocking copy between host and device, ``.item()``, a
  ``nonzero``, a stream sync), then restores the previous mode and warning
  filters at the root's end. The tracer's own syncs are not counted.

Each span also enters ``torch.profiler.record_function(name)``, so a
profile taken with the tracer on (``MetaTrainConfig.profile_iters`` turns
it on for its window) shows the program's spans on the device trace.

Spans are opened from one thread, the one that drives the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch

SYNC_WARNING = "synchronizing CUDA operation"
_OFF = contextlib.nullcontext()  # every span while tracing is off


@dataclasses.dataclass
class Span:
    """One finished span. Times are seconds on ``time.perf_counter``'s
    axis; ``launches`` holds the kernel launch counters that moved,
    ``counts`` the program's counts that moved."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    host_start: float
    host_end: float
    device_start: float = 0.0
    device_end: float = 0.0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    syncs: int = 0

    @property
    def host_s(self) -> float:
        return self.host_end - self.host_start

    @property
    def device_s(self) -> float:
        return self.device_end - self.device_start


def _launch_counts() -> Dict[str, int]:
    from e_osvos_torch.ops import cuda_group_norm, cuda_nms

    return {**cuda_group_norm.launch_counts(), **cuda_nms.launch_counts()}


def _moved(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class _Open:
    """A span while it is open (tracing on)."""

    __slots__ = ("tracer", "rec", "before", "events", "anchor", "profiled")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.rec = Span(name, 0, None, 0, 0.0, 0.0)

    def __enter__(self) -> Span:
        t = self.tracer
        rec = self.rec
        rec.id = t.next_id
        t.next_id += 1
        if t.open:
            parent = t.open[-1]
            rec.parent, rec.root = parent.rec.id, parent.rec.root
            self.anchor = parent.anchor
        else:
            rec.root = rec.id
            self.anchor = t.begin_root()
        t.open.append(self)
        self.before = _launch_counts(), dict(t.counts)
        self.profiled = torch.profiler.record_function(rec.name)
        self.profiled.__enter__()
        self.events = None
        if t.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        rec.host_start = time.perf_counter()
        return rec

    def __exit__(self, *exc) -> None:
        t = self.tracer
        rec = self.rec
        rec.host_end = time.perf_counter()
        try:
            if self.events is not None:
                self.events[1].record()
            self.profiled.__exit__(*exc)
            launched, counted = self.before
            rec.launches = _moved(launched, _launch_counts())
            rec.counts = _moved(counted, t.counts)
        finally:
            t.open.pop()
            t.done.append(self)
            if not t.open:
                t.end_root()


class Tracer:
    """The spans of one process: the switch, the open spans' stack, the
    finished ones, the state of the root span's sync counting, and the
    program's counts."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.on = False
        self.cuda = False
        self.next_id = 0
        self.open: List[_Open] = []
        self.done: List[_Open] = []
        self._warnings: Optional[contextlib.AbstractContextManager] = None
        self._show: Optional[Callable] = None
        self._sync_mode = 0

    def span(self, name: str):
        """A context manager around one part of the program: the shared
        no-op context while tracing is off."""
        return _Open(self, name) if self.on else _OFF

    def enable(self, device: Optional[str] = None) -> None:
        """Turns tracing on. ``device``: where the program runs (``cuda``
        where a card is available, else ``cpu``); on ``cpu`` device times
        are the host's and the sync-debug mode is not set."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.cuda = torch.device(device).type == "cuda"
        self.on = True

    def disable(self) -> None:
        """Turns tracing off; spans open now still close and are kept."""
        self.on = False

    def enabled(self) -> bool:
        return self.on

    def count(self, name: str) -> None:
        """Adds one to the program's count ``name``, on or off."""
        self.counts[name] = self.counts.get(name, 0) + 1

    def program_counts(self) -> Dict[str, int]:
        return dict(self.counts)

    def collect(self) -> List[Span]:
        """The finished spans in the order they closed, their device times
        on the host's clock (one synchronize); clears them."""
        done, self.done = self.done, []
        if any(o.events is not None for o in done):
            torch.cuda.synchronize()
        out = []
        for o in done:
            rec = o.rec
            if o.events is None:
                rec.device_start, rec.device_end = (rec.host_start,
                                                    rec.host_end)
            else:
                event, host = o.anchor
                rec.device_start = host + event.elapsed_time(
                    o.events[0]) / 1e3
                rec.device_end = host + event.elapsed_time(o.events[1]) / 1e3
            out.append(rec)
        return out

    # -- the root span ------------------------------------------------------

    def begin_root(self):
        """Synchronises once, anchors the device's clock to the host's and
        starts counting syncs. Returns the anchor ``(event, host time)``."""
        anchor = (None, 0.0)
        if self.cuda:
            torch.cuda.synchronize()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            anchor = (event, time.perf_counter())
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}",
                                category=UserWarning)
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        if self.cuda:
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return anchor

    def end_root(self) -> None:
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
        self._warnings.__exit__(None, None, None)
        self._warnings = self._show = None

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None) -> None:
        if SYNC_WARNING in str(message) and self.open:
            self.open[-1].rec.syncs += 1
        else:
            self._show(message, category, filename, lineno, file, line)


TRACER = Tracer()
span = TRACER.span
enable = TRACER.enable
disable = TRACER.disable
enabled = TRACER.enabled
collect = TRACER.collect
count = TRACER.count
program_counts = TRACER.program_counts


def totals(records: List[Span]) -> Dict[str, Dict[str, float]]:
    """By span name: the count, the summed host and device seconds, the
    syncs, and the launches of each counter."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        t = out.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                    "device_s": 0.0, "syncs": 0,
                                    "launches": {}})
        t["count"] += 1
        t["host_s"] += r.host_s
        t["device_s"] += r.device_s
        t["syncs"] += r.syncs
        for k, v in r.launches.items():
            t["launches"][k] = t["launches"].get(k, 0) + v
    return out
