"""What the timed path hands the comparison: the program's parameters at
chosen points of its learned-optimizer loops, read without a host sync.

The port runs every fine-tune and every online-adaptation refit through
``meta_optim.fine_tune(cfg, loss_fn, meta_params, batches, ...)``, which
calls ``loss_fn(params, batch)`` once a step with the step's parameters,
updates them in place and returns ``(params, losses)``. ``StepHook``
stands in for that name in the evaluators' modules. In a sequence it is
armed for, it copies the parameters at the planned points into pinned
host buffers with ``non_blocking`` copies on the current stream (ordered
before the next in-place update, so no sync), and keeps the returned
losses. In every sequence it counts the calls and the steps of each:
the passes the configuration fixes.

A point ``(c, s)`` is call ``c`` of the sequence (0 the fine-tune, c >= 1
the refit after window c - 1) before its step ``s``; ``s`` equal to the
call's step count is its return, the parameters that segment window c.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Set, Tuple

import torch

Point = Tuple[int, int]


class StepHook:
    def __init__(self, targets: Sequence[Tuple[str, str]], device):
        self.targets = [(importlib.import_module(m), a) for m, a in targets]
        self.device = torch.device(device)
        self.originals = {}
        self.shapes = None  # name -> (shape, dtype) of the params seen
        self.plan: Set[Point] = set()
        self.slots: Dict[Point, Dict[str, torch.Tensor]] = {}
        self.flats: List[torch.Tensor] = []  # one pinned buffer a slot
        self.taken: Set[Point] = set()
        self.losses: Dict[int, torch.Tensor] = {}
        self.armed = False
        self.steps: List[int] = []  # steps of each call of this sequence
        self.sequences: List[List[int]] = []  # steps by call, a sequence

    # -- installation --------------------------------------------------------

    def install(self) -> "StepHook":
        for module, attr in self.targets:
            orig = getattr(module, attr)
            self.originals[(module, attr)] = orig
            setattr(module, attr, self._wrap(orig))
        return self

    def remove(self) -> None:
        for (module, attr), orig in self.originals.items():
            setattr(module, attr, orig)
        self.originals.clear()

    # -- planning ------------------------------------------------------------

    def allocate(self, plan: Set[Point]) -> None:
        """Buffers for the points of ``plan``, shaped as the parameters
        seen so far (float32, as the port keeps them)."""
        if self.shapes is None:
            raise RuntimeError("no fine_tune call seen yet: warm up first")
        pin = self.device.type == "cuda"
        self.plan = set(plan)
        total = sum(s.numel() for s, _ in self.shapes.values())
        flats = list(self.flats)
        self.slots = {}
        while len(flats) < len(self.plan):
            flats.append(torch.empty(total, dtype=torch.float32,
                                     pin_memory=pin))
        self.flats = flats
        for point, flat in zip(sorted(self.plan), flats):
            slot, at = {}, 0
            for k, (shape, dtype) in self.shapes.items():
                n = shape.numel()
                slot[k] = flat[at:at + n].view(shape)
                at += n
            self.slots[point] = slot

    def begin_sequence(self, armed: bool) -> None:
        if self.steps:
            self.sequences.append(self.steps)
        self.steps = []
        self.armed = armed and bool(self.slots)

    def end_sequence(self) -> None:
        self.sequences.append(self.steps)
        self.steps = []
        self.armed = False

    # -- the stand-in --------------------------------------------------------

    def _snap(self, point: Point, params: Dict[str, torch.Tensor]) -> None:
        slot = self.slots[point]
        with torch.no_grad():
            for k, dst in slot.items():
                dst.copy_(params[k].detach(), non_blocking=True)
        self.taken.add(point)

    def _wrap(self, orig):
        hook = self

        def fine_tune(cfg, loss_fn, *args, **kwargs):
            c = len(hook.steps)
            hook.steps.append(0)
            label = "bench.fine_tune" if c == 0 else "bench.refit"

            def counted(params, batch):
                s = hook.steps[c]
                hook.steps[c] = s + 1
                if hook.shapes is None:
                    hook.shapes = {k: (v.shape, v.dtype)
                                   for k, v in params.items()}
                if hook.armed and (c, s) in hook.plan:
                    hook._snap((c, s), params)
                return loss_fn(params, batch)

            with torch.profiler.record_function(label):
                params, losses = orig(cfg, counted, *args, **kwargs)
            if hook.armed:
                point = (c, hook.steps[c])
                if point in hook.plan:
                    hook._snap(point, params)
                hook.losses[c] = losses.detach().clone()
            return params, losses

        return fine_tune

    # -- after the window ----------------------------------------------------

    def read(self) -> Dict[Point, Dict[str, torch.Tensor]]:
        """The points taken, as host tensors; call after a synchronize."""
        return {p: self.slots[p] for p in self.taken}

