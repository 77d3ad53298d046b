"""The traffic of a cell: a pool of synthetic video sequences made from
the seed, which the window (``harness/window.py``) walks as one
closed-loop client.

A mix (``traffic/<name>.json``) gives the sequences' shape (objects,
frames, height, width), the pool's size and the scene's parameters. Each
sequence is a textured gradient background with sensor noise and
``objects`` coloured squares moving at constant speed, reflected at the
frame's edges so that every object stays in view; object k is id k + 1 in
the label maps, frame 0 is the annotated support frame. The scene follows
the port's ``data/synthetic.py`` moving-squares fixture; it is made on the
device in a few calls and kept in host memory, where the timed path
stages it from. A sequence's work does not depend on its pixels: the seed
moves values, not work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ObjectGroup:
    object_ids: Tuple[int, ...]
    support_frame: int


@dataclasses.dataclass
class Sequence:
    name: str
    object_groups: List[ObjectGroup]
    num_objects: int
    num_frames: int

    def __len__(self) -> int:
        return self.num_frames


class PoolIndex:
    """The port's index interface (``sequences``, ``get_image``,
    ``get_label``) over frames held in host memory: one object group an
    object (the DAVIS-2017 ``single_id`` protocol), support frame 0."""

    def __init__(self, frames: np.ndarray, labels: np.ndarray,
                 objects: int, prefix: str = "seq"):
        self.frames, self.labels = frames, labels  # [P, T, H, W(, 3)]
        self.sequences: Dict[str, Sequence] = {}
        self.names: List[str] = []
        for p in range(frames.shape[0]):
            name = f"{prefix}{p:02d}"
            groups = [ObjectGroup((k + 1,), 0) for k in range(objects)]
            self.sequences[name] = Sequence(name, groups, objects,
                                            frames.shape[1])
            self.names.append(name)

    def position(self, name: str) -> int:
        return self.names.index(name)

    def get_image(self, seq: str, idx: int) -> np.ndarray:
        return self.frames[self.position(seq), idx]

    def get_label(self, seq: str, idx: int) -> Optional[np.ndarray]:
        return self.labels[self.position(seq), idx]

    def truncated(self, frames: int, prefix: str) -> "PoolIndex":
        """The first ``frames`` frames of the pool's first sequence, as an
        index of its own (the warm-up's sequence)."""
        objects = self.sequences[self.names[0]].num_objects
        return PoolIndex(self.frames[:1, :frames], self.labels[:1, :frames],
                         objects, prefix)


def _reflect(pos: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Positions moving on a line, reflected into ``[lo, hi]``."""
    span = hi - lo
    phase = torch.remainder(pos - lo, 2 * span)
    return lo + torch.where(phase > span, 2 * span - phase, phase)


def make_pool(mix: dict, seed: int, device) -> PoolIndex:
    """The mix's pool of sequences from ``seed``, made on ``device`` and
    kept on the host. The same seed gives the same pool."""
    P, T = int(mix["pool"]), int(mix["frames"])
    H, W, K = int(mix["height"]), int(mix["width"]), int(mix["objects"])
    scene = mix["scene"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    half = max(int(min(H, W) * scene["square_frac"]), 3)
    base = uniform((P, 1, 1, 3), *scene["base_rgb"]).floor()
    ramp = (torch.linspace(0, scene["ramp_x"], W, device=device)[None, :, None]
            + torch.linspace(0, scene["ramp_y"], H, device=device)[:, None, None])
    start_y = uniform((P, K), H / 4, 3 * H / 4).floor()
    start_x = uniform((P, K), W / 4, 3 * W / 4).floor()
    vmax = float(scene["speed_max"])
    vel_y = uniform((P, K), -vmax, vmax + 1).floor()
    vel_x = uniform((P, K), -vmax, vmax + 1).floor()
    colors = uniform((P, K, 3), 0, 255).floor()
    t = torch.arange(T, device=device, dtype=torch.float32)
    ys = torch.arange(H, device=device, dtype=torch.float32)
    xs = torch.arange(W, device=device, dtype=torch.float32)
    frames = np.empty((P, T, H, W, 3), np.uint8)
    labels = np.empty((P, T, H, W), np.uint8)
    for p in range(P):
        img = (base[p] + ramp)[None].expand(T, H, W, 3) + scene["noise_std"] \
            * torch.randn((T, H, W, 3), generator=gen, device=device)
        lab = torch.zeros((T, H, W), dtype=torch.uint8, device=device)
        for k in range(K):
            cy = _reflect(start_y[p, k] + vel_y[p, k] * t, half, H - half)
            cx = _reflect(start_x[p, k] + vel_x[p, k] * t, half, W - half)
            cy, cx = cy.round(), cx.round()
            inside = (((ys[None, :] >= cy[:, None] - half)
                       & (ys[None, :] < cy[:, None] + half))[:, :, None]
                      & ((xs[None, :] >= cx[:, None] - half)
                         & (xs[None, :] < cx[:, None] + half))[:, None, :])
            lab[inside] = k + 1
            img = torch.where(inside[..., None], colors[p, k], img)
        frames[p] = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
        labels[p] = lab.cpu().numpy()
    return PoolIndex(frames, labels, K)

