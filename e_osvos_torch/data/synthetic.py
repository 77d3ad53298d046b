"""Synthetic "moving shapes" VOS fixture, a copy of
``e_osvos_tpu/data/synthetic.py`` that gives bit-identical frames and labels
for the same arguments (numpy only).

An in-memory dataset with the VOS indexer interface (``sequences``,
``get_image``, ``get_label``): colored shapes translating over a textured
background, object ids 1..K in the label maps, so the whole fine-tune →
propagate pipeline runs without a dataset on disk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from e_osvos_torch.data.datasets import VOSSequence, _groups_for_ids


def _draw_square(label: np.ndarray, img: np.ndarray, cy: int, cx: int,
                 half: int, obj_id: int, color: np.ndarray) -> None:
    h, w = label.shape
    y0, y1 = max(cy - half, 0), min(cy + half, h)
    x0, x1 = max(cx - half, 0), min(cx + half, w)
    if y1 > y0 and x1 > x0:
        label[y0:y1, x0:x1] = obj_id
        img[y0:y1, x0:x1] = color


def _paint(label: np.ndarray, img: np.ndarray, mask: np.ndarray,
           obj_id: int, color: np.ndarray) -> None:
    label[mask] = obj_id
    img[mask] = color


def _ellipse_mask(h: int, w: int, cy: float, cx: float, ry: float, rx: float,
                  angle: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ca, sa = np.cos(angle), np.sin(angle)
    u = (xx - cx) * ca + (yy - cy) * sa
    v = -(xx - cx) * sa + (yy - cy) * ca
    return (u / max(rx, 1.0)) ** 2 + (v / max(ry, 1.0)) ** 2 <= 1.0


def _triangle_mask(h: int, w: int, cy: float, cx: float, r: float,
                   angle: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    inside = np.ones((h, w), bool)
    for k in range(3):
        a = angle + 2.0 * np.pi * k / 3.0
        # vertex at (cy + r sin a, cx + r cos a); half-plane through the
        # opposite edge
        ny, nx = np.sin(a), np.cos(a)
        inside &= (yy - cy) * ny + (xx - cx) * nx <= r * 0.5
    return inside


class SyntheticVOSIndex:
    """In-memory moving-squares dataset with the VOS indexer interface."""

    def __init__(
        self,
        num_sequences: int = 2,
        num_frames: int = 4,
        size: Tuple[int, int] = (64, 64),
        num_objects: int = 1,
        multi_object: str = "single_id",
        seed: int = 0,
        name_prefix: str = "seq",
        distractors: int = 0,
        occluders: int = 0,
        contrast: float = 1.0,
    ):
        """``distractors``/``occluders``/``contrast`` build the HARD variant,
        where a random init cannot coast on color separability:

        * targets become rotated ellipses; each target gets ``distractors``
          SAME-COLOR background shapes (squares/triangles, label 0) moving
          independently — a model that keys on color alone segments target
          and distractor alike and lands near J≈1/(1+distractors);
        * ``occluders`` texture-colored bars sweep across the frame ABOVE
          everything (GT goes to 0 where a target is covered — the object
          is not visible), entering from the border so the support frame
          stays clean;
        * ``contrast`` < 1 pulls object colors toward the background mean.
        """
        rng = np.random.RandomState(seed)
        h, w = size
        hard = distractors > 0 or occluders > 0 or contrast != 1.0
        self.sequences: Dict[str, VOSSequence] = {}
        self._images: Dict[str, List[np.ndarray]] = {}
        self._labels: Dict[str, List[Optional[np.ndarray]]] = {}

        for s in range(num_sequences):
            name = f"{name_prefix}{s:02d}"
            imgs, labels = [], []
            # background: smooth random gradient texture
            bg = (
                rng.randint(40, 160, (3,))[None, None, :]
                + np.linspace(0, 60, w)[None, :, None]
                + np.linspace(0, 40, h)[:, None, None]
            ).astype(np.float32)
            starts = [
                (rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4))
                for _ in range(num_objects)
            ]
            vels = [
                (rng.randint(-3, 4), rng.randint(-3, 4)) for _ in range(num_objects)
            ]
            colors = [rng.randint(0, 255, (3,)).astype(np.float32)
                      for _ in range(num_objects)]
            half = max(min(h, w) // 8, 3)
            if hard:
                bg_mean = bg.mean(axis=(0, 1))
                colors = [bg_mean + contrast * (c - bg_mean) for c in colors]
                # per-target distractor specs: same color, different shape
                dspecs = []
                for k in range(num_objects):
                    for d in range(distractors):
                        dspecs.append(dict(
                            color=colors[k],
                            shape="triangle" if (k + d) % 2 else "square",
                            cy=float(rng.randint(h // 6, 5 * h // 6)),
                            cx=float(rng.randint(w // 6, 5 * w // 6)),
                            vy=float(rng.randint(-3, 4)),
                            vx=float(rng.randint(-3, 4)),
                            r=half * rng.uniform(0.9, 1.2),
                            spin=rng.uniform(-0.08, 0.08),
                        ))
                ospecs = []
                for o in range(occluders):
                    vertical = bool(rng.randint(2))
                    extent = w if vertical else h
                    ospecs.append(dict(
                        vertical=vertical,
                        width=max(min(h, w) // 10, 2),
                        # enter from the border AFTER t=0, sweep across
                        pos0=-float(max(min(h, w) // 10, 2)),
                        vel=extent / max(num_frames - 1, 1) * rng.uniform(0.7, 1.0),
                        color=np.clip(
                            bg_mean + rng.normal(0, 25, 3), 0, 255
                        ).astype(np.float32),
                    ))
                angs = [rng.uniform(0, np.pi) for _ in range(num_objects)]
                spins = [rng.uniform(-0.06, 0.06) for _ in range(num_objects)]
                ecc = [rng.uniform(0.55, 0.8) for _ in range(num_objects)]
            for t in range(num_frames):
                img = bg + rng.normal(0, 3, (h, w, 3)).astype(np.float32)
                label = np.zeros((h, w), np.uint8)
                if hard:
                    # distractors below targets; occluders above everything
                    for d in dspecs:
                        cy, cx = d["cy"] + d["vy"] * t, d["cx"] + d["vx"] * t
                        if d["shape"] == "triangle":
                            m = _triangle_mask(h, w, cy, cx, 1.6 * d["r"],
                                               d["spin"] * t)
                        else:
                            m = _ellipse_mask(h, w, cy, cx, d["r"], d["r"],
                                              d["spin"] * t)  # disc
                        _paint(label, img, m, 0, d["color"])
                    for k in range(num_objects):
                        cy = starts[k][0] + vels[k][0] * t
                        cx = starts[k][1] + vels[k][1] * t
                        m = _ellipse_mask(h, w, cy, cx, half * ecc[k],
                                          half * 1.25, angs[k] + spins[k] * t)
                        _paint(label, img, m, k + 1, colors[k])
                    for o in ospecs:
                        p = int(round(o["pos0"] + o["vel"] * t))
                        lo, hi = max(p, 0), max(p + o["width"], 0)
                        if o["vertical"]:
                            sl = (slice(None), slice(lo, hi))
                        else:
                            sl = (slice(lo, hi), slice(None))
                        img[sl] = o["color"]
                        label[sl] = 0
                else:
                    for k in range(num_objects):
                        cy = starts[k][0] + vels[k][0] * t
                        cx = starts[k][1] + vels[k][1] * t
                        _draw_square(label, img, cy, cx, half, k + 1, colors[k])
                imgs.append(np.clip(img, 0, 255).astype(np.uint8))
                labels.append(label)
            ids = list(range(1, num_objects + 1))
            groups = _groups_for_ids(ids, 0, multi_object)
            self.sequences[name] = VOSSequence(
                name=name,
                image_paths=[f"<mem>/{name}/{t:05d}.jpg" for t in range(num_frames)],
                label_paths=[f"<mem>/{name}/{t:05d}.png" for t in range(num_frames)],
                object_groups=groups,
                num_objects=num_objects,
            )
            self._images[name] = imgs
            self._labels[name] = labels

    def get_image(self, seq: str, idx: int) -> np.ndarray:
        return self._images[seq][idx]

    def get_label(self, seq: str, idx: int) -> Optional[np.ndarray]:
        return self._labels[seq][idx]
