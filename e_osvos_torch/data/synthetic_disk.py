"""DAVIS-2017- and YouTube-VOS-layout trees of synthetic sequences on disk,
port of ``e_osvos_tpu/data/synthetic_disk.py``.

The trees hold real JPEG frames and palette-PNG annotations, so the whole
user-facing protocol (files → index → decode → one-shot evaluation → PNG
export → J/F) runs as it would on DAVIS. The ``build_*`` functions write the same bytes
as the JAX package's:

* ``build_480p_tree``: 2 val sequences at 480x854, 67 frames each
  (``drift`` with one object, ``crossing`` with two), and with
  ``with_train`` 4 train sequences;
* ``build_ytvos_tree``: a YouTube-VOS ``valid/`` tree at three
  resolutions, with objects that enter mid-sequence;
* ``build_breadth_tree``: many sequences of 1-3 objects at six
  resolutions.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

# DAVIS 480p geometry, val-average sequence length
H480, W480, T480 = 480, 854, 67

_PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0] + [0] * 756


def _texture(rng, shade, h, w):
    """Low-frequency textured background so JPEG round-trips look like
    photographs rather than flat synthetic fills."""
    coarse = rng.randint(0, 255, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    img = np.asarray(
        Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.float32
    )
    return (0.35 * img + 0.65 * shade).astype(np.uint8)


def _blob_mask(cx, cy, rx, ry, angle, h, w):
    """Rotated-ellipse object mask (irregular boundary lengths exercise the
    boundary-F machinery more than axis-aligned squares)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ca, sa = np.cos(angle), np.sin(angle)
    u = (xx - cx) * ca + (yy - cy) * sa
    v = -(xx - cx) * sa + (yy - cy) * ca
    return (u / rx) ** 2 + (v / ry) ** 2 <= 1.0


def _write_sequence(root, seq, objs, rng, h, w, t_frames, quality=92):
    jd = os.path.join(root, "JPEGImages", "480p", seq)
    ad = os.path.join(root, "Annotations", "480p", seq)
    os.makedirs(jd)
    os.makedirs(ad)
    shade = rng.randint(60, 120, 3).astype(np.float32)
    for t in range(t_frames):
        img = _texture(rng, shade, h, w)
        lbl = np.zeros((h, w), np.uint8)
        for oid, o in enumerate(objs, start=1):
            m = _blob_mask(
                o["x0"] + o["dx"] * t, o["y0"] + o["dy"] * t,
                o["rx"] + o.get("drx", 0.0) * t, o["ry"], 0.03 * t, h, w,
            )
            for c in range(3):
                img[..., c] = np.where(
                    m,
                    (0.8 * o["color"][c] + 0.2 * img[..., c]).astype(np.uint8),
                    img[..., c],
                )
            lbl[m] = oid
        Image.fromarray(img).save(os.path.join(jd, f"{t:05d}.jpg"),
                                  quality=quality)
        im = Image.fromarray(lbl, mode="P")
        im.putpalette(_PALETTE)
        im.save(os.path.join(ad, f"{t:05d}.png"))


def build_480p_tree(root: str, with_train: bool = False) -> None:
    """The 2-val-sequence (+4 train) 480p protocol tree."""
    rng = np.random.RandomState(7)
    specs = {
        # one object, translating + slowly scaling
        "drift": [dict(color=(200, 60, 40), x0=140, y0=200, dx=8.0, dy=1.2,
                       rx=70, ry=45, drx=0.35)],
        # two objects crossing paths (multi-object merge + per-object OnA)
        "crossing": [
            dict(color=(40, 170, 220), x0=120, y0=130, dx=8.5, dy=2.4,
                 rx=55, ry=40, drx=0.0),
            dict(color=(230, 200, 50), x0=680, y0=330, dx=-7.5, dy=-1.8,
                 rx=48, ry=62, drx=0.2),
        ],
    }
    train_specs = {
        # detection-parent training sequences: DISJOINT colors/trajectories
        # from the val sequences above (the parent must generalize to the
        # val objects through the one-shot fine-tune, not memorize them)
        "tr_a": [dict(color=(90, 220, 90), x0=200, y0=150, dx=6.0, dy=3.0,
                      rx=60, ry=50, drx=0.2)],
        "tr_b": [dict(color=(180, 90, 200), x0=600, y0=300, dx=-6.5, dy=-2.0,
                      rx=45, ry=65, drx=0.0)],
        "tr_c": [
            dict(color=(240, 140, 40), x0=150, y0=320, dx=7.0, dy=-2.2,
                 rx=52, ry=42, drx=0.3),
            dict(color=(60, 60, 230), x0=700, y0=140, dx=-8.0, dy=2.6,
                 rx=58, ry=48, drx=0.1),
        ],
        "tr_d": [dict(color=(150, 150, 150), x0=420, y0=240, dx=4.0, dy=4.0,
                      rx=75, ry=38, drx=0.25)],
    }
    if with_train:
        specs = {**specs, **train_specs}
    for seq, objs in specs.items():
        _write_sequence(root, seq, objs, rng, H480, W480, T480)
    sets = os.path.join(root, "ImageSets", "2017")
    os.makedirs(sets)
    with open(os.path.join(sets, "val.txt"), "w") as f:
        f.write("drift\ncrossing\n")
    if with_train:
        with open(os.path.join(sets, "train.txt"), "w") as f:
            f.write("".join(s + "\n" for s in sorted(train_specs)))


def build_ytvos_tree(
    root: str,
    num_videos: int = 6,
    t_frames: int = 25,
    seed: int = 13,
) -> Dict[str, dict]:
    """YouTube-VOS-layout ``valid/`` tree at native heterogeneous
    resolutions: ``valid/JPEGImages/<video>/<stem>.jpg``,
    ``valid/Annotations/<video>/<stem>.png`` and ``meta.json`` with each
    object's frames. What sets YouTube-VOS apart:

    * timestamp stems at the real 5-frame annotation stride rather than
      dense DAVIS indices;
    * objects appearing mid-sequence: every odd video's second object is
      first annotated at stem index 2, so it gets its own support frame
      and object group;
    * three native resolutions: (480,854) and (452,838) share the
      (512,896) bucket under ``eval_pad_multiple=64``; (384,640) buckets
      to itself.

    Returns {video: {"hw": (h,w), "objects": n, "entry_frames": {oid: t}}}.
    """
    rng = np.random.RandomState(seed)
    resolutions = [(480, 854), (452, 838), (384, 640)]
    base = os.path.join(root, "valid")
    meta: Dict[str, dict] = {"videos": {}}
    out: Dict[str, dict] = {}
    stems = [f"{5 * t:05d}" for t in range(t_frames)]
    for s in range(num_videos):
        h, w = resolutions[s % len(resolutions)]
        # odd videos: 2 objects, the second entering at stem index 2
        entry = {1: 0} if s % 2 == 0 else {1: 0, 2: 2}
        objs = {}
        for oid, first in entry.items():
            rx = rng.randint(w // 14, w // 9)
            ry = rng.randint(h // 13, h // 8)
            x0 = rng.randint(w // 4, 3 * w // 4)
            y0 = rng.randint(h // 4, 3 * h // 4)
            objs[oid] = dict(
                color=tuple(int(c) for c in rng.randint(30, 240, 3)),
                x0=x0, y0=y0,
                dx=float(rng.uniform(-4, 4)), dy=float(rng.uniform(-2, 2)),
                rx=rx, ry=ry, first=first,
            )
        name = f"video{s:02d}_{h}x{w}"
        jd = os.path.join(base, "JPEGImages", name)
        ad = os.path.join(base, "Annotations", name)
        os.makedirs(jd)
        os.makedirs(ad)
        shade = rng.randint(60, 120, 3).astype(np.float32)
        for t, stem in enumerate(stems):
            img = _texture(rng, shade, h, w)
            lbl = np.zeros((h, w), np.uint8)
            for oid, o in sorted(objs.items()):
                if t < o["first"]:
                    continue
                m = _blob_mask(
                    o["x0"] + o["dx"] * t, o["y0"] + o["dy"] * t,
                    o["rx"], o["ry"], 0.03 * t, h, w,
                )
                for c in range(3):
                    img[..., c] = np.where(
                        m,
                        (0.8 * o["color"][c]
                         + 0.2 * img[..., c]).astype(np.uint8),
                        img[..., c],
                    )
                lbl[m] = oid
            Image.fromarray(img).save(os.path.join(jd, stem + ".jpg"),
                                      quality=92)
            im = Image.fromarray(lbl, mode="P")
            im.putpalette(_PALETTE)
            im.save(os.path.join(ad, stem + ".png"))
        meta["videos"][name] = {
            "objects": {
                str(oid): {"frames": stems[o["first"]:]}
                for oid, o in objs.items()
            }
        }
        out[name] = {"hw": (h, w), "objects": len(objs),
                     "entry_frames": {oid: o["first"]
                                      for oid, o in objs.items()}}
    import json as _json

    with open(os.path.join(base, "meta.json"), "w") as f:
        _json.dump(meta, f)
    return out


def build_breadth_tree(
    root: str,
    num_sequences: int = 10,
    t_frames: int = 25,
    seed: int = 11,
) -> Dict[str, dict]:
    """Breadth tree: ``num_sequences`` val sequences with 1-3 objects
    each across six native resolutions, chosen so that with
    ``eval_pad_multiple=64`` they land in two buckets:

      (480, 854), (476, 850), (452, 838)  →  (512, 896)
      (384, 640), (380, 636), (360, 632)  →  (384, 640)

    Returns {seq: {"hw": (h, w), "objects": n}}: 6 native shapes x 3
    object counts, 18 shape combinations, in 2 buckets x 3 object counts.
    """
    rng = np.random.RandomState(seed)
    resolutions = [(480, 854), (476, 850), (452, 838),
                   (384, 640), (380, 636), (360, 632)]
    meta: Dict[str, dict] = {}
    names = []
    for s in range(num_sequences):
        h, w = resolutions[s % len(resolutions)]
        n_obj = 1 + (s % 3)
        objs = []
        for k in range(n_obj):
            rx = rng.randint(w // 16, w // 9)
            ry = rng.randint(h // 14, h // 8)
            x0 = rng.randint(w // 5, 4 * w // 5)
            y0 = rng.randint(h // 4, 3 * h // 4)
            # velocity bounded so the object stays in frame for t_frames
            dx = rng.uniform(-1.0, 1.0) * min(
                (w - rx - x0) if rng.rand() < 0.5 else (x0 - rx), w
            ) / max(t_frames, 1)
            dy = rng.uniform(-0.5, 0.5) * h / 10 / max(t_frames, 1)
            objs.append(dict(
                color=tuple(int(c) for c in rng.randint(30, 240, 3)),
                x0=x0, y0=y0, dx=float(np.clip(dx, -8, 8)), dy=float(dy),
                rx=rx, ry=ry, drx=float(rng.uniform(0, 0.2)),
            ))
        name = f"b{s:02d}_{h}x{w}_o{n_obj}"
        _write_sequence(root, name, objs, rng, h, w, t_frames)
        meta[name] = {"hw": (h, w), "objects": n_obj}
        names.append(name)
    sets = os.path.join(root, "ImageSets", "2017")
    os.makedirs(sets)
    with open(os.path.join(sets, "val.txt"), "w") as f:
        f.write("".join(n + "\n" for n in names))
    return meta
