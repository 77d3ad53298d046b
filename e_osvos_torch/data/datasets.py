"""Dataset indexes for DAVIS-2016/2017 and YouTube-VOS layouts on disk, port
of ``e_osvos_tpu/data/datasets.py``.

An index maps a sequence to its frame and label paths and its object
groups; decoding is stateless (``load_image``, ``load_label``), natively
(``data/native.py``) where the library builds, else with PIL.

Object-group model:
  * ``multi_object='all'`` → one group containing every object id,
    binarized to a single fg/bg problem;
  * ``multi_object='single_id'`` → one group per object id, each fine-tuned
    and propagated separately (the DAVIS-2017 / YouTube-VOS protocol).

In YouTube-VOS objects appear mid-sequence, so each object group carries
its own support frame.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
from PIL import Image

from e_osvos_torch.data import native

# the benchmark protocol's sequence lists shipped with the repo
# (data/<dataset>/<split>_seqs.txt): DAVIS-2016/2017 train/val/test-dev and
# the YouTube-VOS train_dev_random_123 splits. Protocol data, not code.
SPLIT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "data",
)


def shipped_split_path(dataset: str, split: str) -> Optional[str]:
    """Path of a repo-shipped split list (``data/<dataset>/<split>_seqs.txt``)
    or None. ``dataset`` ∈ {DAVIS-2016, DAVIS-2017, YouTube-VOS}."""
    p = os.path.join(SPLIT_DIR, dataset, f"{split}_seqs.txt")
    return p if os.path.exists(p) else None


@dataclasses.dataclass(frozen=True)
class ObjectGroup:
    """One fine-tune/propagate unit: a set of object ids sharing a support
    frame."""

    object_ids: Tuple[int, ...]
    support_frame: int  # frame index holding GT for these objects


@dataclasses.dataclass
class VOSSequence:
    """Index entry for one video."""

    name: str
    image_paths: List[str]
    label_paths: List[Optional[str]]  # None where no annotation exists
    object_groups: List[ObjectGroup]
    num_objects: int

    def __len__(self) -> int:
        return len(self.image_paths)


def _native():
    """The native decoder module when its library is available, else
    None."""
    return native if native.available() else None


def decoder() -> str:
    """The decoder ``load_image`` and ``load_label`` use: ``native`` or
    ``PIL``."""
    return "native" if _native() is not None else "PIL"


def load_image(path: str) -> np.ndarray:
    """JPEG/PNG → RGB uint8 [H,W,3], natively for JPEGs where the library
    is available, else with PIL."""
    nat = _native()
    if nat is not None and path.lower().endswith((".jpg", ".jpeg")):
        try:
            return nat.decode_jpeg(path)
        except IOError:
            pass
    return np.asarray(Image.open(path).convert("RGB"))


def load_label(path: str) -> np.ndarray:
    """Indexed PNG → uint8 object-id map (palette indices are the ids)."""
    nat = _native()
    if nat is not None:
        try:
            return nat.decode_png_indexed(path)
        except IOError:
            pass
    return np.asarray(Image.open(path), dtype=np.uint8)


def binarize_label(label: np.ndarray, object_ids: Seq[int],
                   keep_ignore: bool = True) -> np.ndarray:
    """Id map → {0, 1, 255} uint8 mask for one object group: group ids → 1,
    ignore (255) stays 255 when ``keep_ignore``, everything else → 0."""
    out = np.isin(label, np.asarray(object_ids)).astype(np.uint8)
    if keep_ignore:
        out = np.where(label == 255, np.uint8(255), out)
    return out


def _groups_for_ids(ids: Seq[int], support_frame: int, multi_object: str
                    ) -> List[ObjectGroup]:
    if not ids:
        # unannotated/background-only: one empty group
        return [ObjectGroup(object_ids=(), support_frame=support_frame)]
    if multi_object == "all":
        return [ObjectGroup(object_ids=tuple(ids), support_frame=support_frame)]
    if multi_object == "single_id":
        return [ObjectGroup(object_ids=(i,), support_frame=support_frame)
                for i in ids]
    raise ValueError(f"unknown multi_object mode {multi_object!r}")


def _object_ids_from_label(label: np.ndarray) -> List[int]:
    ids = np.unique(label)
    return [int(i) for i in ids if i not in (0, 255)]


class DAVISIndex:
    """DAVIS-2016/2017 layout: ``JPEGImages/<res>/<seq>/*.jpg``,
    ``Annotations/<res>/<seq>/*.png``, ``ImageSets/<year>/<split>.txt``."""

    def __init__(self, root: str, split: str = "val", year: str = "2017",
                 resolution: str = "480p", multi_object: str = "single_id",
                 sequences: Optional[Seq[str]] = None):
        self.root = root
        self.year = year
        self.resolution = resolution
        self.multi_object = multi_object
        if sequences is None:
            sequences = self._read_split(split)
        self.sequences: Dict[str, VOSSequence] = {
            name: self._index_sequence(name) for name in sequences}

    def _read_split(self, split: str) -> List[str]:
        # the dataset root's layouts first, then the repo's protocol lists
        candidates = [
            os.path.join(self.root, "ImageSets", self.year, f"{split}.txt"),
            os.path.join(self.root, "ImageSets", self.resolution,
                         f"{split}.txt"),
            os.path.join(self.root, f"{split}.txt"),
            os.path.join(self.root, f"{split}_seqs.txt"),
            shipped_split_path(f"DAVIS-{self.year}", split) or "",
        ]
        for c in candidates:
            if os.path.exists(c):
                with open(c) as f:
                    names = sorted(
                        {ln.strip().split("/")[-2] if "/" in ln else ln.strip()
                         for ln in f if ln.strip()})
                return [n for n in names if n]
        raise FileNotFoundError(
            f"no split file for {split!r} under {self.root}")

    def _index_sequence(self, name: str) -> VOSSequence:
        img_dir = os.path.join(self.root, "JPEGImages", self.resolution, name)
        ann_dir = os.path.join(self.root, "Annotations", self.resolution, name)
        frames = sorted(f for f in os.listdir(img_dir)
                        if f.endswith((".jpg", ".png")))
        image_paths = [os.path.join(img_dir, f) for f in frames]
        label_paths: List[Optional[str]] = []
        for f in frames:
            p = os.path.join(ann_dir, os.path.splitext(f)[0] + ".png")
            label_paths.append(p if os.path.exists(p) else None)
        if label_paths[0] is None:
            raise FileNotFoundError(
                f"first-frame annotation missing for {name}")
        first = load_label(label_paths[0])
        ids = _object_ids_from_label(first)
        if not ids and first.max() > 0 and self.year == "2016":
            ids = [255]  # DAVIS-2016 binary masks use 255 as foreground
        return VOSSequence(
            name=name, image_paths=image_paths, label_paths=label_paths,
            object_groups=_groups_for_ids(ids, 0, self.multi_object),
            num_objects=len(ids))

    def get_image(self, seq: str, idx: int) -> np.ndarray:
        return load_image(self.sequences[seq].image_paths[idx])

    def get_label(self, seq: str, idx: int) -> Optional[np.ndarray]:
        p = self.sequences[seq].label_paths[idx]
        return None if p is None else load_label(p)


class YouTubeVOSIndex:
    """YouTube-VOS layout: ``<split>/JPEGImages/<seq>/*.jpg``,
    ``<split>/Annotations/<seq>/*.png`` and a ``meta.json`` with each
    object's annotated frames."""

    def __init__(self, root: str, split: str = "valid",
                 multi_object: str = "single_id",
                 sequences: Optional[Seq[str]] = None):
        self.root = root
        self.split = split
        self.multi_object = multi_object
        # derived splits such as 'train_dev_random_123_{train,val}' live in
        # the train directory and are defined by the repo's sequence lists
        subdir = split
        if sequences is None:
            shipped = shipped_split_path("YouTube-VOS", split)
            if shipped is not None and split not in os.listdir(root):
                sequences = read_split_file(shipped)
                subdir = "train" if split.startswith("train") else split
        base = os.path.join(root, subdir)
        with open(os.path.join(base, "meta.json")) as f:
            meta = json.load(f)["videos"]
        names = sequences if sequences is not None else sorted(meta)
        self.sequences: Dict[str, VOSSequence] = {
            name: self._index_sequence(base, name, meta[name])
            for name in names}

    def _index_sequence(self, base: str, name: str, meta: dict
                        ) -> VOSSequence:
        img_dir = os.path.join(base, "JPEGImages", name)
        ann_dir = os.path.join(base, "Annotations", name)
        frames = sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir)
                        if f.endswith(".jpg"))
        frame_pos = {f: i for i, f in enumerate(frames)}
        image_paths = [os.path.join(img_dir, f + ".jpg") for f in frames]
        label_paths: List[Optional[str]] = []
        for f in frames:
            p = os.path.join(ann_dir, f + ".png")
            label_paths.append(p if os.path.exists(p) else None)

        # each object's first annotated frame; in 'all' mode the objects
        # sharing a first frame form one group
        obj_first: Dict[int, int] = {}
        for obj_id, obj_meta in meta["objects"].items():
            first = obj_meta["frames"][0]
            if first in frame_pos:
                obj_first[int(obj_id)] = frame_pos[first]
        groups: List[ObjectGroup] = []
        if self.multi_object == "single_id":
            for oid, fidx in sorted(obj_first.items()):
                groups.append(ObjectGroup(object_ids=(oid,),
                                          support_frame=fidx))
        else:
            by_frame: Dict[int, List[int]] = {}
            for oid, fidx in obj_first.items():
                by_frame.setdefault(fidx, []).append(oid)
            for fidx in sorted(by_frame):
                groups.append(ObjectGroup(
                    object_ids=tuple(sorted(by_frame[fidx])),
                    support_frame=fidx))
        return VOSSequence(name=name, image_paths=image_paths,
                           label_paths=label_paths, object_groups=groups,
                           num_objects=len(obj_first))

    def get_image(self, seq: str, idx: int) -> np.ndarray:
        return load_image(self.sequences[seq].image_paths[idx])

    def get_label(self, seq: str, idx: int) -> Optional[np.ndarray]:
        p = self.sequences[seq].label_paths[idx]
        return None if p is None else load_label(p)


def read_split_file(path: str) -> List[str]:
    """A newline-separated sequence list."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class PreloadedIndex:
    """Wraps any index and decodes every frame and label once, serving them
    from memory (small evaluation splits, where decoding again would hold
    up the host)."""

    def __init__(self, index):
        self._index = index
        self.sequences = index.sequences
        self._images: Dict[Tuple[str, int], np.ndarray] = {}
        self._labels: Dict[Tuple[str, int], Optional[np.ndarray]] = {}
        for name, seq in index.sequences.items():
            for t in range(len(seq)):
                self._images[(name, t)] = index.get_image(name, t)
                self._labels[(name, t)] = index.get_label(name, t)

    def get_image(self, seq: str, idx: int) -> np.ndarray:
        return self._images[(seq, idx)]

    def get_label(self, seq: str, idx: int) -> Optional[np.ndarray]:
        return self._labels[(seq, idx)]
