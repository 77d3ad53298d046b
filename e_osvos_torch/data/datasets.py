"""Dataset index types, port of the subset of ``e_osvos_tpu/data/datasets.py``
that the one-shot path needs (no image decoding).

Object-group model:
  * ``multi_object='all'`` → one group containing every object id,
    binarized to a single fg/bg problem;
  * ``multi_object='single_id'`` → one group per object id, each fine-tuned
    and propagated separately.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence as Seq, Tuple

import numpy as np


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
