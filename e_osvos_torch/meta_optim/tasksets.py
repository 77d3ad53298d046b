"""Host-side meta-task sampling into fixed-shape task batches, a copy of
``e_osvos_tpu/meta_optim/tasksets.py`` (plain numpy; for the same seed it
gives the same ``TaskBatch``, bit for bit).

A task is one (sequence, object group) pair: fine-tune on a support frame,
take the meta (query) loss on sampled query frames. ``MetaTaskset`` samples
``TaskSpec``s (support frame, query frames within an optional epsilon
window, label flip / no-label randomization, copy-paste distractors from
single-object sequences) and materializes them as a ``TaskBatch`` of
static-shape numpy arrays, pad + random-cropped on the host. Augmentation
happens later, on the device, from each task's seed
(``parallel/meta_step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from e_osvos_torch.data.datasets import ObjectGroup, binarize_label


class TaskSpec(NamedTuple):
    """One meta-task: fine-tune on ``support_frame`` of ``seq`` for the given
    object ids, evaluate the meta (query) loss on ``query_frames``.

    ``donor``: optional (seq_name, object_ids) of another sequence whose
    object is copy-pasted over every frame of this task as an occluding
    distractor (AUGMENT_SINGLE/AUGMENT_ALL single-object modes,
    meta_tasksets.py:79-96 → vos_dataset.py:346-431)."""

    seq: str
    object_ids: Tuple[int, ...]
    support_frame: int
    query_frames: Tuple[int, ...]
    flip_label: bool
    no_label: bool
    seed: int
    donor: Optional[Tuple[str, Tuple[int, ...]]] = None


class TaskBatch(NamedTuple):
    """Static-shape batch of tasks (leading axis = task), ready for upload.

    Images are raw RGB float32 in [0, 255] (normalization happens inside the
    loss, after on-device augmentation). Labels are int32 {0,1,255}.
    ``seeds`` are per-task seeds of the task's random draws.
    """

    support_img: np.ndarray  # [B, H, W, 3]
    support_label: np.ndarray  # [B, H, W]
    query_imgs: np.ndarray  # [B, Q, H, W, 3]
    query_labels: np.ndarray  # [B, Q, H, W]
    seeds: np.ndarray  # [B] uint32


@dataclasses.dataclass
class MetaTasksetConfig:
    """Sampling knobs, mirroring the reference's task randomization flags
    (cfgs/meta.yaml:16-22, 100-103; meta_tasksets.py:36-50,100-150)."""

    num_query_frames: int = 1
    crop_size: Tuple[int, int] = (480, 480)
    # epsilon window: sample query frames within ±epsilon of the support
    # frame (None = whole sequence), meta_tasksets.py:100-102
    random_frame_epsilon: Optional[int] = None
    # random support frame instead of frame 0 (frame_ids.train='random')
    random_support_frame: bool = True
    random_flip_label: bool = False
    random_no_label: bool = False
    # single-object-sequence handling (KEEP / IGNORE / ONLY /
    # AUGMENT_SINGLE / AUGMENT_ALL), meta_tasksets.py:36-50,79-96; the
    # AUGMENT modes paste a donor sequence's object over the task's frames
    # (paste_distractor below)
    single_obj_seq_mode: str = "KEEP"
    # random subsets of object ids within a group (meta_tasksets.py:71-77)
    random_object_id_sub_group: bool = False


def paste_distractor(
    img: np.ndarray,
    label: np.ndarray,
    donor_img: np.ndarray,
    donor_mask: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Copy-paste a donor object over (img, label) as an occluding distractor.

    Semantics re-derived from the reference compositor (vos_dataset.py:
    346-431): the donor object's bounding-box crop — shrunk (centered) to at
    most the current object's box size — is pasted with its top-left at the
    current object's box center; pasted pixels take the donor's RGB and
    become label 0 (the distractor is *background*, making the fine-tune
    task discriminate the true object from a look-alike occluder). If either
    mask is empty the label is zeroed (the reference's has_label fallback);
    if pasting would erase the entire current object, the paste is skipped.

    ``img`` [H,W,3] float32, ``label`` [H,W] int {0,1,255},
    ``donor_img`` [h,w,3], ``donor_mask`` [h,w] bool. Returns new (img,
    label); inputs are not mutated.
    """
    img = img.copy()
    label = label.copy()
    cur = label == 1
    if not cur.any() or not donor_mask.any():
        label[...] = 0
        return img, label

    dy, dx = np.where(donor_mask)
    d_y0, d_y1 = dy.min(), dy.max() + 1
    d_x0, d_x1 = dx.min(), dx.max() + 1
    cy, cx = np.where(cur)
    c_y0, c_y1 = cy.min(), cy.max() + 1
    c_x0, c_x1 = cx.min(), cx.max() + 1

    # shrink the donor box (centered) to at most the current box size
    def _shrink(a0, a1, limit):
        size = a1 - a0
        crop = min(size, limit)
        pad = (size - crop) // 2
        return a0 + pad, a0 + pad + crop

    d_y0, d_y1 = _shrink(d_y0, d_y1, c_y1 - c_y0)
    d_x0, d_x1 = _shrink(d_x0, d_x1, c_x1 - c_x0)
    patch_img = donor_img[d_y0:d_y1, d_x0:d_x1]
    patch_mask = donor_mask[d_y0:d_y1, d_x0:d_x1]

    # paste with top-left at the current object's box center, clipped
    py = c_y0 + (c_y1 - c_y0) // 2
    px = c_x0 + (c_x1 - c_x0) // 2
    h = min(label.shape[0] - py, patch_img.shape[0])
    w = min(label.shape[1] - px, patch_img.shape[1])
    if h <= 0 or w <= 0:
        return img, label
    paste = np.zeros_like(donor_mask, shape=label.shape)
    paste[py : py + h, px : px + w] = patch_mask[:h, :w]

    new_label = label.copy()
    new_label[paste] = 0
    if not (new_label == 1).any():  # paste would erase the whole object
        return img, label
    img[paste] = patch_img[:h, :w][patch_mask[:h, :w]]
    return img, new_label


class MetaTaskset:
    """Samples TaskSpecs from one or more dataset indexes and assembles
    fixed-shape TaskBatches.

    ``indexes``: list of dataset indexers (DAVISIndex / YouTubeVOSIndex /
    SyntheticVOSIndex — anything with ``.sequences``, ``.get_image``,
    ``.get_label``). Multiple indexes reproduce the reference's
    ConcatDataset over DAVIS+YT-VOS (meta_run.py:51-71).
    """

    def __init__(self, indexes: Sequence, cfg: MetaTasksetConfig, seed: int = 0):
        self.indexes = list(indexes)
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        # flat list of (index, seq_name, group) task units
        self.units: List[Tuple[int, str, ObjectGroup]] = []
        # donor pool for the AUGMENT modes: single-object sequences whose
        # lone object gets copy-pasted over other tasks' frames. (The
        # reference's donor list is gated the other way round — an apparent
        # upstream slip at meta_tasksets.py:36-48; the intended and
        # documented semantics, "augment with single object sequence"
        # vos_dataset.py:346, pastes a SINGLE object.)
        self.single_obj_seqs: List[Tuple[str, Tuple[int, ...]]] = []
        for ii, index in enumerate(self.indexes):
            for name, seq in index.sequences.items():
                single_obj = len(seq.object_groups) == 1
                if single_obj and seq.object_groups[0].object_ids:
                    self.single_obj_seqs.append(
                        (name, seq.object_groups[0].object_ids)
                    )
                if cfg.single_obj_seq_mode == "IGNORE" and single_obj:
                    continue
                if cfg.single_obj_seq_mode == "ONLY" and not single_obj:
                    continue
                for group in seq.object_groups:
                    if group.object_ids:
                        self.units.append((ii, name, group))
        if not self.units:
            raise ValueError("taskset is empty")
        if (
            cfg.single_obj_seq_mode in ("AUGMENT_SINGLE", "AUGMENT_ALL")
            and not self.single_obj_seqs
        ):
            raise ValueError(
                f"{cfg.single_obj_seq_mode} needs at least one single-object "
                "donor sequence"
            )

    def __len__(self) -> int:
        return len(self.units)

    # -- sampling ----------------------------------------------------------

    def sample_spec(self) -> TaskSpec:
        cfg = self.cfg
        ii, name, group = self.units[self.rng.randint(len(self.units))]
        index = self.indexes[ii]
        seq = index.sequences[name]
        T = len(seq)

        # frames with annotations (YT-VOS: not every frame has GT)
        annotated = [
            t for t in range(T)
            if seq.label_paths[t] is not None and t >= group.support_frame
        ]
        if cfg.random_support_frame and len(annotated) > 1:
            support = int(annotated[self.rng.randint(len(annotated))])
        else:
            support = group.support_frame

        pool = [t for t in annotated if t != support]
        if cfg.random_frame_epsilon is not None:
            eps = cfg.random_frame_epsilon
            windowed = [t for t in pool if abs(t - support) <= eps]
            pool = windowed or pool
        if not pool:
            pool = [support]
        query = tuple(
            int(pool[self.rng.randint(len(pool))])
            for _ in range(cfg.num_query_frames)
        )

        ids = group.object_ids
        if cfg.random_object_id_sub_group and len(ids) > 1:
            k = self.rng.randint(1, len(ids) + 1)
            ids = tuple(sorted(self.rng.choice(ids, size=k, replace=False)))

        # AUGMENT copy-paste distractor (meta_tasksets.py:79-96):
        # AUGMENT_ALL composites every task, AUGMENT_SINGLE only tasks from
        # single-object sequences; donor = a different single-object sequence
        donor = None
        mode = cfg.single_obj_seq_mode
        seq_is_single = len(seq.object_groups) == 1
        if mode == "AUGMENT_ALL" or (mode == "AUGMENT_SINGLE" and seq_is_single):
            pool = [d for d in self.single_obj_seqs if d[0] != name]
            if pool:
                donor = pool[self.rng.randint(len(pool))]

        return TaskSpec(
            seq=name,
            object_ids=ids,
            support_frame=support,
            query_frames=query,
            flip_label=bool(cfg.random_flip_label and self.rng.rand() < 0.5),
            no_label=bool(cfg.random_no_label and self.rng.rand() < 0.5),
            seed=int(self.rng.randint(0, 2**31 - 1)),
            donor=donor,
        )

    # -- materialization ---------------------------------------------------

    def _index_for(self, seq: str):
        for index in self.indexes:
            if seq in index.sequences:
                return index
        raise KeyError(seq)

    def _raw_frame(self, index, seq: str, t: int, ids,
                   rng: np.random.RandomState):
        """(img, binarized label) pad+random-cropped to crop_size."""
        img = index.get_image(seq, t).astype(np.float32)
        gt = index.get_label(seq, t)
        label = (
            binarize_label(gt, ids).astype(np.int32)
            if gt is not None
            else np.full(img.shape[:2], 255, np.int32)
        )
        th, tw = self.cfg.crop_size
        h, w = img.shape[:2]
        # pad (ignore-label borders) then random-crop to the static size
        if h < th or w < tw:
            ph, pw = max(th - h, 0), max(tw - w, 0)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            label = np.pad(label, ((0, ph), (0, pw)), constant_values=255)
            h, w = img.shape[:2]
        y0 = rng.randint(0, h - th + 1)
        x0 = rng.randint(0, w - tw + 1)
        return img[y0 : y0 + th, x0 : x0 + tw], label[y0 : y0 + th, x0 : x0 + tw]

    def _frame(self, index, seq: str, t: int, ids, spec: TaskSpec,
               rng: np.random.RandomState):
        """(img, label) for one frame: crop → optional donor copy-paste →
        flip/no-label task randomization (the reference composites on the
        cropped, un-flipped label, vos_dataset.py:246-431)."""
        img, label = self._raw_frame(index, seq, t, ids, rng)
        if spec.donor is not None:
            d_seq, d_ids = spec.donor
            d_index = self._index_for(d_seq)
            d_frames = [
                i for i, p in enumerate(d_index.sequences[d_seq].label_paths)
                if p is not None
            ]
            d_t = int(d_frames[rng.randint(len(d_frames))])
            d_img, d_label = self._raw_frame(d_index, d_seq, d_t, d_ids, rng)
            img, label = paste_distractor(img, label, d_img, d_label == 1)
        if spec.flip_label:
            # task randomization: swap fg/bg (meta_tasksets.py:138-143)
            label = np.where(label == 255, 255, 1 - label)
        if spec.no_label:
            label = np.zeros_like(label)
        return img, label

    def materialize(self, specs: Sequence[TaskSpec]) -> TaskBatch:
        """Decode + crop the frames for a list of TaskSpecs into one batch."""
        s_imgs, s_labels, q_imgs, q_labels, seeds = [], [], [], [], []
        for spec in specs:
            index = self._index_for(spec.seq)
            rng = np.random.RandomState(spec.seed)
            img, label = self._frame(
                index, spec.seq, spec.support_frame, spec.object_ids, spec, rng
            )
            s_imgs.append(img)
            s_labels.append(label)
            qi, ql = [], []
            for t in spec.query_frames:
                img_q, label_q = self._frame(
                    index, spec.seq, t, spec.object_ids, spec, rng
                )
                qi.append(img_q)
                ql.append(label_q)
            q_imgs.append(np.stack(qi))
            q_labels.append(np.stack(ql))
            seeds.append(spec.seed)
        return TaskBatch(
            support_img=np.stack(s_imgs),
            support_label=np.stack(s_labels),
            query_imgs=np.stack(q_imgs),
            query_labels=np.stack(q_labels),
            seeds=np.asarray(seeds, np.uint32),
        )

    def sample_batch(self, batch_size: int) -> TaskBatch:
        return self.materialize([self.sample_spec() for _ in range(batch_size)])
