"""Benchmark-submission packaging, port of
``e_osvos_tpu/utils/submission.py``.

The YouTube-VOS server takes a zip of ``Annotations/<seq>/<frame>.png``.
``package_ytvos_submission`` builds it from a predictions directory as
``cli.evaluate save_preds=<dir>`` writes it (``<dir>/<seq>/<NNNNN>.png``).
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, List, Optional, Sequence


def package_ytvos_submission(preds_dir: str, out_zip: str,
                             sequences: Optional[Sequence[str]] = None,
                             frame_names: Optional[Dict[str, List[str]]] = None
                             ) -> int:
    """Zip ``preds_dir/<seq>/*.png`` into ``Annotations/<seq>/<name>.png``.

    ``sequences`` defaults to every subdirectory, sorted. YouTube-VOS names
    frames by their time stamp (``00005``) while the evaluator numbers
    them in turn: with ``frame_names`` ({seq: [official stem, ...]}) the
    i-th PNG of a sequence takes the i-th stem. Returns the number of files
    packed."""
    seqs = sequences or sorted(
        d for d in os.listdir(preds_dir)
        if os.path.isdir(os.path.join(preds_dir, d)))
    count = 0
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for seq in seqs:
            files = sorted(f for f in os.listdir(os.path.join(preds_dir, seq))
                           if f.endswith(".png"))
            names = frame_names.get(seq) if frame_names else None
            for i, f in enumerate(files):
                stem = (names[i] if names and i < len(names)
                        else os.path.splitext(f)[0])
                zf.write(os.path.join(preds_dir, seq, f),
                         arcname=f"Annotations/{seq}/{stem}.png")
                count += 1
    return count


def ytvos_frame_names(index, seq: str) -> List[str]:
    """The official frame stems of a ``YouTubeVOSIndex`` sequence, from its
    image paths."""
    return [os.path.splitext(os.path.basename(p))[0]
            for p in index.sequences[seq].image_paths]
