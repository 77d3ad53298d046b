"""Time both e-OSVOS-50-OnA paths of one checkout of the port on one GPU,
to compare two commits on the same card.

    python3 scripts/torch_ab_paths.py [--root DIR]

Imports ``chip_smoke`` and ``e_osvos_torch`` from ``DIR`` (default: the
checkout holding this script), builds its kernels, and times each path as
chip_smoke.py does, through ``chip_smoke.timed_sequence``: the DeepLab path
(a 16-frame warm-up sequence, then one 67-frame sequence) and the Mask
R-CNN detection path (a 7-frame warm-up, then one 67-frame sequence), both
at full width in bf16 at 480x854 with seeded random weights. Prints one
JSON line: the root, the card with its power limit, and each path's fps,
sequence seconds and phase seconds (device timeline).

Compare two commits in turns in one call, each run in its own process:
A, B, B, A (an older checkout unpacked with ``git archive`` into a
directory that .gitignore lists).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose chip_smoke.py and port to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ab_paths: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.build_kernels()
    out = {"root": root, "card": card}
    paths = (("deeplab", cs.build_main_path, cs.WARMUP_T, "cpu"),
             ("detection", cs.build_detection_path, cs.DET_WARMUP_T, "cuda"))
    for label, build, warmup_t, gen_device in paths:
        _, meta_params, evaluator, index = build()
        staged = cs.stage_frames(index)
        cs.timed_sequence(evaluator, meta_params, index, staged, "seq00",
                          warmup_t, 0, gen_device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, phases = cs.timed_sequence(evaluator, meta_params, index, staged,
                                         "seq01", cs.MAIN_T, 1, gen_device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[label] = {"fps": cs.MAIN_T / dt, "sequence_s": dt, **phases}
        del meta_params, evaluator, index, staged
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
