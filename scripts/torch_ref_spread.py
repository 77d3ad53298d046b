"""How far rounding alone moves chip_smoke.py's detection reference.

    python3 scripts/torch_ref_spread.py [--seeds 3 4 5 6 8]
        [--perturb 1.1920929e-07 9.5367432e-07] [--repeats 4] [--card]
        [--out PATH]

chip_smoke.py holds the card against the CPU within 1e-3 in probability on
a tiny fp32 Mask R-CNN tracking a 2-object 5-frame 64x64 synthetic sequence
(``chip_smoke.detection_reference``). For each seed of that sequence this
prints one JSON line per witness, each against the plain CPU run:

* ``cpu_perturbed``: the CPU with every weight scaled by ``1 ± eps``, one
  line per ``--perturb`` value: the sequence's own sensitivity to rounding,
  with no second device involved;
* with ``--card`` (needs a GPU): ``card`` runs with the default
  algorithms and ``card_deterministic`` runs under
  ``torch.use_deterministic_algorithms``, ``--repeats`` of each.

Each line gives, per run, the max |dprob| of each object, the frame of the
largest, the pixels off by more than 1e-4, and, for each discrete decision
of the path (``DECISIONS``), which of its calls gave another answer than in
the CPU run: the call's index and whether it ran in a training step
("train") or at inference ("infer"). With ``--out`` the lines also go to a
file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# cuBLAS needs this before its first call to be deterministic
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from e_osvos_torch.engine import one_shot_detection  # noqa: E402
from e_osvos_torch.models import mask_rcnn, rpn  # noqa: E402

# Where the path turns floats into a discrete choice: (name, module, the
# function's name there, which output to record; None for the whole).
DECISIONS = (
    ("rpn_topk", rpn, "topk_stable", 1),  # proposals; anchor samples
    ("rpn_nms", rpn, "fast_nms", 0),
    ("roi_samples", mask_rcnn, "_sample_fixed", 0),  # fg by IoU >= 0.5
    ("head_nms", mask_rcnn, "batched_nms", 0),
    ("boxes_from_masks", one_shot_detection, "masks_to_boxes", 0),
    ("pseudo_labels", one_shot_detection, "build_pseudo_gt", None),
)


def traced(device, seed, perturb=0.0):
    """``chip_smoke.detection_reference`` with every call of each
    decision recorded on the host: (result, {name: [outputs]})."""
    trace, saved = {name: [] for name, *_ in DECISIONS}, []

    def recorder(name, fn, part):
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            trace[name].append((torch.is_grad_enabled(),
                                (out if part is None else out[part]).cpu()))
            return out
        return record

    try:
        for name, module, attr, part in DECISIONS:
            fn = getattr(module, attr)
            saved.append((module, attr, fn))
            setattr(module, attr, recorder(name, fn, part))
        res, _ = chip_smoke.detection_reference(device, seed, perturb)
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    return res, trace


def compare(ref, ref_trace, got, got_trace):
    d = (ref["probs"] - got["probs"]).abs()  # [O, T, H, W]
    per_frame = d.flatten(2).amax(2)  # [O, T]
    differ = {}
    for name, calls in ref_trace.items():
        other = got_trace[name]
        differ[name] = ([f"{i} {'train' if grad else 'infer'}"
                         for i, ((grad, a), (_, b)) in
                         enumerate(zip(calls, other)) if not torch.equal(a, b)]
                        if len(calls) == len(other) else "count differs")
    return {
        "max_abs_per_object": per_frame.amax(1).tolist(),
        "worst_frame_per_object": per_frame.argmax(1).tolist(),
        "pixels_over_1e-4": int((d > 1e-4).sum()),
        "decisions_differ": differ,
        "decision_calls": {k: len(v) for k, v in ref_trace.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5, 6, 8])
    ap.add_argument("--perturb", type=float, nargs="+",
                    default=[2.0 ** -23, 2.0 ** -20])
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.card:
        if not torch.cuda.is_available():
            print("torch_ref_spread: --card needs a CUDA device",
                  file=sys.stderr)
            return 2
        chip_smoke.build_kernels()
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    for seed in args.seeds:
        ref, ref_trace = traced("cpu", seed)
        for eps in args.perturb:
            got = traced("cpu", seed, perturb=eps)
            emit({"seed": seed, "witness": "cpu_perturbed", "eps": eps,
                  "runs": [compare(ref, ref_trace, *got)]})
        if not args.card:
            continue
        for witness, det in (("card", False), ("card_deterministic", True)):
            torch.use_deterministic_algorithms(det)
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.benchmark = False
            runs = [compare(ref, ref_trace,
                            *traced("cuda", seed))
                    for _ in range(args.repeats)]
            emit({"seed": seed, "witness": witness, "runs": runs})
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
