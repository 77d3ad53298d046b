"""The comparison's readings over many seeds in one process, set-up paid
once, for setting the limits (not run by the benchmark's runs):

    python3 benchmark/tools/sweep.py --workload <cell> --seeds 1,2,3:fault \\
        [--program-tf32 default] [--out chiprun_out/sweep.jsonl]

For each seed: the seed's pool and weights, one sequence through the
timed path (the window's sequence 0, ``--seconds 0``), and the readings
of the program and of its control (the reference one precision below the
configuration's at the same points) against the reference. With
``--program-tf32 default`` the program's sequence runs with PyTorch's
own TF32 flags (cuDNN's on) instead of the configuration's; the reference
stays at float32 with TF32 off. A seed written ``<seed>:<fault>`` runs
the program with a planted fault (``harness/faults.py``). One JSON line a
seed, with ``correct`` of the program and of the control at the cell's own
limits; the exit code is 1 where a control came out correct."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import cells, faults, judge, program, seeds  # noqa: E402
from harness.main import HOST_THREADS, Bench, log  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program-tf32", choices=("config", "default"),
                   default="config")
    p.add_argument("--out", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 3
    cell = cells.load_cell(args.workload)
    device = torch.device("cuda")
    program.set_flags(cell.config["precision"])
    torch.set_num_threads(HOST_THREADS)
    bench = Bench(cell, device)
    out = open(args.out, "a") if args.out else None
    control_passed = False
    for item in args.seeds.split(","):
        seed, _, fault = item.partition(":")
        seed, fault = int(seed), fault or "none"
        t0 = time.perf_counter()
        rs = seeds.derive(seed)
        inputs = bench.prepare(rs)
        if args.program_tf32 == "default":
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = False
        flags = program.flags()
        with faults.planted(fault):
            win = bench.window(inputs, rs, 0.0)
        program.set_flags(cell.config["precision"])
        got = bench.compare(inputs, win, rs)
        correct, _ = judge.decide(got["program"], cell.limits)
        control_correct, _ = judge.decide_control(got["control"],
                                                  cell.limits)
        control_passed |= control_correct
        line = {"workload": cell.name, "seed": seed, "fault": fault,
                "program_flags": flags, "correct": correct,
                "control_correct": control_correct,
                "seconds": time.perf_counter() - t0,
                "sequence_s": win.seconds, "readings": got}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 1 if control_passed else 0


if __name__ == "__main__":
    sys.exit(main())
