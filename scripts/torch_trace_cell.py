"""Where a benchmark cell's sequence spends its time, by the port's spans,
on one GPU.

    python3 scripts/torch_trace_cell.py --workload <cell> [--seed N]
        [--pairs P] [--out PATH]

Builds the cell of ``BENCHMARK.json`` as ``benchmark/run.py`` does (the
configuration's precision flags, the pool and the weights from the seed,
the program's model and evaluator, the warm-up sequence), then runs ``P``
pairs of pool sequences through ``eval_sequence``, each pair one with the
tracer off and one with it on (``e_osvos_torch.utils.tracing``), in the
order off, on, on, off, off, on, ... so that a drift of the host's speed
falls on both sides alike, each sequence ended by a synchronize. Prints
one JSON object: the card, every sequence's wall seconds (the pairs give
the tracer's cost when on), and for each traced sequence the spans'
totals by name (count, host and device seconds, host syncs counted on
the span itself, kernel launches) and these quantities of it:

* ``refit_s``, ``segment_s``, ``propagate_s``: summed device seconds of the
  ``refit``, ``segment`` and ``propagate`` spans;
* ``step_ms``, ``step_host_ms``: mean device and host milliseconds of an
  ``inner_step`` span (one learned-SGD step of the fine-tune or a refit);
  a host time near the device time says the step is paced by the host;
  ``steps_by_caller`` gives both for the fine-tune's steps and the refits'
  apart;
* ``syncs_per_frame``: the host syncs counted on all of the sequence's
  spans over its frames.

Every sequence, traced or not, also gives ``timed_conv_fine_tunes``: the
fine-tunes that let cuDNN time their forwards' convolution engines (the
change of ``tracing.program_counts()`` over the sequence; one a sequence
for a 16-bit DeepLab, none for a float32 model or the detection
evaluator).

With ``--out`` it also writes the object to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

from e_osvos_torch.utils import tracing  # noqa: E402


def summary(records, frames: int) -> dict:
    """The traced sequence's totals by span name and its quantities."""
    totals = tracing.totals(records)

    def device_s(name):
        return totals.get(name, {}).get("device_s", 0.0)

    steps = totals.get("inner_step", {"count": 0})
    n = max(steps["count"], 1)
    syncs = sum(t["syncs"] for t in totals.values())
    by_id = {r.id: r for r in records}
    by_caller = {}  # the inner steps of the fine-tune apart from the refits'
    for r in records:
        if r.name == "inner_step":
            t = by_caller.setdefault(by_id[r.parent].name,
                                     {"count": 0, "device_ms": 0.0,
                                      "host_ms": 0.0})
            t["count"] += 1
            t["device_ms"] += 1e3 * r.device_s
            t["host_ms"] += 1e3 * r.host_s
    for t in by_caller.values():
        t["device_ms"] /= t["count"]
        t["host_ms"] /= t["count"]
    return {
        "totals": totals,
        "steps_by_caller": by_caller,
        "refit_s": device_s("refit"),
        "segment_s": device_s("segment"),
        "propagate_s": device_s("propagate"),
        "step_ms": 1e3 * steps.get("device_s", 0.0) / n,
        "step_host_ms": 1e3 * steps.get("host_s", 0.0) / n,
        "syncs_per_frame": syncs / frames,
        "inner_steps": steps["count"],
        "refits": totals.get("refit", {}).get("count", 0),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=2 ** 31 + 17)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--out", help="also write the JSON result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from harness import cells, program, seeds
    from harness import main as bench

    cell = cells.load_cell(args.workload)
    program.set_flags(cell.config["precision"])
    torch.set_num_threads(bench.HOST_THREADS)
    run_seeds = seeds.derive(args.seed)
    b = bench.Bench(cell, torch.device("cuda"))
    inputs = b.prepare(run_seeds)
    pool = inputs.pool
    result = {"card": bench.card(), "torch": torch.__version__,
              "cell": cell.name, "seed": args.seed, "sequences": []}
    for j in range(2 * args.pairs):
        traced = j % 4 in (1, 2)
        name = pool.names[j % len(pool.names)]
        frames = len(pool.sequences[name])
        b.hook.begin_sequence(armed=False)
        if traced:
            tracing.enable("cuda")
        timed = tracing.program_counts().get("timed_conv_fine_tunes", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.evaluator.eval_sequence(pool, name, inputs.meta,
                                  seeds.fold_in(run_seeds.eval, j))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tracing.disable()
        b.hook.end_sequence()
        timed = tracing.program_counts().get("timed_conv_fine_tunes",
                                             0) - timed
        seq = {"j": j, "name": name, "frames": frames, "traced": traced,
               "wall_s": wall, "timed_conv_fine_tunes": timed}
        if traced:
            seq.update(summary(tracing.collect(), frames))
        result["sequences"].append(seq)
        print(json.dumps({k: v for k, v in seq.items() if k != "totals"}),
              file=sys.stderr, flush=True)
    off = [s["wall_s"] for s in result["sequences"] if not s["traced"]]
    on = [s["wall_s"] for s in result["sequences"] if s["traced"]]
    result["tracing_cost"] = sum(on) / sum(off) - 1.0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
