"""Sweep greedy NMS (K3) over both routes on one GPU: the table the route
rule ``e_osvos_torch.ops.cuda_nms.nms_route`` is set from.

    python3 scripts/torch_nms_routes.py [--parent-root DIR] [--out PATH]

For N in {512, 1000, 2000, 4336, 16384} and max_out in {1, 4, 8, 16, 32,
64, 300, 512} (IoU threshold 0.5, chip_smoke's boxes in a 480x854 frame,
10% of the slots invalid), each route forced: device time of one call from
CUDA graphs over 8 input sets in turn (route S, route L, route L, route S;
the best of each pair), and the picks of both routes checked against the
plain twin. With ``--parent-root`` the older checkout's K3 is built and
timed too, before and after the two routes. At max_out 1 and 512 the
device time of each kernel of a call comes from torch.profiler over 20
calls (route L's three launches apart). Prints one JSON line a cell and a
last line with the card, the table and, per N, the largest max_out at
which route S was faster; ``--out`` also writes that last line to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (512, 1000, 2000, 4336, 16384)
MAX_OUTS = (1, 4, 8, 16, 32, 64, 300, 512)
SPLIT_AT = (1, 512)
THRESH = 0.5


def kernel_split(calls, sets) -> dict:
    """Device ms a call of each kernel name, from torch.profiler over 20
    calls of each entry of ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn(*sets[0])
    torch.cuda.synchronize()
    out = {}
    for label, fn in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None) or getattr(
                ev, "cuda_time_total", 0)
            name = re.search(r"nms\w*_kernel", ev.key)
            if name and t:
                out[f"{label}:{name.group(0)}"] = t / 20 / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-root", default=None,
                    help="an older checkout whose K3 is timed beside both routes")
    ap.add_argument("--out", default=None, help="also write the summary here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_nms_routes: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from e_osvos_torch.ops import cuda_nms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.build_kernels()
    parent = cs.load_parent_nms(args.parent_root) if args.parent_root else None
    gen = torch.Generator(device="cpu").manual_seed(6)
    table = []
    for n in NS:
        sets = [cs.nms_inputs("sweep", n, gen) for _ in range(8)]
        for max_out in MAX_OUTS:
            want = cuda_nms.greedy_nms_plain(*sets[0], THRESH, max_out)
            calls = {}
            for route in cuda_nms.ROUTES:
                got = cuda_nms.greedy_nms(*sets[0], THRESH, max_out,
                                          route=route)
                if not all(map(torch.equal, got, want)):
                    raise AssertionError(f"route {route} disagrees with the "
                                         f"twin at N={n}, max_out={max_out}")
                calls[route] = cs.rotating(
                    lambda b, s, v, r=route: cuda_nms.greedy_nms(
                        b, s, v, THRESH, max_out, route=r), sets)
            if parent is not None:
                calls["parent"] = cs.rotating(
                    lambda b, s, v: parent(b, s, v, THRESH, max_out), sets)
            turns = ["parent"] * (parent is not None) + ["s", "l", "l", "s"] + [
                "parent"] * (parent is not None)
            times = {}
            for name in turns:
                t = cs.graph_time_ms(calls[name])
                times[name] = min(times.get(name, t), t)
            cell = {"n": n, "max_out": max_out,
                    "kept": int(want[1].sum()), "rule": cuda_nms.nms_route(
                        n, max_out), **{f"{k}_ms": v for k, v in times.items()}}
            if max_out in SPLIT_AT:
                fns = {r: (lambda b, s, v, r=r: cuda_nms.greedy_nms(
                    b, s, v, THRESH, max_out, route=r)) for r in cuda_nms.ROUTES}
                if parent is not None:
                    fns["parent"] = lambda b, s, v: parent(b, s, v, THRESH,
                                                           max_out)
                cell["split_ms"] = kernel_split(fns, sets)
            table.append(cell)
            print(json.dumps(cell), flush=True)
    s_wins = {n: max([c["max_out"] for c in table
                      if c["n"] == n and c["s_ms"] < c["l_ms"]], default=0)
              for n in NS}
    summary = json.dumps({"card": card, "thresh": THRESH, "table": table,
                          "largest_max_out_route_s_faster": s_wins})
    print(summary, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(summary + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
