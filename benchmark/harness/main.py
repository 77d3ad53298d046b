"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``): the configuration's precision flags, the
pool of sequences and the weights from the seed, the program's model and
evaluator, a warm-up sequence of the cell's own shapes (every kernel
built and run), the capture buffers. Then the measured window; with
``--trace 1`` one more sequence traced after it. Then, with the
program's state freed, the comparison with the plain reference. The last
line of standard output is the result; the numbers compared, each with
its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from harness import capture, cells, counts, judge, peaks, program, seeds
from harness import trace as trace_mod
from harness import traffic, window

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "e_osvos_tpu")
HOST_THREADS = 4  # torch's host threads: one process, few threads, steady load


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card() -> Dict[str, str]:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    info = {"kind": torch.cuda.get_device_name(0), "power_limit": "unread"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0:
            info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def kernel_gn_norms(model) -> int:
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    return sum(isinstance(m, FusedGroupNorm) and m.use_kernel
               for m in model.modules())


def launch_fns():
    from e_osvos_torch.ops import cuda_group_norm, cuda_nms

    def counts():
        return {**cuda_group_norm.launch_counts(), **cuda_nms.launch_counts()}

    def reset():
        cuda_group_norm.reset_launch_counts()
        cuda_nms.reset_launch_counts()

    return counts, reset, cuda_group_norm.LAUNCHES_PER_CALL


class Bench:
    """The system under test of one cell, built once: the program's model
    and evaluator, the step hook in place. Each seed then brings its own
    pool, weights and capture plan (``prepare``)."""

    def __init__(self, cell: cells.Cell, device: torch.device):
        self.cell, self.device = cell, device
        self.cfg, self.mix = cell.config, cell.traffic
        self.fam = cells.family(self.cfg["family"])
        self.frames = int(self.mix["frames"])
        self.objects = int(self.mix["objects"])
        self.hook = capture.StepHook(self.fam.HOOK, device).install()
        self.model = self.fam.build_model(self.cfg, device)
        self.evaluator = self.fam.build_evaluator(self.cfg, self.model,
                                                  device)
        self.counts_fn, self.reset_fn, self.per_call = launch_fns()
        self.n_gn = kernel_gn_norms(self.model)
        self.warmed = False

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def prepare(self, run_seeds: seeds.RunSeeds) -> SimpleNamespace:
        """The seed's pool, weights and meta-parameters; the warm-up
        sequence on the first call; the capture plan and its buffers."""
        from e_osvos_torch.meta_optim import MetaParams

        pool = traffic.make_pool(self.mix, run_seeds.traffic, self.device)
        init, lrs = program.seeded_meta(self.model, self.cfg["meta_optim"],
                                        run_seeds.weights, self.device)
        meta = MetaParams(model_init=init, log_init_lr=lrs)
        if not self.warmed:
            warm = self.cfg["warmup"]
            warm_ev = self.fam.build_evaluator(self.cfg, self.model,
                                               self.device,
                                               num_epochs=warm["num_epochs"])
            windex = pool.truncated(int(warm["frames"]), "warm")
            self.hook.begin_sequence(armed=False)
            warm_ev.eval_sequence(windex, windex.names[0], meta,
                                  seeds.fold_in(run_seeds.eval, 1 << 20))
            self.hook.end_sequence()
            self.warmed = True
        self.hook.sequences.clear()
        ft, refits, points = judge.plan(self.cfg, self.fam, self.frames,
                                        run_seeds.sample)
        self.hook.allocate(points)
        return SimpleNamespace(pool=pool, meta=meta, lrs=lrs, ft=ft,
                               refits=refits, points=points)

    def window(self, inputs, run_seeds: seeds.RunSeeds, seconds: float):
        win = window.run(self.evaluator, inputs.pool, inputs.meta,
                         run_seeds.eval, seconds, self.hook, self.device,
                         self.counts_fn, self.reset_fn)
        want = self.fam.expected_launches(self.cfg, self.frames, self.n_gn,
                                          self.per_call, self.objects)
        log("launches of sequence 0 " + json.dumps(win.launches)
            + " formula " + json.dumps(want))
        log(f"window: {len(win.sequences)} sequences, {win.frames} frames "
            f"in {win.seconds:.3f} s; peak {win.peak_bytes} bytes")
        return win

    def traced_sequence(self, inputs, run_seeds: seeds.RunSeeds, j: int):
        """One more sequence after the window, under the profiler."""
        name = inputs.pool.names[j % len(inputs.pool.names)]
        self.hook.begin_sequence(armed=False)
        _, tr = trace_mod.traced(lambda: self.evaluator.eval_sequence(
            inputs.pool, name, inputs.meta,
            seeds.fold_in(run_seeds.eval, j)))
        self.hook.end_sequence()
        self.hook.sequences.pop()
        return tr, len(inputs.pool.sequences[name])

    def compare(self, inputs, win, run_seeds: seeds.RunSeeds
                ) -> Dict[str, Dict[str, float]]:
        """The numbers compared, of the program and of its control, from
        the window's sequence 0."""
        from families.deeplabv3plus import SeqInputs

        cfg = self.cfg
        seq = SeqInputs(inputs.pool.frames[0], inputs.pool.labels[0],
                        self.objects, seeds.fold_in(run_seeds.eval, 0),
                        self.device)
        jd = judge.Judge(self.fam, cfg, seq, inputs.lrs, self.hook.read(),
                         self.hook.losses, win.first_probs, inputs.ft,
                         inputs.refits, self.device)
        got = jd.readings(log)
        got["program"]["merged_off"] = judge.merged_off(
            win.first_probs, win.first_merged,
            cfg["one_shot"].get("threshold", 0.5))
        got["program"]["passes_off"] = judge.passes_off(
            self.fam.passes(cfg, self.frames), self.hook.sequences)
        self.hook.taken.clear()
        self.hook.losses.clear()
        return got

    def free_program(self) -> None:
        """Drops the program's model and evaluator and the hook (its
        captured points stay readable)."""
        self.hook.remove()
        self.model = self.evaluator = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def shapes(self):
        return {k: tuple(s) for k, (s, _) in self.hook.shapes.items()}


def metrics_of(bench: Bench, win, setup_s: float, traced, lr_names) -> Dict:
    """The cell's end-to-end metrics (no trace) or per-layer metrics (a
    trace), each by its reader; a reader that finds nothing is left out."""
    cell = bench.cell
    specs = cell.per_layer if traced else cell.end_to_end
    view = SimpleNamespace(
        window=win, setup_s=setup_s, cfg=bench.cfg, mix=bench.mix,
        trace=traced[0] if traced else None,
        traced_frames=traced[1] if traced else 0, counts=None, peaks=peaks)
    if traced:
        view.counts = counts.sequence_counts(
            bench.fam, bench.cfg, bench.frames,
            (int(bench.mix["height"]), int(bench.mix["width"])),
            bench.objects, bench.shapes(), lr_names)
        log("counts of one sequence " + json.dumps(view.counts))
    out = {}
    for spec in specs:
        value = cells.metric_reader(spec["name"]).read(view)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    flags = program.set_flags(cell.config["precision"])
    info = card()
    log(f"cell {cell.name}: configuration {cell.config['name']}, traffic "
        f"{cell.traffic['name']}; precision "
        f"{cell.config['precision']['dtype']}, flags {json.dumps(flags)}; "
        f"card {info['kind']}, power limit {info['power_limit']}")
    torch.set_num_threads(HOST_THREADS)
    return measure(cell, args, torch.device("cuda"), info, t_start)


def measure(cell: cells.Cell, args: argparse.Namespace, device: torch.device,
            info: Dict[str, str], t_start: float) -> int:
    """Set-up, window, optional trace, metrics and comparison of one run;
    prints the result line unless a module of JAX or the JAX package was
    loaded by then."""
    run_seeds = seeds.derive(args.seed)
    bench = Bench(cell, device)
    inputs = bench.prepare(run_seeds)
    bench.sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; {len(inputs.points)} capture points, "
        f"{program.param_count(bench.model)} parameters, {bench.n_gn} "
        "GroupNorms on the kernels")
    win = bench.window(inputs, run_seeds, args.seconds)
    t0 = time.perf_counter()
    traced = (bench.traced_sequence(inputs, run_seeds, len(win.sequences))
              if args.trace else None)
    if traced:
        log(f"traced sequence and its reduction: "
            f"{time.perf_counter() - t0:.1f} s")
    lr_names = list(inputs.lrs)
    inputs.meta = None
    bench.free_program()
    t0 = time.perf_counter()
    metrics = metrics_of(bench, win, setup_s, traced, lr_names)
    t1 = time.perf_counter()
    got = bench.compare(inputs, win, run_seeds)
    log(f"metrics {t1 - t0:.1f} s, comparison {time.perf_counter() - t1:.1f} s")
    limits = cell.limits
    correct, checks = judge.decide(got["program"], limits)
    log("readings " + json.dumps(got))
    _, control = judge.decide_control(got["control"], limits)
    log("control fails: " + ", ".join(
        k for k, c in control.items() if not c["value"] <= c["limit"]))
    result = {
        "correct": bool(correct),
        "attempted": len(win.sequences),
        "failed": sum(not s.finite for s in win.sequences),
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": info["kind"],
                   "count": cell.chips,
                   "memory_peak_bytes": int(win.peak_bytes)},
    }
    if traced:
        tr = traced[0]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        log("modules of JAX or the JAX package loaded: " + ", ".join(found))
        return 4
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
