"""Which cuDNN kernels a benchmark cell's convolutions run, and what each
costs, at the support fine-tune's batch and at a refit's, on one GPU.

    python3 scripts/torch_conv_engines.py --workload <cell> --timed 0|1
        [--out PATH]

Builds the cell's model as ``benchmark/run.py`` does (the configuration's
precision flags; the object-stacked model for a cell of several objects)
and records the convolution problems of one forward with gradients at the
fine-tune's batch (the support batch, each object's own images) and at a
refit's (the support frame and its pseudo-labelled frames, shared by the
objects): input shape and strides, weight shape, bias, stride, padding,
dilation, groups, dtype, and how often the step runs each. Then it replays
every problem's three passes apart (forward; dgrad, the gradient to the
input, which the stem's step does not take; wgrad, to the weight), each
after one untimed call, and gives its device milliseconds (CUDA events over
5 calls) and the kernels one call runs with their device microseconds
(``torch.profiler``).

``--timed 1`` turns cuDNN's benchmark mode on for the whole process, so
each problem runs the engine cuDNN times as fastest; ``--timed 0`` runs
the heuristic's picks. Run each in its own process: cuDNN keeps the engine
chosen for a problem for the process's life. Prints one JSON object (the
card, each batch's problems with their passes, and each batch's summed
convolution milliseconds a step), also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

REPS = 5


def record_problems(apply, params, imgs):
    """The convolution problems of one forward of ``apply(params, imgs)``
    with gradients, each with how often it ran."""
    seen = Counter()
    conv2d = F.conv2d

    def recorder(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        seen[(tuple(x.shape), tuple(x.stride()), tuple(w.shape),
              tuple(w.stride()), b is not None, _pair(stride),
              _pair(padding), _pair(dilation), groups, str(x.dtype),
              x.requires_grad)] += 1
        return conv2d(x, w, b, stride, padding, dilation, groups)

    F.conv2d = recorder
    try:
        apply(params, imgs)
    finally:
        F.conv2d = conv2d
    return seen


def _tensor(shape, stride, dtype, device):
    return torch.empty_strided(shape, stride, dtype=dtype,
                               device=device).normal_()


def replay(key, device):
    """Device ms a call and the kernels of one call, for each pass."""
    (xs, xst, ws, wst, bias, stride, padding, dilation, groups, dtype,
     needs_dgrad) = key
    dtype = getattr(torch, dtype.split(".")[1])
    x = _tensor(xs, xst, dtype, device)
    w = _tensor(ws, wst, dtype, device)
    b = _tensor((ws[0],), (1,), dtype, device) if bias else None
    y = F.conv2d(x, w, b, stride, padding, dilation, groups)
    gy = torch.randn_like(y)
    backward = torch.ops.aten.convolution_backward

    passes = {"forward": lambda: F.conv2d(x, w, b, stride, padding,
                                          dilation, groups),
              "wgrad": lambda: backward(gy, x, w, None, stride, padding,
                                        dilation, False, [0, 0], groups,
                                        [False, True, False])}
    if needs_dgrad:
        passes["dgrad"] = lambda: backward(gy, x, w, None, stride, padding,
                                           dilation, False, [0, 0], groups,
                                           [True, False, False])
    out = {}
    for name, fn in passes.items():
        fn()  # the engine's pick (timed under benchmark mode)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = {"ms": start.elapsed_time(end) / REPS,
                     "kernels": kernels}
    return out


def batches(cfg, traffic, objects, device):
    """The fine-tune's and a refit's model inputs: ``(name, imgs)``."""
    h, w = int(traffic["height"]), int(traffic["width"])
    one = cfg["one_shot"]
    k = min(one["online_adapt_step"], one["batch_size"])
    support = torch.rand(one["batch_size"], h, w, 3, device=device)
    if objects > 1:
        support = support.expand(objects, *support.shape)
    return [("fine_tune", support),
            ("refit", torch.rand(1 + k, h, w, 3, device=device))]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--timed", type=int, choices=(0, 1), required=True)
    parser.add_argument("--out", help="also write the JSON result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from harness import cells, program
    from harness import main as bench

    from e_osvos_torch.models import functional_apply
    from e_osvos_torch.models.stacked import object_stacked_apply

    cell = cells.load_cell(args.workload)
    cfg = cell.config
    program.set_flags(cfg["precision"])
    torch.backends.cudnn.benchmark = bool(args.timed)
    device = torch.device("cuda")
    objects = int(cell.traffic["objects"])
    model = cells.family(cfg["family"]).build_model(cfg, device)
    apply = functional_apply(model)
    if objects > 1:
        apply = object_stacked_apply(apply, objects)
    params = {k: v.detach().requires_grad_(v.is_floating_point())
              for k, v in apply.model.state_dict().items()}
    result = {"card": bench.card(), "torch": torch.__version__,
              "cudnn": torch.backends.cudnn.version(), "cell": cell.name,
              "timed": args.timed, "batches": {}}
    for name, imgs in batches(cfg, cell.traffic, objects, device):
        problems = []
        for key, n in record_problems(apply, params, imgs).items():
            passes = replay(key, device)
            problems.append({"x": key[0], "x_stride": key[1], "w": key[2],
                             "bias": key[4], "stride": key[5],
                             "padding": key[6], "dilation": key[7],
                             "groups": key[8], "dtype": key[9],
                             "count": n, "passes": passes})
            torch.cuda.empty_cache()
        step_ms = sum(p["count"] * sum(v["ms"] for v in p["passes"].values())
                      for p in problems)
        result["batches"][name] = {"imgs": list(imgs.shape),
                                   "conv_ms_a_step": step_ms,
                                   "problems": problems}
        print(json.dumps({"batch": name, "conv_ms_a_step": step_ms}),
              file=sys.stderr, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
