"""Where the time of the port's meta step goes, on one GPU.

    python3 scripts/torch_profile_meta_step.py [--out PATH]

Same configuration as chip_smoke.py's meta-training phase (full-width
resnet50 os16 frozen-BN DeepLabV3+, bf16, 4 tasks of 480x480, 5 inner
steps, both modes of scripts/bench_meta_step.py), built by the same
functions. For each mode, after one warm-up meta step through
``MetaTrainer.run``, torch.profiler traces one more meta step through
``MetaTrainer.run`` (task sampling on the host included): device time by
kernel class, the device's busy share of the wall time (the kernels'
durations summed, so overlapping kernels count twice) and the number of
kernels. Prints one JSON object and, with ``--out``, writes it to that
file.
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
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

GN_KERNELS = ("partial_sums_kernel", "group_finalize_kernel",
              "affine_kernel", "affine_dx_kernel")


def kernel_class(name: str) -> str:
    low = name.lower()
    if any(k in name for k in GN_KERNELS):
        return "groupnorm_kernels"
    if any(k in low for k in ("conv", "cudnn", "xmma", "cutlass", "gemm",
                              "wgrad", "dgrad", "fprop", "implicit")):
        return "conv_matmul"
    if "reduce" in low:
        return "reduction"
    if any(k in low for k in ("copy", "memcpy", "memset", "cat")):
        return "copy"
    if "elementwise" in low or "vectorized" in low or "foreach" in low:
        return "elementwise"
    return "other"


def profile(fn):
    """Device time by kernel class and the device's busy share for fn()."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    classes: dict = {}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        cls = kernel_class(evt.name)
        classes[cls] = classes.get(cls, 0.0) + us / 1e3
        n_kernels += 1
    busy = sum(classes.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "kernels": n_kernels,
            "device_ms_by_class": dict(sorted(classes.items(),
                                              key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the JSON result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from e_osvos_torch.models import DeepLabV3Plus

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model = DeepLabV3Plus(num_classes=1, arch="resnet50",
                          backbone_norm="frozen_bn", output_stride=16,
                          dtype=torch.bfloat16, seed=0, device="cuda")
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "tasks": chip_smoke.META_TASKS,
              "hw": chip_smoke.META_HW}
    for tag, step_cfg in chip_smoke.meta_step_configs().items():
        trainer = chip_smoke.build_meta_trainer(model, step_cfg)
        trainer.run(1)  # warm-up (and the first iteration's logging)
        result[tag] = profile(lambda: trainer.run(1))
        print(tag, json.dumps(result[tag]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
