"""Where the time of the port's e-OSVOS-50-OnA sequence goes, on one GPU.

    python3 scripts/torch_profile_one_shot.py [--out PATH]

Same configuration as chip_smoke.py's main path (full-width resnet50 os16
frozen-BN DeepLabV3+, bf16, 480x854, 67 frames). After a 16-frame warm-up
sequence it times one 67-frame sequence through the entry point,
``OneShotEvaluator._eval_object_group``, exactly as chip_smoke.py does
(``chip_smoke.timed_sequence``: CUDA events at the ends of the fine-tune
and the propagation through the evaluator's ``on_phase`` hook, then the
threshold + bit-pack + host fetch).

Then torch.profiler traces, at the same shapes and with the same
functions the sequence runs, a 5-step fine-tune (batch 3), one
online-adaptation refit (10 steps at batch 4) and one window inference
(batch 5): device time by kernel class (convolution and matmul, GroupNorm
kernels, other elementwise, reductions, copies, other) and the device's
busy share of the wall time. Prints one JSON object and, with ``--out``,
writes it to that file.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    from e_osvos_torch.data.datasets import binarize_label
    from e_osvos_torch.engine.one_shot import (
        build_pseudo_gt, fine_tune_on_support, make_ona_refit_fn,
        segment_frames, stack_windows,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model, meta_params, ev, index = chip_smoke.build_main_path()
    cfg, meta_cfg, apply = ev.cfg, ev.meta_cfg, ev.model_apply
    staged = chip_smoke.stage_frames(index)

    chip_smoke.timed_sequence(ev, meta_params, index, staged, "seq00",
                              chip_smoke.WARMUP_T, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, phases = chip_smoke.timed_sequence(ev, meta_params, index, staged,
                                             "seq01", chip_smoke.MAIN_T, 1)
    wall = time.perf_counter() - t0

    # the inputs each traced function gets on the sequence
    frames = staged["seq01"]
    group = index.sequences["seq01"].object_groups[0]
    label = torch.from_numpy(binarize_label(
        index.get_label("seq01", 0), group.object_ids)).to("cuda", torch.int32)
    five_step_cfg = dataclasses.replace(cfg, num_epochs=5)
    params, _ = fine_tune_on_support(apply, meta_cfg, five_step_cfg,
                                     meta_params, torch.Generator().manual_seed(2),
                                     frames[0], label)
    windows, _, _ = stack_windows(frames[1:], cfg.online_adapt_step)
    k = min(cfg.online_adapt_step, cfg.batch_size)
    pseudo = build_pseudo_gt(segment_frames(apply, cfg, params, windows[0])[-k:],
                             cfg.online_adapt_min_prop, None)
    refit = make_ona_refit_fn(apply, meta_cfg, cfg)

    step = profile(lambda: fine_tune_on_support(
        apply, meta_cfg, five_step_cfg, meta_params,
        torch.Generator().manual_seed(2), frames[0], label))
    # the refit updates params in place, as it does on the sequence
    ona = profile(lambda: refit(meta_params, frames[0], label,
                                windows[0][-k:], pseudo, params))
    infer = profile(lambda: segment_frames(apply, cfg, params, windows[0]))

    T = chip_smoke.MAIN_T
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "frames": T,
        "phases_s": phases, "sequence_s": wall, "fps": T / wall,
        "fine_tune_5_steps_profile": step, "refit_10_steps_profile": ona,
        "window_inference_profile": infer,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
