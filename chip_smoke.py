"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

  1. device: the card's name and power limit;
  2. build: compiles the kernels (e_osvos_torch/csrc/*.cu) with nvcc, one
     process per source, all at once;
  3. kernels: each kernel against its plain PyTorch twin on the card. The
     GroupNorm passes (statistics with their group algebra, apply, dx) in
     bf16 at the DeepLab decoder's shapes [3|4|5, 120*214, 256], at the
     Mask R-CNN backbone's GroupNorm-32 shapes (C = 64 at 102480 rows to
     C = 2048 at 405 rows) and at edge shapes; greedy NMS (K3) at the
     detection path's (N = 512, max_out = 1), the greedy RPN's (4336, 512), the
     kernel's largest N = 16384, a ragged N, an all-invalid input, exact
     score ties, -0.0/+0.0 ties, NaN coordinates and IoUs exactly at the
     threshold, where idx and keep must be identical on the route the rule
     picks and on each route forced. With times of the kernel, the twin
     and, where one exists, a single PyTorch call computing the same
     function (device time from CUDA graphs over rotating inputs,
     GroupNorm's three times the L2 cache, and the eager call beside it;
     K3 at (512, 1) and (4336, 512), beside the parent checkout's K3 when
     --parent-root names one, and an empty launch from torch.cuda);
  4. DeepLab main path: e-OSVOS-50-OnA one-shot evaluation (bench.py's
     configuration, the fused window loop) with a full-width resnet50 os16
     frozen-BN DeepLabV3+ in bf16 at 480x854, seeded random weights: a
     16-frame warm-up sequence, then one timed 67-frame sequence, with its
     fps and per-phase times; the kernels' launch counts must equal what
     the configuration implies;
  5. DeepLab multi-object sequence: the same model and evaluator on a
     2-object 67-frame 480x854 sequence (scripts/bench_multiobj.py's
     configuration) through ``OneShotEvaluator.eval_sequence``: the objects
     in turn, then the merge and the J/F scoring on the card, with the
     sequence's fps, per-object phase times, J/F per object and peak
     memory; the launch counts must be twice the single-object ones, and
     the card's J/F must equal the CPU's scoring of the same merged map;
  6. DeepLab host window loop: the same model through an evaluator with
     the default fused_ona=False on a 1-object 67-frame 480x854 sequence
     through ``eval_sequence``, with its fps and phase times; launch counts
     as implied (the same as the fused loop's);
  7. DeepLab reference: the single-group evaluation on a small fp32 model
     and input, on the card and on the CPU (the kernels' plain twins), must
     agree;
  8. DeepLab evaluation reference: ``eval_sequence`` of a 2-object sequence
     on the same small model (the host window loop), on the card and on the
     CPU, must agree in probability and J/F; on the card, ``eval_stream``
     over two sequences must give ``eval_sequence``'s merged maps;
  9. detection main path: Mask R-CNN e-OSVOS-50-OnA one-shot tracking
     (scripts/bench_detection_ona.py's configuration, one detection per
     frame) with a full-width resnet50 GroupNorm-32 FPN Mask R-CNN in bf16
     at 480x854, seeded random weights: a 7-frame warm-up sequence, then
     one timed 67-frame sequence (the fused window loop), with its fps,
     per-phase times and the share of frames with a detection; launch
     counts as implied;
 10. detection reference: a tiny fp32 Mask R-CNN through
     ``DetectionOneShotEvaluator.eval_sequence`` on a 2-object sequence on
     the card and on the CPU, with the same CPU-drawn random numbers, in
     the fused window loop, the host loop and the host loop refitting the
     box and mask heads alone: probabilities within 1e-3, identical NMS
     picks; on the card, ``eval_stream`` over two sequences must give
     ``eval_sequence``'s merged maps;
 11. CLI evaluation, DeepLab, on disk: ``build_480p_tree`` (two 67-frame
     480x854 sequences, 1 and 2 objects) in a temporary directory under
     build/, fresh meta-parameters saved with the port's
     ``save_checkpoint``, then ``e_osvos_torch.cli.evaluate.main`` with
     DAVIS-2017 e-OSVOS-OnA at phase 4's settings, palette PNGs and init_J:
     two eval_seq records with J and F in [0, 1], one PNG a frame with the
     sequence's object ids, launch counts of three single-group sequences
     plus the init_J forwards; each sequence's fps and peak memory beside
     the card's name and power limit, and the decoder that ran;
 12. CLI evaluation, Mask R-CNN, on disk: the same with phase 9's
     configuration on the 1-object sequence (a split file written into the
     tree), launch counts of one sequence plus init_J's tracking;
 13. detection main path with the exact greedy RPN: phase 9's configuration
     with RPNConfig(use_fast_nms=False), the reference's torchvision RPN
     semantics, so K3 also selects the proposals at (N = 4336, max_out =
     512), route L, for every image of every training step and every
     inferred frame; in the warm-up sequence some of those calls are held
     against the plain twin on their own inputs;
 14. meta-training, Mask R-CNN: the full-width detection model (Fast-NMS
     RPN) through ``MetaTrainer.run`` with the detection task family in both
     modes of phase 6's meta-training (scripts/exp_det_meta_480p.py's
     settings: 4 tasks at 480x480, 5 inner steps, first order, Lovász),
     with the same timings and checks, 53 backbone GroupNorms;
 15. meta-training reference, Mask R-CNN: a small fp32 detection meta step
     on the card and on the CPU, first order and second order restricted to
     the box and mask heads (the backbone's GroupNorms stay on the kernels),
     with the CPU's own sensitivity printed beside; the default
     ``roi_heads`` restriction within the same tolerances of first order
     on the CPU;
 16. parent training: ``ParentTrainer`` on the full-width DeepLabV3+ (batch
     8 at 480x480, Adam) and Mask R-CNN with the greedy RPN (batch 4, 2
     instance slots), a warm-up and 3 timed steps on a fixed batch each:
     step seconds, peak memory, a falling loss, launch counts with K3 route
     L once an image a forward;
 17. CLI training, on disk: ``cli.train_parent`` (Mask R-CNN), then
     ``cli.train_meta`` from that parent checkpoint with
     ``random_box_coord_perm``, then ``cli.evaluate`` from that meta
     checkpoint on an 8-frame 480x854 sequence; launch counts as implied.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --parent-root DIR

also builds DIR's e_osvos_torch/csrc/nms.cu (an older checkout, unpacked
with ``git archive`` into a directory .gitignore lists; its C entry point
``nms_greedy``) and times it beside K3 in turns, on the same inputs.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import dataclasses
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores (NVIDIA
# data sheet); the PCIe part: 2.0 TB/s, 51 TFLOP/s.
CARD_PEAKS = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}

MAIN_HW = (480, 854)
MAIN_T = 67
WARMUP_T = 16
GN_C = 256
GN_M = 120 * 214  # decoder C2 resolution at 480x854 (dec_norm1/2)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    return CARD_PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- kernels


# The Mask R-CNN backbone's GroupNorm-32 at 480x854: the stem at the
# fine-tune's batch 3 (2 channels a group), layer4 at batch 3, layer3 in a
# window inference (batch 1), layer2 in a refit (batch 4)
# meta-training at 480x480: decoder at C2 (120x120) and ASPP at C5 (30x30)
GN_META_SHAPES = [(3, 120 * 120, GN_C, 16), (1, 120 * 120, 48, 16),
                  (1, 30 * 30, GN_C, 16)]
GN_BACKBONE_SHAPES = [(3, 240 * 427, 64, 32), (3, 15 * 27, 2048, 32),
                      (1, 30 * 54, 1024, 32), (4, 60 * 107, 512, 32)]


def worst_ratio(got, want, tol, floor):
    """(max abs error, max error over ``tol`` times the largest magnitude of
    ``want`` or ``floor``) of two tuples of tensors; the ratio must stay <=
    1."""
    err = ratio = 0.0
    for k, p in zip(got, want):
        e = (k.float() - p.float()).abs().max().item()
        err = max(err, e)
        ratio = max(ratio, e / (tol * max(floor, p.float().abs().max().item())))
    return err, ratio


def check_gn_kernels(peaks):
    """Each GroupNorm kernel against its plain twin; returns the kernels'
    records (without launch counts, which come from the main paths)."""
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops.group_norm import fused_group_norm, group_norm

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=bf, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen) * scale + shift
        return t.to(dev, dtype)

    # (N, M, C, groups): DeepLab batches, the meta-training decoder at
    # 480x480 (support batch 3 or 1) and ASPP, the Mask R-CNN backbone, then
    # the edge shapes (C = 36 is not a multiple of 8: the scalar variant)
    shapes = [(3, GN_M, GN_C, 16), (4, GN_M, GN_C, 16), (5, GN_M, GN_C, 16),
              *GN_META_SHAPES, *GN_BACKBONE_SHAPES,
              (3, GN_M, 48, 16), (3, 1, GN_C, 16), (2, 1000, GN_C, 16),
              (1, 777, 48, 16), (1, 30 * 54, GN_C, 16), (2, 1000, 36, 4)]
    # Tolerances. The statistics are f32 sums over bf16 inputs, taken in
    # another order than the twin: a, b, mean, rstd within 1e-4 of the
    # largest magnitude (at least 1). The backward coefficients and the
    # parameter gradients are sums of bf16 products over N*M rows: 1e-3 of
    # the largest magnitude. The bf16 outputs may differ by one bf16
    # rounding step (2^-8 relative) where the kernel's FMA and the twin's
    # separate multiply and add round differently: 1e-2 of the largest
    # magnitude (at least 1).
    tol_stat, tol_coef, tol_out = 1e-4, 1e-3, 1e-2
    errs = dict.fromkeys(("group_stats", "affine_apply", "group_grad_coeffs",
                          "affine_dx"), 0.0)
    worst = dict(errs)  # err / tolerance-scale, must stay <= 1

    def note(name, err_ratio):
        errs[name] = max(errs[name], err_ratio[0])
        worst[name] = max(worst[name], err_ratio[1])

    for n, m, c, g in shapes:
        x = rand(n, m, c, scale=2.0, shift=0.5)
        dy = rand(n, m, c)
        scale = rand(c, dtype=torch.float32, scale=0.5, shift=1.0)
        bias = rand(c, dtype=torch.float32, scale=0.5)

        want = K.group_stats_plain(x, scale, bias, g, 1e-6)
        note("group_stats", worst_ratio(K.group_stats(x, scale, bias, g, 1e-6),
                                        want, tol_stat, 1.0))
        mean, rstd = want[2], want[3]
        note("group_grad_coeffs", worst_ratio(
            K.group_grad_coeffs(dy, x, scale, mean, rstd, g),
            K.group_grad_coeffs_plain(dy, x, scale, mean, rstd, g),
            tol_coef, 1e-6))

        # the whole forward through the autograd.Function (group_stats and
        # the apply pass) vs the plain group_norm
        xr = x.clone().requires_grad_(True)
        sr = scale.clone().requires_grad_(True)
        br = bias.clone().requires_grad_(True)
        y_k = fused_group_norm(xr, sr, br, g)
        xp = x.clone().requires_grad_(True)
        sp = scale.clone().requires_grad_(True)
        bp = bias.clone().requires_grad_(True)
        y_p = group_norm(xp, sp, bp, g)
        note("affine_apply", worst_ratio((y_k,), (y_p,), tol_out, 1.0))

        # the whole backward (group_grad_coeffs and the dx pass) vs autograd
        # through the twin
        gk = torch.autograd.grad(y_k, (xr, sr, br), dy)
        gp = torch.autograd.grad(y_p, (xp, sp, bp), dy)
        note("affine_dx", worst_ratio(gk[:1], gp[:1], tol_out, 1.0))
        note("group_grad_coeffs",
             (0.0, worst_ratio(gk[1:], gp[1:], tol_coef, 1.0)[1]))
        log(f"  shape N={n} M={m} C={c} G={g}: ok so far, worst err/tol "
            + json.dumps({k: round(v, 4) for k, v in worst.items()}))
    torch.cuda.synchronize()
    log("kernel max_abs_err " + json.dumps(errs))
    log(f"tolerances: statistics {tol_stat}, backward coefficients and "
        f"parameter grads {tol_coef}, bf16 outputs {tol_out}, each times the "
        f"largest magnitude")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain twins: {bad}")

    # ---- times at the DeepLab fine-tune shape [3, 25680, 256] (the kernels
    # line) and at the Mask R-CNN stem's [3, 102480, 64] ----
    records = time_gn_kernels(peaks, 3, GN_M, GN_C, 16)
    stem = time_gn_kernels(peaks, 3, 240 * 427, 64, 32)
    log("gn kernels at the Mask R-CNN stem [3, 102480, 64] bf16 " + json.dumps(
        {k: {f: v[f] for f in ("ms", "eager_ms", "plain_ms", "bound_ms",
                               "library_ms")}
         for k, v in stem.items()}))
    for name in records:
        records[name]["max_abs_err"] = errs[name]
    time_gn_composites(peaks)
    split_gn_statistics()
    return records


def split_gn_statistics():
    """Device time of each kernel inside the two statistics wrappers (the
    partial sums, then the finalize), from torch.profiler over 20 calls at
    the decoder's and the stem's shapes; logged only."""
    from torch.profiler import ProfilerActivity, profile

    from e_osvos_torch.ops import cuda_group_norm as K

    gen = torch.Generator(device="cuda").manual_seed(5)
    for n, m, c, g in ((3, GN_M, GN_C, 16), (3, 240 * 427, 64, 32)):
        sets = [tuple(torch.randn(n, m, c, device="cuda", generator=gen,
                                  dtype=torch.bfloat16) for _ in range(2))
                for _ in range(3)]
        scale = torch.ones(c, device="cuda")
        _, _, mean, rstd = K.group_stats(sets[0][0], scale, scale, g, 1e-6)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                x, dy = sets[i % 3]
                K.group_stats(x, scale, scale, g, 1e-6)
                K.group_grad_coeffs(dy, x, scale, mean, rstd, g)
            torch.cuda.synchronize()
        split = {}  # kernel<backward?> -> ms a launch
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None) or getattr(
                ev, "cuda_time_total", 0)
            for kname in ("partial_sums_kernel", "group_finalize_kernel"):
                if kname in ev.key and ev.count and t:
                    pair = "true" in ev.key.split(kname)[1].split(">")[0]
                    split[f"{kname}<{'backward' if pair else 'forward'}>"] = (
                        t / ev.count / 1e3)
        log(f"  statistics kernels' device ms a launch at [{n}, {m}, {c}] "
            + (json.dumps(split) if split else "not measured (no device "
               "events)"))


L2_BYTES = 50e6  # H100 L2 cache


def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in one CUDA
    graph after a warm-up on a side stream, the graph replayed ``replays``
    times between CUDA events. The host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def rotating(fn, sets):
    """``fn`` over input sets in turn, one set a call."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def time_gn_kernels(peaks, n: int, m: int, c: int, g: int):
    """Times of the four GroupNorm wrappers at one bf16 ``[n, m, c]``
    shape with their bounds: kernel, twin and library call as device time
    (CUDA graphs; twin, kernel, kernel, twin), and the kernel's eager call
    (host launch included). The inputs rotate over sets that together hold
    more than three times the L2 cache, so every call reads device
    memory."""
    from e_osvos_torch.ops import cuda_group_norm as K

    bw, f32_peak = peaks
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=gen, dtype=dtype)

    elems = n * m * c
    nbytes = elems * 2
    sets = [(rand(n, m, c) * 2.0 + 0.5, rand(n, m, c))
            for _ in range(max(3, math.ceil(3 * L2_BYTES / nbytes)))]
    scale = rand(c, dtype=torch.float32) * 0.5 + 1.0
    bias = rand(c, dtype=torch.float32)
    _, _, mean, rstd = K.group_stats_plain(sets[0][0], scale, bias, g, 1e-6)
    a, b, D = (rand(n, c, dtype=torch.float32) for _ in range(3))
    nc4, ng4, c4 = n * c * 4, n * g * 4, c * 4
    bounds = {  # (bytes moved, f32 operations)
        "group_stats": (nbytes + 2 * c4 + 2 * nc4 + 2 * ng4, 3 * elems),
        "affine_apply": (2 * nbytes + 2 * nc4, 2 * elems),
        "group_grad_coeffs": (2 * nbytes + c4 + 2 * ng4 + 3 * nc4 + 2 * c4,
                              3 * elems),
        "affine_dx": (3 * nbytes + 3 * nc4, 4 * elems),
    }
    calls = {  # (kernel, twin, one library call computing the same or None)
        "group_stats": (
            lambda x, dy: K.group_stats(x, scale, bias, g, 1e-6),
            lambda x, dy: K.group_stats_plain(x, scale, bias, g, 1e-6),
            lambda x, dy: torch.var_mean(x, dim=1, correction=0)),
        "affine_apply": (lambda x, dy: K.affine_apply(x, a, b),
                         lambda x, dy: K.affine_apply_plain(x, a, b), None),
        "group_grad_coeffs": (
            lambda x, dy: K.group_grad_coeffs(dy, x, scale, mean, rstd, g),
            lambda x, dy: K.group_grad_coeffs_plain(dy, x, scale, mean, rstd, g),
            None),
        "affine_dx": (lambda x, dy: K.affine_dx(dy, x, a, b, D),
                      lambda x, dy: K.affine_dx_plain(dy, x, a, b, D), None),
    }
    records = {}
    for name, (kern, plain, lib) in calls.items():
        kern, plain = rotating(kern, sets), rotating(plain, sets)
        t_plain_1 = graph_time_ms(plain)
        t_kern_1 = graph_time_ms(kern)
        t_kern_2 = graph_time_ms(kern)
        t_plain_2 = graph_time_ms(plain)
        t_eager = cuda_time_ms(kern)
        t_lib = graph_time_ms(rotating(lib, sets)) if lib else None
        byts, ops = bounds[name]
        bound = max(byts / bw, ops / f32_peak) * 1e3
        records[name] = {
            "ms": min(t_kern_1, t_kern_2), "plain_ms": min(t_plain_1, t_plain_2),
            "bound_ms": bound,
            "bound_by": "bytes" if byts / bw >= ops / f32_peak else "operations",
            "library_ms": t_lib, "eager_ms": t_eager,
        }
        log(f"  {name} at [{n}, {m}, {c}] G={g}: kernel {t_kern_1:.4f} / "
            f"{t_kern_2:.4f} ms, eager call {t_eager:.4f} ms, plain "
            f"{records[name]['plain_ms']:.4f} ms, library "
            f"{'-' if t_lib is None else f'{t_lib:.4f}'} ms, bound "
            f"{bound:.4f} ms ({len(sets)} input sets)")
    return records


def time_gn_composites(peaks):
    """A GroupNorm forward and backward through ``GroupNormFunction`` beside
    one PyTorch call computing the same (a yardstick the port never calls),
    at the decoder's [3, 25680, 256] bf16, in turns (library, port, port,
    library): eager (host launch included) and as device time."""
    from e_osvos_torch.ops.group_norm import GroupNormFunction

    bw, f32_peak = peaks
    bf = torch.bfloat16
    n, m, c, g = 3, GN_M, GN_C, 16
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(n, m, c, device="cuda", generator=gen, dtype=bf) * 2 + 0.5
    dy = torch.randn(n, m, c, device="cuda", generator=gen, dtype=bf)
    scale = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1.0
    bias = torch.randn(c, device="cuda", generator=gen) * 0.5
    nbytes, elems = x.numel() * 2, x.numel()
    x4 = x.view(n, 120, 214, c).permute(0, 3, 1, 2)  # NCHW, channels_last
    # the library's backward takes NCHW-contiguous operands
    x4c = x4.contiguous()
    dy4c = dy.view(n, 120, 214, c).permute(0, 3, 1, 2).contiguous()
    _, mean, rstd = GroupNormFunction.apply(x, scale, bias, g, 1e-6)
    _, lmean, lrstd = torch.ops.aten.native_group_norm(
        x4c, scale.to(bf), bias.to(bf), n, c, m, g, 1e-6)

    class _Ctx:  # the residuals the forward saved
        saved_tensors = (x, scale, mean, rstd)
        num_groups = g

    composites = {
        "gn_forward": (
            lambda: GroupNormFunction.forward(x, scale, bias, g, 1e-6),
            lambda: torch.nn.functional.group_norm(x4, g, scale.to(bf),
                                                   bias.to(bf), 1e-6),
            (2 * nbytes, 4 * elems)),
        "gn_backward": (
            lambda: GroupNormFunction.backward(_Ctx, dy, None, None),
            lambda: torch.ops.aten.native_group_norm_backward(
                dy4c, x4c, lmean, lrstd, scale.to(bf), n, c, m, g,
                [True, True, True]),
            (3 * nbytes, 8 * elems)),
    }
    comp = {}
    for name, (kern, lib, (byts, ops)) in composites.items():
        rec = {"bound_ms": max(byts / bw, ops / f32_peak) * 1e3}
        for how, timer in (("eager", cuda_time_ms), ("device", graph_time_ms)):
            t_lib_1 = timer(lib)
            t_k = min(timer(kern), timer(kern))
            t_lib_2 = timer(lib)
            rec[f"{how}_ms"] = t_k
            rec[f"{how}_library_ms"] = min(t_lib_1, t_lib_2)
        comp[name] = rec
    log("gn composites at [3, 25680, 256] bf16 " + json.dumps(comp))


# the NMS cases: (name, N, max_out, IoU threshold)
NMS_CASES = [("det_512x1", 512, 1, 0.5), ("det_512x4", 512, 4, 0.5),
             ("rpn_4336x512", 4336, 512, 0.7), ("max_16384x64", 16384, 64, 0.5),
             ("ragged_777", 777, 100, 0.5), ("all_invalid", 512, 8, 0.5),
             ("ties", 2000, 300, 0.5), ("signed_zero_ties", 2000, 300, 0.5),
             ("nan_boxes", 4336, 512, 0.7), ("iou_ties", 2000, 300, 0.5)]


def nms_inputs(name: str, n: int, gen: torch.Generator):
    """Boxes in a 480x854 frame (sizes 8..300 px), scores in [0, 1) and
    valid flags of one NMS case, on the card."""
    xy = torch.rand(n, 2, generator=gen) * torch.tensor([854.0, 480.0])
    wh = torch.exp(torch.rand(n, 2, generator=gen) * 3.6 + 2.1)
    boxes = torch.cat([xy, xy + wh], 1)
    scores = torch.rand(n, generator=gen)
    valid = torch.rand(n, generator=gen) > 0.1
    if name == "all_invalid":
        valid[:] = False
    if name == "ties":  # 16 distinct scores: many exact ties
        scores = torch.floor(scores * 16) / 16
    if name == "signed_zero_ties":  # -0.0 ties +0.0: the lowest index wins
        scores = torch.where(scores < 0.5, 0.0, -0.0)
        scores[::97] = 0.5
    if name == "iou_ties":  # an integer grid: IoUs exactly at 1/2
        xy = torch.randint(0, 12, (n, 2), generator=gen).float()
        boxes = torch.cat([xy, xy + torch.randint(1, 7, (n, 2),
                                                  generator=gen)], 1)
    if name == "nan_boxes":  # a NaN coordinate makes every IoU with it 0
        hit = torch.rand(n, generator=gen) < 0.05
        boxes[hit, torch.randint(0, 4, (int(hit.sum()),), generator=gen)] = (
            torch.nan)
        boxes[7] = torch.nan
        scores[7] = 2.0
    return boxes.cuda(), scores.cuda(), valid.cuda()


def nms_bound(peaks, n: int, max_out: int, kept: int):
    """(bound ms, bound_by) of one greedy NMS: each input read once (16
    bytes of box, 4 of score, 1 of valid flag a box) and each output written
    once (5 bytes a slot); about 15 f32 operations a box in each round
    this run's data needs (the kept boxes, and the round that finds none
    left)."""
    bw, f32_peak = peaks
    byts = 21 * n + 5 * max_out
    ops = 15 * n * min(max_out, kept + 1)
    return (max(byts / bw, ops / f32_peak) * 1e3,
            "bytes" if byts / bw >= ops / f32_peak else "operations")


def load_parent_nms(root: str):
    """K3 of an older checkout at ``root``: its csrc/nms.cu built with the
    port's nvcc flags into build/, bound through its one entry point
    ``nms_greedy``. Returns ``fn(boxes, scores, valid, thr, max_out) ->
    (idx, keep)`` for one image on the current stream."""
    from e_osvos_torch.ops import cuda_build, cuda_nms

    src = os.path.join(os.path.abspath(root), "e_osvos_torch", "csrc", "nms.cu")
    out = cuda_build.BUILD_DIR / "parent_nms.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
                    *cuda_nms.NVCC_EXTRA, "-o", str(out), src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nms_greedy.argtypes = [p, p, p, i, i, ctypes.c_float, i, p, p, p]
    lib.nms_greedy.restype = i

    def run(boxes, scores, valid, thr, max_out):
        idx = torch.empty(max_out, dtype=torch.int32, device=boxes.device)
        keep = torch.empty(max_out, dtype=torch.bool, device=boxes.device)
        err = lib.nms_greedy(boxes.data_ptr(), scores.data_ptr(),
                             valid.data_ptr(), 1, scores.shape[-1], float(thr),
                             max_out, idx.data_ptr(), keep.data_ptr(),
                             cuda_build.stream())
        cuda_build.raise_on(err, "parent greedy_nms")
        return idx, keep

    log(f"parent K3 built from {src}")
    return run


def check_nms_kernel(peaks, parent=None):
    """K3 against its plain twin at every NMS case, on the route the rule
    picks and on each route forced: idx and keep must be identical. Returns
    the records of route S at the detection head's (512, 1) and of route L
    at the greedy RPN's (4336, 512)."""
    from e_osvos_torch.ops import cuda_nms

    gen = torch.Generator(device="cpu").manual_seed(2)
    for name, n, max_out, thr in NMS_CASES:
        boxes, scores, valid = nms_inputs(name, n, gen)
        want = cuda_nms.greedy_nms_plain(boxes, scores, valid, thr, max_out)
        route = cuda_nms.nms_route(n, max_out)
        same = {}
        for r in (None, "s", "l"):
            got = cuda_nms.greedy_nms(boxes, scores, valid, thr, max_out,
                                      route=r)
            torch.cuda.synchronize()
            same[r or "rule"] = all(map(torch.equal, got, want))
        if parent is not None and name in ("det_512x1", "rpn_4336x512"):
            got = parent(boxes, scores, valid, thr, max_out)
            same["parent"] = all(map(torch.equal, got, want))
        idx, keep = want
        kept = int(keep.sum())
        log(f"  nms {name}: N={n} max_out={max_out} kept={kept} route "
            f"{route}; identical " + json.dumps(same))
        if not all(same.values()):
            raise AssertionError(f"K3 disagrees with its twin at {name}: "
                                 f"{same}")
        if name == "all_invalid" and (kept or bool((idx != -1).any())):
            raise AssertionError("K3 kept a box of an all-invalid input")
    timed = {name: time_nms(peaks, name, n, max_out, thr, parent)
             for name, n, max_out, thr in NMS_CASES
             if name in ("det_512x1", "rpn_4336x512")}
    # torch.cuda._sleep(0): one thread that spins for no cycles
    empty = graph_time_ms(lambda: torch.cuda._sleep(0))
    # no single PyTorch call computes greedy NMS (torchvision is absent)
    log("nms times " + json.dumps(timed))
    log(f"empty launch (torch.cuda._sleep(0), graph replay): {empty:.6f} ms")
    return {"greedy_nms": timed["det_512x1"],
            "greedy_nms_l": timed["rpn_4336x512"]}


def time_nms(peaks, name: str, n: int, max_out: int, thr: float, parent):
    """K3's times at one case over 8 input sets in turn: device time from
    CUDA graphs (the parent's K3 and K3 in turns: parent, K3, K3, parent),
    the eager call (host launch included), and the twin's eager time."""
    from e_osvos_torch.ops import cuda_nms

    gen = torch.Generator(device="cpu").manual_seed(4)
    sets = [nms_inputs(name, n, gen) for _ in range(8)]
    kern = rotating(lambda b, s, v: cuda_nms.greedy_nms(b, s, v, thr, max_out),
                    sets)
    old = parent and rotating(lambda b, s, v: parent(b, s, v, thr, max_out),
                              sets)
    t_old_1 = graph_time_ms(old) if old else None
    t_kern = min(graph_time_ms(kern), graph_time_ms(kern))
    t_old = min(t_old_1, graph_time_ms(old)) if old else None
    t_eager = cuda_time_ms(kern)
    plain = rotating(lambda b, s, v: cuda_nms.greedy_nms_plain(
        b, s, v, thr, max_out), sets)
    t_plain = min(cuda_time_ms(plain, iters=5, warmup=1),
                  cuda_time_ms(plain, iters=5, warmup=1))
    kept = sum(int(cuda_nms.greedy_nms(*st, thr, max_out)[1].sum())
               for st in sets) / len(sets)
    bound, bound_by = nms_bound(peaks, n, max_out, kept)
    rec = {"ms": t_kern, "plain_ms": t_plain, "bound_ms": bound,
           "bound_by": bound_by, "library_ms": None, "max_abs_err": 0.0,
           "eager_ms": t_eager, "parent_ms": t_old, "route": cuda_nms.nms_route(n, max_out), "kept": kept}
    log(f"  nms {name}: route {rec['route']} device {t_kern:.6f} ms (parent "
        f"{'not measured' if t_old is None else f'{t_old:.6f}'}), eager "
        f"{t_eager:.6f} ms, plain {t_plain:.4f} ms, bound {bound:.6f} ms "
        f"({bound_by})")
    return rec


# ------------------------------------------------------------ main path


def expected_launches(cfg, T: int, n_gn: int, per_call):
    """GroupNorm kernel launches one sequence implies (support frame 0):
    each of the ``n_gn`` GroupNorms calls the forward wrappers once per
    forward and the backward wrappers once per backward, and a wrapper call
    makes ``per_call[wrapper]`` launches."""
    rest = T - 1
    windows = -(-rest // cfg.online_adapt_step)
    refits = windows - 1
    backwards = cfg.num_epochs + refits * cfg.online_adapt_epochs
    forwards = backwards + windows
    calls = {"group_stats": forwards, "affine_apply": forwards,
             "group_grad_coeffs": backwards, "affine_dx": backwards}
    return {k: v * n_gn * per_call[k] for k, v in calls.items()}


def expected_meta_launches(step_cfg, tasks: int, n_gn: int, per_call):
    """GroupNorm kernel launches one meta step implies: each task runs
    ``num_epochs`` inner forwards and backwards and one query forward and
    backward per truncation segment; each of the ``n_gn`` GroupNorms calls
    the forward wrappers once per forward and the backward wrappers once
    per backward, and a wrapper call makes ``per_call[wrapper]``
    launches."""
    segments = step_cfg.num_epochs // step_cfg.bptt_epochs
    passes = tasks * (step_cfg.num_epochs + segments)
    calls = {"group_stats": passes, "affine_apply": passes,
             "group_grad_coeffs": passes, "affine_dx": passes}
    return {k: v * n_gn * per_call[k] for k, v in calls.items()}


def build_main_path(device="cuda"):
    """bench.py's e-OSVOS-50-OnA configuration on the port: full-width
    resnet50 os16 frozen-BN DeepLabV3+ in bf16 with seeded random weights,
    neuron-level linear lrs at 1e-3 with a learned init, the fused window
    loop, and two synthetic 480x854 sequences of 67 frames."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import OneShotConfig, OneShotEvaluator
    from e_osvos_torch.meta_optim import MetaOptimConfig, init_meta_params
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply

    model = DeepLabV3Plus(num_classes=1, arch="resnet50",
                          backbone_norm="frozen_bn", output_stride=16,
                          dtype=torch.bfloat16, seed=0, device=device)
    meta_cfg = MetaOptimConfig(lr_hierarchy_level="neuron", init_lr=1e-3,
                               learn_model_init=True, use_log_init_lr=False)
    meta_params = init_meta_params(meta_cfg, model)
    cfg = OneShotConfig(num_epochs=50, batch_size=3, loss_func="dice",
                        online_adapt_step=5, online_adapt_epochs=10,
                        online_adapt_min_prop=0.75, augment=AugmentConfig())
    evaluator = OneShotEvaluator(functional_apply(model), meta_cfg, cfg,
                                 device=device, fused_ona=True)
    index = SyntheticVOSIndex(num_sequences=2, num_frames=MAIN_T,
                              size=MAIN_HW, num_objects=1, seed=0)
    return model, meta_params, evaluator, index


def stage_frames(index, device="cuda"):
    """Every sequence's raw frames on the device, before any timer."""
    return {name: torch.from_numpy(np.stack(
        [index.get_image(name, t) for t in range(len(seq))])).to(device)
        for name, seq in index.sequences.items()}


def timed_sequence(evaluator, meta_params, index, staged, name: str, T: int,
                   seed: int, generator_device: str = "cpu"):
    """The first object group of sequence ``name`` (first ``T`` staged
    frames) through the evaluator's ``_eval_object_group`` (the DeepLab
    ``OneShotEvaluator`` or the ``DetectionOneShotEvaluator``), then
    threshold, bit-pack and fetch to the host. The random draws come from a
    generator seeded with ``seed`` on ``generator_device``. Returns (probs,
    unpacked masks, phase seconds on the device's timeline): the
    evaluator's ``on_phase`` hook marks the ends of the fine-tune and the
    propagation with CUDA events; ``fetched_s`` is the threshold, pack and
    host fetch."""
    from e_osvos_torch.ops.bits import pack_mask_bits, unpack_mask_bits

    events = {}

    def mark(phase):
        events[phase] = torch.cuda.Event(enable_timing=True)
        events[phase].record()

    seq = index.sequences[name]
    group = seq.object_groups[0]
    frames = staged[name][:T]
    gen = torch.Generator(device=generator_device).manual_seed(seed)
    evaluator.on_phase = mark
    mark("start")
    probs = evaluator._eval_object_group(
        index, seq, frames, group, meta_params, gen, None,
        support_img=frames[group.support_frame])
    packed = pack_mask_bits(probs >= evaluator.cfg.threshold).cpu().numpy()
    mark("fetched")
    evaluator.on_phase = None
    events["fetched"].synchronize()
    order = ("start", "fine_tune", "propagate", "fetched")
    phases = {f"{b}_s": events[a].elapsed_time(events[b]) / 1e3
              for a, b in zip(order, order[1:])}
    return probs, unpack_mask_bits(packed, probs.shape[-1]), phases


def run_main_path(shared):
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    H, W = MAIN_HW
    t0 = time.perf_counter()
    model, meta_params, evaluator, index = build_main_path()
    cfg = evaluator.cfg
    n_gn = sum(isinstance(mod, FusedGroupNorm) and mod.use_kernel
               for mod in model.modules())
    staged = stage_frames(index)
    torch.cuda.synchronize()
    log(f"main path set-up (model, meta-params, staged frames): "
        f"{time.perf_counter() - t0:.3f} s; {n_gn} GroupNorm layers on the "
        f"kernels")

    t0 = time.perf_counter()
    timed_sequence(evaluator, meta_params, index, staged, "seq00", WARMUP_T, 0)
    torch.cuda.synchronize()
    log(f"warm-up sequence ({WARMUP_T} frames): {time.perf_counter() - t0:.3f} s")

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, masks, phases = timed_sequence(evaluator, meta_params, index,
                                          staged, "seq01", MAIN_T, 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    want = {**expected_launches(cfg, MAIN_T, n_gn, K.LAUNCHES_PER_CALL),
            "greedy_nms": 0, "greedy_nms_s": 0, "greedy_nms_l": 0}
    log(f"timed sequence ({MAIN_T} frames at {H}x{W}): {dt:.3f} s, "
        f"{MAIN_T / dt:.4f} fps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("phases (device timeline; fetched = threshold, pack and host fetch) "
        + json.dumps(phases))
    log("launch counts " + json.dumps(counts) + " expected " + json.dumps(want)
        + " (launches per wrapper call " + json.dumps(K.LAUNCHES_PER_CALL)
        + ")")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if tuple(probs.shape) != (MAIN_T, H, W) or masks.shape != (MAIN_T, H, W):
        raise AssertionError(f"output shapes {tuple(probs.shape)}, {masks.shape}")
    if not bool(torch.isfinite(probs).all()):
        raise AssertionError("non-finite probabilities on the main path")
    log(f"foreground share of the masks: {float(masks[1:].mean()):.4f}")
    shared["deeplab"] = (meta_params, evaluator, n_gn)
    return counts


MULTI_OBJECTS = 2  # scripts/bench_multiobj.py:37


def run_multi_object(shared):
    """A 2-object 67-frame 480x854 sequence through ``eval_sequence`` on the
    main path's model and evaluator (warm from its sequences, same
    shapes): the objects in turn, the merge and the J/F scoring on the
    card. Its wall time runs from the call to the result dict on the host
    (frames loaded and uploaded, probabilities and merged map fetched)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import build_gt_stack
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms
    from e_osvos_torch.ops import metrics

    H, W = MAIN_HW
    meta_params, evaluator, n_gn = shared["deeplab"]
    index = SyntheticVOSIndex(num_sequences=1, num_frames=MAIN_T,
                              size=MAIN_HW, num_objects=MULTI_OBJECTS,
                              multi_object="single_id", seed=0)
    seq = index.sequences["seq00"]
    if len(seq.object_groups) != MULTI_OBJECTS:
        raise AssertionError(f"{len(seq.object_groups)} object groups")
    events = []

    def mark(phase):
        events.append((phase, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    evaluator.on_phase = mark
    t0 = time.perf_counter()
    mark("start")
    res = evaluator.eval_sequence(index, "seq00", meta_params, 1)
    dt = time.perf_counter() - t0
    evaluator.on_phase = None
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    one = expected_launches(evaluator.cfg, MAIN_T, n_gn, K.LAUNCHES_PER_CALL)
    want = {**{k: MULTI_OBJECTS * v for k, v in one.items()},
            "greedy_nms": 0, "greedy_nms_s": 0, "greedy_nms_l": 0}
    # phase seconds on the device's timeline, object by object
    names = [p for p, _ in events]
    if names != ["start"] + ["fine_tune", "propagate"] * MULTI_OBJECTS + [
            "score"]:
        raise AssertionError(f"phases {names}")
    spans = [(b[0], a[1].elapsed_time(b[1]) / 1e3)
             for a, b in zip(events, events[1:])]
    per_object = [dict(spans[2 * o:2 * o + 2]) for o in range(MULTI_OBJECTS)]
    log(f"multi-object sequence ({MULTI_OBJECTS} objects, {MAIN_T} frames at "
        f"{H}x{W}, eval_sequence incl. loading, scoring and fetch): "
        f"{dt:.3f} s, {MAIN_T / dt:.4f} fps; peak memory {peak:.2f} GiB")
    log("multi-object phases (device timeline, seconds) " + json.dumps(
        {"per_object": per_object, "score_s": spans[-1][1]}))
    log("multi-object J per object " + json.dumps(res["J_per_object"])
        + ", F per object " + json.dumps(res["F_per_object"]))
    log("multi-object launch counts " + json.dumps(counts) + " expected "
        + json.dumps(want) + f" ({MULTI_OBJECTS} x the single-object counts)")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    probs, merged = res["probs"], res["merged"]
    if (probs.shape != (MULTI_OBJECTS, MAIN_T, H, W)
            or merged.shape != (MAIN_T, H, W) or merged.dtype != np.uint8):
        raise AssertionError(f"output shapes {probs.shape}, {merged.shape} "
                             f"{merged.dtype}")
    if not np.isfinite(probs).all():
        raise AssertionError("non-finite probabilities")
    scores = res["J_per_object"] + res["F_per_object"]
    if len(scores) != 2 * MULTI_OBJECTS or not np.isfinite(scores).all():
        raise AssertionError(f"J/F per object {scores}")

    # the card's scoring against the CPU's, on the same merged map and GT
    gt_stack, has_gt, ids = build_gt_stack(index, "seq00", seq, MAIN_T,
                                           MAIN_HW)
    host = (torch.from_numpy(merged.astype(np.int32)),
            torch.from_numpy(gt_stack), torch.from_numpy(ids))
    card = tuple(t.cuda() for t in host)
    score_ms = cuda_time_ms(lambda: metrics.sequence_scores(*card), iters=3,
                            warmup=1)
    J_card, F_card = (t.cpu() for t in metrics.sequence_scores(*card))
    t0 = time.perf_counter()
    J_cpu, F_cpu = metrics.sequence_scores(*host)
    cpu_s = time.perf_counter() - t0
    err = max((J_card - J_cpu).abs().max().item(),
              (F_card - F_cpu).abs().max().item())
    means = [float(np.mean(S.numpy()[gi, has_gt]))
             for S in (J_cpu, F_cpu) for gi in range(MULTI_OBJECTS)]
    err_means = float(np.abs(np.array(means) - np.array(scores)).max())
    log(f"multi-object scoring: card sequence_scores {score_ms:.3f} ms, CPU "
        f"{cpu_s:.3f} s; card vs CPU max |dJ|, |dF| per frame {err:.3e}, "
        f"of the means {err_means:.3e} (tol 1e-6)")
    if not (err <= 1e-6 and err_means <= 1e-6):
        raise AssertionError(f"card and CPU J/F disagree: {err}, {err_means}")
    return counts


def run_host_loop(shared):
    """A 1-object 67-frame 480x854 sequence through ``eval_sequence`` of an
    evaluator with the default ``fused_ona=False``: the host window loop
    (a ragged 1-frame tail window, a refit while frames remain) on the main
    path's model. It makes the fused loop's launches."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import OneShotEvaluator
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms

    H, W = MAIN_HW
    # the last user of the main path's model: later phases' peak memory
    # must not count it
    meta_params, fused, n_gn = shared.pop("deeplab")
    evaluator = OneShotEvaluator(fused.model_apply, fused.meta_cfg,
                                 fused.cfg, device="cuda")
    index = SyntheticVOSIndex(num_sequences=1, num_frames=MAIN_T,
                              size=MAIN_HW, num_objects=1, seed=2)
    events = []

    def mark(phase):
        events.append((phase, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    evaluator.on_phase = mark
    t0 = time.perf_counter()
    mark("start")
    res = evaluator.eval_sequence(index, "seq00", meta_params, 3)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    want = {**expected_launches(evaluator.cfg, MAIN_T, n_gn,
                                K.LAUNCHES_PER_CALL),
            "greedy_nms": 0, "greedy_nms_s": 0, "greedy_nms_l": 0}
    if [p for p, _ in events] != ["start", "fine_tune", "propagate", "score"]:
        raise AssertionError(f"phases {[p for p, _ in events]}")
    spans = {f"{b[0]}_s": a[1].elapsed_time(b[1]) / 1e3
             for a, b in zip(events, events[1:])}
    log(f"host window loop sequence (1 object, {MAIN_T} frames at {H}x{W}, "
        f"fused_ona=False, eval_sequence incl. loading, scoring and fetch): "
        f"{dt:.3f} s, {MAIN_T / dt:.4f} fps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("host window loop phases (device timeline) " + json.dumps(spans)
        + f"; J {res['J_per_object']}, F {res['F_per_object']}")
    log("host window loop launch counts " + json.dumps(counts) + " expected "
        + json.dumps(want))
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if res["probs"].shape != (1, MAIN_T, H, W):
        raise AssertionError(f"probs shape {res['probs'].shape}")
    scores = res["J_per_object"] + res["F_per_object"]
    if not (np.isfinite(res["probs"]).all() and np.isfinite(scores).all()):
        raise AssertionError(f"non-finite output, J/F {scores}")
    return counts


def small_eval_setup():
    """The small fp32 configuration of the reference phases: OnA every 2
    frames, degenerate augmentation."""
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import OneShotConfig
    from e_osvos_torch.meta_optim import MetaOptimConfig

    cfg = OneShotConfig(num_epochs=3, batch_size=3, loss_func="dice",
                        online_adapt_step=2, online_adapt_epochs=2,
                        augment=AugmentConfig(
                            scale_min=1.0, scale_max=1.0, rot_deg=0.0,
                            brightness=0.0, contrast=0.0, saturation=0.0,
                            flip_prob=0.0, compute_dtype="float32"))
    return cfg, MetaOptimConfig(init_lr=1e-3, use_log_init_lr=False)


def check_reference():
    """The whole slice on a small fp32 model, on the card and on the CPU."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import OneShotEvaluator
    from e_osvos_torch.meta_optim import init_meta_params
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply

    index = SyntheticVOSIndex(num_sequences=1, num_frames=7, size=(32, 48),
                              seed=3)
    seq = index.sequences["seq00"]
    cfg, meta_cfg = small_eval_setup()
    out = {}
    for device in ("cpu", "cuda"):
        model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                              backbone_norm="frozen_bn", output_stride=16,
                              seed=5, device=device)
        meta_params = init_meta_params(meta_cfg, model)
        ev = OneShotEvaluator(functional_apply(model), meta_cfg, cfg,
                              device=device, fused_ona=True)
        frames = torch.from_numpy(np.stack(
            [index.get_image("seq00", t) for t in range(7)])).to(device)
        gen = torch.Generator(device="cpu").manual_seed(0)
        out[device] = ev._eval_object_group(
            index, seq, frames, seq.object_groups[0], meta_params, gen, None
        ).cpu()
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    log(f"small fp32 slice, card vs CPU: max |dprob| = {err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"card and CPU disagree on the small slice: {err}")


def check_eval_reference():
    """``eval_sequence`` of a 2-object 7-frame 32x48 sequence on the small
    fp32 model (objects in turn, the host window loop) on the card and on
    the CPU: probabilities and J/F within 1e-3. Then, on the card,
    ``eval_stream`` over two sequences against ``eval_sequence`` with the
    seeds ``fold_in(seed, i)`` (the fused loop): identical merged maps."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import OneShotEvaluator, fold_in
    from e_osvos_torch.meta_optim import init_meta_params
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply

    index = SyntheticVOSIndex(num_sequences=2, num_frames=7, size=(32, 48),
                              num_objects=2, seed=3)
    cfg, meta_cfg = small_eval_setup()
    res, built = {}, {}
    for device in ("cpu", "cuda"):
        model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                              backbone_norm="frozen_bn", output_stride=16,
                              seed=5, device=device)
        built[device] = (functional_apply(model),
                         init_meta_params(meta_cfg, model))
        ev = OneShotEvaluator(built[device][0], meta_cfg, cfg, device=device)
        res[device] = ev.eval_sequence(index, "seq00", built[device][1], 0)
    err = float(np.abs(res["cpu"]["probs"] - res["cuda"]["probs"]).max())
    err_jf = max(abs(a - b) for k in ("J_per_object", "F_per_object")
                 for a, b in zip(res["cpu"][k], res["cuda"][k]))
    log(f"small fp32 eval_sequence (2 objects, host window loop), card vs "
        f"CPU: max |dprob| = {err:.3e}, max |dJ|, |dF| = {err_jf:.3e} (tol "
        f"1e-3); J per object on the card {res['cuda']['J_per_object']}")
    if res["cuda"]["probs"].shape != (2, 7, 32, 48):
        raise AssertionError(f"probs shape {res['cuda']['probs'].shape}")
    if not (err <= 1e-3 and err_jf <= 1e-3):
        raise AssertionError(f"card and CPU disagree on eval_sequence: "
                             f"{err}, {err_jf}")

    apply, meta_params = built["cuda"]
    ev = OneShotEvaluator(apply, meta_cfg, cfg, device="cuda", fused_ona=True)
    names = ["seq00", "seq01"]
    masks = ev.eval_stream(index, names, meta_params, 5)
    same = [bool(np.array_equal(masks[name], ev.eval_sequence(
        index, name, meta_params, fold_in(5, i))["merged"]))
        for i, name in enumerate(names)]
    log(f"eval_stream over {len(names)} sequences on the card equals "
        f"eval_sequence(fold_in(seed, i)): {same}")
    if not all(same):
        raise AssertionError("eval_stream differs from eval_sequence")


# ------------------------------------------------------- meta-training

META_HW = (480, 480)  # scripts/bench_meta_step.py:51-54
META_TASKS = 4
META_TIMED = 3  # timed meta steps a mode, after one warm-up


def meta_step_configs():
    """scripts/bench_meta_step.py's two modes: the per-task augmentation
    with a support batch of 1 (configs/meta.yaml's default) and the
    per-step batch-3 mode (the MetaStepConfig default); 5 inner steps, one
    truncation segment, dice loss, first-order meta-gradients."""
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.parallel import MetaStepConfig

    return {
        "per-task batch1": MetaStepConfig(
            num_epochs=5, bptt_epochs=5, train_batch_size=1,
            augment=AugmentConfig(), frame_transform_per_task=True),
        "per-step batch3": MetaStepConfig(
            num_epochs=5, bptt_epochs=5, train_batch_size=3,
            augment=AugmentConfig()),
    }


def build_meta_trainer(model, step_cfg, device="cuda", tasks=META_TASKS):
    """scripts/bench_meta_step.py's trainer on the port: neuron-level linear
    lrs at 1e-3 with a learned init, ``tasks`` tasks a meta step from 4
    synthetic 480x480 sequences of 8 frames, one query frame a task."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import MetaTrainConfig, MetaTrainer
    from e_osvos_torch.meta_optim import (
        MetaOptimConfig, MetaTaskset, MetaTasksetConfig,
    )
    from e_osvos_torch.models import functional_apply
    from e_osvos_torch.parallel import OuterOptimConfig
    from e_osvos_torch.utils import MetricsLogger

    index = SyntheticVOSIndex(num_sequences=4, num_frames=8, size=META_HW)
    taskset = MetaTaskset([index], MetaTasksetConfig(
        num_query_frames=1, crop_size=META_HW), seed=0)
    return MetaTrainer(
        functional_apply(model), model, taskset,
        meta_cfg=MetaOptimConfig(lr_hierarchy_level="neuron", init_lr=1e-3,
                                 learn_model_init=True,
                                 use_log_init_lr=False),
        step_cfg=step_cfg, outer_cfg=OuterOptimConfig(),
        train_cfg=MetaTrainConfig(meta_batch_size=tasks,
                                  num_meta_iters=1, vis_interval=10_000),
        logger=MetricsLogger(echo=False), device=device)


def _meta_phase_seconds(marks):
    """CUDA-event marks ``[(phase, event)]`` → per meta step (split at each
    ``start``) the step's seconds and the seconds of each phase, a phase
    being the time from the previous mark to its own."""
    steps, cur = [], None
    for (_, a), (phase, b) in zip(marks, marks[1:]):
        if phase == "start":
            cur = None
            continue
        if cur is None:
            cur = {"step_s": 0.0}
            steps.append(cur)
        dt = a.elapsed_time(b) / 1e3
        cur[f"{phase}_s"] = cur.get(f"{phase}_s", 0.0) + dt
        cur["step_s"] += dt
    return steps


def run_meta_mode(model, tag, step_cfg, n_gn, build=None):
    """``MetaTrainer.run`` over one warm-up and META_TIMED timed meta steps
    in one call (the pipelined loop): per step the device seconds from
    after task sampling to the end of the outer update, split into
    prepare (upload, draws, per-task augmentation), inner steps, query
    pass and outer update; host sampling seconds apart. The kernels'
    launch counts over the run must equal the formula, the meta-loss must
    be finite, and the learned init, the frozen-BN buffers and the lrs
    must all move (the buffers where the model has any). ``build`` makes
    the trainer (``build_meta_trainer`` by default)."""
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms

    trainer = (build or build_meta_trainer)(model, step_cfg)
    before = [{k: v.clone() for k, v in d.items()}
              for d in trainer.meta_params]
    marks, sample_s = [], []

    def mark(phase):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((phase, ev))

    sample = trainer.taskset.sample_batch

    def sample_then_mark(n):
        t0 = time.perf_counter()
        batch = sample(n)
        sample_s.append(time.perf_counter() - t0)
        mark("start")
        return batch

    trainer.taskset.sample_batch = sample_then_mark
    trainer.step.on_phase = mark
    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.run(1 + META_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    nms_calls = cuda_nms.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = _meta_phase_seconds(marks)
    if len(steps) != 1 + META_TIMED:
        raise AssertionError(f"{len(steps)} timed meta steps in {tag}")
    timed = steps[1:]
    med = {k: float(np.median([s[k] for s in timed])) for k in timed[0]}
    log(f"meta-training {tag}: median {med['step_s']:.4f} s a meta step "
        f"({META_TASKS} tasks x {step_cfg.num_epochs} inner steps, "
        f"{META_HW[0]}x{META_HW[1]}, device timeline after sampling), "
        f"steps {[round(s['step_s'], 4) for s in timed]}; warm-up "
        f"{steps[0]['step_s']:.4f} s; host sampling "
        f"{[round(s, 4) for s in sample_s]} s; wall {wall:.3f} s for "
        f"{1 + META_TIMED} steps; peak memory {peak / 2**30:.2f} GiB")
    log(f"meta-training {tag} phases (median seconds a meta step) "
        + json.dumps({k: round(v, 4) for k, v in med.items()}))
    want = {k: v * (1 + META_TIMED) for k, v in expected_meta_launches(
        step_cfg, META_TASKS, n_gn, K.LAUNCHES_PER_CALL).items()}
    log(f"meta-training {tag} launch counts " + json.dumps(counts)
        + " expected " + json.dumps(want))
    if counts != want:
        raise AssertionError(f"meta launch counts {counts} != {want}")
    if any(nms_calls.values()):
        raise AssertionError(f"K3 ran in meta-training {tag}: {nms_calls}")
    log(f"meta-training {tag}: meta-loss {out['meta_loss']:.6f}, per task "
        f"{[round(x, 6) for x in out['per_task_loss']]}")
    if not np.isfinite([out["meta_loss"], *out["per_task_loss"]]).all():
        raise AssertionError(f"non-finite meta-loss in {tag}")
    lrs = set(trainer.meta_params.log_init_lr)
    groups = {"model_init params": (0, lambda k: k in lrs),
              "frozen-BN buffers": (0, lambda k: k not in lrs),
              "lrs": (1, lambda k: True)}
    moved = {}
    for name, (i, pick) in groups.items():
        after = trainer.meta_params[i]
        keys = [k for k in after if pick(k)]
        moved[name] = (sum(not torch.equal(before[i][k], after[k])
                           for k in keys), len(keys))
    log(f"meta-training {tag}: tensors moved by the outer steps "
        + json.dumps({k: f"{a}/{b}" for k, (a, b) in moved.items()}))
    if (any(a == 0 for a, b in moved.values() if b)
            or not moved["model_init params"][1] or not moved["lrs"][1]):
        raise AssertionError(f"meta-parameters did not move: {moved}")
    return counts, {"median_step_s": med, "peak_bytes": peak}


def meta_peak_memory(model, num_epochs: int) -> int:
    """Peak device memory of one single-task per-step batch-3 meta step
    with ``num_epochs`` inner steps in one segment."""
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.parallel import MetaStepConfig

    cfg = MetaStepConfig(num_epochs=num_epochs, bptt_epochs=num_epochs,
                         train_batch_size=3, augment=AugmentConfig())
    trainer = build_meta_trainer(model, cfg, tasks=1)
    batch = trainer.taskset.sample_batch(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = trainer.step(trainer.meta_params, trainer.opt_state, batch)
    float(out.meta_loss)
    return torch.cuda.max_memory_allocated()


def run_meta_training(shared):
    """Meta-training of the full-width main-path model (resnet50 os16
    frozen-BN DeepLabV3+ in bf16, seeded random weights) through
    ``MetaTrainer.run`` in both modes of scripts/bench_meta_step.py, then
    the peak memory of a meta step with 5 and with 10 inner steps: the
    first-order meta-graph keeps one f32 gradient sum of the parameters a
    segment and no activations, whatever the number of steps, so the
    difference must stay within one f32 copy of the parameters."""
    from e_osvos_torch.models import DeepLabV3Plus
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    t0 = time.perf_counter()
    model = DeepLabV3Plus(num_classes=1, arch="resnet50",
                          backbone_norm="frozen_bn", output_stride=16,
                          dtype=torch.bfloat16, seed=0, device="cuda")
    n_gn = sum(isinstance(m, FusedGroupNorm) and m.use_kernel
               for m in model.modules())
    param_bytes = sum(p.numel() * 4 for p in model.parameters())
    log(f"meta-training set-up: {time.perf_counter() - t0:.3f} s; {n_gn} "
        f"GroupNorm layers on the kernels; {param_bytes / 2**20:.1f} MiB of "
        f"f32 parameters (the gradient sum kept a first-order segment)")
    total = {}
    for tag, step_cfg in meta_step_configs().items():
        counts, result = run_meta_mode(model, tag, step_cfg, n_gn)
        shared[f"meta {tag}"] = result
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    p5, p10 = meta_peak_memory(model, 5), meta_peak_memory(model, 10)
    growth = p10 - p5
    log(f"meta step peak memory (1 task, per-step batch 3): 5 inner steps "
        f"{p5 / 2**30:.3f} GiB, 10 inner steps {p10 / 2**30:.3f} GiB; "
        f"growth {growth / 2**20:.1f} MiB for 5 more steps "
        f"({growth / (5 * param_bytes):.2f} f32 parameter copies a step)")
    if not growth <= param_bytes:
        raise AssertionError(f"peak memory grows {growth} bytes over 5 inner "
                             "steps: activations kept across steps")
    return total


def small_meta_step(device, head_norm="group16", second_order=False,
                    draws_from=None):
    """One meta step of 2 tasks on a small fp32 model (resnet10 os16
    frozen-BN DeepLabV3+, 32x32, 2 inner steps truncated after each, the
    per-step mode with degenerate augmentation): returns (step, the first
    task's (loss, grads), the meta-parameters before the step (copies),
    the step's output)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.meta_optim import (
        MetaOptimConfig, MetaTaskset, MetaTasksetConfig, init_meta_params,
    )
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply
    from e_osvos_torch.parallel import (
        MetaStepConfig, OuterOptimConfig, make_meta_step,
    )

    model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                          backbone_norm="frozen_bn", head_norm=head_norm,
                          output_stride=16, seed=5, device=device)
    meta_cfg = MetaOptimConfig(init_lr=1e-2, use_log_init_lr=False,
                               second_order_gradients=second_order)
    aug = AugmentConfig(scale_min=1.0, scale_max=1.0, rot_deg=0.0,
                        brightness=0.0, contrast=0.0, saturation=0.0,
                        flip_prob=0.0, compute_dtype="float32")
    step = make_meta_step(
        functional_apply(model), meta_cfg,
        MetaStepConfig(num_epochs=2, bptt_epochs=1, train_batch_size=2,
                       augment=aug),
        OuterOptimConfig(model_init_lr=1e-3, log_init_lr_lr=1e-3), 2,
        device=device)
    if draws_from is not None:
        step.task_draws = lambda seed, q, hw: draws_from.task_draws(
            seed, q, hw).to(device)
    tasks = MetaTaskset([SyntheticVOSIndex(num_sequences=2, num_frames=4,
                                           size=(32, 32), seed=3)],
                        MetaTasksetConfig(crop_size=(32, 32)), seed=1)
    batch = tasks.sample_batch(2)
    meta = init_meta_params(meta_cfg, model)
    first = step.task_grads(
        meta, *(torch.from_numpy(np.asarray(getattr(batch, f)[0])).to(device)
                for f in ("support_img", "support_label", "query_imgs",
                          "query_labels")), int(batch.seeds[0]))
    start = [t.clone() for d in meta for t in d.values()]
    out = step(meta, step.init(meta), batch)
    return step, first[:2], start, out


def _rel_err(got, want):
    """Largest |got - want| of each tensor pair over the pair's largest
    |want| (at least 1e-6 of the largest of all); the worst of all."""
    got = [a.detach().double().cpu() for a in got]
    want = [b.detach().double().cpu() for b in want]
    floor = 1e-6 * max(float(b.abs().max()) for b in want)
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), floor)
               for a, b in zip(got, want))


def step_change_excess(got_start, got_new, want_start, want_new,
                       tol=1e-3):
    """The outer step's change ``new − start`` held elementwise to a
    reference's: each entry's |Δ_got − Δ_want| may be ``tol`` of its
    tensor's largest |Δ_want| plus two float32 ulps of the parameter (the
    rounding of ``p + Δ`` on each side; many updates are a few ulps).
    Returns (the largest ratio of difference to limit, the entries over
    their limit, the entries)."""
    worst, over, total = 0.0, 0, 0
    for gs, gn, ws, wn in zip(got_start, got_new, want_start, want_new):
        gs, gn, ws, wn = (t.detach().cpu() for t in (gs, gn, ws, wn))
        mag = torch.maximum(ws.abs(), wn.abs()).float()
        ulp = (torch.nextafter(mag, torch.full_like(mag, math.inf))
               - mag).double()
        want = wn.double() - ws.double()
        diff = ((gn.double() - gs.double()) - want).abs()
        limit = tol * float(want.abs().max()) + 2 * ulp
        worst = max(worst, float((diff / limit).max()))
        over += int((diff > limit).sum())
        total += diff.numel()
    return worst, over, total


def check_meta_reference():
    """One meta step of a small fp32 model on the card (the kernels) and on
    the CPU (their twins) from identical draws: the first task's meta-loss
    (rtol 1e-4), its meta-gradients within 1e-3 of each tensor's largest
    magnitude, and the outer step's change of every meta-parameter by
    ``step_change_excess`` (1e-3 of the tensor's largest change plus two
    ulps). The same limit must reject the card's step with its change
    taken as zero (a missing outer update). Then the same with
    second-order meta-gradients through the plain (_xla) norms; second
    order through the kernel norms must raise."""
    tol_loss, tol = 1e-4, 1e-3
    for label, kw in (("first order", {}),
                      ("second order, _xla norms",
                       dict(head_norm="group16_xla", second_order=True))):
        cpu_step, (c_loss, c_grads), c_start, c_out = small_meta_step(
            "cpu", **kw)
        _, (g_loss, g_grads), g_start, g_out = small_meta_step(
            "cuda", draws_from=cpu_step, **kw)
        loss_err = abs(float(g_loss) - float(c_loss)) / abs(float(c_loss))
        grad_err = _rel_err(
            [g for d in g_grads for g in d.values()],
            [g for d in c_grads for g in d.values()])
        c_new = [t for d in c_out.meta_params for t in d.values()]
        g_new = [t for d in g_out.meta_params for t in d.values()]
        worst, over, n = step_change_excess(g_start, g_new, c_start, c_new,
                                            tol)
        _, noop_over, _ = step_change_excess(g_start, g_start, c_start,
                                             c_new, tol)
        log(f"small fp32 meta step ({label}), card vs CPU: meta-loss "
            f"{float(g_loss):.6f} vs {float(c_loss):.6f} (rel {loss_err:.2e}, "
            f"tol {tol_loss}); meta-grads rel {grad_err:.2e} of each "
            f"tensor's largest magnitude (tol {tol}); outer step's change "
            f"at {worst:.3f} of its limit ({tol} of each tensor's largest "
            f"change + 2 ulps), {over} of {n} entries over; the card's step "
            f"taken as no change: {noop_over} of {n} entries over")
        if not (loss_err <= tol_loss and grad_err <= tol and over == 0):
            raise AssertionError(f"card and CPU disagree on the meta step "
                                 f"({label}): {loss_err}, {grad_err}, "
                                 f"{over} changes over the limit")
        if noop_over == 0:
            raise AssertionError(f"the step-change limit ({label}) does not "
                                 "reject a missing outer update")
    try:
        small_meta_step("cuda", second_order=True)
    except RuntimeError as e:
        if "one level of differentiation" not in str(e):
            raise
        log("second order through the kernel norms raises: " + str(e))
    else:
        raise AssertionError("second order through the kernel norms did not "
                             "raise")


# ------------------------------------------- detection meta-training


def full_detection_model(greedy_rpn: bool = False, **roi_kw):
    """The full-width detection model of scripts/exp_det_meta_480p.py and
    scripts/bench_detection_ona.py: resnet50 GroupNorm-32 FPN Mask R-CNN in
    bf16 with f32 parameters, Lovász mask loss, seeded random weights; the
    Fast-NMS RPN unless ``greedy_rpn``."""
    from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig

    return MaskRCNN(arch="resnet50", backbone_norm="group",
                    dtype=torch.bfloat16,
                    rpn=RPNConfig(use_fast_nms=not greedy_rpn),
                    roi=RoIConfig(**roi_kw), seed=0, device="cuda")


def build_detection_meta_trainer(model, step_cfg, device="cuda",
                                 tasks=META_TASKS):
    """scripts/exp_det_meta_480p.py's meta-trainer on the port: the
    detection task family, neuron-level linear lrs at 1e-3 with a learned
    init, ``tasks`` tasks a meta step from 4 synthetic 480x480 sequences of
    8 frames, one query frame a task."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import MetaTrainConfig, MetaTrainer
    from e_osvos_torch.meta_optim import (
        MetaOptimConfig, MetaTaskset, MetaTasksetConfig,
    )
    from e_osvos_torch.models import functional_apply
    from e_osvos_torch.parallel import OuterOptimConfig, detection_task_fns
    from e_osvos_torch.utils import MetricsLogger

    index = SyntheticVOSIndex(num_sequences=4, num_frames=8, size=META_HW)
    taskset = MetaTaskset([index], MetaTasksetConfig(
        num_query_frames=1, crop_size=META_HW), seed=0)
    apply = functional_apply(model)
    return MetaTrainer(
        apply, model, taskset,
        meta_cfg=MetaOptimConfig(lr_hierarchy_level="neuron", init_lr=1e-3,
                                 learn_model_init=True,
                                 use_log_init_lr=False),
        step_cfg=step_cfg, outer_cfg=OuterOptimConfig(),
        train_cfg=MetaTrainConfig(meta_batch_size=tasks,
                                  num_meta_iters=1, vis_interval=10_000),
        logger=MetricsLogger(echo=False), device=device,
        task_fns=detection_task_fns(model, step_cfg))


def run_detection_meta_training(shared):
    """Meta-training of the full-width Mask R-CNN (Fast-NMS RPN) through
    ``MetaTrainer.run`` in both modes of scripts/bench_meta_step.py (4
    tasks at 480x480, 1 query frame, 5 inner steps in one segment, first
    order): the same timings and checks as the DeepLab meta-training, the
    53 backbone GroupNorms on the kernels, no K3 call (the Fast-NMS RPN)."""
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    t0 = time.perf_counter()
    model = full_detection_model()
    n_gn = sum(isinstance(m, FusedGroupNorm) and m.use_kernel
               for m in model.modules())
    log(f"Mask R-CNN meta-training set-up: {time.perf_counter() - t0:.3f} s; "
        f"{n_gn} GroupNorm layers on the kernels")
    if n_gn != 53:
        raise AssertionError(f"{n_gn} GroupNorms on the kernels, not 53")
    total = {}
    for tag, step_cfg in meta_step_configs().items():
        counts, result = run_meta_mode(model, f"Mask R-CNN, {tag}", step_cfg,
                                       n_gn, build=build_detection_meta_trainer)
        shared[f"detection meta {tag}"] = result
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# The task sampler's seeds the small detection meta step may take, in the
# order they are tried. How far rounding alone moves a random-init detector
# through two inner steps depends on the tasks and on the weights, which
# differ between torch versions (the seeded truncated-normal init): with
# weights scaled by 1 ± 1e-6 on one CPU (``scripts/parity_spread.py
# small-meta``), seeds 2, 3, 4 and 6 moved the meta-loss by at most 5.7e-6
# and no gradient entry beyond 0.48 of the check's limit, seed 1 moved it
# by 1.3e-5 and put 23109 entries over. So the check takes the first seed
# whose own CPU sensitivity lies well inside its tolerance on the machine
# it runs on, and prints the scan.
DET_META_SEEDS = (3, 2, 4, 6, 7, 8, 5, 1)
DET_META_SUBTREES = {
    "first order": None,
    "second order, roi_heads (the default)": ("roi_heads",),
    "second order, box and mask heads": ("box_head", "mask_head"),
}


def small_detection_meta_step(device, subtrees=None, draws_from=None,
                              perturb: float = 0.0,
                              seed: int = DET_META_SEEDS[0]):
    """One meta step of 2 tasks of the detection family on a tiny fp32 Mask
    R-CNN (resnet10 GroupNorm-4 FPN, 64x64, 2 inner steps in one segment,
    the per-step mode at batch 2 with degenerate augmentation): first
    order, or second order restricted to ``subtrees``; the tasks from the
    sampler's ``seed``. ``perturb`` > 0 scales every weight by ``1 ±
    perturb`` (seeded signs). Returns (step,
    the first task's (loss, grads), the meta-parameters before the step
    (copies), the step's output)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.meta_optim import (
        MetaOptimConfig, MetaTaskset, MetaTasksetConfig, init_meta_params,
    )
    from e_osvos_torch.models import (
        MaskRCNN, RoIConfig, RPNConfig, functional_apply,
    )
    from e_osvos_torch.parallel import (
        MetaStepConfig, OuterOptimConfig, detection_task_fns, make_meta_step,
    )

    model = MaskRCNN(
        arch="resnet10", backbone_norm="group4",
        rpn=RPNConfig(anchor_sizes=(8, 16, 32, 64, 128), pre_nms_top_n=64,
                      post_nms_top_n=32, batch_size_per_image=32),
        roi=RoIConfig(batch_size_per_image=16, detections_per_img=1),
        seed=5, device=device)
    if perturb:
        gen = torch.Generator(device="cpu").manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.mul_(1 + perturb * sign.to(p.device, p.dtype))
    meta_cfg = MetaOptimConfig(init_lr=1e-4, use_log_init_lr=False,
                               second_order_gradients=subtrees is not None,
                               second_order_subtrees=tuple(subtrees or ()))
    aug = AugmentConfig(scale_min=1.0, scale_max=1.0, rot_deg=0.0,
                        brightness=0.0, contrast=0.0, saturation=0.0,
                        flip_prob=0.0, compute_dtype="float32")
    step_cfg = MetaStepConfig(num_epochs=2, bptt_epochs=2, train_batch_size=2,
                              augment=aug, remat=False)
    apply = functional_apply(model)
    step = make_meta_step(
        apply, meta_cfg, step_cfg,
        OuterOptimConfig(model_init_lr=1e-3, log_init_lr_lr=1e-3), 2,
        device=device, task_fns=detection_task_fns(model, step_cfg))
    if draws_from is not None:
        step.task_draws = lambda seed, q, hw: draws_from.task_draws(
            seed, q, hw).to(device)
    tasks = MetaTaskset([SyntheticVOSIndex(num_sequences=2, num_frames=4,
                                           size=(64, 64), seed=3)],
                        MetaTasksetConfig(crop_size=(64, 64)), seed=seed)
    batch = tasks.sample_batch(2)
    meta = init_meta_params(meta_cfg, model)
    names = [k for d in meta for k in d]
    first = step.task_grads(
        meta, *(torch.from_numpy(np.asarray(getattr(batch, f)[0])).to(device)
                for f in ("support_img", "support_label", "query_imgs",
                          "query_labels")), int(batch.seeds[0]))
    start = [t.clone() for d in meta for t in d.values()]
    out = step(meta, step.init(meta), batch)
    return step, first, start, out, names


def head_split_excess(names, got, want, tol=1e-3):
    """Elementwise |got − want| against ``tol`` of each tensor's largest
    |want|: (entries over outside the mask head, entries over in it, the
    mask head's entries, the worst ratio). The Lovász mask loss's gradient
    depends on the order of its sorted errors, which two errors equal to
    rounding may swap between devices, so mask-head entries are counted
    apart."""
    rest = head = head_n = 0
    worst = 0.0
    for name, g, w in zip(names, got, want):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        limit = tol * max(float(w.abs().max()), 1e-30)
        ratio = (g - w).abs() / limit
        n = int((ratio > 1).sum())
        worst = max(worst, float(ratio.max()))
        if name.startswith("mask_head."):
            head, head_n = head + n, head_n + ratio.numel()
        else:
            rest += n
    return rest, head, head_n, worst


def pick_detection_meta_seed(tol_loss: float, tol: float):
    """The first of DET_META_SEEDS whose first-order meta step moves, on
    the CPU with weights scaled by 1 ± 1e-6, its meta-loss by at most a
    tenth of ``tol_loss`` and no meta-gradient entry beyond half its limit
    (``tol`` of its tensor's largest magnitude). Returns the seed."""
    for seed in DET_META_SEEDS:
        step, (loss, grads, _), _, _, names = small_detection_meta_step(
            "cpu", seed=seed)
        _, (p_loss, p_grads, _), _, _, _ = small_detection_meta_step(
            "cpu", draws_from=step, perturb=1e-6, seed=seed)
        sens = abs(float(p_loss) - float(loss)) / abs(float(loss))
        rest, head, _, worst = head_split_excess(
            names, [g for d in p_grads for g in d.values()],
            [g for d in grads for g in d.values()], tol)
        log(f"small detection meta step, task seed {seed}: the CPU alone "
            f"with weights x (1 ± 1e-6) moves the meta-loss by {sens:.2e} "
            f"and its gradients by at most {worst:.3f} of the limit "
            f"({rest} + {head} entries over)")
        if sens <= tol_loss / 10 and worst <= 0.5:
            return seed
    raise AssertionError("no task seed gives a well-conditioned small "
                         "detection meta step")


def check_detection_meta_reference():
    """The small detection meta step on the card (the GroupNorm kernels,
    the backbone's included under second order) and on the CPU (their
    twins) from identical draws, first order and second order restricted
    to the box and mask heads, on the tasks ``pick_detection_meta_seed``
    finds well-conditioned on this machine's CPU: the first task's
    meta-loss (rtol 1e-4); its meta-gradients within 1e-3 of each tensor's
    largest magnitude, none over outside the mask head, at most 1% of the
    mask head's entries over and each within 10 times its limit; the outer
    step's change by ``step_change_excess`` (1e-3 of each tensor's largest
    change plus two ulps) with the same mask-head allowance, and the same
    limit rejecting the card's step taken as no change. The CPU's own
    sensitivity (weights scaled by 1 ± 1e-6) is printed beside each
    result. The default restriction, ``roi_heads``, names no parameter of
    either package's Mask R-CNN: on the CPU its step must agree with the
    first-order one within the same tolerances."""
    from e_osvos_torch.ops import cuda_group_norm as K

    tol_loss, tol = 1e-4, 1e-3
    seed = pick_detection_meta_seed(tol_loss, tol)
    cpu_runs = {}
    for label, subtrees in DET_META_SUBTREES.items():
        cpu_step, (c_loss, c_grads, c_tr), c_start, c_out, names = (
            small_detection_meta_step("cpu", subtrees, seed=seed))
        cpu_runs[label] = (c_loss, c_grads, c_out)
        if subtrees == ("roi_heads",):
            f_loss, f_grads, _ = cpu_runs["first order"]
            err = abs(float(c_loss) - float(f_loss)) / abs(float(f_loss))
            rest, head, head_n, worst = head_split_excess(
                names, [g for d in c_grads for g in d.values()],
                [g for d in f_grads for g in d.values()], tol)
            log(f"small fp32 detection meta step ({label}) against the "
                f"first-order step, both on the CPU: meta-loss rel {err:.2e}; "
                f"meta-grads {rest} + {head} entries over {tol} of their "
                f"tensor's largest magnitude, worst {worst:.3f} of the limit "
                "(the subtree names no parameter: first order, computed out "
                "of place)")
            if not (err <= tol_loss and rest == 0 and head <= 0.01 * head_n
                    and worst <= 10):
                raise AssertionError("second order restricted to roi_heads "
                                     "differs from first order")
            continue
        _, (p_loss, p_grads, _), _, _, _ = small_detection_meta_step(
            "cpu", subtrees, draws_from=cpu_step, perturb=1e-6, seed=seed)
        K.reset_launch_counts()
        _, (g_loss, g_grads, g_tr), g_start, g_out, _ = (
            small_detection_meta_step("cuda", subtrees, draws_from=cpu_step,
                                      seed=seed))
        torch.cuda.synchronize()
        counts = K.launch_counts()

        def flat(grads):
            return [g for d in grads for g in d.values()]

        loss_err = abs(float(g_loss) - float(c_loss)) / abs(float(c_loss))
        sens_loss = abs(float(p_loss) - float(c_loss)) / abs(float(c_loss))
        rest, head, head_n, worst = head_split_excess(
            names, flat(g_grads), flat(c_grads), tol)
        s_rest, s_head, _, s_worst = head_split_excess(
            names, flat(p_grads), flat(c_grads), tol)
        c_new = [t for d in c_out.meta_params for t in d.values()]
        g_new = [t for d in g_out.meta_params for t in d.values()]
        heads = [n.startswith("mask_head.") for n in names]

        def part(xs, in_head):
            return [x for x, h in zip(xs, heads) if h == in_head]

        step_worst, step_over, n = step_change_excess(
            part(g_start, False), part(g_new, False),
            part(c_start, False), part(c_new, False), tol)
        h_worst, h_over, h_n = step_change_excess(
            part(g_start, True), part(g_new, True),
            part(c_start, True), part(c_new, True), tol)
        _, noop_over, _ = step_change_excess(g_start, g_start, c_start,
                                             c_new, tol)
        log(f"small fp32 detection meta step ({label}, task seed {seed}), "
            f"card vs CPU: meta-loss {float(g_loss):.6f} vs "
            f"{float(c_loss):.6f} (rel {loss_err:.2e}, tol {tol_loss}; the "
            f"CPU alone with weights x (1 ± 1e-6): {sens_loss:.2e}); "
            f"meta-grads over {tol} of their tensor's largest magnitude: "
            f"{rest} outside the mask head, {head} of its {head_n} entries, "
            f"worst {worst:.2f} of the limit (the CPU alone, weights x (1 ± "
            f"1e-6): {s_rest}, {s_head}, {s_worst:.2f}); outer step's change "
            f"at {step_worst:.3f} / {h_worst:.3f} of its limit outside / in "
            f"the mask head, {step_over} of {n} / {h_over} of {h_n} entries "
            f"over; the card's step taken as no change: {noop_over} entries "
            f"over; the first task's inner losses {g_tr.tolist()} vs "
            f"{c_tr.tolist()}, the tasks' meta-losses "
            f"{g_out.per_task_loss.tolist()} vs {c_out.per_task_loss.tolist()}"
            f"; GroupNorm kernel launches on the card " + json.dumps(counts))
        if not (loss_err <= tol_loss and rest == 0 and head <= 0.01 * head_n
                and worst <= 10 and step_over == 0 and h_over <= 0.01 * h_n
                and h_worst <= 10):
            raise AssertionError(f"card and CPU disagree on the detection "
                                 f"meta step ({label})")
        if noop_over == 0:
            raise AssertionError(f"the step-change limit ({label}) does not "
                                 "reject a missing outer update")
        if not (counts.get("group_stats") and counts.get("group_grad_coeffs")):
            raise AssertionError(f"the detection meta step ({label}) did not "
                                 f"run on the GroupNorm kernels: {counts}")


# ------------------------------------------------------- parent training

PARENT_TIMED = 3  # timed steps a model, after one warm-up


class FixedBatch:
    """A sampler that hands out its first batch again and again (with its
    seeds, so the augmentation repeats too): the loss must fall on it."""

    def __init__(self, sampler):
        self.sampler, self.batch = sampler, None

    def sample_batch(self, n):
        if self.batch is None:
            self.batch = self.sampler.sample_batch(n)
        return self.batch


def run_parent_phase(tag, model, cfg, sampler, n_gn, greedy_rpn=False):
    """One warm-up and PARENT_TIMED timed ``ParentTrainer`` steps on one
    fixed batch, then the loss of that batch once more without a step:
    each step's seconds (synchronized wall time), the peak memory, finite
    losses with the last below the first (a detection loss swings from
    step to step while the box classifier settles, so the check reads the
    end, not each step), and launch counts of one forward and one backward
    a step and the last forward on each of the ``n_gn`` GroupNorms, with K3
    route L once for each image of a forward with the greedy RPN."""
    from e_osvos_torch.engine import ParentTrainer
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms
    from e_osvos_torch.utils import MetricsLogger
    from e_osvos_torch.utils.device import upload

    trainer = ParentTrainer(model, FixedBatch(sampler), cfg,
                            logger=MetricsLogger(echo=False), device="cuda")
    batch = trainer.sampler.sample_batch(cfg.batch_size)
    losses, secs = [], []
    for i in range(1 + PARENT_TIMED):
        if i == 1:
            K.reset_launch_counts()
            cuda_nms.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(*batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    with torch.no_grad():
        losses.append(float(trainer.loss(
            trainer.params, *(upload(a, trainer.device) for a in batch[:2]),
            *trainer.sample_draws(batch[2], tuple(batch[0].shape[1:3])))))
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    calls = {"group_stats": PARENT_TIMED + 1,
             "affine_apply": PARENT_TIMED + 1,
             "group_grad_coeffs": PARENT_TIMED, "affine_dx": PARENT_TIMED}
    want = {k: v * n_gn * K.LAUNCHES_PER_CALL[k] for k, v in calls.items()}
    rpn = (PARENT_TIMED + 1) * cfg.batch_size if greedy_rpn else 0
    want.update(greedy_nms=rpn, greedy_nms_s=0, greedy_nms_l=rpn)
    log(f"parent training, {tag}: steps {[round(x, 4) for x in secs[1:]]} s "
        f"(median {float(np.median(secs[1:])):.4f} s; warm-up {secs[0]:.3f} "
        f"s), batch {cfg.batch_size} at {cfg.crop_size[0]}x{cfg.crop_size[1]}"
        f", {cfg.optimizer} lr {cfg.lr}; peak memory {peak / 2**30:.2f} GiB; "
        f"losses on the fixed batch (before each step, then after the "
        f"last) {[round(x, 6) for x in losses]}")
    log(f"parent training, {tag}: launch counts " + json.dumps(counts)
        + " expected " + json.dumps(want))
    if counts != want:
        raise AssertionError(f"parent {tag} launch counts {counts} != {want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"parent {tag}: losses {losses} do not fall")
    return counts


def run_parent_training(shared):
    """``ParentTrainer`` at the ``ParentTrainConfig`` defaults on the
    full-width DeepLabV3+ (resnet50 os16 frozen-BN, GN-16 head, bf16; batch
    8 at 480x480, Adam lr 1e-4, cross-entropy and dice), then on the
    full-width Mask R-CNN with the greedy RPN (batch 4, 2 instance slots,
    lr 1e-4: scripts/exp_det_meta_480p.py's parent), each on synthetic
    480x480 frames."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import (
        FrameSampler, InstanceFrameSampler, ParentTrainConfig,
    )
    from e_osvos_torch.models import DeepLabV3Plus
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    def kernel_norms(model):
        return sum(isinstance(m, FusedGroupNorm) and m.use_kernel
                   for m in model.modules())

    total = {}
    model = DeepLabV3Plus(num_classes=1, arch="resnet50",
                          backbone_norm="frozen_bn", output_stride=16,
                          dtype=torch.bfloat16, seed=0, device="cuda")
    index = SyntheticVOSIndex(num_sequences=4, num_frames=8, size=META_HW)
    counts = run_parent_phase(
        "DeepLab", model, ParentTrainConfig(crop_size=META_HW),
        FrameSampler([index], META_HW, seed=0), kernel_norms(model))
    del model
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    model = full_detection_model(greedy_rpn=True)
    index = SyntheticVOSIndex(num_sequences=4, num_frames=8, size=META_HW,
                              num_objects=2)
    cfg = ParentTrainConfig(task="detection", batch_size=4, max_objects=2,
                            crop_size=META_HW)
    counts = run_parent_phase(
        "Mask R-CNN (greedy RPN)", model, cfg,
        InstanceFrameSampler([index], META_HW, max_objects=2, seed=0),
        kernel_norms(model), greedy_rpn=True)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def run_cli_training(shared):
    """The training command lines at full width on the disk tree's train
    split (``build_480p_tree(with_train=True)``): ``cli.train_parent`` for
    Mask R-CNN (2 steps, batch 4, 2 instance slots, 480x480 crops), then
    ``cli.train_meta`` from that parent (``parent_model.checkpoint``; 2
    meta-iterations of 2 tasks, 2 inner steps, ``random_box_coord_perm``),
    then ``cli.evaluate`` from that meta checkpoint on an 8-frame 480x854
    sequence written into the tree. The learned init must start at the
    parent, and the launch counts equal what the three runs imply."""
    from e_osvos_torch import config
    from e_osvos_torch.cli import evaluate, train_meta, train_parent
    from e_osvos_torch.data.synthetic_disk import _write_sequence
    from e_osvos_torch.engine import DetectionOneShotConfig
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms
    from e_osvos_torch.utils import load_checkpoint

    tree = disk_tree(shared)
    root = os.path.join(tree, "DAVIS")
    short_t = 8
    _write_sequence(root, "short", [dict(color=(210, 80, 60), x0=300, y0=220,
                                         dx=6.0, dy=2.0, rx=60, ry=45)],
                    np.random.RandomState(11), MAIN_HW[0], MAIN_HW[1],
                    short_t)
    with open(os.path.join(root, "ImageSets", "2017", "short.txt"), "w") as f:
        f.write("short\n")
    out = os.path.join(tree, "training")
    base = ["with", "DAVIS-2017", f"datasets.train.root={root}",
            f"datasets.val.root={root}", "parent_model.architecture=MaskRCNN",
            "parent_model.backbone_norm=group", "data_cfg.crop_sizes.train="
            f"[{META_HW[0]},{META_HW[1]}]"]
    n_gn = 53

    def per_pass(passes):
        return {k: passes * n_gn * K.LAUNCHES_PER_CALL[k]
                for k in ("group_stats", "affine_apply", "group_grad_coeffs",
                          "affine_dx")}

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    t0 = time.perf_counter()
    argv = base + [f"save_dir={os.path.join(out, 'parent')}",
                   "parent.num_iters=2", "parent.batch_size=4",
                   "parent.max_objects=2", "parent.log_interval=1"]
    log("CLI training: python -m e_osvos_torch.cli.train_parent "
        + " ".join(argv))
    with contextlib.redirect_stdout(io.StringIO()):  # metrics.jsonl has it
        train_parent.main(argv)
    parent = os.path.join(out, "parent", "parent_final.ckpt")
    parent_state, meta = load_checkpoint(parent, map_location="cuda")
    log(f"CLI training: train_parent {time.perf_counter() - t0:.3f} s; "
        f"{parent} at step {meta['step']}")

    t0 = time.perf_counter()
    argv = base + [f"parent_model.checkpoint={parent}",
                   f"save_dir={os.path.join(out, 'meta')}",
                   "random_box_coord_perm=True", "num_meta_iters=2",
                   "meta_batch_size=2", "num_epochs.train=2",
                   "bptt_epochs=2", "vis_interval=1"]
    log("CLI training: python -m e_osvos_torch.cli.train_meta "
        + " ".join(argv))
    with contextlib.redirect_stdout(io.StringIO()):  # metrics.jsonl has it
        trainer = train_meta.main(argv)
    init = trainer.meta_params.model_init
    drift = max(float((init[k] - parent_state[k]).abs().max())
                for k in parent_state)
    log(f"CLI training: train_meta {time.perf_counter() - t0:.3f} s; the "
        f"learned init {drift:.3e} from the parent after 2 outer steps")
    if set(init) != set(parent_state) or not 0.0 < drift < 1e-3:
        raise AssertionError("the meta-training did not start from the "
                             f"parent checkpoint (largest change {drift})")

    t0 = time.perf_counter()
    ckpt = os.path.join(out, "meta", "last_meta_iter.ckpt")
    argv = base + ["e-OSVOS-OnA", "datasets.val.split=short",
                   f"parent_model.checkpoint={parent}",
                   f"meta_optim_model_file={ckpt}",
                   f"save_dir={os.path.join(out, 'eval')}",
                   "parent_model.detections_per_img=1",
                   "num_epochs.eval=10", "eval_online_adapt.min_prop=0.75",
                   "eval_ona_window_bucket=0", "eval_fused_ona=True"]
    log("CLI training: python -m e_osvos_torch.cli.evaluate " + " ".join(argv))
    records = evaluate.main(argv)
    torch.cuda.synchronize()
    log(f"CLI training: evaluate {time.perf_counter() - t0:.3f} s; "
        + json.dumps(records))
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    if [r["event"] for r in records] != ["eval_seq", "eval_total"] or not (
            0.0 <= records[0]["J_mean"] <= 1.0):
        raise AssertionError(f"CLI training: evaluation records {records}")
    cfg = config.parse_cli(argv)
    one = config.to_one_shot_config(cfg)
    det_cfg = DetectionOneShotConfig(**{
        f.name: getattr(one, f.name) for f in dataclasses.fields(one)})
    want = expected_detection_launches(det_cfg, short_t, n_gn,
                                       K.LAUNCHES_PER_CALL)
    meta_passes = 2 * 2 * (2 + 1)  # iterations x tasks x (inner + query)
    for k, v in per_pass(2 + meta_passes).items():  # + 2 parent steps
        want[k] += v
    log("CLI training: launch counts " + json.dumps(counts) + " expected "
        + json.dumps(want))
    if counts != want:
        raise AssertionError(f"CLI training launch counts {counts} != {want}")
    return counts


# ------------------------------------------------------- detection path

DET_WARMUP_T = 7  # two windows: a fine-tune, a refit, 10 inferred frames


def expected_detection_launches(cfg, T: int, n_gn: int, per_call,
                                greedy_rpn: bool = False):
    """Launches one detection sequence implies (support frame 0, one
    detection per frame): every GroupNorm of the backbone calls the forward
    wrappers once per training step and once per inferred frame (the padded
    tail included), the backward wrappers once per training step; K3 runs
    once per inferred frame in the detection head at (N = 512, max_out =
    1), on route S. With the greedy RPN, K3 also selects the proposals of
    each image at (4336, 512), on route L: ``batch_size`` images a
    fine-tune step, the support frame and ``min(step, batch_size)`` pseudo
    frames a refit step, one image an inferred frame."""
    step = cfg.online_adapt_step
    windows = -(-(T - 1) // step)
    refit_steps = (windows - 1) * cfg.online_adapt_epochs
    steps = cfg.num_epochs + refit_steps
    frames = windows * step
    calls = {"group_stats": steps + frames, "affine_apply": steps + frames,
             "group_grad_coeffs": steps, "affine_dx": steps}
    want = {k: v * n_gn * per_call[k] for k, v in calls.items()}
    rpn = (cfg.num_epochs * cfg.batch_size
           + refit_steps * (1 + min(step, cfg.batch_size)) + frames
           if greedy_rpn else 0)
    want.update(greedy_nms=frames + rpn, greedy_nms_s=frames,
                greedy_nms_l=rpn)
    return want


def build_detection_path(device="cuda", greedy_rpn: bool = False):
    """scripts/bench_detection_ona.py's e-OSVOS-50-OnA configuration on the
    port, with one detection per frame (the single-id VOS mode): full-width
    resnet50 GroupNorm-32 FPN Mask R-CNN in bf16 with seeded random weights,
    neuron-level linear lrs at 1e-4 with a learned init, EXTEND proposal
    augmentation, OnA every 5 frames for 10 steps at min_prop 0.75 in the
    fused window loop, and two synthetic 480x854 sequences of 67 frames.
    ``greedy_rpn`` selects
    the proposals by exact greedy NMS (the reference's torchvision RPN), not
    Fast NMS."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import (
        DetectionOneShotConfig, DetectionOneShotEvaluator,
    )
    from e_osvos_torch.meta_optim import MetaOptimConfig, init_meta_params
    from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig

    model = MaskRCNN(arch="resnet50", backbone_norm="group",
                     dtype=torch.bfloat16,
                     rpn=RPNConfig(use_fast_nms=not greedy_rpn),
                     roi=RoIConfig(detections_per_img=1), seed=0,
                     device=device)
    meta_cfg = MetaOptimConfig(lr_hierarchy_level="neuron", init_lr=1e-4,
                               learn_model_init=True, use_log_init_lr=False)
    meta_params = init_meta_params(meta_cfg, model)
    cfg = DetectionOneShotConfig(num_epochs=50, batch_size=3,
                                 online_adapt_step=5, online_adapt_epochs=10,
                                 online_adapt_min_prop=0.75,
                                 proposal_aug_mode="EXTEND")
    evaluator = DetectionOneShotEvaluator(model, meta_cfg, cfg, device=device,
                                          fused_ona=True)
    index = SyntheticVOSIndex(num_sequences=2, num_frames=MAIN_T,
                              size=MAIN_HW, num_objects=1, seed=0)
    return model, meta_params, evaluator, index


class CheckedRPNNMS:
    """Stands in for the RPN's ``batched_nms`` in a warm-up: every
    ``every``-th call, up to ``most`` of them, its K3 picks are held
    against the plain twin on the same inputs, moved to the CPU."""

    def __init__(self, every: int = 48, most: int = 5):
        from e_osvos_torch.ops import nms

        self.batched_nms, self.every, self.most = nms.batched_nms, every, most
        self.calls, self.checked = 0, []

    def __call__(self, boxes, scores, ids, thr, max_out, valid=None):
        got = self.batched_nms(boxes, scores, ids, thr, max_out, valid=valid)
        if self.calls % self.every == 0 and len(self.checked) < self.most:
            want = self.batched_nms(
                boxes.cpu(), scores.cpu(), ids.cpu(), thr, max_out,
                valid=None if valid is None else valid.cpu())
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            self.checked.append((tuple(boxes.shape), max_out, same))
        self.calls += 1
        return got


def run_detection_path(greedy_rpn: bool = False):
    from e_osvos_torch.models import rpn
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    H, W = MAIN_HW
    tag = "detection (greedy RPN)" if greedy_rpn else "detection"
    t0 = time.perf_counter()
    model, meta_params, evaluator, index = build_detection_path(
        greedy_rpn=greedy_rpn)
    n_gn = sum(isinstance(mod, FusedGroupNorm) and mod.use_kernel
               for mod in model.modules())
    staged = stage_frames(index)
    torch.cuda.synchronize()
    log(f"{tag} set-up (model, meta-params, staged frames): "
        f"{time.perf_counter() - t0:.3f} s; {n_gn} GroupNorm layers on the "
        f"kernels")

    t0 = time.perf_counter()
    checked = CheckedRPNNMS() if greedy_rpn else None
    if checked:
        rpn.batched_nms = checked
    try:
        timed_sequence(evaluator, meta_params, index, staged, "seq00",
                       DET_WARMUP_T, 0, "cuda")
    finally:
        if checked:
            rpn.batched_nms = checked.batched_nms
    torch.cuda.synchronize()
    log(f"{tag} warm-up sequence ({DET_WARMUP_T} frames): "
        f"{time.perf_counter() - t0:.3f} s")
    if checked:
        log(f"{tag}: RPN NMS calls held against the twin in the warm-up "
            f"(boxes shape, max_out, identical): {checked.checked}")
        if not checked.checked or not all(c[2] for c in checked.checked):
            raise AssertionError("K3 disagrees with its twin on the greedy "
                                 "RPN's inputs")

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, masks, phases = timed_sequence(evaluator, meta_params, index,
                                          staged, "seq01", MAIN_T, 1, "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    want = expected_detection_launches(evaluator.cfg, MAIN_T, n_gn,
                                       K.LAUNCHES_PER_CALL, greedy_rpn)
    log(f"{tag} timed sequence ({MAIN_T} frames at {H}x{W}): {dt:.3f} s, "
        f"{MAIN_T / dt:.4f} fps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{tag} phases (device timeline; fetched = threshold, pack and "
        "host fetch) " + json.dumps(phases))
    log(f"{tag} launch counts " + json.dumps(counts) + " expected "
        + json.dumps(want))
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if tuple(probs.shape) != (MAIN_T, H, W) or masks.shape != (MAIN_T, H, W):
        raise AssertionError(f"output shapes {tuple(probs.shape)}, {masks.shape}")
    if not bool(torch.isfinite(probs).all()):
        raise AssertionError(f"non-finite probabilities on the {tag} path")
    detected = (probs[1:] > 0).flatten(1).any(1).float().mean()
    log(f"{tag}: share of frames with a non-empty detection "
        f"{float(detected):.4f}; foreground share of the masks "
        f"{float(masks[1:].mean()):.4f}")
    return counts


DET_REF_T = 5
# The synthetic sequence's seed. How far rounding alone moves this small
# tracked sequence depends on the input: on seeds 3 and 8 the card read up
# to 4.0e-3 from the CPU in some runs, and on the CPU alone weights scaled
# by 1 ± 2^-20 move seed 3's probabilities by 0.45-0.51
# (scripts/torch_ref_spread.py, readings in PERF.md). Seed 6 read at most
# 4.0e-4 on the card in every recorded run.
DET_REF_SEED = 6


def detection_reference_setup(device: str, perturb: float = 0.0,
                              fused_ona: bool = True,
                              only_box_head: bool = False):
    """The tiny fp32 Mask R-CNN of the detection reference on ``device``,
    its meta-parameters and its evaluator (the fused window loop unless
    ``fused_ona`` is False; ``only_box_head`` refits the heads alone).
    ``perturb`` > 0 scales every weight by ``1 ± perturb`` (seeded signs):
    rounding noise put in on purpose."""
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import (
        DetectionOneShotConfig, DetectionOneShotEvaluator,
    )
    from e_osvos_torch.meta_optim import MetaOptimConfig, init_meta_params
    from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig

    cfg = DetectionOneShotConfig(
        num_epochs=2, batch_size=3, online_adapt_step=2,
        online_adapt_epochs=2, proposal_aug_mode="EXTEND",
        ona_only_box_head=only_box_head,
        augment=AugmentConfig(
            scale_min=1.0, scale_max=1.0, rot_deg=0.0, brightness=0.0,
            contrast=0.0, saturation=0.0, flip_prob=0.0,
            compute_dtype="float32"))
    meta_cfg = MetaOptimConfig(init_lr=1e-3, use_log_init_lr=False)
    rpn = RPNConfig(anchor_sizes=(8, 16, 32, 64, 128), pre_nms_top_n=64,
                    post_nms_top_n=32, batch_size_per_image=32)
    roi = RoIConfig(batch_size_per_image=16, detections_per_img=1)
    model = MaskRCNN(arch="resnet10", backbone_norm="group4", rpn=rpn,
                     roi=roi, seed=5, device=device)
    if perturb:
        gen = torch.Generator(device="cpu").manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.mul_(1 + perturb * sign.to(p.device, p.dtype))
    meta_params = init_meta_params(meta_cfg, model)
    ev = DetectionOneShotEvaluator(model, meta_cfg, cfg, device=device,
                                   fused_ona=fused_ona)
    return meta_params, ev


def detection_reference(device: str, index_seed: int = DET_REF_SEED,
                        perturb: float = 0.0, fused_ona: bool = True,
                        only_box_head: bool = False):
    """``DetectionOneShotEvaluator.eval_sequence`` of a 2-object 5-frame
    64x64 synthetic sequence (seed ``index_seed``) on the tiny fp32 Mask
    R-CNN of ``detection_reference_setup`` on ``device``, the random
    numbers drawn from CPU generators. Returns the result dict (the
    probabilities on the host) and the detection head's NMS picks frame by
    frame, on the host."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.models import mask_rcnn

    index = SyntheticVOSIndex(num_sequences=1, num_frames=DET_REF_T,
                              size=(64, 64), num_objects=2, seed=index_seed)
    meta_params, ev = detection_reference_setup(device, perturb, fused_ona,
                                                only_box_head)
    batched_nms, picks = mask_rcnn.batched_nms, []

    def recording_nms(*args, **kwargs):
        idx, keep = batched_nms(*args, **kwargs)
        picks.append(idx.cpu())
        return idx, keep

    mask_rcnn.batched_nms = recording_nms
    try:
        res = ev.eval_sequence(index, "seq00", meta_params, 0)
    finally:
        mask_rcnn.batched_nms = batched_nms
    res["probs"] = res["probs"].cpu()
    return res, picks


def check_detection_reference():
    """The detection reference on the card and on the CPU, with the same
    random numbers, in the fused window loop, the host loop, and the host
    loop refitting the box and mask heads alone: probabilities within 1e-3
    and the same NMS pick in every frame. Then, on the card,
    ``eval_stream`` over two sequences against ``eval_sequence`` with the
    seeds ``fold_in(seed, i)`` (the fused loop): identical merged maps."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import fold_in

    for label, fused, heads in (("fused loop", True, False),
                                ("host loop", False, False),
                                ("host loop, only box head", False, True)):
        res, picks = {}, {}
        for device in ("cpu", "cuda"):
            res[device], picks[device] = detection_reference(
                device, fused_ona=fused, only_box_head=heads)
        probs = {d: r["probs"] for d, r in res.items()}
        if probs["cuda"].shape != (2, DET_REF_T, 64, 64):
            raise AssertionError(f"probs shape {tuple(probs['cuda'].shape)}")
        err = (probs["cpu"] - probs["cuda"]).abs().max().item()
        same = [torch.equal(a, b) for a, b in zip(picks["cpu"], picks["cuda"])]
        log(f"tiny fp32 detection eval_sequence ({label}; 2 objects, sequence "
            f"seed {DET_REF_SEED}), card vs CPU: max |dprob| = {err:.3e} (tol "
            f"1e-3); NMS picks of {len(same)} frames identical: {all(same)}; "
            f"J per object on the card {res['cuda']['J_per_object']}, on the "
            f"CPU {res['cpu']['J_per_object']}")
        if not err <= 1e-3:
            raise AssertionError(f"card and CPU disagree on the detection "
                                 f"slice ({label}): {err}")
        if len(picks["cpu"]) != len(picks["cuda"]) or not all(same) or not same:
            raise AssertionError(f"card and CPU picked different detections "
                                 f"({label})")

    index = SyntheticVOSIndex(num_sequences=2, num_frames=DET_REF_T,
                              size=(64, 64), num_objects=2, seed=DET_REF_SEED)
    meta_params, ev = detection_reference_setup("cuda")
    names = ["seq00", "seq01"]
    masks = ev.eval_stream(index, names, meta_params, 5)
    same = [bool(np.array_equal(masks[name], ev.eval_sequence(
        index, name, meta_params, fold_in(5, i))["merged"]))
        for i, name in enumerate(names)]
    log(f"detection eval_stream over {len(names)} sequences on the card "
        f"equals eval_sequence(fold_in(seed, i)): {same}")
    if not all(same):
        raise AssertionError("detection eval_stream differs from "
                             "eval_sequence")


# ------------------------------------------------- command lines on disk

CLI_SEQS = {"drift": 1, "crossing": 2}  # build_480p_tree's val sequences


def disk_tree(shared):
    """``build_480p_tree`` with its train split in a temporary directory
    under build/ (which .gitignore lists), built once and removed when the
    script exits."""
    if "tree" not in shared:
        from e_osvos_torch.data.synthetic_disk import build_480p_tree

        base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build")
        os.makedirs(base, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_disk_", dir=base)
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        t0 = time.perf_counter()
        build_480p_tree(os.path.join(tmp, "DAVIS"), with_train=True)
        log(f"disk tree: build_480p_tree(with_train=True) in {time.perf_counter() - t0:.2f} s")
        shared["tree"] = tmp
    return shared["tree"]


def run_cli(tag: str, argv, out: str, shared):
    """Save fresh meta-parameters of the configuration's model with the
    port's ``save_checkpoint``, then run ``cli.evaluate.main`` on them with
    palette PNGs and init_J. Returns (parsed config, the model's GroupNorm
    count on the kernels, the logged records, the launch counts)."""
    from e_osvos_torch import config
    from e_osvos_torch.cli import evaluate
    from e_osvos_torch.cli.common import build_parent_model
    from e_osvos_torch.data import datasets, native
    from e_osvos_torch.meta_optim import init_meta_params
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms
    from e_osvos_torch.ops.group_norm import FusedGroupNorm
    from e_osvos_torch.utils import save_checkpoint

    ckpt = os.path.join(out, "meta.ckpt")
    argv = argv + [f"meta_optim_model_file={ckpt}", f"save_dir={out}",
                   f"save_preds={os.path.join(out, 'preds')}",
                   "eval_init_j=True"]
    cfg = config.parse_cli(argv)
    model = build_parent_model(cfg)
    n_gn = sum(isinstance(m, FusedGroupNorm) and m.use_kernel
               for m in model.modules())
    mp = init_meta_params(config.to_meta_optim_config(cfg), model)
    save_checkpoint(ckpt, {"meta_params": mp._asdict(), "opt_state": {}})
    del model, mp
    why = f" (native loader: {native.error})" if native.error else ""
    log(f"{tag}: decoder {datasets.decoder()}{why}; {n_gn} GroupNorm layers "
        f"on the kernels; python -m e_osvos_torch.cli.evaluate "
        + " ".join(argv))

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = evaluate.main(argv)
    torch.cuda.synchronize()
    log(f"{tag}: cli.evaluate.main {time.perf_counter() - t0:.3f} s")
    return cfg, n_gn, records, {**K.launch_counts(),
                                **cuda_nms.launch_counts()}


def check_cli_output(tag: str, records, out: str, seqs, per_seq_launches,
                     counts):
    """The evaluation's records (one eval_seq a sequence, J and F in [0,
    1]), its palette PNGs (one a frame, object ids of the sequence) and its
    launch counts against what the configuration implies."""
    from e_osvos_torch.utils.png import load_indexed_png

    events = [r["event"] for r in records]
    if events != ["init_eval_seq", "eval_seq"] * len(seqs) + ["eval_total"]:
        raise AssertionError(f"{tag}: records {events}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for r in records:
        if r["event"] != "eval_seq":
            continue
        log(f"{tag}: {r['seq']} ({MAIN_T} frames at {MAIN_HW[0]}x"
            f"{MAIN_HW[1]}, {seqs[r['seq']]} object(s)): {r['fps']:.4f} fps, "
            f"{r['time_per_frame'] * MAIN_T:.3f} s, peak memory "
            f"{r['peak_mem_gib']:.2f} GiB, J {r['J_mean']:.4f}, F "
            f"{r['F_mean']:.4f} on {smi.strip()}")
        if not all(0.0 <= r[k] <= 1.0 for k in ("J_mean", "F_mean")):
            raise AssertionError(f"{tag}: J/F out of [0, 1]: {r}")
    for name, n_obj in seqs.items():
        d = os.path.join(out, "preds", name)
        files = sorted(os.listdir(d))
        if files != [f"{t:05d}.png" for t in range(MAIN_T)]:
            raise AssertionError(f"{tag}: {len(files)} PNGs for {name}")
        ids = set()
        for f in files:
            label = load_indexed_png(os.path.join(d, f))
            if label.shape != MAIN_HW:
                raise AssertionError(f"{tag}: PNG shape {label.shape}")
            ids |= set(np.unique(label).tolist())
        log(f"{tag}: {name}: {len(files)} palette PNGs, object ids {ids}")
        if not ids <= set(range(n_obj + 1)) or n_obj not in ids:
            raise AssertionError(f"{tag}: ids {ids} in {name}'s PNGs")
    want = {k: sum(per_seq_launches[name].get(k, 0) for name in seqs)
            for k in counts}
    log(f"{tag}: launch counts " + json.dumps(counts) + " expected "
        + json.dumps(want))
    if counts != want:
        raise AssertionError(f"{tag}: launch counts {counts} != {want}")


def run_cli_deeplab(shared):
    """``cli.evaluate.main`` on the disk tree's two val sequences with
    DAVIS-2017 e-OSVOS-OnA at bench.py's settings (resnet50 os16 frozen-BN
    backbone, GN-16 head, bf16, 50 steps, OnA every 5 frames for 10 steps at
    min_prop 0.75, the fused loop without window bucketing), palette PNGs
    and init_J: K1/K2 launches of three single-group sequences plus one
    init_J forward of each sequence."""
    from e_osvos_torch import config
    from e_osvos_torch.ops import cuda_group_norm as K

    tree = disk_tree(shared)
    out = os.path.join(tree, "deeplab")
    argv = ["with", "DAVIS-2017", "e-OSVOS-OnA",
            f"datasets.val.root={os.path.join(tree, 'DAVIS')}",
            "num_epochs.eval=50", "eval_online_adapt.min_prop=0.75",
            "eval_ona_window_bucket=0", "eval_fused_ona=True"]
    cfg, n_gn, records, counts = run_cli("CLI evaluation, DeepLab", argv,
                                         out, shared)
    one = expected_launches(config.to_one_shot_config(cfg), MAIN_T, n_gn,
                            K.LAUNCHES_PER_CALL)
    init = {k: n_gn * K.LAUNCHES_PER_CALL[k]
            for k in ("group_stats", "affine_apply")}
    per_seq = {name: {k: n * one[k] + init.get(k, 0) for k in one}
               for name, n in CLI_SEQS.items()}
    check_cli_output("CLI evaluation, DeepLab", records, out, CLI_SEQS,
                     per_seq, counts)
    return counts


def run_cli_detection(shared):
    """``cli.evaluate.main`` with Mask R-CNN at
    scripts/bench_detection_ona.py's settings (resnet50 GroupNorm-32 FPN,
    bf16, one detection per frame, the Fast-NMS RPN, lrs at 1e-4, 50 steps,
    OnA every 5 frames for 10 steps at min_prop 0.75, the fused loop), on
    ``drift`` alone through a split file written into the tree: the
    launches of one sequence plus init_J's tracking of the 66 frames after
    the support frame (one forward and one K3 route S call a frame)."""
    from e_osvos_torch import config
    from e_osvos_torch.engine import DetectionOneShotConfig
    from e_osvos_torch.ops import cuda_group_norm as K

    tree = disk_tree(shared)
    root = os.path.join(tree, "DAVIS")
    with open(os.path.join(root, "ImageSets", "2017", "drift.txt"), "w") as f:
        f.write("drift\n")
    out = os.path.join(tree, "maskrcnn")
    argv = ["with", "DAVIS-2017", "e-OSVOS-OnA", f"datasets.val.root={root}",
            "datasets.val.split=drift", "parent_model.architecture=MaskRCNN",
            "parent_model.backbone_norm=group",
            "parent_model.detections_per_img=1",
            "meta_optim_cfg.init_lr=0.0001", "num_epochs.eval=50",
            "eval_online_adapt.min_prop=0.75", "eval_ona_window_bucket=0",
            "eval_fused_ona=True"]
    cfg, n_gn, records, counts = run_cli("CLI evaluation, Mask R-CNN", argv,
                                         out, shared)
    base = config.to_one_shot_config(cfg)
    det_cfg = DetectionOneShotConfig(**{
        f.name: getattr(base, f.name) for f in dataclasses.fields(base)})
    want = expected_detection_launches(det_cfg, MAIN_T, n_gn,
                                       K.LAUNCHES_PER_CALL)
    rest = MAIN_T - 1
    for k in ("group_stats", "affine_apply"):
        want[k] += rest * n_gn * K.LAUNCHES_PER_CALL[k]
    for k in ("greedy_nms", "greedy_nms_s"):
        want[k] += rest
    check_cli_output("CLI evaluation, Mask R-CNN", records, out,
                     {"drift": 1}, {"drift": want}, counts)
    return counts


# ------------------------------------------------------------------ main


REPLACES = {
    "group_stats": "e_osvos_tpu/ops/pallas_group_norm.py:47",
    "group_grad_coeffs": "e_osvos_tpu/ops/pallas_group_norm.py:63",
    # the elementwise passes XLA fused around the two Pallas kernels
    "affine_apply": "e_osvos_tpu/ops/pallas_group_norm.py:167",
    "affine_dx": "e_osvos_tpu/ops/pallas_group_norm.py:208",
    # K3's two routes
    "greedy_nms": "e_osvos_tpu/ops/pallas_nms.py:35",
    "greedy_nms_l": "e_osvos_tpu/ops/pallas_nms.py:35",
}
SOURCES = {"group_stats": "group_norm", "group_grad_coeffs": "group_norm",
           "affine_apply": "group_norm", "affine_dx": "group_norm",
           "greedy_nms": "nms", "greedy_nms_l": "nms"}
# the launch count each record reads: K3's records, each route's calls
COUNTED_AS = {"greedy_nms": "greedy_nms_s"}


def build_kernels():
    """Every kernel source at once, one nvcc each; logs the compiler's
    register and spill report."""
    from e_osvos_torch.ops import cuda_build, cuda_group_norm, cuda_nms

    t0 = time.perf_counter()
    libs = cuda_build.build_all([(cuda_group_norm.NAME, ()),
                                 (cuda_nms.NAME, cuda_nms.NVCC_EXTRA)])
    cuda_group_norm._load()
    cuda_nms._load()
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for so in libs.values():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas ({so.name}): " + line.strip())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-root", default=None,
                    help="an older checkout whose K3 is timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # The port is imported from the checkout holding this script.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    peaks = card_peaks(name)
    build_kernels()

    t0 = time.perf_counter()
    records = check_gn_kernels(peaks)
    parent = load_parent_nms(args.parent_root) if args.parent_root else None
    records.update(check_nms_kernel(peaks, parent))
    log(f"kernel checks: {time.perf_counter() - t0:.2f} s")

    shared = {}
    phases = (("DeepLab main path", lambda: run_main_path(shared)),
              ("DeepLab multi-object sequence",
               lambda: run_multi_object(shared)),
              ("DeepLab host window loop", lambda: run_host_loop(shared)),
              ("DeepLab reference", check_reference),
              ("DeepLab evaluation reference", check_eval_reference),
              ("CLI evaluation, DeepLab, on disk",
               lambda: run_cli_deeplab(shared)),
              ("meta-training", lambda: run_meta_training(shared)),
              ("meta-training reference", check_meta_reference),
              ("detection main path", run_detection_path),
              ("detection reference", check_detection_reference),
              ("CLI evaluation, Mask R-CNN, on disk",
               lambda: run_cli_detection(shared)),
              ("detection main path, greedy RPN",
               lambda: run_detection_path(greedy_rpn=True)),
              ("meta-training, Mask R-CNN",
               lambda: run_detection_meta_training(shared)),
              ("meta-training reference, Mask R-CNN",
               check_detection_meta_reference),
              ("parent training, DeepLab and Mask R-CNN (greedy RPN)",
               lambda: run_parent_training(shared)),
              ("CLI training, on disk", lambda: run_cli_training(shared)))
    launches = dict.fromkeys(records, 0)
    for label, phase in phases:
        t0 = time.perf_counter()
        counts = phase() or {}
        for k in launches:
            launches[k] += counts.get(COUNTED_AS.get(k, k), 0)
        log(f"{label} phase: {time.perf_counter() - t0:.2f} s")

    kernels = []
    for kname, rec in records.items():
        kernels.append({
            "name": (f"gn_{kname}" if SOURCES[kname] == "group_norm"
                     else kname),
            "route": "cuda",
            "source": f"e_osvos_torch/csrc/{SOURCES[kname]}.cu",
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
