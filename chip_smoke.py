"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

  1. device: the card's name and power limit;
  2. build: compiles the kernels (e_osvos_torch/csrc/*.cu) with nvcc, one
     process per source, all at once;
  3. kernels: each kernel against its plain PyTorch twin on the card. The
     GroupNorm passes (statistics with their group algebra, apply, dx) in
     bf16 at the DeepLab decoder's shapes [3|4|5, 120*214, 256], at the
     object-stacked widths of the batched evaluation ([3|4|5, 120*214, 512],
     [3, 120*214, 96], [5, 120*214, 1280]), at the Mask R-CNN backbone's
     GroupNorm-32 shapes (C = 64 at 102480 rows to C = 2048 at 405 rows)
     and its object-stacked ones ([3, 102480, 128] with 64 groups up to 5
     objects' [1, 1620, 5120] with 160) and at edge shapes; greedy NMS
     (K3) at the
     detection path's (N = 512, max_out = 1), the greedy RPN's (4336, 512), the
     2-object path's stacked calls ([2, 512, 4] at max_out 1, [6, 4336, 4]
     at 512), the kernel's largest N = 16384, a ragged N, an all-invalid input, exact
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
     configuration) through ``OneShotEvaluator.eval_sequence``, the objects
     batched (the default: one object-stacked model) and in turn
     (``batch_objects=False``), once each, batched first, each with the merge
     and the J/F scoring on the card: fps, phase times, J/F per object and
     peak memory; the launch counts must be the single-object ones batched
     and twice them in turn, and the card's J/F must equal the CPU's
     scoring of the same merged map;
  6. DeepLab host window loop: the same model through an evaluator with
     the default fused_ona=False on a 1-object 67-frame 480x854 sequence
     through ``eval_sequence``, with its fps and phase times; launch counts
     as implied (the same as the fused loop's);
  7. DeepLab reference: the single-group evaluation on a small fp32 model
     and input, on the card and on the CPU (the kernels' plain twins), must
     agree;
  8. DeepLab evaluation reference: ``eval_sequence`` of a 2-object sequence
     on the same small model (the host window loop), objects batched on the
     card and on the CPU and in turn on the card, must agree in probability
     and J/F; on the card, ``eval_stream`` over two sequences must give
     ``eval_sequence``'s merged maps;
  9. detection main path: Mask R-CNN e-OSVOS-50-OnA one-shot tracking
     (scripts/bench_detection_ona.py's configuration, one detection per
     frame) with a full-width resnet50 GroupNorm-32 FPN Mask R-CNN in bf16
     at 480x854, seeded random weights: a 7-frame warm-up sequence, then
     one timed 67-frame sequence (the fused window loop), with its fps,
     per-phase times and the share of frames with a detection; launch
     counts as implied;
  9b. detection multi-object sequence: phase 9's model and configuration
     on a 2-object 27-frame 480x854 sequence through ``eval_sequence``, the
     objects batched (the default: one object-stacked Mask R-CNN) and in
     turn (``batch_objects=False``), one timed run each after a 7-frame
     warm-up of each: fps, the fine-tune and propagation split on the
     device timeline, peak memory; launch counts as
     ``expected_detection_launches`` implies for 2 objects (one object's
     batched, twice them in turn);
 10. detection reference: a tiny fp32 Mask R-CNN through
     ``DetectionOneShotEvaluator.eval_sequence`` on a 2-object sequence
     (groups in turn) on the card and on the CPU, with the same CPU-drawn
     random numbers, in the fused window loop, the host loop and the host
     loop refitting the box and mask heads alone: probabilities within
     1e-3, identical NMS picks; on the card, ``eval_stream`` over two
     sequences must give each one's first group mask of
     ``eval_sequence``;
 10b. detection batched reference: the same model on a 2-object sequence
     with the objects batched, in the fused and the host loop: on the
     card batched against in turn, and batched card against batched CPU,
     probabilities within 1e-3; K3 on a stacked ``[2, N, 4]`` detection-head
     call picks what its twin picks;
 11. CLI evaluation, DeepLab, on disk: ``build_480p_tree`` (two 67-frame
     480x854 sequences, 1 and 2 objects) in a temporary directory under
     build/, fresh meta-parameters saved with the port's
     ``save_checkpoint``, then ``e_osvos_torch.cli.evaluate.main`` with
     DAVIS-2017 e-OSVOS-OnA at phase 4's settings, palette PNGs and init_J:
     two eval_seq records with J and F in [0, 1], one PNG a frame with the
     sequence's object ids, launch counts of two single-group sequences
     (the 2-object one batched) plus the init_J forwards; each sequence's
     fps and peak memory beside the card's name and power limit, and the
     decoder that ran;
 11b. CLI evaluation, reference checkpoints, on disk: a full-width parent
     ``.pth`` in the reference's key vocabulary (BatchNorm statistics
     drawn from a seed) and a ``.model`` meta checkpoint with NEURON lrs,
     written by ``models/torch_import.py`` from the seeded weights; the
     command line's loaders must give the same tensors on the card and on
     the CPU bit for bit; then ``cli.evaluate.main`` from them on the
     2-object sequence alone (objects batched), checked as phase 11;
 12. CLI evaluation, Mask R-CNN, on disk: the same with phase 9's
     configuration on the 1-object sequence (a split file written into the
     tree), launch counts of one sequence plus init_J's tracking;
 13. detection main path with the exact greedy RPN: phase 9's configuration
     with RPNConfig(use_fast_nms=False), the reference's torchvision RPN
     semantics, so K3 also selects the proposals at (N = 4336, max_out =
     512), route L, in one call over every image of each training step and
     each inferred frame; in the warm-up sequence some of those calls are
     held against the plain twin on their own inputs;
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
     checkpoint on an 8-frame 480x854 sequence; launch counts as implied;
 18. training over several GPUs (``parallel.mesh``, ``multihost``), under
     deterministic algorithms: (a) a one-rank NCCL process group in this
     process, through which the full-width DeepLab and Mask R-CNN meta
     steps (4 tasks, 480x480) and phase 16's parent steps must equal the
     same steps without a group bit for bit, with one all-reduce a step
     (its bytes and time printed) and launch counts as implied; (b) two
     gloo ranks sharing the card, each a process of its own: the full-width
     DeepLab meta step (2 tasks a rank) and a small fp32 Mask R-CNN meta
     step and parent step with the greedy RPN (K3 on each rank) against
     one process on the card (losses rtol 1e-6, trained tensors within
     1e-6 of each tensor's largest magnitude), bit-identical across the
     ranks, each rank's launch counts the formula's for its own tasks;
     step seconds, all-reduce bytes and seconds and each rank's peak
     memory printed beside one process's;
 19. evaluation over several GPUs (``OneShotEvaluator(mesh=...)``: frames
     sharded; ``DetectionOneShotEvaluator(mesh=...)``: objects sharded),
     under deterministic algorithms: (a) a one-rank NCCL process group in
     this process, through which phase 4's DeepLab sequence (11 frames)
     and phase 9b's 2-object Mask R-CNN sequence (7 frames), their
     fine-tunes cut to 10 steps, must equal the same evaluator without a
     group bit for bit, with the gathers' and broadcasts' bytes and
     seconds printed and launch counts as implied; (b) two gloo ranks
     sharing the card: the same DeepLab sequence, a small fp32 DeepLab
     2-object sequence and a small fp32 Mask R-CNN 3-object sequence (the
     objects padded to 4), each rank's result bit-identical to the other's
     and to one process running the ranks' frame blocks or object shares
     in turn, the small ones within 1e-5 (DeepLab; Mask R-CNN: the mean)
     and J/F within 1e-3 of one process, each rank's launch counts the
     formula's (K3 on each rank); seconds, collectives and peak memory a
     rank printed beside one process's; (c)
     ``e_osvos_torch.dryrun.dryrun_multichip(2, backend="gloo")``, beside
     (a);
 20. the ``batch`` norm (flax's BatchNorm with frozen running statistics
     and a learned affine): (a) a full-width parent ``.pth`` of the
     resnet50 os16 ``batch``-backbone DeepLabV3+ (GN-16 head, bf16) whose
     BatchNorm statistics are drawn from a seed (around each norm's input,
     ``draw_batch_statistics``) and a NEURON-lr ``.model``, loaded by the
     command line bit for bit alike on the card and on the CPU and equal
     to the written model (statistics unfolded), then ``cli.evaluate.main``
     at phase 11's settings on the 1-object sequence: fps and peak memory
     beside phase 11's frozen-BN run of it, K1/K2 launches of the head's
     norms by phase 4's formula; (b) that model through
     ``MetaTrainer.run`` in both modes of phase 6 (a warm-up and two timed
     steps each): seconds, peak memory, launch counts, every running mean
     and variance reached by a non-zero meta-gradient and finite; (c) with
     a ``batch`` backbone, card against CPU: phase 7's single-group
     evaluation and phase 6's reference meta step (first and second
     order) within 1e-3, phase 8's 2-object sequence (probabilities
     within 1e-3 card against CPU and batched against in turn, merged
     maps equal wherever rounding cannot decide the label), and phase
     10's detection sequence, whose every detection-head K3 call must
     pick what the twin picks from the same inputs (its probabilities are
     printed beside the CPU's own spread: that tiny detector is
     ill-conditioned with this backbone).

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
import copy
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
# objects as a batch axis (models/stacked.py): O objects' GN-16 norms as one
# norm of O*C channels and O*16 groups; 2 objects' decoder in the fine-tune,
# refit and window (batch 3, 4, 5) and low-level norm, 5 objects' window
GN_STACKED_SHAPES = [(3, GN_M, 2 * GN_C, 32), (4, GN_M, 2 * GN_C, 32),
                     (5, GN_M, 2 * GN_C, 32), (3, GN_M, 2 * 48, 32),
                     (5, GN_M, 5 * GN_C, 80)]
# the object-stacked Mask R-CNN backbone (GroupNorm-32 of O*C channels and
# O*32 groups): 2 objects' stem in the fine-tune, layer4 in a refit, and 5
# objects' layer1 and layer3 in a window inference
GN_DET_STACKED = (3, 240 * 427, 2 * 64, 64)
GN_DET_STACKED_SHAPES = [GN_DET_STACKED, (4, 15 * 27, 2 * 2048, 64),
                         (1, 120 * 214, 5 * 256, 160),
                         (1, 30 * 54, 5 * 1024, 160)]


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

    # (N, M, C, groups): DeepLab batches, the object-stacked decoder and
    # low-level norm of the 2-object batched evaluation and the 5-object
    # window, the meta-training decoder at 480x480 (support batch 3 or 1) and
    # ASPP, the Mask R-CNN backbone, then the edge shapes (C = 36 is not a
    # multiple of 8: the scalar variant)
    shapes = [(3, GN_M, GN_C, 16), (4, GN_M, GN_C, 16), (5, GN_M, GN_C, 16),
              *GN_STACKED_SHAPES, *GN_META_SHAPES, *GN_BACKBONE_SHAPES,
              *GN_DET_STACKED_SHAPES,
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
    stacked = time_gn_kernels(peaks, 3, GN_M, 2 * GN_C, 32)
    log("gn kernels at the 2-object stacked decoder [3, 25680, 512] bf16 "
        + json.dumps({k: {f: v[f] for f in ("ms", "eager_ms", "plain_ms",
                                             "bound_ms", "library_ms")}
                      for k, v in stacked.items()}))
    stem = time_gn_kernels(peaks, 3, 240 * 427, 64, 32)
    log("gn kernels at the Mask R-CNN stem [3, 102480, 64] bf16 " + json.dumps(
        {k: {f: v[f] for f in ("ms", "eager_ms", "plain_ms", "bound_ms",
                               "library_ms")}
         for k, v in stem.items()}))
    det_stacked = time_gn_kernels(peaks, *GN_DET_STACKED)
    log("gn kernels at the 2-object stacked Mask R-CNN stem [3, 102480, 128] "
        "bf16, 64 groups " + json.dumps(
            {k: {f: v[f] for f in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                   "library_ms")}
             for k, v in det_stacked.items()}))
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


# the NMS cases: (name, images, N, max_out, IoU threshold); one image is
# the unbatched [N, 4] call. det_2x512x1 is the 2-object detection head's
# call a frame, rpn_6x4336x512 the greedy RPN's call in a fine-tune step of
# 3 images of 2 objects batched.
NMS_CASES = [("det_512x1", 1, 512, 1, 0.5), ("det_512x4", 1, 512, 4, 0.5),
             ("det_2x512x1", 2, 512, 1, 0.5),
             ("rpn_4336x512", 1, 4336, 512, 0.7),
             ("rpn_6x4336x512", 6, 4336, 512, 0.7),
             ("max_16384x64", 1, 16384, 64, 0.5),
             ("ragged_777", 1, 777, 100, 0.5), ("all_invalid", 1, 512, 8, 0.5),
             ("ties", 1, 2000, 300, 0.5), ("signed_zero_ties", 1, 2000, 300, 0.5),
             ("nan_boxes", 1, 4336, 512, 0.7), ("iou_ties", 1, 2000, 300, 0.5)]


def nms_inputs(name: str, n: int, gen: torch.Generator, images: int = 1):
    """Boxes in a 480x854 frame (sizes 8..300 px), scores in [0, 1) and
    valid flags of one NMS case, on the card: ``[N, 4]``, ``[N]``, ``[N]``
    for one image, else ``images`` such draws stacked."""
    if images > 1:
        return tuple(torch.stack(t) for t in zip(
            *(nms_inputs(name, n, gen) for _ in range(images))))
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
    for name, images, n, max_out, thr in NMS_CASES:
        boxes, scores, valid = nms_inputs(name, n, gen, images)
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
        log(f"  nms {name}: {images} image(s), N={n} max_out={max_out} "
            f"kept={kept} route "
            f"{route}; identical " + json.dumps(same))
        if not all(same.values()):
            raise AssertionError(f"K3 disagrees with its twin at {name}: "
                                 f"{same}")
        if name == "all_invalid" and (kept or bool((idx != -1).any())):
            raise AssertionError("K3 kept a box of an all-invalid input")
    timed = {name: time_nms(peaks, name, n, max_out, thr, parent)
             for name, _, n, max_out, thr in NMS_CASES
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


def kernel_norms(model) -> int:
    """The GroupNorms of ``model`` that run on the kernels."""
    from e_osvos_torch.ops.group_norm import FusedGroupNorm

    return sum(isinstance(m, FusedGroupNorm) and m.use_kernel
               for m in model.modules())


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

    H, W = MAIN_HW
    t0 = time.perf_counter()
    model, meta_params, evaluator, index = build_main_path()
    cfg = evaluator.cfg
    n_gn = kernel_norms(model)
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
    shared["main fps"] = MAIN_T / dt
    return counts


MULTI_OBJECTS = 2  # scripts/bench_multiobj.py:37
# batched and looped runs each, in turns; one each keeps the whole run well
# inside its time limit
MULTI_RUNS = 1


def multi_object_run(evaluator, meta_params, index, want, objects: int,
                     T: int, batched: bool):
    """One ``eval_sequence`` of ``index``'s ``seq00`` (``objects`` groups of
    ``T`` frames), objects batched or in turn (the evaluator's
    ``batch_objects``); its wall time runs from the call to the result dict
    on the host (frames loaded and uploaded, probabilities and merged map
    fetched). Returns (result, seconds, peak GiB, launch counts, [(phase,
    seconds on the device's timeline)]). The launch counts must equal
    ``want``."""
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms

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
    if torch.is_tensor(res["probs"]):
        res["probs"] = res["probs"].cpu()
    dt = time.perf_counter() - t0
    evaluator.on_phase = None
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    times = 1 if batched else objects
    names = [p for p, _ in events]
    if names != ["start"] + ["fine_tune", "propagate"] * times + ["score"]:
        raise AssertionError(f"phases {names}")
    spans = [(b[0], a[1].elapsed_time(b[1]) / 1e3)
             for a, b in zip(events, events[1:])]
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    probs, merged = res["probs"], res["merged"]
    if (tuple(probs.shape) != (objects, T) + MAIN_HW
            or merged.shape != (T,) + MAIN_HW or merged.dtype != np.uint8):
        raise AssertionError(f"output shapes {tuple(probs.shape)}, "
                             f"{merged.shape} {merged.dtype}")
    if not bool(torch.isfinite(torch.as_tensor(probs)).all()):
        raise AssertionError("non-finite probabilities")
    scores = res["J_per_object"] + res["F_per_object"]
    if len(scores) != 2 * objects or not np.isfinite(scores).all():
        raise AssertionError(f"J/F per object {scores}")
    return res, dt, peak, counts, spans


def run_multi_object(shared):
    """A 2-object 67-frame 480x854 sequence through ``eval_sequence`` on the
    main path's model and evaluator (warm from its sequences, same shapes),
    the objects batched (the default, one object-stacked model) and in turn
    (``batch_objects=False``), ``MULTI_RUNS`` times each in turns, batched
    first; then the card's J/F scoring against the CPU's on the batched
    run's merged map."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import OneShotEvaluator, build_gt_stack
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import metrics

    meta_params, batched_ev, n_gn = shared["deeplab"]
    loop_ev = OneShotEvaluator(batched_ev.model_apply, batched_ev.meta_cfg,
                               batched_ev.cfg, device="cuda", fused_ona=True,
                               batch_objects=False)
    if not batched_ev.batch_objects or not batched_ev.fused_ona:
        raise AssertionError("the main path's evaluator is not the default "
                             "batched, fused one")
    index = SyntheticVOSIndex(num_sequences=1, num_frames=MAIN_T,
                              size=MAIN_HW, num_objects=MULTI_OBJECTS,
                              multi_object="single_id", seed=0)
    seq = index.sequences["seq00"]
    if len(seq.object_groups) != MULTI_OBJECTS:
        raise AssertionError(f"{len(seq.object_groups)} object groups")
    one = expected_launches(batched_ev.cfg, MAIN_T, n_gn,
                            K.LAUNCHES_PER_CALL)
    runs = {True: [], False: []}
    total = {}
    for _ in range(MULTI_RUNS):
        for batched in (True, False):
            times = 1 if batched else MULTI_OBJECTS
            want = {**{k: times * v for k, v in one.items()},
                    "greedy_nms": 0, "greedy_nms_s": 0, "greedy_nms_l": 0}
            res, dt, peak, counts, spans = multi_object_run(
                batched_ev if batched else loop_ev, meta_params, index, want,
                MULTI_OBJECTS, MAIN_T, batched)
            runs[batched].append((res, dt, peak))
            phases = {"groups": [dict(spans[2 * o:2 * o + 2])
                                 for o in range(times)],
                      "score_s": spans[-1][1]}
            tag = "batched" if batched else "in turn"
            log(f"multi-object sequence, objects {tag} ({MULTI_OBJECTS} "
                f"objects, {MAIN_T} frames at {MAIN_HW[0]}x{MAIN_HW[1]}, "
                f"eval_sequence incl. loading, scoring and fetch): {dt:.3f} "
                f"s, {MAIN_T / dt:.4f} fps; peak memory {peak:.2f} GiB; "
                "phases (device timeline, seconds) " + json.dumps(phases)
                + "; J per object " + json.dumps(res["J_per_object"])
                + ", F per object " + json.dumps(res["F_per_object"]))
            log(f"multi-object launch counts ({tag}) " + json.dumps(counts)
                + f" as expected ({times} x the single-object counts)")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for batched in (True, False):
        fps = [MAIN_T / dt for _, dt, _ in runs[batched]]
        log(f"multi-object summary, objects "
            f"{'batched' if batched else 'in turn'}: fps {json.dumps(fps)}, "
            f"peak GiB {json.dumps([pk for _, _, pk in runs[batched]])} on "
            f"{smi.strip()}")
    diff = float(np.abs(runs[True][0][0]["probs"]
                        - runs[False][0][0]["probs"]).max())
    log(f"multi-object full width, bf16: batched vs in turn max |dprob| "
        f"{diff:.3e} (reported, not held: 50 bf16 steps of a random-weight "
        f"model; the small fp32 reference holds them)")

    # the card's scoring against the CPU's, on the same merged map and GT
    res = runs[True][0][0]
    merged, scores = res["merged"], res["J_per_object"] + res["F_per_object"]
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
    return total


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


def check_reference(backbone_norm="frozen_bn"):
    """The whole slice on a small fp32 model, on the card and on the CPU
    (a ``batch`` backbone's statistics drawn, ``draw_batch_statistics``)."""
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
        model = draw_batch_statistics(DeepLabV3Plus(
            num_classes=1, arch="resnet10", backbone_norm=backbone_norm,
            output_stride=16, seed=5, device=device), 5)
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
    log(f"small fp32 slice ({backbone_norm} backbone), card vs CPU: max "
        f"|dprob| = {err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"card and CPU disagree on the small slice: {err}")


def check_eval_reference(backbone_norm="frozen_bn"):
    """``eval_sequence`` of a 2-object 7-frame 32x48 sequence on the small
    fp32 model (the host window loop), the objects batched (the default) on
    the card and on the CPU, and in turn on the card: probabilities and J/F
    within 1e-3 of each other. Then, on the card, ``eval_stream`` over two
    sequences against ``eval_sequence`` with the seeds ``fold_in(seed, i)``
    (the fused loop, objects batched): identical merged maps.

    With a ``batch`` backbone (phase 20; statistics from
    ``draw_batch_statistics``) the probabilities stay held within 1e-3 both
    ways, and in place of J/F the merged maps must be identical wherever
    the pixel's label is decided by more than rounding: the largest of
    (0.5, each object's probability), which the merge takes, ahead of the
    next by more than twice the comparison's largest probability gap. J/F
    are printed: these probabilities are not saturated, so a pixel within
    rounding of the threshold, or of another object's probability, flips
    and moves J/F by more than 1e-3. ``eval_stream`` is phase 8's alone."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import OneShotEvaluator, fold_in
    from e_osvos_torch.meta_optim import init_meta_params
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply

    index = SyntheticVOSIndex(num_sequences=2, num_frames=7, size=(32, 48),
                              num_objects=2, seed=3)
    cfg, meta_cfg = small_eval_setup()
    res, built = {}, {}
    for device in ("cpu", "cuda"):
        model = draw_batch_statistics(DeepLabV3Plus(
            num_classes=1, arch="resnet10", backbone_norm=backbone_norm,
            output_stride=16, seed=5, device=device), 5)
        built[device] = (functional_apply(model),
                         init_meta_params(meta_cfg, model))
        ev = OneShotEvaluator(built[device][0], meta_cfg, cfg, device=device)
        res[device] = ev.eval_sequence(index, "seq00", built[device][1], 0)
    apply, meta_params = built["cuda"]
    res["loop"] = OneShotEvaluator(apply, meta_cfg, cfg, device="cuda",
                                   batch_objects=False).eval_sequence(
        index, "seq00", meta_params, 0)

    def gap(a, b):
        return (float(np.abs(res[a]["probs"] - res[b]["probs"]).max()),
                max(abs(x - y) for k in ("J_per_object", "F_per_object")
                    for x, y in zip(res[a][k], res[b][k])))

    def decided_flips(a, b, err):
        """Merged pixels that differ between runs a and b, all of them and
        those whose label leads the runner-up by more than 2·err."""
        planes = np.concatenate([np.full_like(res[a]["probs"][:1], 0.5),
                                 res[a]["probs"]], 0)
        top = np.sort(planes, 0)
        decided = top[-1] - top[-2] > 2 * err
        differ = res[a]["merged"] != res[b]["merged"]
        return int(differ.sum()), int(differ[decided].sum())

    cpu_err, cpu_jf = gap("cpu", "cuda")
    loop_err, loop_jf = gap("loop", "cuda")
    batch = backbone_norm == "batch"
    cpu_flips = decided_flips("cpu", "cuda", cpu_err)
    loop_flips = decided_flips("loop", "cuda", loop_err)
    log(f"small fp32 eval_sequence ({backbone_norm} backbone, 2 objects, "
        f"host window loop), objects batched, card vs CPU: max |dprob| = "
        f"{cpu_err:.3e}, max |dJ|, |dF| = {cpu_jf:.3e}; on the card, "
        f"batched vs in turn: {loop_err:.3e}, {loop_jf:.3e} (tol 1e-3); "
        f"merged pixels that differ, all / decided by more than rounding: "
        f"card vs CPU {cpu_flips}, batched vs in turn {loop_flips}; J per "
        f"object on the card {res['cuda']['J_per_object']}")
    if res["cuda"]["probs"].shape != (2, 7, 32, 48):
        raise AssertionError(f"probs shape {res['cuda']['probs'].shape}")
    held = (max(cpu_err, loop_err) if batch
            else max(cpu_err, cpu_jf, loop_err, loop_jf))
    if not held <= 1e-3 or (batch and (cpu_flips[1] or loop_flips[1])):
        raise AssertionError(
            f"eval_sequence disagrees: card vs CPU {cpu_err}, {cpu_jf}, "
            f"merged pixels {cpu_flips}; batched vs in turn {loop_err}, "
            f"{loop_jf}, {loop_flips}")
    if batch:
        return

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


def build_meta_trainer(model, step_cfg, device="cuda", tasks=META_TASKS,
                       mesh=None):
    """scripts/bench_meta_step.py's trainer on the port: neuron-level linear
    lrs at 1e-3 with a learned init, ``tasks`` tasks a meta step from 4
    synthetic 480x480 sequences of 8 frames, one query frame a task; the
    tasks spread over ``mesh``'s ranks where one is given."""
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
        logger=MetricsLogger(echo=False), device=device, mesh=mesh)


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


def run_meta_mode(model, tag, step_cfg, n_gn, build=None,
                  n_timed=META_TIMED, watch_buffers=False):
    """``MetaTrainer.run`` over one warm-up and ``n_timed`` timed meta
    steps in one call (the pipelined loop): per step the device seconds
    from after task sampling to the end of the outer update, split into
    prepare (upload, draws, per-task augmentation), inner steps, query
    pass and outer update; host sampling seconds apart. The kernels'
    launch counts over the run must equal the formula, the meta-loss must
    be finite, and the learned init, the buffers (frozen-BN constants or
    ``batch`` norms' statistics) and the lrs must all move (the buffers
    where the model has any). With ``watch_buffers`` the result names the
    buffers that moved, those whose meta-gradient was non-zero in some
    outer step (flags kept on the device, read after the run) and counts
    those that stayed finite. ``build`` makes
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
    lrs = set(trainer.meta_params.log_init_lr)
    buffers = {k: v for k, v in trainer.meta_params.model_init.items()
               if k not in lrs}
    grad_flags = torch.zeros(len(buffers), dtype=torch.bool, device="cuda")
    if watch_buffers:
        outer_step = trainer.opt_state.step

        def step_and_watch(*args, **kwargs):
            grad_flags.logical_or_(torch.stack([
                torch.zeros((), dtype=torch.bool, device="cuda")
                if v.grad is None else v.grad.ne(0).any()
                for v in buffers.values()]))
            return outer_step(*args, **kwargs)

        trainer.opt_state.step = step_and_watch
    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = trainer.run(1 + n_timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    nms_calls = cuda_nms.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = _meta_phase_seconds(marks)
    if len(steps) != 1 + n_timed:
        raise AssertionError(f"{len(steps)} timed meta steps in {tag}")
    timed = steps[1:]
    med = {k: float(np.median([s[k] for s in timed])) for k in timed[0]}
    log(f"meta-training {tag}: median {med['step_s']:.4f} s a meta step "
        f"({META_TASKS} tasks x {step_cfg.num_epochs} inner steps, "
        f"{META_HW[0]}x{META_HW[1]}, device timeline after sampling), "
        f"steps {[round(s['step_s'], 4) for s in timed]}; warm-up "
        f"{steps[0]['step_s']:.4f} s; host sampling "
        f"{[round(s, 4) for s in sample_s]} s; wall {wall:.3f} s for "
        f"{1 + n_timed} steps; peak memory {peak / 2**30:.2f} GiB")
    log(f"meta-training {tag} phases (median seconds a meta step) "
        + json.dumps({k: round(v, 4) for k, v in med.items()}))
    want = {k: v * (1 + n_timed) for k, v in expected_meta_launches(
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
    groups = {"model_init params": (0, lambda k: k in lrs),
              "buffers": (0, lambda k: k not in lrs),
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
    result = {"median_step_s": med, "peak_bytes": peak, "base_bytes": base}
    if watch_buffers:
        result.update(
            buffers=set(buffers),
            buffers_moved={k for k, v in buffers.items()
                           if not torch.equal(before[0][k], v)},
            buffers_reached={k for k, flag in zip(
                buffers, grad_flags.tolist()) if flag},
            buffers_finite=sum(bool(torch.isfinite(v).all())
                               for v in buffers.values()))
    return counts, result


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

    t0 = time.perf_counter()
    model = DeepLabV3Plus(num_classes=1, arch="resnet50",
                          backbone_norm="frozen_bn", output_stride=16,
                          dtype=torch.bfloat16, seed=0, device="cuda")
    n_gn = kernel_norms(model)
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
                    draws_from=None, backbone_norm="frozen_bn"):
    """One meta step of 2 tasks on a small fp32 model (resnet10 os16
    DeepLabV3+, frozen-BN backbone unless ``backbone_norm`` says otherwise,
    32x32, 2 inner steps truncated after each, the per-step mode with
    degenerate augmentation): returns (step, the first task's (loss,
    grads), the meta-parameters before the step (copies), the step's
    output)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.meta_optim import (
        MetaOptimConfig, MetaTaskset, MetaTasksetConfig, init_meta_params,
    )
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply
    from e_osvos_torch.parallel import (
        MetaStepConfig, OuterOptimConfig, make_meta_step,
    )

    model = draw_batch_statistics(DeepLabV3Plus(
        num_classes=1, arch="resnet10", backbone_norm=backbone_norm,
        head_norm=head_norm, output_stride=16, seed=5, device=device), 5)
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


def check_meta_reference(backbone_norm="frozen_bn"):
    """One meta step of a small fp32 model on the card (the kernels) and on
    the CPU (their twins) from identical draws: the first task's meta-loss
    (rtol 1e-4), its meta-gradients within 1e-3 of each tensor's largest
    magnitude, and the outer step's change of every meta-parameter by
    ``step_change_excess`` (1e-3 of the tensor's largest change plus two
    ulps). The same limit must reject the card's step with its change
    taken as zero (a missing outer update). Then the same with
    second-order meta-gradients through the plain (_xla) norms; with the
    frozen-BN backbone, second order through the kernel norms must
    raise."""
    tol_loss, tol = 1e-4, 1e-3
    for label, kw in (("first order", {}),
                      ("second order, _xla norms",
                       dict(head_norm="group16_xla", second_order=True))):
        label = f"{backbone_norm} backbone, {label}"
        kw["backbone_norm"] = backbone_norm
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
    if backbone_norm != "frozen_bn":
        return
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
                                 tasks=META_TASKS, mesh=None):
    """scripts/exp_det_meta_480p.py's meta-trainer on the port: the
    detection task family, neuron-level linear lrs at 1e-3 with a learned
    init, ``tasks`` tasks a meta step from 4 synthetic 480x480 sequences of
    8 frames, one query frame a task; the tasks spread over ``mesh``'s
    ranks where one is given."""
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
        task_fns=detection_task_fns(model, step_cfg), mesh=mesh)


def run_detection_meta_training(shared):
    """Meta-training of the full-width Mask R-CNN (Fast-NMS RPN) through
    ``MetaTrainer.run`` in both modes of scripts/bench_meta_step.py (4
    tasks at 480x480, 1 query frame, 5 inner steps in one segment, first
    order): the same timings and checks as the DeepLab meta-training, the
    53 backbone GroupNorms on the kernels, no K3 call (the Fast-NMS RPN)."""

    t0 = time.perf_counter()
    model = full_detection_model()
    n_gn = kernel_norms(model)
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
    route L once a forward (over all its images) with the greedy RPN."""
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
    rpn = PARENT_TIMED + 1 if greedy_rpn else 0
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
                                greedy_rpn: bool = False, objects: int = 1,
                                batched: bool = True, fused: bool = True):
    """Launches one detection sequence implies (support frame 0, one
    detection per frame): every GroupNorm of the backbone calls the forward
    wrappers once per training step and once per inferred frame (the padded
    tail included), the backward wrappers once per training step; K3 runs
    once per inferred frame in the detection head at (N = 512, max_out =
    1), on route S. With the greedy RPN, K3 also selects the proposals at
    (4336, 512), on route L, in one call over all images of a forward: one
    a fine-tune step, a refit step and an inferred frame.

    ``objects`` groups of one support frame: in turn every count is
    ``objects`` times one group's; batched (one object-stacked model) a
    GroupNorm call and each K3 call serve every object, so the counts are
    one group's. The host loop (``fused=False``) infers no padded tail.
    """
    step = cfg.online_adapt_step
    windows = -(-(T - 1) // step)
    refit_steps = (windows - 1) * cfg.online_adapt_epochs
    steps = cfg.num_epochs + refit_steps
    frames = windows * step if fused else T - 1
    times = 1 if batched else objects
    calls = {"group_stats": steps + frames, "affine_apply": steps + frames,
             "group_grad_coeffs": steps, "affine_dx": steps}
    want = {k: times * v * n_gn * per_call[k] for k, v in calls.items()}
    rpn = times * (steps + frames) if greedy_rpn else 0
    want.update(greedy_nms=times * frames + rpn, greedy_nms_s=times * frames,
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


def run_detection_path(greedy_rpn: bool = False, shared=None):
    """One detection sequence of ``MAIN_T`` frames after a warm-up (see the
    module's phases 9 and 13); ``shared`` keeps the Fast-NMS path's model,
    meta-parameters and evaluator for the multi-object phase."""
    from e_osvos_torch.models import rpn
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms

    H, W = MAIN_HW
    tag = "detection (greedy RPN)" if greedy_rpn else "detection"
    t0 = time.perf_counter()
    model, meta_params, evaluator, index = build_detection_path(
        greedy_rpn=greedy_rpn)
    n_gn = kernel_norms(model)
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
    if shared is not None:
        shared["detection"] = (model, meta_params, evaluator, n_gn)
    return counts


DET_MULTI_OBJECTS = 2
# frames of phase 9b's timed sequences: 67 until the whole run passed 900 s
# with phase 19 (964.24 s on a slow host); the fine-tunes and widths stay
DET_MULTI_T = 27
# fine-tune steps of phase 9b's warm-ups (the timed runs take the cell's 50)
DET_MULTI_WARM_EPOCHS = 5


def run_detection_multi_object(shared):
    """The detection main path's model and configuration (the fused loop)
    on a 2-object DET_MULTI_T-frame 480x854 sequence through
    ``eval_sequence``, the
    objects batched (the default: one object-stacked Mask R-CNN) and in
    turn, one timed run each after a 7-frame warm-up of each (the stacked
    model has its own cuDNN plans; the warm-ups' fine-tunes take
    DET_MULTI_WARM_EPOCHS steps, the same shapes as the timed runs' 50):
    fps, the fine-tune / propagation split on the device timeline, peak
    memory, launch counts against ``expected_detection_launches`` for 2
    objects."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import DetectionOneShotEvaluator
    from e_osvos_torch.ops import cuda_group_norm as K

    model, meta_params, single_ev, n_gn = shared["detection"]
    warm_cfg = dataclasses.replace(single_ev.cfg,
                                   num_epochs=DET_MULTI_WARM_EPOCHS)
    evs = {(batched, cfg.num_epochs): DetectionOneShotEvaluator(
        model, single_ev.meta_cfg, cfg, device="cuda", fused_ona=True,
        batch_objects=batched)
        for batched in (True, False) for cfg in (single_ev.cfg, warm_cfg)}
    if not DetectionOneShotEvaluator(model, single_ev.meta_cfg, single_ev.cfg,
                                     device="cuda").batch_objects:
        raise AssertionError("the detection evaluator does not batch objects "
                             "by default")
    kw = dict(num_sequences=1, size=MAIN_HW, num_objects=DET_MULTI_OBJECTS,
              multi_object="single_id", seed=0)
    warm = SyntheticVOSIndex(num_frames=DET_WARMUP_T, **kw)
    index = SyntheticVOSIndex(num_frames=DET_MULTI_T, **kw)
    if len(index.sequences["seq00"].object_groups) != DET_MULTI_OBJECTS:
        raise AssertionError("expected 2 object groups")

    def run(batched, index, T, cfg=single_ev.cfg):
        want = expected_detection_launches(
            cfg, T, n_gn, K.LAUNCHES_PER_CALL,
            objects=DET_MULTI_OBJECTS, batched=batched)
        return multi_object_run(evs[batched, cfg.num_epochs], meta_params,
                                index, want, DET_MULTI_OBJECTS, T, batched)

    total, runs = {}, {}
    for batched in (True, False):
        tag = "batched" if batched else "in turn"
        t0 = time.perf_counter()
        run(batched, warm, DET_WARMUP_T, warm_cfg)
        log(f"detection multi-object warm-up ({tag}, {DET_WARMUP_T} "
            f"frames, {DET_MULTI_WARM_EPOCHS}-step fine-tune): "
            f"{time.perf_counter() - t0:.3f} s")
    for batched in (True, False):
        tag = "batched" if batched else "in turn"
        res, dt, peak, counts, spans = run(batched, index, DET_MULTI_T)
        runs[batched] = res
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        split = {"fine_tune_s": 0.0, "propagate_s": 0.0, "score_s": 0.0}
        for phase, sec in spans:
            split[phase + "_s"] += sec
        log(f"detection multi-object sequence, objects {tag} "
            f"({DET_MULTI_OBJECTS} objects, {DET_MULTI_T} frames at "
            f"{MAIN_HW[0]}x{MAIN_HW[1]}, eval_sequence incl. loading, scoring "
            f"and fetch): {dt:.3f} s, {DET_MULTI_T / dt:.4f} fps; peak memory "
            f"{peak:.2f} GiB; device timeline (s) " + json.dumps(split)
            + "; J per object " + json.dumps(res["J_per_object"]))
        log(f"detection multi-object launch counts ({tag}) "
            + json.dumps(counts) + " (as expected)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    diff = float((runs[True]["probs"] - runs[False]["probs"]).abs().max())
    log(f"detection multi-object full width, bf16: batched vs in turn max "
        f"|dprob| {diff:.3e} (reported, not held: 50 bf16 steps of a "
        f"random-weight detector; the small fp32 reference holds them) on "
        f"{smi.strip()}")
    return total


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
                              only_box_head: bool = False,
                              batch_objects: bool = False,
                              backbone_norm: str = "group4"):
    """The tiny fp32 Mask R-CNN of the detection reference on ``device``,
    its meta-parameters and its evaluator (the fused window loop unless
    ``fused_ona`` is False; ``only_box_head`` refits the heads alone; the
    object groups in turn unless ``batch_objects``). ``perturb`` > 0 scales
    every weight by ``1 ± perturb`` (seeded signs): rounding noise put in
    on purpose. A ``batch`` backbone's statistics are drawn
    (``draw_batch_statistics``)."""
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
    model = draw_batch_statistics(MaskRCNN(
        arch="resnet10", backbone_norm=backbone_norm, rpn=rpn, roi=roi,
        seed=5, device=device), 5)
    if perturb:
        gen = torch.Generator(device="cpu").manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.mul_(1 + perturb * sign.to(p.device, p.dtype))
    meta_params = init_meta_params(meta_cfg, model)
    ev = DetectionOneShotEvaluator(model, meta_cfg, cfg, device=device,
                                   fused_ona=fused_ona,
                                   batch_objects=batch_objects)
    return meta_params, ev


def detection_reference(device: str, index_seed: int = DET_REF_SEED,
                        perturb: float = 0.0, fused_ona: bool = True,
                        only_box_head: bool = False,
                        batch_objects: bool = False,
                        backbone_norm: str = "group4"):
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
                                                only_box_head, batch_objects,
                                                backbone_norm)
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
    """The detection reference (object groups in turn) on the card and on
    the CPU, with the same random numbers, in the fused window loop, the
    host loop, and the host loop refitting the box and mask heads alone:
    probabilities within 1e-3 and the same NMS pick in every frame. Then,
    on the card, ``eval_stream`` over two 2-object sequences against
    ``eval_sequence`` with the seeds ``fold_in(seed, i)`` (the fused loop,
    groups in turn): each stream row is the first group's mask, exactly."""
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
    same = []
    for i, name in enumerate(names):
        probs = ev.eval_sequence(index, name, meta_params,
                                 fold_in(5, i))["probs"][0]
        same.append(bool(np.array_equal(
            masks[name], (probs >= ev.cfg.threshold).cpu().numpy())))
    log(f"detection eval_stream over {len(names)} 2-object sequences on the "
        f"card equals the first group's mask of eval_sequence(fold_in(seed, "
        f"i)): {same}")
    if not all(same):
        raise AssertionError("detection eval_stream differs from "
                             "eval_sequence")


# The 2-object sequence's seed of the batched reference, chosen as
# DET_REF_SEED was, on the card's machine (scripts/torch_ref_spread.py
# --batched --card; readings in PERF.md): weights scaled by 1 ± 2^-23 move
# the batched CPU run by at most 1.0e-4 on this seed and the card reads
# 7.8e-5 from it; on seed 6 that machine's CPU run sits on a boundary
# (2^-23 moves it by 6.3e-2, and the card reads the moved value).
DET_BATCHED_SEED = 1


def check_detection_batched_reference():
    """The detection reference with the objects batched (one
    object-stacked Mask R-CNN) on a 2-object sequence (seed
    ``DET_BATCHED_SEED``), in the fused and the host window loop: on the
    card, batched against in turn, and batched on the card against batched
    on the CPU, probabilities within 1e-3. The detection head's first
    stacked NMS calls on the card (``[2, N, 4]``, one a frame) pick on the
    card exactly what they pick on the CPU, where the plain twin runs."""
    from e_osvos_torch.models import mask_rcnn

    batched_nms, calls = mask_rcnn.batched_nms, []

    def recording(boxes, *args, **kwargs):
        if boxes.is_cuda and boxes.shape[0] == 2 and len(calls) < 3:
            calls.append((boxes.clone(), [a.clone() if torch.is_tensor(a)
                                          else a for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kwargs.items()}))
        return batched_nms(boxes, *args, **kwargs)

    for label, fused in (("fused loop", True), ("host loop", False)):
        res = {}
        mask_rcnn.batched_nms = recording
        try:
            for device, batched in (("cpu", True), ("cuda", True),
                                    ("cuda", False)):
                res[device, batched] = detection_reference(
                    device, DET_BATCHED_SEED, fused_ona=fused,
                    batch_objects=batched)[0]
        finally:
            mask_rcnn.batched_nms = batched_nms
        probs = {k: r["probs"] for k, r in res.items()}
        if probs["cuda", True].shape != (2, DET_REF_T, 64, 64):
            raise AssertionError(f"probs shape "
                                 f"{tuple(probs['cuda', True].shape)}")
        loop = (probs["cuda", True] - probs["cuda", False]).abs().max().item()
        cpu = (probs["cuda", True] - probs["cpu", True]).abs().max().item()
        log(f"tiny fp32 detection eval_sequence, objects batched ({label}; 2 "
            f"objects, sequence seed {DET_BATCHED_SEED}): on the card batched "
            f"vs in turn max |dprob| = {loop:.3e}, batched card vs CPU "
            f"{cpu:.3e} (tol 1e-3); J per object batched on the card "
            f"{res['cuda', True]['J_per_object']}, in turn "
            f"{res['cuda', False]['J_per_object']}")
        if not (loop <= 1e-3 and cpu <= 1e-3):
            raise AssertionError(f"the batched detection reference "
                                 f"disagrees ({label}): {loop}, {cpu}")
    if not calls:
        raise AssertionError("no stacked detection-head NMS call recorded")
    for boxes, args, kwargs in calls:
        got = [t.cpu() for t in batched_nms(boxes, *args, **kwargs)]
        want = batched_nms(boxes.cpu(), *[a.cpu() if torch.is_tensor(a)
                                          else a for a in args],
                           **{k: v.cpu() if torch.is_tensor(v) else v
                              for k, v in kwargs.items()})
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        log(f"K3 on a stacked detection-head call, boxes "
            f"{tuple(boxes.shape)}: picks on the card identical to the "
            f"twin's: {same}; picks {got[0].tolist()}")
        if not same:
            raise AssertionError("K3 disagrees with its twin on a stacked "
                                 "call")


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
    from e_osvos_torch.utils import save_checkpoint

    ckpt = os.path.join(out, "meta.ckpt")
    argv = argv + [f"meta_optim_model_file={ckpt}", f"save_dir={out}",
                   f"save_preds={os.path.join(out, 'preds')}",
                   "eval_init_j=True"]
    cfg = config.parse_cli(argv)
    model = build_parent_model(cfg)
    n_gn = kernel_norms(model)
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
    shared.setdefault("cli base", {})[tag] = base = (
        torch.cuda.memory_allocated() / 2**30)
    t0 = time.perf_counter()
    records = evaluate.main(argv)
    torch.cuda.synchronize()
    log(f"{tag}: cli.evaluate.main {time.perf_counter() - t0:.3f} s; "
        f"{base:.2f} GiB allocated before it (earlier phases' tensors, in "
        f"each sequence's peak)")
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
    and init_J: K1/K2 launches of two single-group sequences (the 2-object
    sequence runs its objects batched) plus one init_J forward of each
    sequence."""
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
    per_seq = {name: {k: one[k] + init.get(k, 0) for k in one}
               for name in CLI_SEQS}
    check_cli_output("CLI evaluation, DeepLab", records, out, CLI_SEQS,
                     per_seq, counts)
    shared["cli"] = {r["seq"]: r for r in records if r["event"] == "eval_seq"}
    return counts


REFERENCE_SEQ = "crossing"  # build_480p_tree's 2-object val sequence


def write_reference_checkpoints(cfg, out: str, seed: int):
    """A full-width DeepLabV3+ parent ``.pth`` in the reference's key
    vocabulary, its frozen BNs as BatchNorms with running statistics drawn
    from ``seed`` (a ``batch`` model's own statistics and affine, drawn
    from ``seed`` by ``draw_batch_statistics``), and a ``.model`` meta
    checkpoint with NEURON lrs drawn from ``seed``, both from the port's
    seeded model on the CPU (``models/torch_import.py``'s writers).
    Returns their paths and the written model's ``state_dict``."""
    from e_osvos_torch import config
    from e_osvos_torch.cli.common import build_parent_model
    from e_osvos_torch.meta_optim import init_meta_params
    from e_osvos_torch.models.torch_import import (
        reference_meta_checkpoint,
        reference_state_dict,
    )

    model = draw_batch_statistics(build_parent_model(dict(cfg, device="cpu")),
                                  seed)
    buffers = [n for n, _ in model.named_buffers()]
    pth, meta_file = (os.path.join(out, "parent.pth"),
                      os.path.join(out, "meta.model"))
    torch.save(reference_state_dict(model.state_dict(), "deeplab_v3plus",
                                    buffers, seed=seed), pth)
    mp = init_meta_params(config.to_meta_optim_config(cfg), model)
    gen = torch.Generator().manual_seed(seed)
    lrs = {k: v * torch.empty(v.shape).uniform_(0.5, 2.0, generator=gen)
           for k, v in mp.log_init_lr.items()}
    torch.save(reference_meta_checkpoint(mp._replace(log_init_lr=lrs),
                                         "deeplab_v3plus"), meta_file)
    return pth, meta_file, model.state_dict()


def run_cli_reference(shared):
    """The reference's checkpoint files through the command line: a
    full-width parent ``.pth`` (BatchNorm statistics to fold) and a
    ``.model`` meta checkpoint with NEURON lrs, written from seeded weights
    (``write_reference_checkpoints``), then ``cli.evaluate.main`` with
    phase 11's settings on the disk tree's 2-object sequence alone (a
    split file), its objects batched. The parent and meta-parameters the
    command line loads on the card must equal its CPU import bit for bit;
    records, PNGs and launch counts as phase 11's (one sequence)."""
    return cli_from_reference_files(
        shared, "CLI evaluation, reference checkpoints", REFERENCE_SEQ, 2,
        [], "reference")[0]


def cli_from_reference_files(shared, tag: str, seq: str, objects: int,
                             extra, subdir: str, unfolded: bool = False):
    """Reference-format parent and meta files of the configuration
    (phase 11's settings plus ``extra`` keys) written from seeded weights,
    loaded by the command line on the card and on the CPU (bit for bit the
    same; with ``unfolded``, also bit for bit the written model's state:
    ``batch`` norms take the file's statistics as they are), then
    ``cli.evaluate.main`` from them on the disk tree's sequence ``seq``
    alone (a split file), checked as phase 11. Returns (launch counts, the
    sequence's eval_seq record with ``base_gib``, the GiB allocated before
    the command line ran)."""
    from e_osvos_torch import config
    from e_osvos_torch.cli import evaluate
    from e_osvos_torch.cli.common import (
        build_parent_model,
        init_model_params,
        resolve_meta_params,
    )
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms

    tree = disk_tree(shared)
    root = os.path.join(tree, "DAVIS")
    with open(os.path.join(root, "ImageSets", "2017", f"{seq}.txt"),
              "w") as f:
        f.write(seq + "\n")
    out = os.path.join(tree, subdir)
    os.makedirs(out, exist_ok=True)
    argv = ["with", "DAVIS-2017", "e-OSVOS-OnA", f"datasets.val.root={root}",
            f"datasets.val.split={seq}", "num_epochs.eval=50",
            "eval_online_adapt.min_prop=0.75", "eval_ona_window_bucket=0",
            "eval_fused_ona=True"] + list(extra)
    t0 = time.perf_counter()
    pth, meta_file, written = write_reference_checkpoints(
        config.parse_cli(argv), out, seed=7)
    log(f"{tag}: wrote {os.path.basename(pth)} "
        f"({os.path.getsize(pth) / 2**20:.1f} MiB) and "
        f"{os.path.basename(meta_file)} "
        f"({os.path.getsize(meta_file) / 2**20:.1f} MiB) in "
        f"{time.perf_counter() - t0:.2f} s")
    argv += [f"parent_model.checkpoint={pth}",
             f"meta_optim_model_file={meta_file}", f"save_dir={out}",
             f"save_preds={os.path.join(out, 'preds')}", "eval_init_j=True"]

    # what the command line loads, on the card and on the CPU
    loaded = {}
    for device in ("cpu", "cuda"):
        cfg = config.parse_cli(argv + [f"device={device}"])
        model = init_model_params(cfg, build_parent_model(cfg))
        meta = resolve_meta_params(cfg, model)
        n_gn = kernel_norms(model)
        loaded[device] = (
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            {f"{field}.{k}": v.detach().cpu() for field in meta._fields
             for k, v in (getattr(meta, field) or {}).items()})
        del model, meta
    differ = [k for i in (0, 1) for k, v in loaded["cpu"][i].items()
              if not torch.equal(v, loaded["cuda"][i][k])]
    sizes = [len(loaded["cpu"][i]) for i in (0, 1)]
    log(f"{tag}: {sizes[0]} parent tensors and {sizes[1]} meta-parameter "
        f"tensors loaded on the card, {len(differ)} differ from the CPU "
        f"import bit for bit")
    if differ or loaded["cuda"][0].keys() != loaded["cpu"][0].keys():
        raise AssertionError(f"{tag}: card and CPU imports differ: "
                             f"{differ[:8]}")
    if unfolded:
        stats = [k for k in written if k.endswith((".mean", ".var"))]
        changed = [k for k, v in written.items()
                   if not torch.equal(loaded["cuda"][0][k], v)]
        log(f"{tag}: {len(stats)} running statistics in the parent; "
            f"{len(changed)} of {len(written)} loaded tensors differ from "
            f"the written model's bit for bit (statistics unfolded)")
        if changed or not stats:
            raise AssertionError(f"{tag}: the parent loaded folded or "
                                 f"changed: {changed[:8]}")
    del loaded

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    records = evaluate.main(argv)
    torch.cuda.synchronize()
    log(f"{tag}: cli.evaluate.main {time.perf_counter() - t0:.3f} s; "
        f"{base:.2f} GiB allocated before it (earlier phases' tensors, in "
        f"each sequence's peak)")
    counts = {**K.launch_counts(), **cuda_nms.launch_counts()}
    cfg = config.parse_cli(argv)
    one = expected_launches(config.to_one_shot_config(cfg), MAIN_T, n_gn,
                            K.LAUNCHES_PER_CALL)
    for k in ("group_stats", "affine_apply"):  # init_J's forward
        one[k] += n_gn * K.LAUNCHES_PER_CALL[k]
    check_cli_output(tag, records, out, {seq: objects}, {seq: one}, counts)
    rec = [r for r in records if r["event"] == "eval_seq"][0]
    return counts, dict(rec, base_gib=base)


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


# ------------------------------------------- training over several GPUs

DIST_RANKS = 2  # gloo ranks sharing the one card
# tests/test_torch_port_distributed.py's tolerance of a 2-rank step against
# one process: losses rtol 1e-6; each trained tensor within 1e-6 of its
# largest magnitude, floored at 1e-6 of the largest of all
DIST_TOL = 1e-6
DIST_RANK_TIMEOUT = 300  # seconds a spawned rank may take


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations where one exists (a warning where none does), so that
    two runs of a step can be held together bit for bit."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.backends.cudnn.benchmark = prev[1]
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])


@contextlib.contextmanager
def timed_all_reduce(record):
    """Each ``torch.distributed.all_reduce`` inside appends (bytes, seconds
    from a synchronization before it to one after) to ``record``."""
    import torch.distributed as dist

    plain = dist.all_reduce

    def timed(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = plain(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        record.append((tensor.numel() * tensor.element_size(),
                       time.perf_counter() - t0))
        return work

    dist.all_reduce = timed
    try:
        yield record
    finally:
        dist.all_reduce = plain


def small_greedy_detection_model():
    """``small_detection_meta_step``'s tiny fp32 Mask R-CNN (resnet10
    GroupNorm-4 FPN) with the exact greedy RPN, so that K3 runs in its
    training forwards."""
    from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig

    return MaskRCNN(
        arch="resnet10", backbone_norm="group4",
        rpn=RPNConfig(anchor_sizes=(8, 16, 32, 64, 128), pre_nms_top_n=64,
                      post_nms_top_n=32, batch_size_per_image=32,
                      use_fast_nms=False),
        roi=RoIConfig(batch_size_per_image=16, detections_per_img=1),
        seed=5, device="cuda")


def full_deeplab_model():
    """The main path's full-width DeepLabV3+ (resnet50 os16 frozen-BN, GN-16
    head, bf16, seeded random weights)."""
    from e_osvos_torch.models import DeepLabV3Plus

    return DeepLabV3Plus(num_classes=1, arch="resnet50",
                         backbone_norm="frozen_bn", output_stride=16,
                         dtype=torch.bfloat16, seed=0, device="cuda")


def build_small_detection_meta_trainer(model, mesh):
    """``small_detection_meta_step``'s meta step (2 tasks of 64x64, 2 inner
    steps in one segment, support batch 2, degenerate augmentation, first
    order) in a ``MetaTrainer`` over ``mesh``."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import MetaTrainConfig, MetaTrainer
    from e_osvos_torch.meta_optim import (
        MetaOptimConfig, MetaTaskset, MetaTasksetConfig,
    )
    from e_osvos_torch.models import functional_apply
    from e_osvos_torch.parallel import (
        MetaStepConfig, OuterOptimConfig, detection_task_fns,
    )
    from e_osvos_torch.utils import MetricsLogger

    aug = AugmentConfig(scale_min=1.0, scale_max=1.0, rot_deg=0.0,
                        brightness=0.0, contrast=0.0, saturation=0.0,
                        flip_prob=0.0, compute_dtype="float32")
    step_cfg = MetaStepConfig(num_epochs=2, bptt_epochs=2, train_batch_size=2,
                              augment=aug, remat=False)
    tasks = MetaTaskset([SyntheticVOSIndex(num_sequences=2, num_frames=4,
                                           size=(64, 64), seed=3)],
                        MetaTasksetConfig(crop_size=(64, 64)),
                        seed=DET_META_SEEDS[0])
    return MetaTrainer(
        functional_apply(model), model, tasks,
        meta_cfg=MetaOptimConfig(init_lr=1e-4, use_log_init_lr=False),
        step_cfg=step_cfg,
        outer_cfg=OuterOptimConfig(model_init_lr=1e-3, log_init_lr_lr=1e-3),
        train_cfg=MetaTrainConfig(meta_batch_size=DIST_RANKS,
                                  num_meta_iters=1, vis_interval=10_000),
        logger=MetricsLogger(echo=False), device="cuda",
        task_fns=detection_task_fns(model, step_cfg), mesh=mesh)


def build_parent_trainer(model, mesh, size=META_HW, batch=None):
    """Phase 16's ``ParentTrainer`` over ``mesh``: the dense task at batch
    8, or for a Mask R-CNN the detection task at batch 4 with 2 instance
    slots, on synthetic frames of ``size``."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import (
        FrameSampler, InstanceFrameSampler, ParentTrainConfig, ParentTrainer,
    )
    from e_osvos_torch.models import MaskRCNN
    from e_osvos_torch.utils import MetricsLogger

    if isinstance(model, MaskRCNN):
        index = SyntheticVOSIndex(num_sequences=4, num_frames=8, size=size,
                                  num_objects=2)
        cfg = ParentTrainConfig(task="detection", batch_size=batch or 4,
                                max_objects=2, crop_size=size)
        sampler = InstanceFrameSampler([index], size, max_objects=2, seed=0)
    else:
        index = SyntheticVOSIndex(num_sequences=4, num_frames=8, size=size)
        cfg = ParentTrainConfig(batch_size=batch or 8, crop_size=size)
        sampler = FrameSampler([index], size, seed=0)
    return ParentTrainer(model, sampler, cfg,
                         logger=MetricsLogger(echo=False), device="cuda",
                         mesh=mesh)


# step name -> (model, trainer over a mesh)
DIST_STEPS = {
    "DeepLab meta step": (full_deeplab_model, lambda m, mesh: (
        build_meta_trainer(m, meta_step_configs()["per-task batch1"],
                           mesh=mesh))),
    "Mask R-CNN meta step": (full_detection_model, lambda m, mesh: (
        build_detection_meta_trainer(
            m, meta_step_configs()["per-task batch1"], mesh=mesh))),
    "DeepLab parent step": (full_deeplab_model, build_parent_trainer),
    "Mask R-CNN parent step, greedy RPN": (
        lambda: full_detection_model(greedy_rpn=True), build_parent_trainer),
    "small Mask R-CNN meta step, greedy RPN": (
        small_greedy_detection_model, build_small_detection_meta_trainer),
    "small Mask R-CNN parent step, greedy RPN": (
        small_greedy_detection_model, lambda m, mesh: build_parent_trainer(
            m, mesh, size=(64, 64), batch=DIST_RANKS * 2)),
}


def dist_expected_launches(trainer, model, mesh):
    """The kernel launches of one step of ``trainer`` on this rank: each
    kernel GroupNorm's wrappers once a forward and a backward (a meta step:
    this rank's tasks x (inner steps + segments) of each, as
    ``expected_meta_launches``; a parent step: one of each), and with the
    greedy RPN one K3 call a forward, route L."""
    from e_osvos_torch.engine import ParentTrainer
    from e_osvos_torch.ops import cuda_group_norm as K

    n_gn = kernel_norms(model)
    if isinstance(trainer, ParentTrainer):
        want = {k: n_gn * v for k, v in K.LAUNCHES_PER_CALL.items()}
        forwards = 1
    else:
        cfg = trainer.step.step_cfg
        tasks = trainer.train_cfg.meta_batch_size // mesh.num_tasks
        want = expected_meta_launches(cfg, tasks, n_gn, K.LAUNCHES_PER_CALL)
        forwards = tasks * (cfg.num_epochs + cfg.num_epochs // cfg.bptt_epochs)
    greedy = not getattr(getattr(model, "rpn", None), "use_fast_nms", True)
    k3 = forwards if greedy else 0
    want.update(greedy_nms=k3, greedy_nms_s=0, greedy_nms_l=k3)
    return want


def dist_step(name, mesh, steps=1):
    """``steps`` steps of DIST_STEPS[name] over ``mesh`` from a fresh model
    and trainer (the full batch sampled on every rank, this rank's rows
    run), under ``deterministic_algorithms``: the trained tensors after the
    first step (copies), its losses (the step's loss, then every task's on
    every rank), its launch counts and the formula's, each step's seconds
    (synchronized wall time), each step's all-reduces (bytes, seconds), and
    the first step's peak memory."""
    from e_osvos_torch.engine import ParentTrainer
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms
    from e_osvos_torch.parallel import shard_task_batch

    build_model, build_trainer = DIST_STEPS[name]
    model = build_model()
    trainer = build_trainer(model, mesh)
    parent = isinstance(trainer, ParentTrainer)
    res = {"step_s": [], "reduces": [],
           "expected": dist_expected_launches(trainer, model, mesh)}
    with deterministic_algorithms():
        for i in range(steps):
            if parent:
                batch = trainer.sampler.sample_batch(trainer.cfg.batch_size)
            else:
                batch = shard_task_batch(mesh, trainer.taskset.sample_batch(
                    trainer.train_cfg.meta_batch_size))
            K.reset_launch_counts()
            cuda_nms.reset_launch_counts()
            record = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with timed_all_reduce(record):
                if parent:
                    losses = trainer.step(*batch).reshape(1)
                else:
                    out = trainer.step(trainer.meta_params,
                                       trainer.opt_state, batch)
                    losses = torch.cat([out.meta_loss.reshape(1),
                                        out.per_task_loss])
            torch.cuda.synchronize()
            res["step_s"].append(time.perf_counter() - t0)
            res["reduces"].append(record)
            if i == 0:
                res["counts"] = {**K.launch_counts(),
                                 **cuda_nms.launch_counts()}
                res["peak"] = torch.cuda.max_memory_allocated()
                res["losses"] = losses.detach().float().cpu()
                tensors = (list(trainer.params.values()) if parent else
                           [t for d in trainer.meta_params if d is not None
                            for t in d.values()])
                res["tensors"] = [t.detach().clone() for t in tensors]
    return res


def parent_shards_in_turn(name, shards):
    """DIST_STEPS[name]'s parent step as ``shards`` task shards take it,
    in one process and with no collective: each shard's loss and gradients
    on its rows (its own draws), in turn; their mean; one optimizer step.
    The plain reference of a parent step over ``shards`` ranks. Returns
    (tensors after the step, mean loss)."""
    from e_osvos_torch.parallel import Mesh, task_sharding
    from e_osvos_torch.utils.device import upload

    build_model, build_trainer = DIST_STEPS[name]
    trainer = build_trainer(build_model(), Mesh())
    imgs, labels, seeds = trainer.sampler.sample_batch(trainer.cfg.batch_size)
    leaves = list(trainer.params.values())
    grads, loss = None, 0.0
    with deterministic_algorithms():
        for t in range(shards):
            rows = task_sharding(Mesh(t, shards, shards), len(seeds))
            shard_loss = trainer.loss(
                trainer.params, upload(imgs[rows], trainer.device),
                upload(labels[rows], trainer.device),
                *trainer.sample_draws(seeds[rows], imgs.shape[1:3]))
            g = torch.autograd.grad(shard_loss, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(leaves, g)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss = loss + shard_loss.detach()
        for p, g in zip(leaves, grads):
            p.grad = g * (1.0 / shards)
        trainer.opt.step()
    torch.cuda.synchronize()
    return ([p.detach().clone() for p in leaves],
            (loss * (1.0 / shards)).float().cpu().reshape(1))


def dist_close(got, want, tol=DIST_TOL):
    """The worst over tensor pairs of |got − want| over ``tol`` of the
    pair's largest |want|, floored at ``tol`` of the largest of all."""
    peak = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        mag = max(float(w.abs().max()), tol * peak, 1e-30)
        worst = max(worst, float((g.double().cpu() - w.double().cpu())
                                 .abs().max()) / (tol * mag))
    return worst


def _reduce_log(res):
    return "; ".join(
        f"step {i + 1}: " + (", ".join(f"{b / 2**20:.2f} MiB in {s * 1e3:.2f}"
                                       " ms" for b, s in rec) or "none")
        for i, rec in enumerate(res["reduces"]))


def run_world_one(shared):
    """18 (a): a process group of one rank through NCCL on the card
    (``multihost.initialize`` on a localhost rendezvous): each full-width
    step (the DeepLab and Mask R-CNN meta steps of 4 tasks at 480x480,
    per-task mode; phase 16's parent steps, Mask R-CNN with the greedy RPN)
    over ``make_mesh()`` must equal the same step without a process group
    bit for bit (an all-reduce over one rank is the identity), make one
    all-reduce where the ungrouped step makes none, and launch the kernels
    as the formulas say."""
    import torch.distributed as dist
    from e_osvos_torch.parallel import Mesh, make_mesh, multihost

    multihost.initialize(coordinator_address=f"tcp://localhost:{free_port()}",
                         num_processes=1, process_id=0)
    total, failed = {}, []
    try:
        mesh = make_mesh()
        log(f"training over GPUs (a): backend {dist.get_backend()}, "
            f"world {mesh.world_size}, mesh {mesh.shape}")
        if (dist.get_backend() != "nccl" or mesh.group is None
                or mesh.world_size != 1):
            raise AssertionError(f"not a one-rank NCCL mesh: {mesh}")
        # NCCL sets its communicator up at the first collective (about
        # 1.3 s on an H100): keep that out of the steps' all-reduce times
        dist.all_reduce(torch.zeros(1, device="cuda"), group=mesh.group)
        for name in list(DIST_STEPS)[:4]:
            plain = dist_step(name, Mesh())
            grouped = dist_step(name, mesh)
            same = (torch.equal(plain["losses"], grouped["losses"])
                    and all(torch.equal(a, b) for a, b in
                            zip(plain["tensors"], grouped["tensors"])))
            diff = max(float((a - b).abs().max()) for a, b in
                       zip(plain["tensors"], grouped["tensors"]))
            log(f"training over GPUs (a), {name}: grouped step "
                f"{'identical to' if same else 'DIFFERS from'} the ungrouped "
                f"one (largest difference {diff:.3e}; losses "
                f"{grouped['losses'].tolist()}); {grouped['step_s'][0]:.4f} "
                f"s against {plain['step_s'][0]:.4f} s ungrouped; all-reduce "
                f"{_reduce_log(grouped)}; peak memory "
                f"{grouped['peak'] / 2**30:.2f} GiB; launch counts "
                + json.dumps(grouped["counts"]) + " expected "
                + json.dumps(grouped["expected"]))
            for r in (plain, grouped):
                if r["counts"] != r["expected"]:
                    failed.append(f"{name} launch counts")
                for k, v in r["counts"].items():
                    total[k] = total.get(k, 0) + v
            if not same:
                failed.append(f"{name} not identical")
            if len(grouped["reduces"][0]) != 1 or plain["reduces"][0]:
                failed.append(f"{name} all-reduce calls")
            del plain, grouped
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if failed:
        raise AssertionError(f"training over GPUs (a): {failed}")
    return total


def gloo_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase 18 (b), started by ``run_gloo_ranks``: joins the
    gloo group through the file ``store`` on this card (``LOCAL_RANK`` 0:
    the ranks share it), runs two steps of each of DIST_STEPS' DeepLab meta
    step and small Mask R-CNN steps over ``make_mesh()`` and saves the
    results to ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from e_osvos_torch.parallel import make_mesh, multihost

    multihost.initialize(coordinator_address=f"file://{store}",
                         num_processes=world, process_id=rank,
                         backend="gloo")
    try:
        from e_osvos_torch.utils import resolve_device

        if resolve_device(None) != torch.device("cuda:0"):
            raise AssertionError(f"rank {rank}'s default device is "
                                 f"{resolve_device(None)}, not cuda:0")
        mesh = make_mesh()
        results = {}
        for name in GLOO_STEPS:
            res = dist_step(name, mesh, steps=2)
            res["tensors"] = [t.cpu() for t in res["tensors"]]
            results[name] = res
            torch.cuda.empty_cache()
        torch.save(results, out)
    finally:
        torch.distributed.destroy_process_group()


GLOO_STEPS = ("DeepLab meta step", "small Mask R-CNN meta step, greedy RPN",
              "small Mask R-CNN parent step, greedy RPN")


def spawn_gloo_ranks(target: str):
    """DIST_RANKS processes sharing the card, rank r running
    ``chip_smoke.<target>(r, DIST_RANKS, store, out)`` (a ``file://``
    store and result files in a temporary directory under build/). A rank
    that fails or outlives DIST_RANK_TIMEOUT fails the caller, with its
    output. Returns (each rank's saved results, seconds from start to
    exit)."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_", dir=base)
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DIST_RANKS)]
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{target}("
         f"{r}, {DIST_RANKS}, {store!r}, {outs[r]!r})"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(DIST_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=DIST_RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{target} {r} exited {p.returncode}:\n"
                                 f"{tail}")
    return [torch.load(o, weights_only=False) for o in outs], wall


def run_gloo_ranks(shared):
    """18 (b): DIST_RANKS gloo ranks sharing the card, each a process of its
    own (``gloo_rank``), against one process on the card: the full-width
    DeepLab meta step of 4 tasks (2 a rank) and the small fp32 Mask R-CNN
    meta step (1 task a rank) and parent step (2 frames a rank) with the
    greedy RPN, so K3 runs on each rank. One process runs the meta steps
    whole and the parent step shard by shard (``parent_shards_in_turn``).
    Each rank's losses and trained tensors within DIST_TOL of one
    process's, bit-identical across the ranks, each rank's launch counts
    the formula's for its tasks. Step seconds are printed beside one
    process's as information: two ranks on one card share its SMs and are
    not expected to be faster."""
    from e_osvos_torch.parallel import Mesh

    ref = {}
    for name in GLOO_STEPS[:2]:
        res = dist_step(name, Mesh(), steps=2)
        res["tensors"] = [t.cpu() for t in res["tensors"]]
        ref[name] = res
        torch.cuda.empty_cache()
    name = GLOO_STEPS[2]
    tensors, loss = parent_shards_in_turn(name, DIST_RANKS)
    ref[name] = {"tensors": [t.cpu() for t in tensors], "losses": loss}
    torch.cuda.empty_cache()

    ranks, wall = spawn_gloo_ranks("gloo_rank")
    log(f"training over GPUs (b): {DIST_RANKS} gloo ranks on one card, "
        f"{wall:.2f} s from start to exit")
    failed = []
    for name in GLOO_STEPS:
        want = ref[name]
        rows = []
        for r, got in enumerate(ranks):
            res = got[name]
            loss_err = float(((res["losses"].double()
                               - want["losses"].double()).abs()
                              / want["losses"].double().abs()).max())
            close = dist_close(res["tensors"], want["tensors"])
            rows.append(f"rank {r}: losses rel {loss_err:.2e}, trained "
                        f"tensors at {close:.3f} of the limit; steps "
                        f"{[round(x, 4) for x in res['step_s']]} s; "
                        f"all-reduce {_reduce_log(res)}; peak memory "
                        f"{res['peak'] / 2**30:.2f} GiB; launch counts "
                        + json.dumps(res["counts"]))
            if loss_err > DIST_TOL or close > 1:
                failed.append(f"{name}, rank {r}: off one process")
            if res["counts"] != res["expected"]:
                failed.append(f"{name}, rank {r}: launch counts "
                              f"{res['counts']} != {res['expected']}")
        identical = all(
            torch.equal(a, b) for a, b in
            zip(ranks[0][name]["tensors"], ranks[1][name]["tensors"])) and (
            torch.equal(ranks[0][name]["losses"], ranks[1][name]["losses"]))
        if not identical:
            failed.append(f"{name}: ranks differ")
        one = (f"one process: steps {[round(x, 4) for x in want['step_s']]}"
               f" s, peak memory {want['peak'] / 2**30:.2f} GiB"
               if "step_s" in want else "one process: shards in turn")
        log(f"training over GPUs (b), {name}: trained tensors "
            f"{'bit-identical' if identical else 'DIFFERENT'} across the "
            f"ranks; {one}; " + " | ".join(rows))
    if failed:
        raise AssertionError(f"training over GPUs (b): {failed}")
    return {}


def run_distributed_training(shared):
    """Phase 18: (a) then (b); the launch counts of (a)'s steps."""
    counts = run_world_one(shared)
    run_gloo_ranks(shared)
    return counts


# ------------------------------------------------ evaluation over GPUs

EVAL_DIST_T = 11  # frames of phase 19's full-width DeepLab sequence
EVAL_DIST_DET_T = 7  # of its full-width 2-object Mask R-CNN sequence
# fine-tune steps of both (50 in phases 4 and 9b): the phase checks the
# paths over ranks, whose collectives come after the fine-tune, and stays
# inside its budget of about two minutes
EVAL_DIST_EPOCHS = 10
# ranks against one process (tests/test_torch_port_eval_distributed.py):
# probabilities within 1e-5, J/F within 1e-3
EVAL_DIST_TOL = 1e-5
EVAL_DIST_JF_TOL = 1e-3


@contextlib.contextmanager
def timed_collectives(record):
    """Each ``torch.distributed.all_reduce`` and ``broadcast`` inside
    appends (name, bytes, seconds from a synchronization before it to one
    after) to ``record``."""
    import torch.distributed as dist

    plain = {name: getattr(dist, name) for name in ("all_reduce",
                                                    "broadcast")}

    def timed(name):
        def call(tensor, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = plain[name](tensor, *args, **kwargs)
            torch.cuda.synchronize()
            record.append((name, tensor.numel() * tensor.element_size(),
                           time.perf_counter() - t0))
            return work
        return call

    for name in plain:
        setattr(dist, name, timed(name))
    try:
        yield record
    finally:
        for name, fn in plain.items():
            setattr(dist, name, fn)


def full_deeplab_eval_setup():
    """Phase 4's model, meta-parameters and configuration (the fine-tune
    cut to EVAL_DIST_EPOCHS steps) on a 1-object EVAL_DIST_T-frame 480x854
    sequence, in the host window loop (the sharded path's). Returns
    (evaluator factory of a mesh, meta-parameters, index, each rank's
    expected launches)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import OneShotEvaluator
    from e_osvos_torch.ops import cuda_group_norm as K

    model, meta_params, ev, _ = build_main_path()
    cfg = dataclasses.replace(ev.cfg, num_epochs=EVAL_DIST_EPOCHS)
    index = SyntheticVOSIndex(num_sequences=1, num_frames=EVAL_DIST_T,
                              size=MAIN_HW, num_objects=1, seed=1)
    want = {**expected_launches(cfg, EVAL_DIST_T, kernel_norms(model),
                                K.LAUNCHES_PER_CALL),
            "greedy_nms": 0, "greedy_nms_s": 0, "greedy_nms_l": 0}
    return (lambda mesh: OneShotEvaluator(ev.model_apply, ev.meta_cfg, cfg,
                                          device="cuda", mesh=mesh),
            meta_params, index, want)


def full_detection_eval_setup():
    """Phase 9b's model, meta-parameters and configuration (the fine-tune
    cut to EVAL_DIST_EPOCHS steps) on a 2-object EVAL_DIST_DET_T-frame
    480x854 sequence, in the host window loop; a rank's expected launches
    are one group's (its share of 2 objects over one rank, stacked)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import DetectionOneShotEvaluator
    from e_osvos_torch.ops import cuda_group_norm as K

    model, meta_params, ev, _ = build_detection_path()
    cfg = dataclasses.replace(ev.cfg, num_epochs=EVAL_DIST_EPOCHS)
    index = SyntheticVOSIndex(num_sequences=1, num_frames=EVAL_DIST_DET_T,
                              size=MAIN_HW, num_objects=DET_MULTI_OBJECTS,
                              multi_object="single_id", seed=0)
    want = expected_detection_launches(
        cfg, EVAL_DIST_DET_T, kernel_norms(model), K.LAUNCHES_PER_CALL,
        objects=DET_MULTI_OBJECTS, fused=False)
    return (lambda mesh: DetectionOneShotEvaluator(
        model, ev.meta_cfg, cfg, device="cuda", mesh=mesh),
        meta_params, index, want)


def small_deeplab_eval_setup():
    """Phase 8's small fp32 DeepLabV3+ on a 2-object 7-frame 32x48
    sequence (the host window loop, OnA every 2 frames)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import OneShotEvaluator
    from e_osvos_torch.meta_optim import init_meta_params
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply
    from e_osvos_torch.ops import cuda_group_norm as K

    cfg, meta_cfg = small_eval_setup()
    model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                          backbone_norm="frozen_bn", output_stride=16,
                          seed=5, device="cuda")
    index = SyntheticVOSIndex(num_sequences=1, num_frames=7, size=(32, 48),
                              num_objects=2, seed=3)
    want = {**expected_launches(cfg, 7, kernel_norms(model),
                                K.LAUNCHES_PER_CALL),
            "greedy_nms": 0, "greedy_nms_s": 0, "greedy_nms_l": 0}
    return (lambda mesh: OneShotEvaluator(functional_apply(model), meta_cfg,
                                          cfg, device="cuda", mesh=mesh),
            init_meta_params(meta_cfg, model), index, want)


def small_detection_eval_setup():
    """Phase 10's tiny fp32 Mask R-CNN on a 3-object DET_REF_T-frame 64x64
    sequence, objects batched in the host window loop; over DIST_RANKS
    ranks the objects pad to 4 and each rank runs 2 stacked (its expected
    launches: one group's)."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.engine import DetectionOneShotEvaluator
    from e_osvos_torch.ops import cuda_group_norm as K

    meta_params, ev = detection_reference_setup("cuda", fused_ona=False,
                                                batch_objects=True)
    index = SyntheticVOSIndex(num_sequences=1, num_frames=DET_REF_T,
                              size=(64, 64), num_objects=3,
                              seed=DET_BATCHED_SEED)
    want = expected_detection_launches(
        ev.cfg, DET_REF_T, kernel_norms(ev.model), K.LAUNCHES_PER_CALL,
        objects=2, fused=False)
    return (lambda mesh: DetectionOneShotEvaluator(
        ev.model, ev.meta_cfg, ev.cfg, device="cuda", mesh=mesh),
        meta_params, index, want)


# run name -> setup; the full-width runs are (a)'s, all four (b)'s
EVAL_DIST_RUNS = {
    "full-width DeepLab, 1 object": full_deeplab_eval_setup,
    "full-width Mask R-CNN, 2 objects": full_detection_eval_setup,
    "small fp32 DeepLab, 2 objects": small_deeplab_eval_setup,
    "small fp32 Mask R-CNN, 3 objects": small_detection_eval_setup,
}
EVAL_GLOO_RUNS = ("full-width DeepLab, 1 object",
                  "small fp32 DeepLab, 2 objects",
                  "small fp32 Mask R-CNN, 3 objects")


def eval_dist_run(ev, meta_params, index, seed: int = 1):
    """``eval_sequence`` of ``index``'s ``seq00`` under
    ``deterministic_algorithms``: the probabilities and merged map on the
    host, J/F, wall seconds (the call to the result on the host), peak
    memory, launch counts and the collectives (name, bytes, seconds)."""
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops import cuda_nms

    K.reset_launch_counts()
    cuda_nms.reset_launch_counts()
    record = []
    with deterministic_algorithms():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with timed_collectives(record):
            res = ev.eval_sequence(index, "seq00", meta_params, seed)
        probs = torch.as_tensor(res["probs"]).cpu()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if not bool(torch.isfinite(probs).all()):
        raise AssertionError("non-finite probabilities")
    return {"probs": probs, "merged": res["merged"],
            "J": res["J_per_object"], "F": res["F_per_object"],
            "seconds": dt, "peak": torch.cuda.max_memory_allocated(),
            "counts": {**K.launch_counts(), **cuda_nms.launch_counts()},
            "collectives": record}


def _collectives_log(record):
    by = {}
    for name, nbytes, sec in record:
        n, b, t = by.get(name, (0, 0, 0.0))
        by[name] = (n + 1, b + nbytes, t + sec)
    return ", ".join(f"{n} {name} {b / 2**20:.2f} MiB in {t * 1e3:.2f} ms"
                     for name, (n, b, t) in by.items()) or "none"


def _gap(got, want):
    """(largest, mean |dprob|, largest |dJ|, |dF|) of two runs."""
    d = (got["probs"].double() - want["probs"].double()).abs()
    jf = max([abs(a - b) for k in ("J", "F")
              for a, b in zip(got[k], want[k])] + [0.0])
    return float(d.max()), float(d.mean()), jf


def run_eval_world_one(shared):
    """19 (a): a process group of one rank through NCCL on the card: the
    full-width DeepLab sequence (frames sharded) and the full-width 2-object
    Mask R-CNN sequence (objects sharded) over ``make_mesh()`` must equal
    the same evaluator without a group bit for bit (a gather and a
    broadcast over one rank are the identity), with launch counts as the
    formulas say. The ungrouped DeepLab run is (b)'s one-process
    reference."""
    import torch.distributed as dist
    from e_osvos_torch.parallel import Mesh, make_mesh, multihost

    multihost.initialize(coordinator_address=f"tcp://localhost:{free_port()}",
                         num_processes=1, process_id=0)
    total, failed = {}, []
    try:
        mesh = make_mesh()
        if (dist.get_backend() != "nccl" or mesh.group is None
                or mesh.world_size != 1):
            raise AssertionError(f"not a one-rank NCCL mesh: {mesh}")
        dist.all_reduce(torch.zeros(1, device="cuda"), group=mesh.group)
        for name in list(EVAL_DIST_RUNS)[:2]:
            make, meta_params, index, want = EVAL_DIST_RUNS[name]()
            plain = eval_dist_run(make(Mesh()), meta_params, index)
            grouped = eval_dist_run(make(mesh), meta_params, index)
            same = (torch.equal(plain["probs"], grouped["probs"])
                    and np.array_equal(plain["merged"], grouped["merged"])
                    and plain["J"] == grouped["J"]
                    and plain["F"] == grouped["F"])
            err, _, _ = _gap(grouped, plain)
            log(f"evaluation over GPUs (a), {name}: grouped "
                f"{'identical to' if same else 'DIFFERS from'} ungrouped "
                f"(largest |dprob| {err:.3e}); {grouped['seconds']:.3f} s "
                f"against {plain['seconds']:.3f} s ungrouped; collectives "
                f"{_collectives_log(grouped['collectives'])}; peak memory "
                f"{grouped['peak'] / 2**30:.2f} GiB; J {grouped['J']}; "
                "launch counts " + json.dumps(grouped["counts"])
                + " expected " + json.dumps(want))
            for r in (plain, grouped):
                if r["counts"] != want:
                    failed.append(f"{name} launch counts")
                for k, v in r["counts"].items():
                    total[k] = total.get(k, 0) + v
            if not same:
                failed.append(f"{name} not identical")
            if plain["collectives"] or not grouped["collectives"]:
                failed.append(f"{name} collectives")
            if name.startswith("full-width DeepLab"):
                shared["eval one process"] = plain
            del plain, grouped, make, meta_params
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if failed:
        raise AssertionError(f"evaluation over GPUs (a): {failed}")
    return total


def eval_gloo_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase 19 (b), started by ``spawn_gloo_ranks``: joins the
    gloo group through the file ``store`` on this card, runs each of
    EVAL_GLOO_RUNS over ``make_mesh()`` and saves the results to ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from e_osvos_torch.parallel import make_mesh, multihost

    multihost.initialize(coordinator_address=f"file://{store}",
                         num_processes=world, process_id=rank,
                         backend="gloo")
    try:
        mesh = make_mesh()
        results = {}
        for name in EVAL_GLOO_RUNS:
            make, meta_params, index, want = EVAL_DIST_RUNS[name]()
            results[name] = dict(eval_dist_run(make(mesh), meta_params,
                                               index), expected=want)
            del make, meta_params
            torch.cuda.empty_cache()
        torch.save(results, out)
    finally:
        torch.distributed.destroy_process_group()


def frames_in_turn(make, meta_params, index, shards: int, seed: int = 1):
    """The frame-sharded evaluation's plain reference: ``eval_dist_run``
    of an evaluator without a group whose every segmentation runs the
    ranks' blocks of the frames (padded by repeating the last) in turn in
    this process, each through ``segment_frames`` as a rank runs its
    own."""
    from e_osvos_torch.engine.one_shot import segment_frames
    from e_osvos_torch.parallel import Mesh, pad_rows, padded_rows

    ev = make(Mesh())

    def blocks(model_apply, params, frames, stacked=False):
        n, dim = frames.shape[0], 1 if stacked else 0
        parts = []
        for r in range(shards):
            n_pad, rows = padded_rows(Mesh(r, shards, shards), n)
            parts.append(segment_frames(model_apply, ev.cfg, params,
                                        pad_rows(frames, n_pad)[rows],
                                        stacked))
        return torch.cat(parts, dim).narrow(dim, 0, n)

    ev._segment = blocks
    return eval_dist_run(ev, meta_params, index, seed)


def objects_in_turn(make, meta_params, index, shards: int, seed: int = 1):
    """The object-sharded evaluation's plain reference: each of ``shards``
    shares of the padded object axis through the same evaluator code in
    this process, in turn, with no collective; their probabilities put
    together, the pad dropped."""
    from e_osvos_torch.engine.one_shot import stage_sequence
    from e_osvos_torch.parallel import Mesh

    seq = index.sequences["seq00"]
    parts = []
    with deterministic_algorithms():
        for r in range(shards):
            ev = make(Mesh(r, shards, shards))
            frames, support, (_, h0, w0) = stage_sequence(
                index, "seq00", ev.device, ev.cfg.pad_multiple)
            parts.append(ev._eval_objects_batched(
                index, seq, frames, meta_params, seed, None,
                orig_hw=(h0, w0),
                support_img=support[seq.object_groups[0].support_frame]))
    probs = torch.cat(parts)[:len(seq.object_groups)]
    return probs[..., :h0, :w0].cpu()


def run_eval_gloo_ranks(shared):
    """19 (b): DIST_RANKS gloo ranks sharing the card (``eval_gloo_rank``)
    against one process on the card: the full-width DeepLab sequence
    (frames sharded; one process runs the ranks' frame blocks in turn,
    ``frames_in_turn``, the same computations, and (a)'s ungrouped run
    is printed beside: bf16 convolutions of 3 frames and of 5 round
    differently, and the refits on the pseudo labels carry that on), the
    small fp32 DeepLab 2-object sequence
    (frames sharded) and the small fp32 Mask R-CNN 3-object sequence
    (objects sharded, padded to 4: one process runs the shares in turn,
    ``objects_in_turn``, the same computations, and its batched evaluator,
    which stacks 3 objects where a rank stacks 2: the tiny tracker turns
    that rounding into up to 3.3e-3 at a few pixels, so there the mean
    error is held and the largest printed). Probabilities within
    EVAL_DIST_TOL and J/F within EVAL_DIST_JF_TOL, bit-identical across the
    ranks, each rank's launch counts the formula's (K3 on each rank in the
    detection run)."""
    from e_osvos_torch.parallel import Mesh

    ref, in_turn = {}, {}
    for name in EVAL_GLOO_RUNS:
        make, meta_params, index, _ = EVAL_DIST_RUNS[name]()
        if name.startswith("full-width"):
            ref[name] = shared.pop("eval one process")
            in_turn[name] = frames_in_turn(make, meta_params, index,
                                           DIST_RANKS)["probs"]
        else:
            ref[name] = eval_dist_run(make(Mesh()), meta_params, index)
        if "Mask R-CNN" in name:
            in_turn[name] = objects_in_turn(make, meta_params, index,
                                            DIST_RANKS)
        del make, meta_params
        torch.cuda.empty_cache()

    ranks, wall = spawn_gloo_ranks("eval_gloo_rank")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"evaluation over GPUs (b): {DIST_RANKS} gloo ranks on one card "
        f"({smi.strip()}), {wall:.2f} s from start to exit; the ranks share "
        "the card's SMs, so their seconds show the collectives' cost, not "
        f"the speed-up of {DIST_RANKS} cards")
    failed = []
    for name in EVAL_GLOO_RUNS:
        want = ref[name]
        rows = []
        for r, got in enumerate(ranks):
            res = got[name]
            err, mean, jf = _gap(res, want)
            rows.append(f"rank {r}: largest |dprob| {err:.3e}, mean "
                        f"{mean:.3e}, |dJ|, |dF| {jf:.3e}; "
                        f"{res['seconds']:.3f} s; collectives "
                        f"{_collectives_log(res['collectives'])}; peak "
                        f"memory {res['peak'] / 2**30:.2f} GiB; launch "
                        "counts " + json.dumps(res["counts"]))
            if name in in_turn:
                exact = float((res["probs"] - in_turn[name]).abs().max())
                rows[-1] += f"; against the shares in turn {exact:.3e}"
            if name.startswith("full-width"):  # printed beside, not held
                ok = exact <= EVAL_DIST_TOL
            elif "Mask R-CNN" in name:
                ok = (exact <= EVAL_DIST_TOL and mean <= EVAL_DIST_TOL
                      and jf <= EVAL_DIST_JF_TOL)
                if res["counts"]["greedy_nms"] == 0:
                    failed.append(f"{name}, rank {r}: no K3 launch")
            else:
                ok = err <= EVAL_DIST_TOL and jf <= EVAL_DIST_JF_TOL
            if not ok:
                failed.append(f"{name}, rank {r}: off one process")
            if res["counts"] != res["expected"]:
                failed.append(f"{name}, rank {r}: launch counts "
                              f"{res['counts']} != {res['expected']}")
        a, b = (got[name] for got in ranks)
        identical = (torch.equal(a["probs"], b["probs"])
                     and np.array_equal(a["merged"], b["merged"])
                     and a["J"] == b["J"] and a["F"] == b["F"])
        if not identical:
            failed.append(f"{name}: ranks differ")
        log(f"evaluation over GPUs (b), {name}: "
            f"{'bit-identical' if identical else 'DIFFERENT'} across the "
            f"ranks; one process {want['seconds']:.3f} s, peak memory "
            f"{want['peak'] / 2**30:.2f} GiB; " + " | ".join(rows))
    if failed:
        raise AssertionError(f"evaluation over GPUs (b): {failed}")


def start_eval_dryrun():
    """19 (c): ``e_osvos_torch.dryrun.dryrun_multichip(DIST_RANKS,
    backend="gloo")``, its ranks sharing the card, started in a thread (its
    processes spend most of their time reaching the card, beside (a));
    the returned function waits for it and checks that the ranks' results
    agree bit for bit."""
    import threading

    from e_osvos_torch.dryrun import dryrun_multichip

    out = {}

    def run():
        t0 = time.perf_counter()
        try:
            out["ranks"] = dryrun_multichip(DIST_RANKS, backend="gloo")
        except Exception as e:  # raised by the waiting function
            out["error"] = e
        out["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=run)
    thread.start()
    return lambda: check_eval_dryrun(thread, out)


def check_eval_dryrun(thread, out):
    thread.join()
    if "error" in out:
        raise out["error"]
    a, b = out["ranks"]
    same = (a["meta_loss"] == b["meta_loss"]
            and a["detection_meta_loss"] == b["detection_meta_loss"]
            and torch.equal(a["dense_probs"], b["dense_probs"])
            and torch.equal(a["detection_probs"], b["detection_probs"]))
    log(f"evaluation over GPUs (c): dryrun_multichip({DIST_RANKS}, "
        f"backend='gloo') in {out['seconds']:.2f} s, beside (a); meta loss "
        f"{a['meta_loss']:.6g}, detection meta loss "
        f"{a['detection_meta_loss']:.6g}, J {a['J_mean']:.6g}, init J "
        f"{a['init_J_mean']:.6g}; ranks "
        f"{'agree' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("dryrun_multichip: the ranks differ")


def run_distributed_evaluation(shared):
    """Phase 19: (c) started, (a), (b), then (c) waited for; the launch
    counts of (a)'s runs."""
    dryrun = start_eval_dryrun()
    try:
        counts = run_eval_world_one(shared)
        run_eval_gloo_ranks(shared)
    finally:
        dryrun()
    return counts


# ------------------------------------------------------- the ``batch`` norm

BATCH_SEQ = "drift"  # build_480p_tree's 1-object val sequence
BATCH_META_TIMED = 2  # timed meta steps a mode in phase 20, after a warm-up


def draw_batch_statistics(model, seed: int):
    """Every ``batch`` norm of ``model`` given running statistics drawn
    from ``seed`` around its input's own, as a trained parent's norms would
    hold them, and a drawn affine, in place. A CPU copy of the model runs
    the first 2 frames of a synthetic 64x64 sequence of seed ``seed``,
    normalized as the evaluators and meta steps normalize them (``davis``):
    the DeepLab family whole, Mask R-CNN its trunk. Each norm, as its
    input arrives, takes per channel mean = μ + 0.1·σ·N(0, 1) and var =
    σ²·U(0.5, 2) of that input's μ and σ² (σ² floored at 1e-3 of its mean
    over the channels), scale ~ 1 + 0.2·N(0, 1) and bias ~ 0.1·N(0, 1).
    Computed on the CPU, so a card model and a CPU model get the same
    values. The defaults (mean 0, var 1) leave the norm an identity that
    does not normalize: a random-weight trunk's activations then grow
    layer by layer, the outputs saturate and the tiny detector's fine-tune
    diverges. A model without such norms is left as it is. Returns
    ``model``."""
    from e_osvos_torch.data import transforms
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.models import BatchNorm

    norms = [n for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    if not norms:
        return model
    index = SyntheticVOSIndex(num_sequences=1, num_frames=2, size=(64, 64),
                              seed=seed)
    x = transforms.normalize(torch.from_numpy(np.stack(
        [index.get_image("seq00", t) for t in range(2)])).float(), "davis")
    gen = torch.Generator().manual_seed(seed)
    ref = copy.deepcopy(model).to("cpu")
    mods = dict(ref.named_modules())

    def calibrate(mod, args):
        x = args[0].detach().float()
        mu, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
        var = torch.maximum(var, 1e-3 * var.mean())
        c = mu.numel()
        mod.mean.copy_(mu + 0.1 * var.sqrt() * torch.randn(c, generator=gen))
        mod.var.copy_(var * torch.empty(c).uniform_(0.5, 2.0, generator=gen))
        mod.scale.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
        mod.bias.copy_(0.1 * torch.randn(c, generator=gen))

    hooks = [mods[n].register_forward_pre_hook(calibrate) for n in norms]
    with torch.no_grad():
        if hasattr(ref, "logits_nchw"):
            ref(x)
        else:
            ref.backbone(x.permute(0, 3, 1, 2))
        for h in hooks:
            h.remove()
        own = dict(model.named_modules())
        for n in norms:
            for leaf in ("scale", "bias", "mean", "var"):
                getattr(own[n], leaf).copy_(getattr(mods[n], leaf))
    return model


def check_batch_detection_reference():
    """The tiny fp32 detection reference (phase 10's, the fused loop) with
    a ``batch`` backbone on the card: every detection-head K3 call of the
    sequence picks on the card exactly what the plain twin picks on the
    CPU from the same inputs, and the probabilities are finite. The gap to
    the CPU run is printed beside the CPU's own spread under weights x (1
    ± 2^-20), not held: with this backbone the tiny detector's RPN top-k
    turns on near-ties from its first training forward, and rounding alone
    moves the CPU run by about half a unit of probability (the spread
    printed here; PERF.md), so a 1e-3 bound on the sequence would measure
    the model's conditioning, not the port."""
    from e_osvos_torch.models import mask_rcnn
    from e_osvos_torch.ops import cuda_nms

    batched_nms, calls = mask_rcnn.batched_nms, []

    def recording(boxes, *args, **kwargs):
        if boxes.is_cuda:
            calls.append((boxes.clone(), [a.clone() if torch.is_tensor(a)
                                          else a for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kwargs.items()}))
        return batched_nms(boxes, *args, **kwargs)

    mask_rcnn.batched_nms = recording
    cuda_nms.reset_launch_counts()
    try:
        card, _ = detection_reference("cuda", backbone_norm="batch")
    finally:
        mask_rcnn.batched_nms = batched_nms
    k3 = cuda_nms.launch_counts()["greedy_nms"]
    cpu, _ = detection_reference("cpu", backbone_norm="batch")
    moved, _ = detection_reference("cpu", perturb=2.0 ** -20,
                                   backbone_norm="batch")
    same = []
    for boxes, args, kwargs in calls:
        got = [t.cpu() for t in batched_nms(boxes, *args, **kwargs)]
        want = batched_nms(boxes.cpu(), *[a.cpu() if torch.is_tensor(a)
                                          else a for a in args],
                           **{k: v.cpu() if torch.is_tensor(v) else v
                              for k, v in kwargs.items()})
        same.append(all(torch.equal(g, w) for g, w in zip(got, want)))
    gap = (card["probs"] - cpu["probs"]).abs().max().item()
    spread = (moved["probs"] - cpu["probs"]).abs().max().item()
    log(f"tiny fp32 detection eval_sequence (batch backbone, fused loop; 2 "
        f"objects, sequence seed {DET_REF_SEED}): {len(same)} detection-head "
        f"K3 calls on the card ({k3} K3 launches), picks identical to the "
        f"twin's on the same inputs: {sum(same)}/{len(same)}; card vs CPU "
        f"max |dprob| {gap:.3e} beside the CPU's own spread under weights x "
        f"(1 ± 2^-20) {spread:.3e} (printed, not held)")
    if not calls or not all(same) or k3 == 0:
        raise AssertionError(f"K3 on the batch-backbone detection sequence: "
                             f"{sum(same)}/{len(same)} calls identical to "
                             f"the twin, {k3} launches")
    if tuple(card["probs"].shape) != (2, DET_REF_T, 64, 64) or not bool(
            torch.isfinite(card["probs"]).all()):
        raise AssertionError("the batch-backbone detection sequence's "
                             "probabilities are not finite or of the "
                             "expected shape")


def run_batch_norm(shared):
    """Phase 20, the ``batch`` norm (running statistics, learned affine):
    (a) ``cli.evaluate`` with ``parent_model.backbone_norm=batch`` and the
    GroupNorm-16 head from a reference ``.pth`` whose statistics are drawn
    from a seed and a NEURON-lr ``.model`` (``cli_from_reference_files``,
    statistics unfolded), phase 11's settings on the 1-object sequence:
    fps and peak memory beside phase 11's frozen-BN run of the same
    sequence, K1/K2 launches of the head's norms as phase 4's formula
    gives them; (b) ``MetaTrainer.run`` of the full-width ``batch``
    DeepLabV3+ in both modes of phase 6 (one warm-up, BATCH_META_TIMED
    timed steps): seconds and peak memory beside phase 6's, launch counts,
    every running ``mean``/``var`` moved and finite; (c) the small fp32
    references with a ``batch`` backbone on the card against the CPU:
    the single-group evaluation, the meta step (first and second order),
    the detection sequence (K3 picks identical to the twin's) and the
    2-object sequence batched against in turn. Returns the launch counts
    of (a) and (b)."""
    from e_osvos_torch.models import DeepLabV3Plus

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    tag = "batch norm, CLI evaluation"
    counts, rec = cli_from_reference_files(
        shared, tag, BATCH_SEQ, 1,
        ["parent_model.backbone_norm=batch",
         "parent_model.decoder_norm_layer=group16"], "batch_norm",
        unfolded=True)
    base = shared.get("cli", {}).get(BATCH_SEQ)
    if base is not None:
        grew = rec["peak_mem_gib"] - rec["base_gib"]
        base_grew = base["peak_mem_gib"] - shared["cli base"][
            "CLI evaluation, DeepLab"]
        log(f"{tag}: {rec['fps']:.4f} fps, peak memory "
            f"{rec['peak_mem_gib']:.2f} GiB ({grew:.2f} over what was "
            f"allocated before); phase 11's frozen-BN run of {BATCH_SEQ}: "
            f"{base['fps']:.4f} fps, {base['peak_mem_gib']:.2f} GiB "
            f"({base_grew:.2f} over); ratio {rec['fps'] / base['fps']:.4f}, "
            f"the sequence's own memory {grew - base_grew:+.2f} GiB; "
            f"phase 4's timed sequence "
            f"{shared.get('main fps', float('nan')):.4f} fps; on {smi}")

    t0 = time.perf_counter()
    model = draw_batch_statistics(DeepLabV3Plus(
        num_classes=1, arch="resnet50", backbone_norm="batch",
        output_stride=16, dtype=torch.bfloat16, seed=0, device="cuda"), 3)
    n_gn = kernel_norms(model)
    log(f"batch norm, meta-training set-up: {time.perf_counter() - t0:.3f} "
        f"s; {n_gn} GroupNorm layers on the kernels")
    for mode, step_cfg in meta_step_configs().items():
        got, result = run_meta_mode(model, f"{mode}, batch backbone",
                                    step_cfg, n_gn, n_timed=BATCH_META_TIMED,
                                    watch_buffers=True)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        frozen = shared.get(f"meta {mode}")
        if frozen is not None:
            grew, base_grew = (
                (r["peak_bytes"] - r["base_bytes"]) / 2**30
                for r in (result, frozen))
            log(f"batch norm, meta-training {mode}: median "
                f"{result['median_step_s']['step_s']:.4f} s a step, peak "
                f"{result['peak_bytes'] / 2**30:.2f} GiB ({grew:.2f} over "
                f"what was allocated before); phase 6's frozen-BN "
                f"{frozen['median_step_s']['step_s']:.4f} s, "
                f"{frozen['peak_bytes'] / 2**30:.2f} GiB ({base_grew:.2f} "
                f"over); on {smi}")
        stats, moved = result["buffers"], result["buffers_moved"]
        reached = result["buffers_reached"]
        by_leaf = {leaf: (sum(k.endswith(leaf) for k in moved),
                          sum(k.endswith(leaf) for k in stats))
                   for leaf in (".mean", ".var")}
        log(f"batch norm, meta-training {mode}: of {len(stats)} running "
            f"statistics, {len(reached)} had a non-zero meta-gradient in an "
            f"outer step, {result['buffers_finite']} are finite; moved in "
            f"value: means "
            f"{by_leaf['.mean'][0]}/{by_leaf['.mean'][1]}, variances "
            f"{by_leaf['.var'][0]}/{by_leaf['.var'][1]} (before RAdam's "
            f"rectification at step 6 an update is the outer lr, 1e-5, "
            f"times the first moment: a variance near 1 moves only where "
            f"that exceeds half an f32 ulp, 6e-8)")
        if (not stats or reached != stats
                or result["buffers_finite"] != len(stats)):
            raise AssertionError(
                f"running statistics after the outer steps: "
                f"{sorted(stats - reached)[:8]} not reached, "
                f"{len(stats) - result['buffers_finite']} not finite")
    del model

    check_reference(backbone_norm="batch")
    check_meta_reference(backbone_norm="batch")
    check_batch_detection_reference()
    check_eval_reference(backbone_norm="batch")
    return counts


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
              ("CLI evaluation, reference checkpoints, on disk",
               lambda: run_cli_reference(shared)),
              ("meta-training", lambda: run_meta_training(shared)),
              ("meta-training reference", check_meta_reference),
              ("detection main path",
               lambda: run_detection_path(shared=shared)),
              ("detection multi-object sequence",
               lambda: run_detection_multi_object(shared)),
              ("detection reference", check_detection_reference),
              ("detection batched reference",
               check_detection_batched_reference),
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
              ("CLI training, on disk", lambda: run_cli_training(shared)),
              ("training over several GPUs",
               lambda: run_distributed_training(shared)),
              ("evaluation over several GPUs",
               lambda: run_distributed_evaluation(shared)),
              ("the batch norm", lambda: run_batch_norm(shared)))
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
