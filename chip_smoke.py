"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

  1. device: the card's name and power limit;
  2. build: compiles the GroupNorm kernels (e_osvos_torch/csrc) with nvcc;
  3. kernels: each kernel against its plain PyTorch twin in bf16, at the
     main path's shapes [3|4|5, 120*214, 256] and at edge shapes (C = 48,
     M = 1, M not a multiple of the row chunk, N = 1), with times of the
     kernel, the twin and, where one exists, a single PyTorch call computing
     the same function;
  4. main path: e-OSVOS-50-OnA one-shot evaluation (bench.py's
     configuration) with a full-width resnet50 os16 frozen-BN DeepLabV3+ in
     bf16 at 480x854, seeded random weights: a 16-frame warm-up sequence,
     then one timed 67-frame sequence, with its fps and per-phase times; the
     kernels' launch counts must equal what the configuration implies;
  5. reference: the same evaluation on a small fp32 model and input, on the
     card and on the CPU (the kernels' plain twins), must agree.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def check_kernels(peaks):
    """Each kernel against its plain twin; returns the kernels' records
    (without launch counts, which come from the main path)."""
    from e_osvos_torch.ops import cuda_group_norm as K
    from e_osvos_torch.ops.group_norm import (
        GroupNormFunction, fused_group_norm, group_norm,
    )

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=bf, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen) * scale + shift
        return t.to(dev, dtype)

    # (N, M, C, groups): main-path batches, then the edge shapes
    shapes = [(3, GN_M, GN_C, 16), (4, GN_M, GN_C, 16), (5, GN_M, GN_C, 16),
              (3, GN_M, 48, 16), (3, 1, GN_C, 16), (2, 1000, GN_C, 16),
              (1, 777, 48, 16), (1, 30 * 54, GN_C, 16)]
    # Tolerances. Sums are f32 over bf16 inputs, taken in another order than
    # the twin: relative 1e-4 of the sum of magnitudes. The bf16 outputs may
    # differ by one bf16 rounding step (2^-8 relative) where the kernel's
    # FMA and the twin's separate multiply and add round differently:
    # 1e-2 of the largest magnitude. The parameter gradients are sums of
    # bf16 products over N*M rows: relative 1e-3.
    tol_sum, tol_out, tol_param = 1e-4, 1e-2, 1e-3
    errs = {"channel_sums": 0.0, "affine_apply": 0.0, "pair_sums": 0.0,
            "affine_dx": 0.0}
    worst = {k: 0.0 for k in errs}  # err / tolerance-scale, must stay <= 1
    for n, m, c, g in shapes:
        x = rand(n, m, c, scale=2.0, shift=0.5)
        dy = rand(n, m, c)
        scale = rand(c, dtype=torch.float32, scale=0.5, shift=1.0)
        bias = rand(c, dtype=torch.float32, scale=0.5)

        s_k, sq_k = K.channel_sums(x)
        s_p, sq_p = K.channel_sums_plain(x)
        mag = x.float().abs().sum(1)
        e = max((s_k - s_p).abs().max().item(), (sq_k - sq_p).abs().max().item())
        r = max(((s_k - s_p).abs() / (tol_sum * mag + 1e-6)).max().item(),
                ((sq_k - sq_p).abs() / (tol_sum * (x.float() ** 2).sum(1) + 1e-6)).max().item())
        errs["channel_sums"] = max(errs["channel_sums"], e)
        worst["channel_sums"] = max(worst["channel_sums"], r)

        p1_k, p2_k = K.pair_sums(dy, x)
        p1_p, p2_p = K.pair_sums_plain(dy, x)
        e = max((p1_k - p1_p).abs().max().item(), (p2_k - p2_p).abs().max().item())
        r = max(((p1_k - p1_p).abs() / (tol_sum * dy.float().abs().sum(1) + 1e-6)).max().item(),
                ((p2_k - p2_p).abs() / (tol_sum * (dy.float() * x.float()).abs().sum(1) + 1e-6)).max().item())
        errs["pair_sums"] = max(errs["pair_sums"], e)
        worst["pair_sums"] = max(worst["pair_sums"], r)

        # K1 + apply through the autograd.Function vs the plain group_norm
        xr = x.clone().requires_grad_(True)
        sr = scale.clone().requires_grad_(True)
        br = bias.clone().requires_grad_(True)
        y_k = fused_group_norm(xr, sr, br, g)
        xp = x.clone().requires_grad_(True)
        sp = scale.clone().requires_grad_(True)
        bp = bias.clone().requires_grad_(True)
        y_p = group_norm(xp, sp, bp, g)
        e = (y_k.float() - y_p.float()).abs().max().item()
        errs["affine_apply"] = max(errs["affine_apply"], e)
        worst["affine_apply"] = max(
            worst["affine_apply"], e / (tol_out * max(1.0, y_p.float().abs().max().item())))

        # K2 + dx via the Function's backward vs autograd through the twin
        gk = torch.autograd.grad(y_k, (xr, sr, br), dy)
        gp = torch.autograd.grad(y_p, (xp, sp, bp), dy)
        e = (gk[0].float() - gp[0].float()).abs().max().item()
        errs["affine_dx"] = max(errs["affine_dx"], e)
        worst["affine_dx"] = max(
            worst["affine_dx"], e / (tol_out * max(1.0, gp[0].float().abs().max().item())))
        for a, b_ in zip(gk[1:], gp[1:]):
            rp = ((a - b_).abs().max() / (tol_param * max(1.0, b_.abs().max().item()))).item()
            worst["pair_sums"] = max(worst["pair_sums"], rp)
        log(f"  shape N={n} M={m} C={c} G={g}: ok so far, worst err/tol "
            + json.dumps({k: round(v, 4) for k, v in worst.items()}))
    torch.cuda.synchronize()
    log("kernel max_abs_err " + json.dumps(errs))
    log(f"tolerances: sums rel {tol_sum}, bf16 outputs {tol_out} x max|ref|, "
        f"param grads rel {tol_param}")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain twins: {bad}")

    # ---- times at the main path's fine-tune shape [3, 25680, 256] ----
    bw, f32_peak = peaks
    n, m, c, g = 3, GN_M, GN_C, 16
    x = rand(n, m, c, scale=2.0, shift=0.5)
    dy = rand(n, m, c)
    scale = rand(c, dtype=torch.float32, scale=0.5, shift=1.0)
    bias = rand(c, dtype=torch.float32, scale=0.5)
    a = rand(n, c, dtype=torch.float32)
    b = rand(n, c, dtype=torch.float32)
    D = rand(n, c, dtype=torch.float32)
    elems = n * m * c
    nbytes = elems * x.element_size()
    bounds = {  # (bytes moved, f32 operations)
        "channel_sums": (nbytes + 2 * n * c * 4, 2 * elems),
        "affine_apply": (2 * nbytes + 2 * n * c * 4, 2 * elems),
        "pair_sums": (2 * nbytes + 2 * n * c * 4, 2 * elems),
        "affine_dx": (3 * nbytes + 3 * n * c * 4, 4 * elems),
    }
    calls = {
        "channel_sums": (lambda: K.channel_sums(x), lambda: K.channel_sums_plain(x)),
        "affine_apply": (lambda: K.affine_apply(x, a, b), lambda: K.affine_apply_plain(x, a, b)),
        "pair_sums": (lambda: K.pair_sums(dy, x), lambda: K.pair_sums_plain(dy, x)),
        "affine_dx": (lambda: K.affine_dx(dy, x, a, b, D), lambda: K.affine_dx_plain(dy, x, a, b, D)),
    }
    records = {}
    for name, (kern, plain) in calls.items():
        t_plain_1 = cuda_time_ms(plain)
        t_kern_1 = cuda_time_ms(kern)
        t_kern_2 = cuda_time_ms(kern)
        t_plain_2 = cuda_time_ms(plain)
        byts, ops = bounds[name]
        bound = max(byts / bw, ops / f32_peak) * 1e3
        records[name] = {
            "ms": min(t_kern_1, t_kern_2), "plain_ms": min(t_plain_1, t_plain_2),
            "bound_ms": bound,
            "bound_by": "bytes" if byts / bw >= ops / f32_peak else "operations",
            "library_ms": None, "max_abs_err": errs[name],
        }
        log(f"  {name}: kernel {records[name]['ms']:.4f} ms, plain "
            f"{records[name]['plain_ms']:.4f} ms, bound {bound:.4f} ms")

    # GroupNorm forward / backward as composites, beside one PyTorch call
    # computing the same function (a yardstick the port never calls)
    x4 = x.view(n, 120, 214, c).permute(0, 3, 1, 2)  # NCHW, channels_last
    # the library's backward takes NCHW-contiguous operands
    x4c, dy4c = x4.contiguous(), dy.view(n, 120, 214, c).permute(0, 3, 1, 2).contiguous()
    y, mean, rstd = GroupNormFunction.apply(x, scale, bias, g, 1e-6)
    _, lmean, lrstd = torch.ops.aten.native_group_norm(
        x4c, scale.to(bf), bias.to(bf), n, c, m, g, 1e-6)

    def fwd():
        return GroupNormFunction.forward(x, scale, bias, g, 1e-6)

    def bwd():
        class _Ctx:  # the residuals the forward saved
            saved_tensors = (x, scale, mean, rstd)
            num_groups = g
        return GroupNormFunction.backward(_Ctx, dy, None, None)

    composites = {
        "gn_forward": (fwd, lambda: torch.nn.functional.group_norm(
            x4, g, scale.to(bf), bias.to(bf), 1e-6),
            (2 * nbytes, 4 * elems)),
        "gn_backward": (bwd, lambda: torch.ops.aten.native_group_norm_backward(
            dy4c, x4c, lmean, lrstd, scale.to(bf), n, c, m, g,
            [True, True, True]), (3 * nbytes, 8 * elems)),
    }
    comp = {}
    for name, (kern, lib, (byts, ops)) in composites.items():
        t_lib_1 = cuda_time_ms(lib)
        t_k = cuda_time_ms(kern)
        t_lib_2 = cuda_time_ms(lib)
        comp[name] = {"ms": t_k, "library_ms": min(t_lib_1, t_lib_2),
                      "bound_ms": max(byts / bw, ops / f32_peak) * 1e3}
    log("gn composites at [3, 25680, 256] bf16 " + json.dumps(comp))
    return records


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
    calls = {"channel_sums": forwards, "affine_apply": forwards,
             "pair_sums": backwards, "affine_dx": backwards}
    return {k: v * n_gn * per_call[k] for k, v in calls.items()}


def build_main_path(device="cuda"):
    """bench.py's e-OSVOS-50-OnA configuration on the port: full-width
    resnet50 os16 frozen-BN DeepLabV3+ in bf16 with seeded random weights,
    neuron-level linear lrs at 1e-3 with a learned init, and two synthetic
    480x854 sequences of 67 frames."""
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
                                 device=device)
    index = SyntheticVOSIndex(num_sequences=2, num_frames=MAIN_T,
                              size=MAIN_HW, num_objects=1, seed=0)
    return model, meta_params, evaluator, index


def stage_frames(index, device="cuda"):
    """Every sequence's raw frames on the device, before any timer."""
    return {name: torch.from_numpy(np.stack(
        [index.get_image(name, t) for t in range(len(seq))])).to(device)
        for name, seq in index.sequences.items()}


def timed_sequence(evaluator, meta_params, index, staged, name: str, T: int,
                   seed: int):
    """The first object group of sequence ``name`` (first ``T`` staged
    frames) through ``OneShotEvaluator._eval_object_group``, then threshold,
    bit-pack and fetch to the host. Returns (probs, unpacked masks, phase
    seconds on the device's timeline): the evaluator's ``on_phase`` hook
    marks the ends of the fine-tune and the propagation with CUDA events;
    ``fetched_s`` is the threshold, pack and host fetch."""
    from e_osvos_torch.ops.bits import pack_mask_bits, unpack_mask_bits

    events = {}

    def mark(phase):
        events[phase] = torch.cuda.Event(enable_timing=True)
        events[phase].record()

    seq = index.sequences[name]
    group = seq.object_groups[0]
    frames = staged[name][:T]
    gen = torch.Generator(device="cpu").manual_seed(seed)
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


def run_main_path():
    from e_osvos_torch.ops import cuda_group_norm as K
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
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, masks, phases = timed_sequence(evaluator, meta_params, index,
                                          staged, "seq01", MAIN_T, 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    want = expected_launches(cfg, MAIN_T, n_gn, K.LAUNCHES_PER_CALL)
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
    return counts


def check_reference():
    """The whole slice on a small fp32 model, on the card and on the CPU."""
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import OneShotConfig, OneShotEvaluator
    from e_osvos_torch.meta_optim import MetaOptimConfig, init_meta_params
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply

    index = SyntheticVOSIndex(num_sequences=1, num_frames=7, size=(32, 48),
                              seed=3)
    seq = index.sequences["seq00"]
    cfg = OneShotConfig(num_epochs=3, batch_size=3, loss_func="dice",
                        online_adapt_step=2, online_adapt_epochs=2,
                        augment=AugmentConfig(
                            scale_min=1.0, scale_max=1.0, rot_deg=0.0,
                            brightness=0.0, contrast=0.0, saturation=0.0,
                            flip_prob=0.0, compute_dtype="float32"))
    meta_cfg = MetaOptimConfig(init_lr=1e-3, use_log_init_lr=False)
    out = {}
    for device in ("cpu", "cuda"):
        model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                              backbone_norm="frozen_bn", output_stride=16,
                              seed=5, device=device)
        meta_params = init_meta_params(meta_cfg, model)
        ev = OneShotEvaluator(functional_apply(model), meta_cfg, cfg,
                              device=device)
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


# ------------------------------------------------------------------ main


REPLACES = {
    "channel_sums": "e_osvos_tpu/ops/pallas_group_norm.py:47",
    "pair_sums": "e_osvos_tpu/ops/pallas_group_norm.py:63",
    # the elementwise passes XLA fused around the two Pallas kernels
    "affine_apply": "e_osvos_tpu/ops/pallas_group_norm.py:167",
    "affine_dx": "e_osvos_tpu/ops/pallas_group_norm.py:208",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # The port is imported from the checkout holding this script.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from e_osvos_torch.ops import cuda_group_norm as K

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

    t0 = time.perf_counter()
    so = K.build()
    K._load()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    log_path = so.with_suffix(".log")
    for line in log_path.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    t0 = time.perf_counter()
    records = check_kernels(peaks)
    log(f"kernel checks: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    counts = run_main_path()
    log(f"main path phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check_reference()
    log(f"reference phase: {time.perf_counter() - t0:.2f} s")

    kernels = []
    for kname, rec in records.items():
        kernels.append({
            "name": f"gn_{kname}", "route": "cuda",
            "source": "e_osvos_torch/csrc/group_norm.cu",
            "replaces": REPLACES[kname], "launches": counts[kname],
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
