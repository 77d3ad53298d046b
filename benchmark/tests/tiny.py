"""A cell of each family at a size the CPU holds: resnet10, 48x64 frames,
8-frame sequences, 4 fine-tune and 2 refit steps, and the tiny Mask
R-CNN's proposal counts cut to match. Shared by the tests."""

from __future__ import annotations


import torch

from harness import cells, faults, judge, main, seeds

# limits at this size: in float32 the sound program reads under 1e-4 on
# every number against the reference (the kernels' plain twins run on the
# CPU); every fault reads above them (tests/test_bench_faults.py)
TINY_LIMITS = {"step_gap": 0.05, "step_angle": 0.001, "loss_gap": 1e-3,
               "frame_gap": 0.01, "merged_off": 0, "passes_off": 0}


def cell(family: str, objects: int = 1, dtype: str = "float32",
         limits=None) -> cells.Cell:
    name = {"deeplabv3plus": "deeplabv3plus-r50-os16",
            "maskrcnn": "maskrcnn-r50-fpn-gn32-f32"}[family]
    cfg = cells.config(name)
    cfg["name"] = name
    cfg["model"]["arch"] = "resnet10"
    cfg["model"]["dtype"] = dtype
    cfg["precision"]["dtype"] = dtype
    cfg["augment"]["compute_dtype"] = dtype
    cfg["one_shot"].update(num_epochs=4, online_adapt_epochs=2)
    cfg["warmup"] = {"frames": 4, "num_epochs": 2}
    if family == "maskrcnn":
        m = cfg["model"]
        m["backbone_norm"] = "group4"
        m["rpn"] = dict(m["rpn"], pre_nms_top_n=100, post_nms_top_n=32,
                        batch_size_per_image=32)
        m["roi"] = dict(m["roi"], batch_size_per_image=16)
    mix = cells.traffic(f"seq67-480p-{objects}obj")
    mix.update(frames=8, height=48, width=64, pool=2, name="tiny")
    e2e = [{"name": n, "unit": "u"} for n in ("seq_fps", "peak_mem_gib",
                                              "setup_s")]
    layer = [{"name": n, "unit": "u"} for n in (
        "fine_tune_s", "propagate_s", "kernels_per_frame",
        "device_idle_share", "gn_roofline", "mfu")]
    return cells.Cell("tiny", 1, cfg, mix, e2e, layer, 1,
                      dict(limits or TINY_LIMITS))


def run(c: cells.Cell, seed: int, fault: str = "none", trace: bool = False):
    """One run of ``c`` on the CPU but for the look for a card: set-up,
    window, optional trace, comparison. Returns (correct, readings,
    window, bench, traced)."""
    torch.manual_seed(0)
    device = torch.device("cpu")
    rs = seeds.derive(seed)
    bench = main.Bench(c, device)
    inputs = bench.prepare(rs)
    with faults.planted(fault):
        win = bench.window(inputs, rs, 0.0)
    traced = (bench.traced_sequence(inputs, rs, len(win.sequences))
              if trace else None)
    bench.free_program()
    got = bench.compare(inputs, win, rs)
    correct, _ = judge.decide(got["program"], c.limits)
    return correct, got, win, bench, traced
