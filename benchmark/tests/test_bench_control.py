"""The control, the reference one precision below the configuration's
put in the program's place, comes out not correct. DeepLab's control
(float8 operands and gradients) shows on the CPU; Mask R-CNN's (TF32)
needs a card. On a card each cell's control is also judged at the cell's
own size and limits, beside the sound program."""

import gc
import json
import os

import pytest
import torch

import tiny
from harness import judge

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(
    os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def test_deeplab_control_fails():
    _, got, *_ = tiny.run(tiny.cell("deeplabv3plus", 1), 5)
    correct, checks = judge.decide(got["control"], {
        k: v for k, v in tiny.TINY_LIMITS.items()
        if k in ("step_gap", "loss_gap", "frame_gap")})
    assert not correct, checks


@pytest.mark.cuda
def test_maskrcnn_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a card")

    from harness import main, seeds

    c = tiny.cell("maskrcnn", 1)
    rs = seeds.derive(5)
    bench = main.Bench(c, torch.device("cuda"))
    inputs = bench.prepare(rs)
    win = bench.window(inputs, rs, 0.0)
    bench.free_program()
    got = bench.compare(inputs, win, rs)
    correct, checks = judge.decide(got["control"], {
        k: v for k, v in tiny.TINY_LIMITS.items()
        if k in ("step_gap", "loss_gap", "frame_gap")})
    assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("the cells' sizes need a card")

    from harness import cells, main, program, seeds

    c = cells.load_cell(name)
    program.set_flags(c.config["precision"])
    rs = seeds.derive(2 ** 31 + 17)
    bench = main.Bench(c, torch.device("cuda"))
    inputs = bench.prepare(rs)
    win = bench.window(inputs, rs, 0.0)
    bench.free_program()
    got = bench.compare(inputs, win, rs)
    del bench, inputs, win
    gc.collect()
    torch.cuda.empty_cache()
    correct, checks = judge.decide(got["program"], c.limits)
    assert correct, checks
    correct, checks = judge.decide_control(got["control"], c.limits)
    assert not correct, checks
