"""The plain reference against ``e_osvos_torch`` at a tiny size on the
CPU, through the whole run but the look for a card: in float32 the
program (its kernels' plain twins on the CPU) and the reference agree on
every compared number, for each family, and the run's metrics and trace
reduce."""

import pytest

import tiny


@pytest.mark.parametrize("family,objects", [("deeplabv3plus", 1),
                                            ("deeplabv3plus", 2),
                                            ("maskrcnn", 1)])
def test_program_matches_reference(family, objects):
    correct, got, win, bench, traced = tiny.run(
        tiny.cell(family, objects), 2 ** 31 + 11, trace=True)
    p = got["program"]
    assert correct, p
    assert p["merged_off"] == 0 and p["passes_off"] == 0
    assert p["step_gap"] < 0.01 and p["loss_gap"] < 1e-4
    assert len(win.sequences) == 1 and win.frames == 8
    assert traced is not None and traced[0].window_s > 0


def test_bf16_program_reads_its_precision():
    """The bf16 DeepLab, as the configuration states it, sits between the
    float32 program and the float8 control on every number (the ordering
    the limits are set from)."""
    _, got, *_ = tiny.run(tiny.cell("deeplabv3plus", 1, "bfloat16"), 7)
    p, c = got["program"], got["control"]
    for k in ("step_gap", "loss_gap", "frame_gap"):
        assert 0 < p[k] < c[k], (k, p[k], c[k])
