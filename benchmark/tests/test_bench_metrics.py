"""The metric readers' arithmetic on planted records, and the yardstick's
counts against hand-counted shapes."""

from types import SimpleNamespace

import pytest
import torch

from harness import cells, counts, peaks, window
from plainref.group_norm import FusedGroupNorm
from plainref.resnet import Conv


def _window(ends, frames=67):
    seqs = [window.Sequence(j, "s", frames, e, {}, True)
            for j, e in enumerate(ends)]
    return window.Window(seqs, ends[-1], 2 ** 30, None, None, {})


def read(name, **kw):
    return cells.metric_reader(name).read(SimpleNamespace(**kw))


def test_seq_fps_is_all_frames_over_all_time():
    steady = _window([10.0, 20.0, 30.0, 40.0])
    stalled = _window([10.0, 20.0, 45.0, 55.0])  # one sequence stalls 15 s
    assert read("seq_fps", window=steady) == pytest.approx(4 * 67 / 40.0)
    assert read("seq_fps", window=stalled) == pytest.approx(4 * 67 / 55.0)
    # a median of per-sequence rates would not see the stall
    per_seq = sorted(67 / d for d in (10.0, 10.0, 25.0, 10.0))
    assert per_seq[2] == pytest.approx(6.7)
    assert read("seq_fps", window=stalled) < 0.75 * 6.7


def test_peak_mem_and_idle_share():
    assert read("peak_mem_gib", window=_window([1.0])) == 1.0
    trace = SimpleNamespace(busy_s=3.0, window_s=4.0)
    assert read("device_idle_share", trace=trace) == pytest.approx(25.0)
    assert read("device_idle_share", trace=None) is None


class _ConvNorm:
    """A family whose reference is one 3x3 convolution and one GroupNorm."""

    @staticmethod
    def flop_passes(cfg, frames, objects):
        return [("train", 2, 5), ("infer", 3, 7)]

    class Reference:
        def __init__(self, cfg, objects, device, mode):
            conv = Conv(3, 8, 3, padding=1).to(device)
            norm = FusedGroupNorm(8, num_groups=4).to(device)
            self.net = torch.nn.Sequential(conv, norm)

            def apply(theta, imgs):
                return torch.func.functional_call(
                    self.net, theta, (imgs.permute(0, 3, 1, 2),))

            self.apply = apply

        def module(self):
            return self.net


def test_counts_against_hand_counts():
    h, w = 6, 10
    shapes = {"0.weight": (8, 3, 3, 3), "1.scale": (8,), "1.bias": (8,)}
    cfg = {"model": {"dtype": "bfloat16"}}
    got = counts.sequence_counts(_ConvNorm, cfg, 0, (h, w), 1, shapes,
                                 list(shapes))
    conv = 2 * 8 * 3 * 9 * h * w  # FLOPs an image, forward
    # training: forward, and a backward for the weight only (the input
    # needs no gradient): 2 convolutions an image
    flops = 5 * 2 * (2 * conv) + 7 * 3 * conv
    act = 8 * h * w * 2  # the norm's input in bf16, an image
    gn = 5 * 2 * act * (2 + 3) + 7 * 3 * act * 2
    assert got == {"flops": flops, "gn_bytes": gn}
    run = SimpleNamespace(window=_window([2.0, 4.0]), counts=got,
                          cfg={"precision": {"dtype": "bfloat16"}},
                          peaks=peaks)
    assert read("mfu", **vars(run)) == pytest.approx(
        100 * 2 * flops / (4.0 * 989e12))
    trace = SimpleNamespace(kernel_s={"void affine_kernel<float>": 1e-3,
                                      "partial_sums_kernel": 1e-3,
                                      "other": 5.0})
    assert read("gn_roofline", trace=trace, counts=got, peaks=peaks) == \
        pytest.approx(100 * gn / 3.35e12 / 2e-3)
