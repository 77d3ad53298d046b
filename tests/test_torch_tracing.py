"""The port's spans and counters (``e_osvos_torch/utils/tracing.py``).

Off, a span is one shared no-op context and the program's outputs are
those of a run with tracing on, bit for bit. On, one sequence of each
evaluator path gives one ``sequence`` root, the inner steps and refits
its configuration fixes, parents whose host intervals hold their
children, the ``on_phase`` marks unchanged, and launches that add up to
the kernel counters' change (the counters moved here by the kernels'
plain twins, which leave them alone on the CPU).

Tiny models on the CPU: DeepLabV3+ resnet10 frozen-BN, group16 head,
32x48, 6 frames, OnA every 2 frames (three windows, two refits), one
object or two stacked; Mask R-CNN resnet10 GroupNorm-4, 64x64, 5 frames
(two windows, one refit). 3 fine-tune steps, 2 a refit; degenerate
augmentation. The ``cuda`` case runs the DeepLab path on the card:

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda
"""

import warnings

import numpy as np
import pytest
import torch

from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import (
    DetectionOneShotConfig,
    DetectionOneShotEvaluator,
    OneShotConfig,
    OneShotEvaluator,
)
from e_osvos_torch.engine import one_shot
from e_osvos_torch.meta_optim import MetaOptimConfig, init_meta_params
from e_osvos_torch.models import DeepLabV3Plus, functional_apply
from e_osvos_torch.models.mask_rcnn import MaskRCNN, RoIConfig
from e_osvos_torch.models.resnet import Conv
from e_osvos_torch.models.rpn import RPNConfig
from e_osvos_torch.ops import cuda_group_norm, cuda_nms
from e_osvos_torch.utils import tracing

AUG_KW = dict(scale_min=1.0, scale_max=1.0, rot_deg=0.0, brightness=0.0,
              contrast=0.0, saturation=0.0, flip_prob=0.0,
              compute_dtype="float32")
CFG_KW = dict(num_epochs=3, batch_size=3, loss_func="dice",
              online_adapt_step=2, online_adapt_epochs=2)
SYNC = "called a synchronizing CUDA operation"
# the span each span opens inside
PARENTS = {"stage": {"sequence"}, "fine_tune": {"sequence"},
           "propagate": {"sequence"}, "score": {"sequence"},
           "segment": {"propagate"}, "pseudo_gt": {"propagate"},
           "refit": {"propagate"}, "inner_step": {"fine_tune", "refit"},
           "forward": {"inner_step"}, "backward": {"inner_step"},
           "update": {"inner_step"}}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing kept."""
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


@pytest.fixture
def counted_twins(monkeypatch):
    """The plain twins of K1 and K3 count a launch a call, as the kernels
    do on the card."""
    stats, nms = cuda_group_norm.group_stats_plain, cuda_nms.greedy_nms_plain

    def stats_counted(*args, **kw):
        cuda_group_norm.group_stats.launches += 2
        return stats(*args, **kw)

    def nms_counted(*args, **kw):
        cuda_nms.greedy_nms.launches += 1
        return nms(*args, **kw)

    monkeypatch.setattr(cuda_group_norm, "group_stats_plain", stats_counted)
    monkeypatch.setattr(cuda_nms, "greedy_nms_plain", nms_counted)


def _counts():
    return {**cuda_group_norm.launch_counts(), **cuda_nms.launch_counts()}


# -- the tracer alone -------------------------------------------------------


def test_off_is_one_shared_noop_context():
    assert tracing.span("a") is tracing.span("b")
    with torch.profiler.profile() as prof:
        filters = list(warnings.filters)
        with tracing.span("tracing_test_off"):
            torch.ones(3).sum()
        assert warnings.filters == filters
    assert tracing.collect() == []
    assert "tracing_test_off" not in {e.name for e in prof.events()}

    tracing.enable("cpu")
    with torch.profiler.profile() as prof:
        with tracing.span("tracing_test_on"):
            torch.ones(3).sum()
    assert "tracing_test_on" in {e.name for e in prof.events()}
    (rec,) = tracing.collect()
    assert rec.name == "tracing_test_on" and rec.parent is None
    assert (rec.device_start, rec.device_end) == (rec.host_start,
                                                  rec.host_end)
    assert tracing.collect() == []


def test_syncs_count_on_the_innermost_span():
    filters = list(warnings.filters)
    tracing.enable("cpu")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with tracing.span("root"):
            warnings.warn(SYNC)
            with tracing.span("child"):
                for _ in range(3):  # one call site: none deduplicated
                    warnings.warn(SYNC)
                warnings.warn("something else")
            with tracing.span("child"):
                pass
        warnings.warn(SYNC)  # outside any span: shown, not counted
    recs = {(r.name, r.id): r for r in tracing.collect()}
    assert [r.syncs for r in recs.values()] == [3, 0, 1]
    assert [str(w.message) for w in seen] == ["something else", SYNC]
    assert warnings.filters == filters


def test_ids_parents_roots_and_an_exception():
    tracing.enable("cpu")
    for _ in range(2):
        with pytest.raises(ValueError):
            with tracing.span("root"), tracing.span("mid"):
                with tracing.span("leaf"):
                    pass
                raise ValueError
    assert not tracing.TRACER.open
    recs = tracing.collect()
    assert [r.name for r in recs] == ["leaf", "mid", "root"] * 2
    by_id = {r.id: r for r in recs}
    for r in recs:
        root = by_id[r.root]
        assert root.parent is None and root.name == "root"
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.host_start <= r.host_start <= r.host_end <= p.host_end
    assert len({r.root for r in recs}) == 2
    totals = tracing.totals(recs)
    assert totals["leaf"]["count"] == 2
    assert totals["root"]["host_s"] == pytest.approx(
        sum(r.host_s for r in recs if r.name == "root"))


# -- the evaluators ---------------------------------------------------------


def _deeplab(objects: int, fused: bool, dtype=torch.float32,
             batch_objects: bool = True):
    model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                          backbone_norm="frozen_bn", head_norm="group16",
                          output_stride=16, dtype=dtype, device="cpu")
    meta_cfg = MetaOptimConfig()
    ev = OneShotEvaluator(functional_apply(model), meta_cfg,
                          OneShotConfig(augment=AugmentConfig(**AUG_KW),
                                        **CFG_KW),
                          device="cpu", fused_ona=fused,
                          batch_objects=batch_objects)
    index = SyntheticVOSIndex(num_sequences=1, num_frames=6, size=(32, 48),
                              num_objects=objects, seed=2)
    return ev, init_meta_params(meta_cfg, model), index, 3


def _maskrcnn(objects: int, fused: bool):
    model = MaskRCNN(rpn=RPNConfig(anchor_sizes=(8, 16, 32, 64, 128),
                                   pre_nms_top_n=64, post_nms_top_n=32,
                                   batch_size_per_image=32),
                     roi=RoIConfig(batch_size_per_image=16,
                                   detections_per_img=1),
                     arch="resnet10", backbone_norm="group4", device="cpu")
    meta_cfg = MetaOptimConfig(init_lr=1e-4)
    ev = DetectionOneShotEvaluator(
        model, meta_cfg,
        DetectionOneShotConfig(augment=AugmentConfig(**AUG_KW), **CFG_KW),
        device="cpu", fused_ona=fused)
    index = SyntheticVOSIndex(num_sequences=1, num_frames=5, size=(64, 64),
                              num_objects=objects, seed=4)
    return ev, init_meta_params(meta_cfg, model), index, 2


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("build,objects,fused", [
    (_deeplab, 1, True), (_deeplab, 1, False), (_deeplab, 2, True),
    (_maskrcnn, 1, True), (_maskrcnn, 1, False)],
    ids=["deeplab-fused", "deeplab-host", "deeplab-2obj-stacked",
         "maskrcnn-fused", "maskrcnn-host"])
def test_span_tree_of_a_sequence(build, objects, fused, counted_twins):
    ev, meta, index, windows = build(objects, fused)
    off = ev.eval_sequence(index, "seq00", meta, 7)
    assert tracing.collect() == []

    phases = []
    ev.on_phase = phases.append
    tracing.enable("cpu")
    before = _counts()
    on = ev.eval_sequence(index, "seq00", meta, 7)
    moved = {k: v - before[k] for k, v in _counts().items()
             if v != before[k]}
    recs = tracing.collect()

    for key in ("probs", "merged"):
        assert np.array_equal(_host(on[key]), _host(off[key]))
    assert on["J_mean"] == off["J_mean"]
    assert phases == ["fine_tune", "propagate", "score"]

    by_id = {r.id: r for r in recs}
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "sequence"
    children = {r.id: [] for r in recs}
    for r in recs:
        assert r.root == root.id
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.name in PARENTS[r.name], (r.name, p.name)
            assert p.host_start <= r.host_start <= r.host_end <= p.host_end
            children[p.id].append(r)
    totals = tracing.totals(recs)
    cfg = ev.cfg
    assert totals["inner_step"]["count"] == (
        cfg.num_epochs + (windows - 1) * cfg.online_adapt_epochs)
    assert totals["refit"]["count"] == windows - 1
    assert totals["segment"]["count"] == windows
    assert totals["fine_tune"]["count"] == totals["propagate"]["count"] == 1

    # launches: the root's are the counters' change, and a span's children
    # issue no more than it does
    assert moved and root.launches == moved
    for r in recs:
        for k, v in r.launches.items():
            assert sum(c.launches.get(k, 0) for c in children[r.id]) <= v
    assert sum(r.launches.get("group_stats", 0) for r in recs
               if r.name in ("forward", "segment")) == moved["group_stats"]


# -- cuDNN's timed engine picks ---------------------------------------------


def _bf16_deeplab(objects, fused, batch_objects=True):
    return _deeplab(objects, fused, torch.bfloat16, batch_objects)


def _model_of(ev):
    return getattr(ev, "model", None) or ev.model_apply.model


@pytest.fixture
def flag_reads(monkeypatch):
    """``reads(ev)`` installs readers of ``torch.backends.cudnn.benchmark``
    on ``ev``'s model and returns their list of ``(where, open spans,
    flag)``: a forward hook of every ``Conv`` (``conv``), a hook on each
    one's output that fires inside ``autograd.grad`` (``grad``), and every
    ``F.conv2d`` call, the model's and the dense scoring's (``conv2d``).
    The readers see the open spans, so tracing is on."""
    out = []
    conv2d = torch.nn.functional.conv2d

    def now(where):
        out.append((where, {o.rec.name for o in tracing.TRACER.open},
                    torch.backends.cudnn.benchmark))

    def read_conv2d(*args, **kwargs):
        now("conv2d")
        return conv2d(*args, **kwargs)

    def on_forward(mod, args, y):
        now("conv")
        if y.requires_grad:
            y.register_hook(lambda g: now("grad"))

    monkeypatch.setattr(torch.nn.functional, "conv2d", read_conv2d)

    def install(ev):
        for m in _model_of(ev).modules():
            if isinstance(m, Conv):
                m.register_forward_hook(on_forward)
        tracing.enable("cpu")
        return out

    return install


def _timed(where, spans):
    """Whether a read should find the flag on: in a fine-tune's forward."""
    return where != "grad" and "fine_tune" in spans


@pytest.mark.parametrize("build,objects,fused,batched,fine_tunes", [
    (_bf16_deeplab, 1, True, True, 1), (_bf16_deeplab, 1, False, True, 1),
    (_bf16_deeplab, 2, True, True, 1), (_bf16_deeplab, 2, True, False, 2)],
    ids=["fused", "host", "2obj-stacked", "2obj-in-turn"])
def test_bf16_fine_tune_times_conv_engines(build, objects, fused, batched,
                                           fine_tunes, flag_reads,
                                           monkeypatch):
    """A bf16 DeepLab's support fine-tune runs its forwards with cuDNN's
    benchmark flag on and its backward (``autograd.grad``) with the flag as
    it was (off), as do its refits, window inference and scoring. Each such
    fine-tune is counted once, on its ``fine_tune`` span, and the outputs
    are bit for bit those of the flag left alone."""
    ev, meta, index, _ = build(objects, fused, batched)
    torch.backends.cudnn.benchmark = False
    reads = flag_reads(ev)
    before = tracing.program_counts().get("timed_conv_fine_tunes", 0)
    got = ev.eval_sequence(index, "seq00", meta, 7)
    assert (tracing.program_counts()["timed_conv_fine_tunes"] - before
            == fine_tunes)
    recs = tracing.collect()
    fts = [r for r in recs if r.name == "fine_tune"]
    assert len(fts) == fine_tunes
    assert all(r.counts == {"timed_conv_fine_tunes": 1} for r in fts)
    assert not any("timed_conv_fine_tunes" in r.launches for r in recs)
    assert not any(r.counts for r in recs
                   if r.name in ("refit", "propagate", "segment", "score"))
    assert torch.backends.cudnn.benchmark is False

    assert all(flag == _timed(where, spans)
               for where, spans, flag in reads)
    seen = {(where, span) for where, spans, _ in reads for span in spans}
    for span in ("fine_tune", "refit"):
        assert {("conv", span), ("grad", span)} <= seen, span
    assert {("conv", "segment"), ("conv2d", "score")} <= seen

    monkeypatch.setattr(one_shot, "times_conv_engines", lambda *a: False)
    reads.clear()
    left = ev.eval_sequence(index, "seq00", meta, 7)
    assert reads and not any(flag for _, _, flag in reads)
    for key in ("probs", "merged"):
        assert np.array_equal(_host(got[key]), _host(left[key]))


@pytest.mark.parametrize("build,fused", [
    (_deeplab, True), (_deeplab, False), (_maskrcnn, True),
    (_maskrcnn, False)],
    ids=["deeplab-f32-fused", "deeplab-f32-host", "maskrcnn-fused",
         "maskrcnn-host"])
def test_float32_and_detection_keep_the_heuristic(build, fused, flag_reads):
    """A float32 DeepLab sequence and a Mask R-CNN sequence read cuDNN's
    benchmark flag off in every convolution, forward and backward, and
    count no timed fine-tune."""
    ev, meta, index, _ = build(1, fused)
    torch.backends.cudnn.benchmark = False
    reads = flag_reads(ev)
    before = tracing.program_counts()
    ev.eval_sequence(index, "seq00", meta, 7)
    assert tracing.program_counts() == before
    assert not any(flag for _, _, flag in reads)
    seen = {(where, span) for where, spans, _ in reads for span in spans}
    assert {("conv", "fine_tune"), ("grad", "fine_tune"),
            ("grad", "refit")} <= seen


@pytest.mark.parametrize("flag", [False, True])
def test_timed_conv_engines_restore_the_flag(flag, monkeypatch):
    """The benchmark flag reads as it was after a bf16 fine-tune and after
    an exception raised inside its learned-SGD loop, and on inside; the
    engine limit is PyTorch's, untouched."""
    cudnn = torch.backends.cudnn
    ev, meta, index, _ = _bf16_deeplab(1, True)
    limit = cudnn.benchmark_limit
    cudnn.benchmark = flag
    try:
        ev.eval_sequence(index, "seq00", meta, 7)
        assert (cudnn.benchmark, cudnn.benchmark_limit) == (flag, limit)

        inside = []

        def raising(params, batch):
            inside.append((cudnn.benchmark, cudnn.benchmark_limit))
            raise RuntimeError("planted")

        monkeypatch.setattr(one_shot, "make_support_loss_fn",
                            lambda *a: raising)
        with pytest.raises(RuntimeError, match="planted"):
            ev.eval_sequence(index, "seq00", meta, 7)
        assert inside == [(True, limit)]
        assert (cudnn.benchmark, cudnn.benchmark_limit) == (flag, limit)
    finally:
        cudnn.benchmark = False


@pytest.mark.parametrize("mode", ["cudnn", "torch"])
def test_deterministic_algorithms_keep_the_heuristic(mode, flag_reads):
    """Where the caller asked for deterministic algorithms (cuDNN's flag, or
    ``torch.use_deterministic_algorithms``) a bf16 fine-tune leaves the
    benchmark flag off and counts no timed fine-tune: timing could pick
    another engine, and another rounding, from run to run."""
    cudnn = torch.backends.cudnn
    ev, meta, index, _ = _bf16_deeplab(1, True)
    cudnn.benchmark = False
    prev = (cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    if mode == "cudnn":
        cudnn.deterministic = True
    else:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reads = flag_reads(ev)
        before = tracing.program_counts()
        ev.eval_sequence(index, "seq00", meta, 7)
        assert tracing.program_counts() == before
    finally:
        cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])
    assert not any(r.counts for r in tracing.collect())
    assert not any(flag for _, _, flag in reads)
    assert {("conv", "fine_tune"), ("grad", "fine_tune")} <= {
        (where, span) for where, spans, _ in reads for span in spans}


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card(cuda):
    tracing.enable("cuda")
    x = torch.ones(1024, device=cuda)
    with tracing.span("root"):
        y = x * 2
        with tracing.span("planted"):
            y.sum().item()
    planted, root = tracing.collect()
    assert (planted.syncs, root.syncs) == (1, 0)
    assert root.device_start <= planted.device_start
    assert planted.device_end <= root.device_end

    model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                          backbone_norm="frozen_bn", head_norm="group16",
                          output_stride=16, device=cuda)
    meta_cfg = MetaOptimConfig()
    ev = OneShotEvaluator(functional_apply(model), meta_cfg,
                          OneShotConfig(augment=AugmentConfig(**AUG_KW),
                                        **CFG_KW),
                          device=cuda, fused_ona=True)
    index = SyntheticVOSIndex(num_sequences=1, num_frames=6, size=(32, 48),
                              seed=2)
    meta = init_meta_params(meta_cfg, model)
    ev.eval_sequence(index, "seq00", meta, 7)  # builds the kernels
    tracing.collect()
    before = _counts()
    ev.eval_sequence(index, "seq00", meta, 7)
    recs = tracing.collect()
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.device_start <= r.device_start <= r.device_end \
                <= p.device_end, (r.name, p.name)
    (prop,) = [r for r in recs if r.name == "propagate"]
    inside = sum(r.device_s for r in recs if r.name in ("refit", "segment"))
    assert 0 < inside <= prop.device_s
    (root,) = [r for r in recs if r.parent is None]
    assert root.launches == {k: v - before[k] for k, v in _counts().items()
                             if v != before[k]}
    assert sum(r.syncs for r in recs) > 0
