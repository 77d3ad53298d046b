"""The GroupNorm kernels and the greedy NMS kernel (K3) on the card against
their plain twins, a model with ``batch`` norms on the card against
the CPU, and the support fine-tune's timed cuDNN engines against the
heuristic's.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode) and run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

These tests import no JAX-side code, so they also run where only the port
is installed."""

import numpy as np
import pytest
import torch

from e_osvos_torch.ops import cuda_group_norm as kernels
from e_osvos_torch.ops import cuda_nms
from e_osvos_torch.ops.group_norm import FusedGroupNorm, group_norm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (N, M, C): ragged chunk tail, C not a multiple of 32, M = 1
SHAPES = [(2, 300, 64), (1, 257, 48), (3, 1, 256)]
# (N, M, C, G) of the statistics wrappers: SHAPES, then C = 36 (not a
# multiple of 8: the scalar variant in bf16) and C = 30 (scalar in f32 too)
STAT_SHAPES = [(2, 300, 64, 32), (1, 257, 48, 16), (3, 1, 256, 16),
               (2, 129, 36, 4), (1, 50, 30, 5)]


def _stat_inputs(shape, dtype, device, seed=0):
    n, m, c, _ = shape
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, m, c, generator=gen) * 2 + 0.5).to(device, dtype)
    dy = torch.randn(n, m, c, generator=gen).to(device, dtype)
    scale = (1.0 + 0.3 * torch.randn(c, generator=gen)).to(device)
    bias = (0.3 * torch.randn(c, generator=gen)).to(device)
    return x, dy, scale, bias


def _assert_close(got, want, tol):
    """Each output within ``tol`` of the largest magnitude of the twin's."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(1e-6, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAT_SHAPES)
def test_sums_match_twins(cuda, shape, dtype):
    """group_stats and group_grad_coeffs against their twins: statistics
    within 1e-5 (fp32 inputs) / 1e-4 (bf16) of the largest magnitude,
    backward coefficients and parameter gradients within 1e-4 / 1e-3 (sums
    of products over N*M rows, in another order); two launches each."""
    x, dy, scale, bias = _stat_inputs(shape, dtype, cuda)
    g = shape[3]
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    kernels.reset_launch_counts()
    got = kernels.group_stats(x, scale, bias, g, 1e-6)
    want = kernels.group_stats_plain(x, scale, bias, g, 1e-6)
    torch.cuda.synchronize()
    _assert_close(got, want, tol)
    mean, rstd = want[2], want[3]
    got = kernels.group_grad_coeffs(dy, x, scale, mean, rstd, g)
    want = kernels.group_grad_coeffs_plain(dy, x, scale, mean, rstd, g)
    torch.cuda.synchronize()
    _assert_close(got, want, 10 * tol)
    assert kernels.launch_counts()["group_stats"] == 2
    assert kernels.launch_counts()["group_grad_coeffs"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAT_SHAPES)
def test_elementwise_match_twins(cuda, shape, dtype):
    """The apply and dx passes against their twins: one rounding of the
    output dtype (fp32: 1e-5, bf16: 1e-2 of the largest magnitude)."""
    x, dy, scale, bias = _stat_inputs(shape, dtype, cuda, seed=1)
    a, b, mean, rstd = kernels.group_stats_plain(x, scale, bias, shape[3], 1e-6)
    A, B, D, _, _ = kernels.group_grad_coeffs_plain(dy, x, scale, mean, rstd,
                                                    shape[3])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _assert_close([kernels.affine_apply(x, a, b)],
                  [kernels.affine_apply_plain(x, a, b)], tol)
    _assert_close([kernels.affine_dx(dy, x, A, B, D)],
                  [kernels.affine_dx_plain(dy, x, A, B, D)], tol)


@pytest.mark.parametrize("shape", [(3, 25680, 256, 16), (3, 102480, 64, 32),
                                   (2, 129, 36, 4)])
def test_statistics_bit_identical_across_calls(cuda, shape):
    """The partial sums and their combine run in a fixed order (no
    atomics): two calls on the same input give the same bits."""
    x, dy, scale, bias = _stat_inputs(shape, torch.bfloat16, cuda, seed=2)
    g = shape[3]
    first = kernels.group_stats(x, scale, bias, g, 1e-6)
    again = kernels.group_stats(x, scale, bias, g, 1e-6)
    back = kernels.group_grad_coeffs(dy, x, scale, first[2], first[3], g)
    back2 = kernels.group_grad_coeffs(dy, x, scale, first[2], first[3], g)
    torch.cuda.synchronize()
    for a, b in zip(first + back, again + back2):
        assert torch.equal(a, b)


def test_misaligned_operands_take_the_scalar_variant(cuda):
    """A contiguous view that starts off a 16-byte boundary runs the VEC = 1
    kernels, with the same results as the twins."""
    n, m, c, g = 2, 77, 64, 16
    flat = torch.randn(n * m * c + 1, device=cuda)
    x = flat[1:].view(n, m, c)
    assert x.data_ptr() % 16 != 0
    scale = torch.ones(c, device=cuda)
    bias = torch.zeros(c, device=cuda)
    got = kernels.group_stats(x, scale, bias, g, 1e-6)
    want = kernels.group_stats_plain(x, scale, bias, g, 1e-6)
    _assert_close(got, want, 1e-5)
    _assert_close([kernels.affine_apply(x, got[0], got[1])],
                  [kernels.affine_apply_plain(x, want[0], want[1])], 1e-5)


def test_wrappers_capture_in_a_cuda_graph(cuda):
    """The wrappers launch on PyTorch's current stream and allocate with
    torch.empty, so a CUDA graph captures them (chip_smoke.py times them
    so)."""
    x, dy, scale, bias = _stat_inputs((2, 300, 64, 32), torch.bfloat16, cuda)
    want = kernels.group_stats(x, scale, bias, 32, 1e-6)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kernels.group_stats(x, scale, bias, 32, 1e-6)
        y = kernels.affine_apply(x, got[0], got[1])
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(y, kernels.affine_apply(x, want[0], want[1]))


@pytest.mark.parametrize("shape", SHAPES)
def test_module_forward_backward_fp32(cuda, shape):
    """FusedGroupNorm through the kernels == plain group_norm with autograd,
    fp32: values and gradients atol 1e-4; each wrapper called once."""
    n, m, c = shape
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, m, 1, c, generator=gen).to(cuda).permute(0, 3, 1, 2)
    w = torch.randn(n, m, 1, c, generator=gen).to(cuda).permute(0, 3, 1, 2)
    mod = FusedGroupNorm(c, 16).to(cuda)
    with torch.no_grad():
        mod.scale.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
        mod.bias.copy_(0.3 * torch.randn(c, generator=gen))
    kernels.reset_launch_counts()
    xk = x.clone().requires_grad_(True)
    yk = mod(xk)
    gk = torch.autograd.grad((yk * w).sum(), (xk, mod.scale, mod.bias))
    assert kernels.launch_counts() == kernels.LAUNCHES_PER_CALL
    xp = x.clone().requires_grad_(True)
    yp = group_norm(xp.movedim(1, -1), mod.scale, mod.bias, 16).movedim(-1, 1)
    gp = torch.autograd.grad((yp * w).sum(), (xp, mod.scale, mod.bias))
    torch.cuda.synchronize()
    np.testing.assert_allclose(yk.detach().cpu(), yp.detach().cpu(), atol=1e-4)
    for a, b in zip(gk, gp):
        np.testing.assert_allclose(a.cpu(), b.cpu(), atol=1e-4, rtol=1e-4)


def test_wrappers_reject_bad_operands(cuda):
    """A dtype, a shape or a device the kernels do not take raises."""
    x = torch.zeros(2, 8, 16, device=cuda, dtype=torch.float16)
    s = torch.ones(16, device=cuda)
    with pytest.raises(TypeError):
        kernels.group_stats(x, s, s, 4, 1e-6)
    y = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        kernels.group_stats(y, s, s, 4, 1e-6)  # not contiguous
    x = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError):
        kernels.group_stats(x.view(16, 16), s, s, 4, 1e-6)  # not [N, M, C]
    with pytest.raises(ValueError):
        kernels.group_stats(x, s.cpu(), s, 4, 1e-6)  # mixed devices
    with pytest.raises(TypeError):
        kernels.group_stats(x, s.double(), s, 4, 1e-6)
    mean = torch.zeros(2, 4, device=cuda)
    with pytest.raises(ValueError):
        kernels.group_grad_coeffs(x, x, s, mean[:, :2], mean, 4)
    with pytest.raises(ValueError):
        kernels.affine_apply(x, mean, mean)  # coefficients not [N, C]


def _batch_norm_model(device, dtype):
    """A resnet10 os16 DeepLabV3+ with ``batch`` norms in the backbone
    (statistics and affine drawn from a seed, far from the identity) and the
    GroupNorm-16 head, in ``dtype``, on ``device``."""
    from e_osvos_torch.models import BatchNorm, DeepLabV3Plus

    model = DeepLabV3Plus(num_classes=1, arch="resnet10",
                          backbone_norm="batch", head_norm="group16",
                          output_stride=16, dtype=dtype, seed=2,
                          device=device)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.mean.numel()
                m.mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.var.copy_(torch.empty(c).uniform_(0.5, 2.0, generator=gen))
                m.scale.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return model


def _logits_and_grads(device, dtype, x, w):
    """The ``batch``-backbone model's logits and the gradients of their
    weighted sum to every parameter and running statistic, on the host."""
    from e_osvos_torch.models import functional_apply

    model = _batch_norm_model(device, dtype)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.state_dict().items()}
    y = functional_apply(model)(params, x.to(device))
    grads = torch.autograd.grad((y * w.to(device)).sum(),
                                list(params.values()))
    return {"logits": y.detach().cpu(),
            **{k: g.detach().cpu() for k, g in zip(params, grads)}}


def _rel_errs(got, want):
    """Each tensor's largest |got − want| over its largest |want|."""
    return {k: float((got[k].double() - v.double()).abs().max())
            / max(float(v.abs().max()), 1e-6) for k, v in want.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_model_matches_cpu(cuda, dtype):
    """The ``batch``-backbone model on the card (the head's GroupNorms on
    the kernels) against the same model on the CPU (the twins), 2 images of
    32x48 of unit scale, its logits and the gradients of their weighted sum
    to every parameter and running statistic; each GroupNorm wrapper called
    once a norm a pass. float32: within 1e-4 of each tensor's largest
    magnitude. bfloat16, where the two devices' convolutions round
    differently: each tensor's error against the CPU's float32 result at
    most twice the CPU's own bfloat16 error plus 1e-3. (At 60 times that
    input scale the gradients' sums cancel, and the card's default
    nondeterministic backward reductions then land far from the CPU's
    result where its deterministic algorithms do not.)"""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 32, 48, 3, generator=gen)
    w = torch.randn(2, 32, 48, 1, generator=gen)
    kernels.reset_launch_counts()
    got = _logits_and_grads(cuda, dtype, x, w)
    n_gn = 9  # ASPP 6, low_norm, dec_norm1, dec_norm2
    assert kernels.launch_counts() == {k: n_gn * v for k, v in
                                       kernels.LAUNCHES_PER_CALL.items()}
    assert all(bool(torch.isfinite(t).all()) for t in got.values())
    f32 = _logits_and_grads("cpu", torch.float32, x, w)
    if dtype == torch.float32:
        errs = _rel_errs(got, f32)
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        assert worst[0][1] <= 1e-4, worst
    else:
        cpu = _rel_errs(_logits_and_grads("cpu", dtype, x, w), f32)
        card = _rel_errs(got, f32)
        over = {k: (card[k], cpu[k]) for k in f32
                if card[k] > 2 * cpu[k] + 1e-3}
        assert not over, sorted(over.items())[:5]


# the benchmark cells' frame: a 480x854 DeepLabV3+ ResNet-50 os16 support
# batch of 3
CELL_HW = (480, 854)


def _support_step(cuda, dtype, seed=0):
    """One learned-SGD step of ``fine_tune_on_support`` at batch 3 on a
    full-size frame, from the learned init of a seeded ResNet-50 DeepLabV3+
    (the benchmark cells' model) computing in ``dtype``: each learned
    parameter's step, on the host."""
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import OneShotConfig, one_shot
    from e_osvos_torch.meta_optim import MetaOptimConfig, init_meta_params
    from e_osvos_torch.models import DeepLabV3Plus, functional_apply

    model = DeepLabV3Plus(num_classes=1, arch="resnet50",
                          backbone_norm="frozen_bn", head_norm="group16",
                          output_stride=16, dtype=dtype, seed=0, device=cuda)
    meta_cfg = MetaOptimConfig(lr_hierarchy_level="neuron", init_lr=1e-3)
    meta = init_meta_params(meta_cfg, model)
    cfg = OneShotConfig(num_epochs=1, batch_size=3,
                        augment=AugmentConfig(compute_dtype="float32"))
    gen = torch.Generator().manual_seed(seed)
    h, w = CELL_HW
    img = (torch.rand(h, w, 3, generator=gen) * 255).to(cuda)
    label = torch.zeros(h, w, dtype=torch.int32)
    label[120:300, 200:520] = 1
    params, _ = one_shot.fine_tune_on_support(
        functional_apply(model), meta_cfg, cfg, meta, gen, img,
        label.to(cuda))
    return {k: (params[k].detach() - meta.model_init[k]).float().cpu()
            for k in meta.log_init_lr}


# cuDNN's heuristic engine for the ASPP's dilation-12 and -18 forward over
# layer4's bf16 map at batch 3 (cuDNN 9 on an H100)
DIRECT_KERNEL = "conv2d_grouped_direct_kernel"


def _profiled(fn):
    """``fn()`` and the names of the device kernels it ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}


def test_timed_conv_engines_match_the_heuristic(cuda, monkeypatch):
    """The bf16 support fine-tune's step with cuDNN's timed engine picks
    against the heuristic's. The mechanism: a timed step after the one
    that tuned runs no ``conv2d_grouped_direct_kernel``, where the
    heuristic's step runs it. The result: each parameter's step within
    twice the heuristic bf16 step's gap to the float32 step from the same
    parameters, plus 1e-3 (of the float32 step's largest magnitude). A
    float32 convolution of the Mask R-CNN stem's shape at the fine-tune's
    batch, which the bf16 stem's problem matches but for the dtype, gives
    the same bits after the timed fine-tunes as before them, with the flag
    back off.

    cuDNN keeps the engine chosen for a problem whatever the benchmark flag
    reads later, so the timed picks take effect only where the fine-tune is
    the first in the process to run its problems: here the timed steps run
    first, and the heuristic's step runs with the TF32 flag on, which is
    part of the problem's key and changes no bf16 arithmetic, so it neither
    reuses the timed picks nor leaves its own to them."""
    from e_osvos_torch.engine import one_shot
    from e_osvos_torch.utils import tracing

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, CELL_HW[0], CELL_HW[1], 3, generator=gen).to(cuda)
    x = x.permute(0, 3, 1, 2)  # NHWC in memory, as the port's convolutions
    stem_w = torch.randn(64, 3, 7, 7, generator=gen).to(cuda)

    def stem():
        return torch.nn.functional.conv2d(x, stem_w, None, 2, 3)

    before = stem()
    counts = tracing.program_counts().get("timed_conv_fine_tunes", 0)
    timed = _support_step(cuda, torch.bfloat16)
    _, tuned = _profiled(lambda: _support_step(cuda, torch.bfloat16))
    assert tracing.program_counts()["timed_conv_fine_tunes"] == counts + 2
    assert torch.backends.cudnn.benchmark is False
    assert torch.equal(stem(), before)

    monkeypatch.setattr(one_shot, "times_conv_engines", lambda *a: False)
    torch.backends.cudnn.allow_tf32 = True
    try:
        heuristic, picked = _profiled(
            lambda: _support_step(cuda, torch.bfloat16))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert any(DIRECT_KERNEL in k for k in picked), sorted(picked)
    assert tuned and not any(DIRECT_KERNEL in k for k in tuned)
    f32 = _support_step(cuda, torch.float32)
    over = {}
    for k, want in f32.items():
        scale = max(float(want.abs().max()), 1e-6)
        gap = float((timed[k] - heuristic[k]).abs().max()) / scale
        bf16 = float((heuristic[k] - want).abs().max()) / scale
        if gap > 2 * bf16 + 1e-3:
            over[k] = (gap, bf16)
    assert all(bool(torch.isfinite(t).all()) for t in timed.values())
    assert not over, sorted(over.items())[:5]


# (N, max_out, IoU threshold): the detection path's, a ragged N, several
# boxes a thread, the kernel's largest N
NMS_SHAPES = [(512, 1, 0.5), (777, 100, 0.5), (4336, 512, 0.7),
              (16384, 64, 0.5)]


def _nms_inputs(n, seed, ties=False):
    gen = torch.Generator().manual_seed(seed)
    xy = torch.rand(n, 2, generator=gen) * 400
    wh = torch.exp(torch.rand(n, 2, generator=gen) * 3.6 + 2.1)
    scores = torch.rand(n, generator=gen)
    if ties:
        scores = torch.floor(scores * 8) / 8
    valid = torch.rand(n, generator=gen) > 0.1
    return torch.cat([xy, xy + wh], 1), scores, valid


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,max_out,thr", NMS_SHAPES)
def test_nms_matches_twin(cuda, n, max_out, thr, ties):
    """K3's idx and keep identical to the twin's on the same card tensors,
    on the route ``nms_route`` picks; one call counted, on that route."""
    boxes, scores, valid = (t.to(cuda) for t in _nms_inputs(n, n, ties))
    cuda_nms.reset_launch_counts()
    idx, keep = cuda_nms.greedy_nms(boxes, scores, valid, thr, max_out)
    route = cuda_nms.nms_route(n, max_out)
    assert cuda_nms.launch_counts() == {
        "greedy_nms": 1, "greedy_nms_s": int(route == "s"),
        "greedy_nms_l": int(route == "l")}
    want_i, want_k = cuda_nms.greedy_nms_plain(boxes, scores, valid, thr,
                                               max_out)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_i) and torch.equal(keep, want_k)
    assert int(keep.sum()) > 0


def test_nms_batch_and_edge_inputs(cuda):
    """A batch of images (one block an image), an all-invalid image, -inf
    scores and max_out past the alive boxes, on both routes: -1 / False
    padding as the twin gives."""
    boxes, scores, valid = _nms_inputs(300, 1)
    scores[::5] = -torch.inf
    b = torch.stack([boxes, boxes + 3.0, boxes])
    s = torch.stack([scores, scores.flip(0), scores])
    v = torch.stack([valid, valid, torch.zeros_like(valid)])
    args = [t.to(cuda).contiguous() for t in (b, s, v)]
    want_i, want_k = cuda_nms.greedy_nms_plain(*args, 0.5, 400)
    for route in cuda_nms.ROUTES:
        idx, keep = cuda_nms.greedy_nms(*args, 0.5, 400, route=route)
        torch.cuda.synchronize()
        assert torch.equal(idx, want_i) and torch.equal(keep, want_k), route
        assert (idx[2] == -1).all() and not keep[2].any()


def _route_edges():
    """(N, max_out) on both sides of the route rule's crossover, at the
    detection path's N and the greedy RPN's."""
    out = []
    for n in (512, 4336):
        last_s = max(m for m in range(1, 513) if cuda_nms.nms_route(n, m) == "s")
        out += [(n, last_s), (n, last_s + 1)]
    return out


@pytest.mark.parametrize("route", ["s", "l"])
@pytest.mark.parametrize("n,max_out", [(512, 1), (512, 4), (777, 100),
                                       (2000, 300), (4336, 512), (16384, 64),
                                       (1, 3), (65, 70)])
def test_nms_routes_match_twin(cuda, n, max_out, route):
    """Each route, forced, at NMS_SHAPES' N and the edges (one box, one
    box past a chunk), with exact score ties: identical to the twin; one
    call counted, on that route."""
    boxes, scores, valid = (t.to(cuda) for t in _nms_inputs(n, n + 7, True))
    cuda_nms.reset_launch_counts()
    idx, keep = cuda_nms.greedy_nms(boxes, scores, valid, 0.5, max_out,
                                    route=route)
    assert cuda_nms.launch_counts() == {
        "greedy_nms": 1, "greedy_nms_s": int(route == "s"),
        "greedy_nms_l": int(route == "l")}
    want_i, want_k = cuda_nms.greedy_nms_plain(boxes, scores, valid, 0.5,
                                               max_out)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_i) and torch.equal(keep, want_k)


def test_nms_crossover_edges_match_twin(cuda):
    """Both routes on both sides of the crossover: identical to the twin,
    and the default call takes the route the rule names."""
    for n, max_out in _route_edges():
        boxes, scores, valid = (t.to(cuda) for t in _nms_inputs(n, max_out))
        want_i, want_k = cuda_nms.greedy_nms_plain(boxes, scores, valid, 0.6,
                                                   max_out)
        for route in (None, "s", "l"):
            cuda_nms.reset_launch_counts()
            idx, keep = cuda_nms.greedy_nms(boxes, scores, valid, 0.6,
                                            max_out, route=route)
            taken = route or cuda_nms.nms_route(n, max_out)
            assert cuda_nms.launch_counts()[f"greedy_nms_{taken}"] == 1
            torch.cuda.synchronize()
            assert torch.equal(idx, want_i) and torch.equal(keep, want_k)


def _edge_scores_and_boxes(kind, n, seed):
    boxes, scores, valid = _nms_inputs(n, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    pick = torch.randperm(n, generator=gen)
    if kind == "signed_zero":  # -0.0 ties +0.0: the lowest index wins
        scores = torch.where(torch.rand(n, generator=gen) < 0.5, 0.0, -0.0)
        scores[pick[:5]] = 0.5
    elif kind == "plus_inf":
        scores[pick[:20]] = torch.inf
        scores[pick[20:30]] = -torch.inf
    elif kind == "nan_boxes":
        boxes[pick[:25], torch.randint(0, 4, (25,), generator=gen)] = torch.nan
        boxes[pick[25]] = torch.nan
        scores[pick[25]] = 2.0
    return boxes, scores, valid


@pytest.mark.parametrize("route", ["s", "l"])
@pytest.mark.parametrize("kind", ["signed_zero", "plus_inf", "nan_boxes"])
@pytest.mark.parametrize("n,max_out", [(512, 8), (4336, 512)])
def test_nms_edge_values_match_twin(cuda, kind, n, max_out, route):
    """-0.0/+0.0 score ties, +inf and -inf scores, NaN coordinates: both
    routes identical to the twin."""
    args = [t.to(cuda) for t in _edge_scores_and_boxes(kind, n, n)]
    idx, keep = cuda_nms.greedy_nms(*args, 0.5, max_out, route=route)
    want_i, want_k = cuda_nms.greedy_nms_plain(*args, 0.5, max_out)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_i) and torch.equal(keep, want_k)
    if kind == "signed_zero":  # the ±0 picks come in index order
        picked = idx[keep].long()
        zero = picked[args[1][picked] == 0]
        assert len(zero) > 1 and (zero[1:] > zero[:-1]).all()


@pytest.mark.parametrize("route", ["s", "l"])
@pytest.mark.parametrize("thr", [0.5, 1 / 3, 2 / 3, 0.25])
def test_nms_iou_at_the_threshold_matches_twin(cuda, thr, route):
    """Boxes on an integer grid give many IoUs exactly at, or a few ulps
    from, the threshold (1/2, 1/3, 2/3, 1/4): both routes decide each as
    the twin does."""
    gen = torch.Generator().manual_seed(int(thr * 1000))
    n = 700
    xy = torch.randint(0, 12, (n, 2), generator=gen).float()
    wh = torch.randint(1, 7, (n, 2), generator=gen).float()
    boxes = torch.cat([xy, xy + wh], 1).to(cuda)
    scores = torch.rand(n, generator=gen).to(cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    idx, keep = cuda_nms.greedy_nms(boxes, scores, valid, thr, 300,
                                    route=route)
    want_i, want_k = cuda_nms.greedy_nms_plain(boxes, scores, valid, thr, 300)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_i) and torch.equal(keep, want_k)


def test_nms_rejects_bad_operands(cuda):
    boxes, scores, valid = (t.to(cuda) for t in _nms_inputs(64, 2))
    with pytest.raises(TypeError):
        cuda_nms.greedy_nms(boxes.double(), scores, valid, 0.5, 4)
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms(boxes.t(), scores, valid, 0.5, 4)
    big = [t.to(cuda) for t in _nms_inputs(16385, 3)]
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms(*big, 0.5, 4)
    flat = torch.zeros(64 * 4 + 1, device=cuda)
    with pytest.raises(ValueError):  # off the 16-byte boundary
        cuda_nms.greedy_nms(flat[1:].view(64, 4), scores, valid, 0.5, 4)
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms(boxes, scores, valid, 0.5, 4, route="x")
