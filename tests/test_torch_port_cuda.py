"""The GroupNorm kernels and the greedy NMS kernel (K3) on the card against
their plain twins.

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_sums_match_twins(cuda, shape, dtype):
    """f32 sums: relative 1e-5 (fp32 inputs) / 1e-4 (bf16 inputs) of the
    sum of magnitudes."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen).to(cuda, dtype)
    dy = torch.randn(shape, generator=gen).to(cuda, dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    xf, dyf = x.float(), dy.float()
    pairs = [(kernels.channel_sums(x), kernels.channel_sums_plain(x),
              (xf.abs().sum(1), (xf * xf).sum(1))),
             (kernels.pair_sums(dy, x), kernels.pair_sums_plain(dy, x),
              (dyf.abs().sum(1), (dyf * xf).abs().sum(1)))]
    for got, want, mags in pairs:
        for g, w, mag in zip(got, want, mags):
            assert ((g - w).abs() <= tol * mag + 1e-6).all()


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
    x = torch.zeros(2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kernels.channel_sums(x)
    y = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        kernels.channel_sums(y)


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
    """K3's idx and keep identical to the twin's on the same card tensors;
    one launch per call."""
    boxes, scores, valid = (t.to(cuda) for t in _nms_inputs(n, n, ties))
    cuda_nms.reset_launch_counts()
    idx, keep = cuda_nms.greedy_nms(boxes, scores, valid, thr, max_out)
    assert cuda_nms.launch_counts() == {"greedy_nms": 1}
    want_i, want_k = cuda_nms.greedy_nms_plain(boxes, scores, valid, thr,
                                               max_out)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_i) and torch.equal(keep, want_k)
    assert int(keep.sum()) > 0


def test_nms_batch_and_edge_inputs(cuda):
    """A batch of images (grid = B), an all-invalid image, -inf scores and
    max_out past the alive boxes: -1 / False padding as the twin gives."""
    boxes, scores, valid = _nms_inputs(300, 1)
    scores[::5] = -torch.inf
    b = torch.stack([boxes, boxes + 3.0, boxes])
    s = torch.stack([scores, scores.flip(0), scores])
    v = torch.stack([valid, valid, torch.zeros_like(valid)])
    args = [t.to(cuda).contiguous() for t in (b, s, v)]
    idx, keep = cuda_nms.greedy_nms(*args, 0.5, 400)
    want_i, want_k = cuda_nms.greedy_nms_plain(*args, 0.5, 400)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_i) and torch.equal(keep, want_k)
    assert (idx[2] == -1).all() and not keep[2].any()


def test_nms_rejects_bad_operands(cuda):
    boxes, scores, valid = (t.to(cuda) for t in _nms_inputs(64, 2))
    with pytest.raises(TypeError):
        cuda_nms.greedy_nms(boxes.double(), scores, valid, 0.5, 4)
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms(boxes.t(), scores, valid, 0.5, 4)
    big = [t.to(cuda) for t in _nms_inputs(16385, 3)]
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms(*big, 0.5, 4)
