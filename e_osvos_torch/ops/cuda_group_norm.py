"""Hand-written CUDA kernels of the GroupNorm passes, and their plain twins.

Four wrappers, each over tensors laid out as ``[N, M, C]`` (NHWC activations
flattened over space, the layout contract of
``e_osvos_tpu/ops/pallas_group_norm.py``), with G groups of C / G channels:

  * ``group_stats(x, scale, bias, G, eps)`` → ``(a, b, mean, rstd)``: the
    per-(n, c) sums Σx, Σx² of the Pallas ``_stats_kernel`` (K1) and the
    group algebra of ``_fwd`` on them; ``a = rstd·γ``, ``b = β − mean·a``
    ([N, C]), ``mean``/``rstd`` ([N, G], the backward's residuals). Two
    launches: partial sums, then a finalize.
  * ``group_grad_coeffs(dy, x, scale, mean, rstd, G)`` →
    ``(A, B, D, dgamma, dbeta)``: Σdy, Σdy·x from one read of (dy, x) (the
    Pallas ``_pair_sums_kernel``, K2) and the algebra of ``_bwd``, so that
    ``dx = dy·A + x·B + D``. Two launches, as above.
  * ``affine_apply(x, a, b)`` → ``x·a + b`` in x's dtype, a/b per (n, c).
  * ``affine_dx(dy, x, A, B, D)`` → ``dy·A + x·B + D`` in x's dtype.

A GroupNorm forward is ``group_stats`` then ``affine_apply`` (three
launches), a backward ``group_grad_coeffs`` then ``affine_dx`` (three). The
last two are the elementwise passes that XLA fused around the Pallas kernels
on the TPU. All are memory-bound; the source note in ``csrc/group_norm.cu``
gives the bound and what the design does about it. The launch geometry
(``sweep_tiling``, ``finalize_groups``) is computed here and passed to the
kernels, which check it before they launch.

A wrapper given CPU tensors computes its plain PyTorch twin (the CPU path and
the kernels' oracle). Given CUDA tensors it launches its kernels or raises.
Each wrapper counts the kernel launches it makes in ``<wrapper>.launches``
(``LAUNCHES_PER_CALL`` per call on the card), never for the plain twin.

The kernels are built at first use by ``ops/cuda_build.py`` and loaded
with ctypes; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from e_osvos_torch.ops import cuda_build

NAME = "group_norm"  # csrc/group_norm.cu

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None  # loaded at first launch

# Kernel launches per wrapper call on the card: the two statistics wrappers
# launch partial_sums_kernel, then group_finalize_kernel.
LAUNCHES_PER_CALL = {"group_stats": 2, "group_grad_coeffs": 2,
                     "affine_apply": 1, "affine_dx": 1}

THREADS = 256  # every kernel's block (csrc/group_norm.cu kThreads)
MAX_LANES = 256  # threads along C in one block (kMaxLanes)
# the sweep grid aims at one wave of this many blocks a SM (kMinBlocksPerSM)
BLOCKS_PER_SM = 4
UNROLL = 4  # chunk rows are whole multiples of this many thread steps
# Fewest rows a chunk of the partial-sums kernels: its partial sums (8 bytes
# a channel, written and read again) then cost at most 1/8 of the bf16 rows
# they sum. The elementwise passes have no partials and take any chunk.
MIN_CHUNK_ROWS = 64
FINALIZE_CHANNELS = 32  # channels a finalize block aims for (one warp's row)
MAX_FINALIZE_SMEM = 48 * 1024  # bytes (kMaxFinalizeSmem)
H100_SMS = 132


class SweepTiling(NamedTuple):
    """How the partial-sums and elementwise kernels cut ``[N, M, C]``: a
    block of ``THREADS`` threads owns (n, slice of ``lanes·vec`` channels,
    chunk of ``rows_per_chunk`` rows); grid ``(chunks, cslices, N)``."""
    vec: int  # channels a thread loads at once (16 bytes, or 1)
    lanes: int  # threads along C, a power of two
    cslices: int
    rows_per_chunk: int
    chunks: int


def sweep_tiling(n: int, m: int, c: int, itemsize: int, aligned: bool,
                 min_rows: int, sm_count: int = H100_SMS) -> SweepTiling:
    """16-byte vectors along C where C and the operands' alignment allow
    (else one element a thread), up to ``MAX_LANES`` threads along C, and
    row chunks sized so the grid is about ``BLOCKS_PER_SM`` blocks on every
    SM (never fewer than one chunk an image and slice, nor fewer than
    ``min_rows`` rows a chunk), in whole steps of ``UNROLL`` rows a
    thread."""
    wide = 16 // itemsize
    vec = wide if aligned and c % wide == 0 else 1
    nvec = c // vec
    lanes = min(1 << (nvec - 1).bit_length(), MAX_LANES)
    cslices = -(-nvec // lanes)
    step = (THREADS // lanes) * UNROLL
    chunks_wanted = max(1, BLOCKS_PER_SM * sm_count // (n * cslices))
    rows = max(-(-m // chunks_wanted), min_rows)
    rows = -(-rows // step) * step
    return SweepTiling(vec, lanes, cslices, rows, -(-m // rows))


def finalize_groups(c: int, g: int) -> int:
    """Groups a finalize block owns: whole groups of about
    ``FINALIZE_CHANNELS`` channels. Its shared memory, two floats a channel
    and four a group, must fit ``MAX_FINALIZE_SMEM``."""
    gs = c // g
    gpb = max(1, min(g, FINALIZE_CHANNELS // gs))
    if (2 * gpb * gs + 4 * gpb) * 4 > MAX_FINALIZE_SMEM:
        raise ValueError(f"{gs} channels a group exceed the finalize "
                         "kernel's shared memory")
    return gpb


class Geometry(NamedTuple):
    """The launch geometry of one wrapper call, passed to the kernels as the
    C struct ``Geometry`` of ``csrc/group_norm.cu`` (the same int fields in
    the same order)."""
    n: int
    m: int
    c: int
    g: int
    dtype: int
    vec: int
    lanes: int
    cslices: int
    rows_per_chunk: int
    chunks: int
    groups_per_block: int


@functools.lru_cache(maxsize=1024)
def _geometry(n: int, m: int, c: int, g: int, code: int, aligned: bool,
              min_rows: int, sm_count: int) -> Tuple[Geometry, ctypes.Array]:
    """The geometry and its C struct, built once per shape (the cache keeps
    the struct alive), so that a call converts one pointer instead of eleven
    ints. ``g = 0`` for the elementwise passes, which have no finalize."""
    t = sweep_tiling(n, m, c, 4 if code == 0 else 2, aligned, min_rows,
                     sm_count)
    geom = Geometry(n, m, c, g, code, *t, finalize_groups(c, g) if g else 0)
    return geom, (ctypes.c_int * len(geom))(*geom)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(g: int, min_rows: int, *tensors: torch.Tensor
          ) -> Tuple[Geometry, int]:
    """The geometry of a call on ``tensors`` and its C struct's address."""
    x = tensors[0]
    n, m, c = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    geom, struct = _geometry(n, m, c, g, _DTYPE_CODES[x.dtype], aligned,
                             min_rows, _sm_count(x.device.index or 0))
    return geom, ctypes.addressof(struct)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load(NAME)
    p = ctypes.c_void_p
    lib.gn_group_stats.argtypes = [p, p, p, p, p, ctypes.c_float, p]
    lib.gn_group_grad_coeffs.argtypes = [p] * 8
    lib.gn_affine.argtypes = [p] * 6
    lib.gn_affine_dx.argtypes = [p] * 8
    for fn in (lib.gn_group_stats, lib.gn_group_grad_coeffs, lib.gn_affine,
               lib.gn_affine_dx):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_nmc(*tensors: torch.Tensor) -> Tuple[int, int, int]:
    x = tensors[0]
    if x.dim() != 3:
        raise ValueError(f"expected [N, M, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    for t in tensors:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError("operands differ in shape or dtype")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous [N, M, C]")
    n, m, c = x.shape
    if n == 0 or m == 0 or c == 0:
        raise ValueError(f"empty operand of shape {tuple(x.shape)}")
    if m * c >= 2**31 or n > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernels' "
                         "index range")
    return n, m, c


def _check_f32(shape, device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 coefficients, got {t.dtype}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"coefficients must be contiguous f32 "
                             f"{list(shape)} on the operands' device")


def check_groups(c: int, g: int) -> None:
    if g < 1 or c % g:
        raise ValueError(f"channels {c} not divisible by groups {g}")


# ---- plain twins --------------------------------------------------------


def _group_stats(s: torch.Tensor, sq: torch.Tensor, g: int, m_per_group: int,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel sums [N, C] → per-group (mean, rstd) [N, G]."""
    n, c = s.shape
    gs = s.view(n, g, c // g).sum(-1)
    gsq = sq.view(n, g, c // g).sum(-1)
    mean = gs / m_per_group
    # clamp: E[x^2]-E[x]^2 can cancel slightly negative in f32
    var = (gsq / m_per_group - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def _expand(t: torch.Tensor, c: int) -> torch.Tensor:
    """[N, G] → [N, C] per-channel broadcast."""
    return t.repeat_interleave(c // t.shape[-1], dim=-1)


def _coefficients(mean, rstd, scale, bias, c):
    a = _expand(rstd, c) * scale.float()[None]
    b = bias.float()[None] - _expand(mean, c) * a
    return a.contiguous(), b.contiguous()


def group_stats_plain(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, num_groups: int, eps: float):
    n, m, c = x.shape
    xf = x.float()
    s, sq = xf.sum(1), (xf * xf).sum(1)
    mean, rstd = _group_stats(s, sq, num_groups, m * (c // num_groups), eps)
    a, b = _coefficients(mean, rstd, scale, bias, c)
    return a, b, mean, rstd


def group_grad_coeffs_plain(dy: torch.Tensor, x: torch.Tensor,
                            scale: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, num_groups: int):
    n, m, c = x.shape
    g = num_groups
    m_per_group = m * (c // g)
    dyf = dy.float()
    s1, s2 = dyf.sum(1), (dyf * x.float()).sum(1)  # Σdy, Σdy·x [N, C]
    mean_c = _expand(mean, c)
    rstd_c = _expand(rstd, c)
    gamma = scale.float()[None]
    sum_dy_xhat = rstd_c * (s2 - mean_c * s1)
    dgamma = sum_dy_xhat.sum(0).to(scale.dtype)
    dbeta = s1.sum(0).to(scale.dtype)
    c1 = (gamma * s1).view(n, g, c // g).sum(-1)  # Σ dy·γ per group
    c2 = (gamma * sum_dy_xhat).view(n, g, c // g).sum(-1)  # Σ dy·γ·x̂
    # dx = rstd·γ·dy − rstd/m·(c1 + x̂·c2) = A·dy + B·x + D
    A = (rstd_c * gamma).contiguous()
    B = _expand(-(rstd * rstd) * c2 / m_per_group, c).contiguous()
    D = _expand((rstd * rstd * c2 * mean - rstd * c1) / m_per_group,
                c).contiguous()
    return A, B, D, dgamma, dbeta


def affine_apply_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    return (x.float() * a[:, None] + b[:, None]).to(x.dtype)


def affine_dx_plain(dy, x, A, B, D) -> torch.Tensor:
    return (dy.float() * A[:, None] + x.float() * B[:, None]
            + D[:, None]).to(x.dtype)


# ---- wrappers -------------------------------------------------------------


def _views(ws: torch.Tensor, offset: int, *shapes):
    """Contiguous views of the workspace, one after another from
    ``offset``."""
    out = []
    for shape in shapes:
        out.append(ws.as_strided(shape, (shape[-1], 1)[2 - len(shape):],
                                 offset))
        offset += math.prod(shape)
    return tuple(out)


def group_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                num_groups: int, eps: float):
    """K1 and the forward algebra: [N, M, C] → (a, b) f32 [N, C] and
    (mean, rstd) f32 [N, G], one read of x. ``scale``/``bias``: f32 [C]."""
    check_groups(x.shape[-1], num_groups)
    if cuda_build.is_cpu(x, scale, bias):
        return group_stats_plain(x, scale, bias, num_groups, eps)
    n, m, c = _check_nmc(x)
    _check_f32((c,), x.device, scale, bias)
    geom, struct = _plan(num_groups, MIN_CHUNK_ROWS, x)
    g = num_groups
    # one workspace: partials [N, chunks, C, 2], a, b [N, C], mean, rstd [N, G]
    partial = n * geom.chunks * c * 2
    ws = torch.empty(partial + 2 * n * (c + g), dtype=torch.float32,
                     device=x.device)
    err = _load().gn_group_stats(x.data_ptr(), scale.data_ptr(),
                                 bias.data_ptr(), ws.data_ptr(), struct, eps,
                                 cuda_build.stream())
    cuda_build.raise_on(err, "group_stats")
    group_stats.launches += LAUNCHES_PER_CALL["group_stats"]
    return _views(ws, partial, (n, c), (n, c), (n, g), (n, g))


def group_grad_coeffs(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                      mean: torch.Tensor, rstd: torch.Tensor,
                      num_groups: int):
    """K2 and the backward algebra: (dy, x) [N, M, C] with the forward's
    (mean, rstd) [N, G] → (A, B, D) f32 [N, C] for ``dx = dy·A + x·B + D``
    and (dgamma, dbeta) f32 [C], one read of (dy, x)."""
    check_groups(x.shape[-1], num_groups)
    if cuda_build.is_cpu(dy, x, scale, mean, rstd):
        return group_grad_coeffs_plain(dy, x, scale, mean, rstd, num_groups)
    n, m, c = _check_nmc(dy, x)
    _check_f32((c,), x.device, scale)
    _check_f32((n, num_groups), x.device, mean, rstd)
    geom, struct = _plan(num_groups, MIN_CHUNK_ROWS, dy, x)
    # one workspace: partials, A, B, D [N, C], dgamma, dbeta [C]
    partial = n * geom.chunks * c * 2
    ws = torch.empty(partial + (3 * n + 2) * c, dtype=torch.float32,
                     device=x.device)
    err = _load().gn_group_grad_coeffs(
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), ws.data_ptr(), struct, cuda_build.stream())
    cuda_build.raise_on(err, "group_grad_coeffs")
    group_grad_coeffs.launches += LAUNCHES_PER_CALL["group_grad_coeffs"]
    return _views(ws, partial, (n, c), (n, c), (n, c), (c,), (c,))


def affine_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """``x·a + b`` over [N, M, C] with f32 a/b of shape [N, C]; x's dtype."""
    if cuda_build.is_cpu(x, a, b):
        return affine_apply_plain(x, a, b)
    n, m, c = _check_nmc(x)
    _check_f32((n, c), x.device, a, b)
    y = torch.empty_like(x)
    _, struct = _plan(0, 1, x, y)
    err = _load().gn_affine(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                            y.data_ptr(), struct, cuda_build.stream())
    cuda_build.raise_on(err, "affine_apply")
    affine_apply.launches += LAUNCHES_PER_CALL["affine_apply"]
    return y


def affine_dx(dy: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``dy·A + x·B + D`` over [N, M, C] with f32 A/B/D [N, C]; x's dtype."""
    if cuda_build.is_cpu(dy, x, A, B, D):
        return affine_dx_plain(dy, x, A, B, D)
    n, m, c = _check_nmc(dy, x)
    _check_f32((n, c), x.device, A, B, D)
    dx = torch.empty_like(x)
    _, struct = _plan(0, 1, dy, x, dx)
    err = _load().gn_affine_dx(
        dy.data_ptr(), x.data_ptr(), A.data_ptr(), B.data_ptr(), D.data_ptr(),
        dx.data_ptr(), struct, cuda_build.stream())
    cuda_build.raise_on(err, "affine_dx")
    affine_dx.launches += LAUNCHES_PER_CALL["affine_dx"]
    return dx


WRAPPERS = {
    "group_stats": group_stats,
    "group_grad_coeffs": group_grad_coeffs,
    "affine_apply": affine_apply,
    "affine_dx": affine_dx,
}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
