"""Hand-written CUDA kernels of the GroupNorm passes, and their plain twins.

Four wrappers, each over tensors laid out as ``[N, M, C]`` (NHWC activations
flattened over space, the layout contract of
``e_osvos_tpu/ops/pallas_group_norm.py``):

  * ``channel_sums(x)`` → (Σx, Σx²) per (n, c), f32. Replaces the Pallas
    ``_stats_kernel`` (K1). Two launches: per-chunk partials, then a
    deterministic combine.
  * ``pair_sums(dy, x)`` → (Σdy, Σdy·x) per (n, c), f32, from one read of
    (dy, x). Replaces the Pallas ``_pair_sums_kernel`` (K2). Two launches,
    as above.
  * ``affine_apply(x, a, b)`` → ``x·a + b`` in x's dtype, a/b per (n, c).
  * ``affine_dx(dy, x, A, B, D)`` → ``dy·A + x·B + D`` in x's dtype.

The last two are the elementwise passes that XLA fused around the Pallas
kernels on the TPU; eager PyTorch would split each into several passes over
the activation. All four are memory-bound; the source note in
``csrc/group_norm.cu`` gives the bound and what the design does about it.

A wrapper given CPU tensors computes its plain PyTorch twin (the CPU path and
the kernels' oracle). Given CUDA tensors it launches its kernels or raises.
Each wrapper counts the kernel launches it makes in ``<wrapper>.launches``
(``LAUNCHES_PER_CALL`` per call on the card: two for the sums, one for the
elementwise passes), never for the plain twin.

The kernels are built at first use by ``ops/cuda_build.py`` and loaded
with ctypes; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from e_osvos_torch.ops import cuda_build

NAME = "group_norm"  # csrc/group_norm.cu

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None  # loaded at first launch

# Kernel launches per wrapper call on the card: the sums launch
# partial_sums_kernel, then combine_partials_kernel.
LAUNCHES_PER_CALL = {"channel_sums": 2, "pair_sums": 2, "affine_apply": 1,
                     "affine_dx": 1}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gn_rows_per_chunk.argtypes = []
    lib.gn_rows_per_chunk.restype = i
    lib.gn_channel_sums.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.gn_channel_sums.restype = i
    lib.gn_affine.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.gn_affine.restype = i
    lib.gn_affine_dx.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.gn_affine_dx.restype = i
    _lib = lib
    return lib


def _check_nmc(*tensors: torch.Tensor) -> Tuple[int, int, int, int]:
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
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernels' index range")
    return n, m, c, _DTYPE_CODES[x.dtype]


def _check_coeffs(n: int, c: int, device, *coeffs: torch.Tensor) -> None:
    for t in coeffs:
        if (t.shape != (n, c) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != device):
            raise ValueError("coefficients must be contiguous f32 [N, C] "
                             "on the operands' device")


# ---- plain twins --------------------------------------------------------


def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    return xf.sum(1), (xf * xf).sum(1)


def pair_sums_plain(dy: torch.Tensor, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    dyf = dy.float()
    return dyf.sum(1), (dyf * x.float()).sum(1)


def affine_apply_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    return (x.float() * a[:, None] + b[:, None]).to(x.dtype)


def affine_dx_plain(dy, x, A, B, D) -> torch.Tensor:
    return (dy.float() * A[:, None] + x.float() * B[:, None]
            + D[:, None]).to(x.dtype)


# ---- wrappers -------------------------------------------------------------


def _sums(name: str, a: torch.Tensor, b: Optional[torch.Tensor]):
    operands = (a,) if b is None else (a, b)
    n, m, c, code = _check_nmc(*operands)
    lib = _load()
    rows = lib.gn_rows_per_chunk()
    chunks = -(-m // rows)
    if chunks > 65535:
        raise ValueError(f"M={m} exceeds the kernels' chunk grid")
    partial = torch.empty((n, chunks, c, 2), dtype=torch.float32, device=a.device)
    out1 = torch.empty((n, c), dtype=torch.float32, device=a.device)
    out2 = torch.empty((n, c), dtype=torch.float32, device=a.device)
    err = lib.gn_channel_sums(
        a.data_ptr(), (a if b is None else b).data_ptr(), partial.data_ptr(),
        out1.data_ptr(), out2.data_ptr(), n, m, c, code, int(b is not None),
        cuda_build.stream(),
    )
    cuda_build.raise_on(err, name)
    return out1, out2


def channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: [N, M, C] → (Σx, Σx²) as f32 [N, C], one read of x."""
    if cuda_build.is_cpu(x):
        return channel_sums_plain(x)
    out = _sums("channel_sums", x, None)
    channel_sums.launches += LAUNCHES_PER_CALL["channel_sums"]
    return out


def pair_sums(dy: torch.Tensor, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: [N, M, C] ×2 → (Σdy, Σdy·x) as f32 [N, C], one read of (dy, x)."""
    if cuda_build.is_cpu(dy, x):
        return pair_sums_plain(dy, x)
    out = _sums("pair_sums", dy, x)
    pair_sums.launches += LAUNCHES_PER_CALL["pair_sums"]
    return out


def affine_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """``x·a + b`` over [N, M, C] with f32 a/b of shape [N, C]; x's dtype."""
    if cuda_build.is_cpu(x, a, b):
        return affine_apply_plain(x, a, b)
    n, m, c, code = _check_nmc(x)
    _check_coeffs(n, c, x.device, a, b)
    y = torch.empty_like(x)
    err = _load().gn_affine(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), n, m, c, code,
        cuda_build.stream(),
    )
    cuda_build.raise_on(err, "affine_apply")
    affine_apply.launches += LAUNCHES_PER_CALL["affine_apply"]
    return y


def affine_dx(dy: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``dy·A + x·B + D`` over [N, M, C] with f32 A/B/D [N, C]; x's dtype."""
    if cuda_build.is_cpu(dy, x, A, B, D):
        return affine_dx_plain(dy, x, A, B, D)
    n, m, c, code = _check_nmc(dy, x)
    _check_coeffs(n, c, x.device, A, B, D)
    dx = torch.empty_like(x)
    err = _load().gn_affine_dx(
        dy.data_ptr(), x.data_ptr(), A.data_ptr(), B.data_ptr(), D.data_ptr(),
        dx.data_ptr(), n, m, c, code, cuda_build.stream(),
    )
    cuda_build.raise_on(err, "affine_dx")
    affine_dx.launches += LAUNCHES_PER_CALL["affine_dx"]
    return dx


WRAPPERS = {
    "channel_sums": channel_sums,
    "pair_sums": pair_sums,
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
