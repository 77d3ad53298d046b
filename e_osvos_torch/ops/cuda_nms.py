"""Hand-written CUDA kernels of padded greedy NMS (K3), and their plain twins.

``greedy_nms(boxes, scores, valid, iou_threshold, max_out)`` over boxes
``[N, 4]`` (or ``[B, N, 4]``) xyxy f32, scores ``[N]`` f32 and valid ``[N]``
bool returns ``(idx [max_out] int32, -1 padded; keep [max_out] bool)``: the
semantics of the Pallas ``_nms_kernel`` in ``e_osvos_tpu/ops/pallas_nms.py``.
Two routes, picked per call by ``nms_route(N, max_out)``:

  * ``"s"``, few picks: one launch, the ``max_out`` rounds inside one block
    an image;
  * ``"l"``, many picks: three launches over all SMs (rank by counting, an
    IoU bitmask of the score order, a chunked scan), with a workspace from
    ``torch.empty`` laid out by ``workspace_layout``.

The source note in ``csrc/nms.cu`` gives the kernels' bound and design.

Given CPU tensors the wrapper computes the plain twin ``greedy_nms_plain``
(max_out rounds of arg-max with lowest-index ties, one-vs-all IoU, suppress);
given CUDA tensors it launches the route's kernels or raises.
``greedy_nms.launches`` counts the wrapper calls on the card and
``greedy_nms.route_calls`` the calls of each route; the twin counts nothing.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from e_osvos_torch.ops import cuda_build

NAME = "nms"  # csrc/nms.cu
# the IoU must round as the twin's separate multiply and add do
NVCC_EXTRA = ("-fmad=false",)
ROUTES = ("s", "l")
TILE = 64  # route L: boxes a mask word, a tile, a scan chunk
ALIGN = 256  # bytes, each workspace piece

_lib: Optional[ctypes.CDLL] = None  # loaded at first launch


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load(NAME, NVCC_EXTRA)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nms_max_boxes.argtypes = []
        lib.nms_max_boxes.restype = i
        lib.nms_few.argtypes = [p, p, p, i, i, f, i, p, p, p]
        lib.nms_few.restype = i
        lib.nms_many.argtypes = [p, p, p, i, i, f, i, p, p, p, p, p, p, p]
        lib.nms_many.restype = i
        _lib = lib
    return _lib


def nms_route(n: int, max_out: int) -> str:
    """The route of one call: ``"s"`` while ``max_out <= max(8, N / 512)``,
    where ``max_out`` rounds in one block beat route L's three launches on
    an H100 (``scripts/torch_nms_routes.py``: route S was faster up to 8-16
    picks at N = 512..4336 and up to 32 at N = 16384), else ``"l"``. The
    detection head's calls, (512, 1), take route S; the exact greedy RPN's,
    (4336, 512), take route L."""
    return "s" if max_out <= max(8, n // 512) else "l"


def mask_grid(n: int) -> Tuple[int, int]:
    """(64-bit words a mask row, mask blocks an image) of route L at ``n``
    boxes: a row holds a bit for each box; a block covers one (row tile,
    column tile ≥ row tile) pair."""
    words = -(-n // TILE)
    return words, words * (words + 1) // 2


def workspace_layout(b: int, n: int) -> Tuple[Dict[str, int], int]:
    """Byte offsets of route L's workspace pieces in one buffer, and its
    size: ``sorted_box [b, n]`` float4, ``sorted_idx [b, n]`` int32,
    ``count [b]`` int32, ``mask [b, n, words]`` uint64."""
    words, _ = mask_grid(n)
    sizes = {"sorted_box": 16 * b * n, "sorted_idx": 4 * b * n,
             "count": 4 * b, "mask": 8 * b * n * words}
    offsets, at = {}, 0
    for name, size in sizes.items():
        offsets[name] = at
        at += -(-size // ALIGN) * ALIGN
    return offsets, at


def iou_one_vs_all(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one xyxy box ``[..., 4]`` against ``[..., N, 4]``, with the
    TPU kernel's guard: ``union > 0 ? inter / max(union, 1e-9) : 0``."""
    box = box[..., None, :]
    iw = (torch.minimum(box[..., 2], boxes[..., 2])
          - torch.maximum(box[..., 0], boxes[..., 0])).clamp_min(0.0)
    ih = (torch.minimum(box[..., 3], boxes[..., 3])
          - torch.maximum(box[..., 1], boxes[..., 1])).clamp_min(0.0)
    inter = iw * ih
    area_w = ((box[..., 2] - box[..., 0]).clamp_min(0.0)
              * (box[..., 3] - box[..., 1]).clamp_min(0.0))
    area = ((boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0))
    union = area + area_w - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), 0.0)


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float, max_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin, over ``[..., N]`` with no host sync."""
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    lane = torch.arange(n, device=scores.device)
    alive = valid.bool() & (scores > -torch.inf)
    idx = torch.full(lead + (max_out,), -1, dtype=torch.int32,
                     device=scores.device)
    keep = torch.zeros(lead + (max_out,), dtype=torch.bool,
                       device=scores.device)
    for r in range(max_out):
        masked = torch.where(alive, scores, -torch.inf)
        best_s = masked.amax(-1, keepdim=True)
        ok = best_s > -torch.inf
        best = torch.where(alive & (masked >= best_s), lane, n).amin(
            -1, keepdim=True)
        best_box = torch.gather(
            boxes, -2, best.clamp_max(n - 1)[..., None].expand(
                lead + (1, 4)))[..., 0, :]
        iou = iou_one_vs_all(best_box, boxes)
        alive = alive & (iou <= iou_threshold) & (lane != best) & ok
        idx[..., r] = torch.where(ok[..., 0], best[..., 0].int(), -1)
        keep[..., r] = ok[..., 0]
    return idx, keep


def _check(boxes, scores, valid, max_out: int) -> Tuple[int, int]:
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("boxes and scores must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    single = scores.dim() == 1
    b = 1 if single else scores.shape[0]
    n = scores.shape[-1]
    want = ((n, 4), (n,)) if single else ((b, n, 4), (b, n))
    if (tuple(boxes.shape), tuple(scores.shape)) != want or valid.shape != scores.shape:
        raise ValueError(f"expected boxes {want[0]}, scores/valid {want[1]}; "
                         f"got {tuple(boxes.shape)}, {tuple(scores.shape)}, "
                         f"{tuple(valid.shape)}")
    for t in (boxes, scores, valid):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if n < 1 or max_out < 1:
        raise ValueError(f"need at least one box and one output, got N={n}, "
                         f"max_out={max_out}")
    return b, n


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_out: int, route: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: padded greedy NMS of ``N ≤ 16384`` boxes (per image) →
    ``(idx [.., max_out] int32, keep [.., max_out] bool)``. ``route``
    forces ``"s"`` or ``"l"`` (the tests and the crossover sweep); by
    default ``nms_route(N, max_out)`` picks it."""
    if cuda_build.is_cpu(boxes, scores, valid):
        return greedy_nms_plain(boxes, scores, valid, iou_threshold, max_out)
    b, n = _check(boxes, scores, valid, max_out)
    route = route or nms_route(n, max_out)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    lib = _load()
    if n > lib.nms_max_boxes():
        raise ValueError(f"N={n} exceeds the kernel's {lib.nms_max_boxes()} "
                         "boxes an image")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must start on a 16-byte boundary (float4 "
                         "loads)")
    lead = scores.shape[:-1]
    dev = boxes.device
    idx = torch.empty(lead + (max_out,), dtype=torch.int32, device=dev)
    keep = torch.empty(lead + (max_out,), dtype=torch.bool, device=dev)
    args = (boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), b, n,
            float(iou_threshold), max_out, idx.data_ptr(), keep.data_ptr())
    if route == "s":
        err = lib.nms_few(*args, cuda_build.stream())
    else:
        offsets, size = workspace_layout(b, n)
        ws = torch.empty(size, dtype=torch.uint8, device=dev)
        base = ws.data_ptr()
        err = lib.nms_many(*args, *(base + offsets[k] for k in (
            "sorted_box", "sorted_idx", "count", "mask")), cuda_build.stream())
    cuda_build.raise_on(err, f"greedy_nms (route {route})")
    greedy_nms.launches += 1
    greedy_nms.route_calls[route] += 1
    return idx, keep


greedy_nms.launches = 0
greedy_nms.route_calls = dict.fromkeys(ROUTES, 0)


def reset_launch_counts() -> None:
    greedy_nms.launches = 0
    greedy_nms.route_calls = dict.fromkeys(ROUTES, 0)


def launch_counts() -> Dict[str, int]:
    return {"greedy_nms": greedy_nms.launches,
            **{f"greedy_nms_{r}": v for r, v in greedy_nms.route_calls.items()}}
