"""Device selection and host-to-device upload for the port's entry
points."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Asking for ``cuda`` without a card raises; there is no
    quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def to_host(t: torch.Tensor):
    """``t`` queued for copy to pinned host memory behind the work that
    makes it: ``(host tensor, event to wait on or None)``. Waiting on the
    event waits for this copy, not for work issued after it."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a card it goes from pinned memory
    without blocking the host, so the upload overlaps queued work."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
