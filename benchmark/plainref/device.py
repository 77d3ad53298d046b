"""Device resolution of the reference: the device asked for, the CPU by
default (the port's ``utils/device.py`` defaults to the card)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cpu" if device is None else device)
