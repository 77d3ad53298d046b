"""Small helpers shared by the port's entry points: device selection,
metrics logging and checkpoints."""

from e_osvos_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from e_osvos_torch.utils.device import resolve_device
from e_osvos_torch.utils.logging import MetricsLogger, Timer

__all__ = ["MetricsLogger", "Timer", "load_checkpoint", "resolve_device",
           "save_checkpoint"]
