"""Small helpers shared by the port's entry points."""

from e_osvos_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
