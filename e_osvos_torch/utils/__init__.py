"""Small helpers shared by the port's entry points: device selection,
metrics logging, checkpoints, palette PNGs, overlays, benchmark
submissions and the fine-tune-steps sweep."""

from e_osvos_torch.utils.analysis import sweep_fine_tune_steps
from e_osvos_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from e_osvos_torch.utils.device import resolve_device
from e_osvos_torch.utils.logging import MetricsLogger, Timer
from e_osvos_torch.utils.png import (
    davis_palette,
    load_indexed_png,
    save_indexed_png,
)
from e_osvos_torch.utils.submission import (
    package_ytvos_submission,
    ytvos_frame_names,
)
from e_osvos_torch.utils.visualize import (
    draw_boxes,
    overlay_masks,
    save_debug_overlay,
)

__all__ = ["MetricsLogger", "Timer", "davis_palette", "draw_boxes",
           "load_checkpoint", "load_indexed_png", "overlay_masks",
           "package_ytvos_submission", "resolve_device", "save_checkpoint",
           "save_debug_overlay", "save_indexed_png", "sweep_fine_tune_steps",
           "ytvos_frame_names"]
