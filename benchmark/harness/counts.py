"""The yardstick's counts of a sequence's work, from the reference model
on meta tensors (no memory, no device): the convolution and matrix
FLOPs of each pass (``torch.utils.flop_counter.FlopCounterMode``,
backward included), and the bytes every GroupNorm must move: a forward
reads its input and writes its output (2 x the input's bytes), a
backward reads the input and the output's gradient and writes the
input's (3 x). The activation's bytes are at the configuration's model
dtype, the precision the program's GroupNorm kernels read. A sequence's
counts are the passes' counts times the passes the configuration fixes
(``family.flop_passes``), whatever implements them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

GN_FORWARD_BYTES = 2  # reads x, writes y
GN_BACKWARD_BYTES = 3  # reads x and dy, writes dx


def _meta_inputs(ref, batch: int, hw, train: bool):
    """Meta tensors for one pass of the reference's model apply: the
    normalized images and, for Mask R-CNN, what a training forward or a
    tracked frame takes besides."""
    h, w = hw
    imgs = torch.empty((batch, h, w, 3), device="meta")
    model = getattr(ref, "model", None)
    if model is None:  # DeepLab: the logits of the batch
        return (imgs,), {}
    if not train:
        k = model.roi.detections_per_img
        (js,) = model.draw_shapes(hw, batch, train=False)
        return (imgs,), dict(
            prev_boxes=torch.zeros((batch, k, 4), device="meta"),
            prev_valid=torch.ones((batch, k), dtype=torch.bool,
                                  device="meta"),
            proposal_aug_mode=ref.oscfg.proposal_aug_mode,
            draws=torch.empty(js, device="meta"))
    draws = ref.TrainDraws(*(torch.empty(s, device="meta") for s in
                             model.draw_shapes(hw, batch, num_objects=1)))
    gt = torch.zeros((batch, 1, h, w), device="meta")
    valid = torch.ones((batch, 1), dtype=torch.bool, device="meta")
    return (imgs, gt, valid), dict(train=True, draws=draws)


def pass_counts(family, cfg: dict, passes, hw, objects: int, theta_shapes,
                lr_names) -> Dict[Tuple[str, int], Tuple[float, float]]:
    """``{(kind, batch): (flops, groupnorm bytes)}`` of one pass of each
    ``(kind, batch, count)`` of ``passes``."""
    from torch.utils.flop_counter import FlopCounterMode

    from plainref.group_norm import FusedGroupNorm

    ref = family.Reference(cfg, objects, "meta", "reference")
    itemsize = torch.empty((), dtype=getattr(
        torch, cfg["model"]["dtype"])).element_size()
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0].numel()))
        for m in ref.module().modules() if isinstance(m, FusedGroupNorm)]
    out = {}
    try:
        for kind, batch, _ in passes:
            if (kind, batch) in out:
                continue
            seen.clear()
            train = kind == "train"
            theta = {k: torch.empty(s, device="meta",
                                    requires_grad=train and k in lr_names)
                     for k, s in theta_shapes.items()}
            args, kwargs = _meta_inputs(ref, batch, hw, train)
            with FlopCounterMode(display=False) as fc:
                if train:
                    res = ref.apply(theta, *args, **kwargs)
                    loss = res[0] if isinstance(res, tuple) else res
                    torch.autograd.grad(loss.float().sum(),
                                        [theta[k] for k in lr_names])
                else:
                    with torch.no_grad():
                        ref.apply(theta, *args, **kwargs)
            per = GN_FORWARD_BYTES + (GN_BACKWARD_BYTES if train else 0)
            out[(kind, batch)] = (float(fc.get_total_flops()),
                                  float(sum(seen) * itemsize * per))
    finally:
        for h in hooks:
            h.remove()
    return out


def sequence_counts(family, cfg: dict, frames: int, hw, objects: int,
                    theta_shapes, lr_names) -> Dict[str, float]:
    """FLOPs and GroupNorm bytes of one sequence of ``frames`` frames."""
    passes = family.flop_passes(cfg, frames, objects)
    per = pass_counts(family, cfg, passes, hw, objects, theta_shapes,
                      lr_names)
    flops = gn = 0.0
    for kind, batch, count in passes:
        f, b = per[(kind, batch)]
        flops += count * f
        gn += count * b
    return {"flops": flops, "gn_bytes": gn}
