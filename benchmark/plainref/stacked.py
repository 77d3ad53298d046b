"""Objects as a batch axis: several objects' copies of a model folded into
its channel axis, the port's counterpart of the JAX package's ``vmap`` over
object groups (``e_osvos_tpu/engine/one_shot.py`` and
``one_shot_detection.py``, ``batch_objects``).

An object-stacked DeepLab or Mask R-CNN holds O objects' weights in one
model:

  * every convolution has O times its output channels, the objects' weights
    concatenated along dim 0, and runs with ``groups=O``; the stem reads the
    shared frames as one ordinary convolution with the concatenated
    ``[O·64, 3, 7, 7]`` weight, or each object's own images
    (``[B, O·3, H, W]``) grouped;
  * every GroupNorm has O·G groups over O·C channels (the K1/K2 kernels
    take any C), every frozen-BN affine its buffers repeated O times, every
    ``batch`` norm its affine and running statistics repeated O times
    (the stem's norm reads O·64 channels whether the stem convolution
    read shared frames or each object's own images);
  * DeepLab: the two channel concatenations (ASPP's branches, the
    decoder's ASPP and low-level features) are ordered object by object
    (``deeplab.cat_channels``), so each group reads its own object's
    features; the classifier gives one logit plane an object: ``[B, H, W,
    O]``;
  * Mask R-CNN: the backbone, FPN and RPN head run folded; at the RPN the
    objects unfold into O·B images (``rpn.unfold_objects``: image o·B + b),
    over which proposals, targets, RoI pooling, NMS and pasting run
    unchanged; the box head's dense layers are one batched matrix product
    over objects (``Dense.objects``), the mask head's convolutions and
    deconvolution grouped. Every per-object argument and result carries a
    leading O (``mask_rcnn.MaskRCNN``).

The objects never mix: object o's block of every tensor depends on object
o's block of the weights alone, so a gradient of the sum of the objects'
losses is each object's own gradient, and the learned optimizer's update
``p ← p − lr·g`` (lrs repeated along dim 0, the neuron axis) is the objects'
updates side by side. ``torch.func.vmap`` cannot pass through the kernels'
ctypes calls; grouped convolutions, wider norms and batched products do the
same work.

Entries are stacked along dim 0 (``stack_objects``); any model apply that
is not a DeepLab's or a Mask R-CNN's runs its objects in turn over the
stacked entries (``object_stacked_apply``), with the same interface.
"""

from __future__ import annotations

import copy
import weakref
from typing import Callable, Dict, List, Mapping, Sequence

import torch
from torch import nn

from plainref.deeplab import _SegmentationModel
from plainref.mask_rcnn import MaskRCNN
from plainref.resnet import (
    BatchNorm, Conv, ConvTranspose, Dense, FrozenScaleBias,
)
from plainref.group_norm import FusedGroupNorm

Params = Dict[str, torch.Tensor]
STACKABLE = (_SegmentationModel, MaskRCNN)


def stack_objects(per_object: Sequence[Mapping[str, torch.Tensor]]
                  ) -> Params:
    """O objects' entries, each concatenated along dim 0 (``[p] * O``
    repeats one object's). A 0-dim entry has no object axis and must be the
    same for every object."""
    out = {}
    for k, v in per_object[0].items():
        vs = [p[k] for p in per_object]
        if v.dim() == 0:
            if any(not torch.equal(x, v) for x in vs[1:]):
                raise ValueError(f"{k}: a scalar cannot differ by object")
            out[k] = v
        else:
            out[k] = torch.cat(vs, 0)
    return out


def stack_lrs(lrs: Mapping[str, torch.Tensor], objects: int) -> Params:
    """Learning rates shared by ``objects`` objects: an lr that broadcasts
    along dim 0 (0-dim, or of size 1 there) stays as it is, the rest repeat
    along dim 0 like their parameters."""
    return {k: v if v.dim() == 0 or v.shape[0] == 1
            else torch.cat([v] * objects) for k, v in lrs.items()}


def unstack_objects(params: Mapping[str, torch.Tensor], objects: int
                    ) -> List[Params]:
    """The per-object entries of stacked ``params``: views of dim-0 slices
    (0-dim entries shared)."""
    out: List[Params] = [{} for _ in range(objects)]
    for k, v in params.items():
        parts = [v] * objects if v.dim() == 0 else v.chunk(objects, 0)
        if v.dim() and v.shape[0] % objects:
            raise ValueError(f"{k}: dim 0 of {tuple(v.shape)} does not "
                             f"split into {objects} objects")
        for o, part in enumerate(parts):
            out[o][k] = part
    return out


def stack_model(model: nn.Module, objects: int) -> nn.Module:
    """An object-stacked copy of a DeepLab or a Mask R-CNN: ``objects``
    copies of its weights and buffers side by side, grouped convolutions,
    wider norms, object-ordered concatenations, batched dense layers."""
    if not isinstance(model, STACKABLE):
        raise TypeError(f"cannot stack a {type(model).__name__}")
    stacked = copy.deepcopy(model)
    with torch.no_grad():
        for mod in stacked.modules():
            if isinstance(mod, (Conv, ConvTranspose)):
                mod.groups = objects
            elif isinstance(mod, FusedGroupNorm):
                mod.num_groups *= objects
            elif not isinstance(mod, (FrozenScaleBias, BatchNorm, Dense)) \
                    and any(True for _ in mod.parameters(recurse=False)):
                raise TypeError(f"cannot stack a {type(mod).__name__}")
            if hasattr(mod, "objects"):
                mod.objects = objects
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(torch.cat([p] * objects)))
            for name, b in list(mod.named_buffers(recurse=False)):
                setattr(mod, name, torch.cat([b] * objects))
    return stacked


class _StackedModel:
    """The object-stacked form of a DeepLab or a Mask R-CNN. Entries a
    call's ``params`` lacks (the frozen-BN buffers of a learned init
    without them) come from the template model as it is at the call,
    stacked."""

    def __init__(self, model: nn.Module, objects: int):
        self._template = weakref.ref(model)
        self.objects = objects
        self.model = stack_model(model, objects)
        self._names = frozenset(model.state_dict())

    def __call__(self, params, imgs: torch.Tensor, *args, **kwargs):
        missing = self._names - params.keys()
        if missing:
            state = self._template().state_dict()
            params = {**stack_objects([{k: state[k] for k in missing}]
                                      * self.objects), **params}
        if imgs.dim() == 5:  # [O, B, H, W, 3]: each object's own images
            o, b, h, w, c = imgs.shape
            imgs = imgs.permute(1, 2, 3, 0, 4).reshape(b, h, w, o * c)
        return torch.func.functional_call(self.model, params,
                                          (imgs,) + args, kwargs)


_STACKED: "weakref.WeakKeyDictionary[nn.Module, Dict[int, _StackedModel]]" \
    = weakref.WeakKeyDictionary()


def object_stacked_apply(model_apply: Callable, objects: int) -> Callable:
    """``apply(params, imgs, ...)`` of ``objects`` objects at once over
    stacked ``params`` (``stack_objects``): ``imgs`` is ``[B, H, W, 3]``
    shared by the objects or ``[O, B, H, W, 3]``, one batch an object. A
    one-class segmentation model gives the logits ``[B, H, W, O]``, object
    o's in plane o; a Mask R-CNN takes and gives every per-object argument
    and result with a leading O (``mask_rcnn.MaskRCNN``).

    The ``functional_apply`` of a DeepLab or a Mask R-CNN gets its
    object-stacked model (built once per model and object count); any
    other apply runs the objects in turn on their views of ``params``."""
    model = getattr(model_apply, "model", None)
    if isinstance(model, STACKABLE):
        per_count = _STACKED.setdefault(model, {})
        if objects not in per_count:
            per_count[objects] = _StackedModel(model, objects)
        return per_count[objects]

    def apply(params, imgs: torch.Tensor) -> torch.Tensor:
        outs = [model_apply(p, imgs[o] if imgs.dim() == 5 else imgs)
                for o, p in enumerate(unstack_objects(params, objects))]
        return torch.cat(outs, -1)

    return apply
