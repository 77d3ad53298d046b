"""What the command lines share: config → model, datasets, parent weights
and meta-parameters. Port of ``e_osvos_tpu/cli/common.py``.

Checkpoints: a parent is a flax msgpack file of the JAX package's
``variables`` or the port's own ``ParentTrainer`` checkpoint (a
``state_dict`` written by ``torch.save``; ``parent_model.checkpoint``,
``parent_model.<role>.paths``); meta-parameters come from a JAX meta checkpoint ``{"meta_params",
"opt_state"}`` (msgpack) or from the port's own ``MetaTrainer.save``
(``torch.save``). The reference's ``.pth``/``.pt`` parents and ``.model``
meta checkpoints go through ``models/torch_import.py``: a name-mapped import
when the key vocabulary names a reference model family (BatchNorm
statistics folded into a ``frozen_bn`` norm, copied as they are into a
``batch`` one), the reference's shape-matched copy otherwise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from e_osvos_torch import config as cfglib
from e_osvos_torch.data.datasets import (
    DAVISIndex,
    YouTubeVOSIndex,
    read_split_file,
)
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.voc import VOC2012Index
from e_osvos_torch.meta_optim import MetaParams, init_meta_params
from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig, build_model
from e_osvos_torch.models.jax_weights import (
    meta_params_from_flax,
    state_dict_from_jax,
)
from e_osvos_torch.models.torch_import import (
    detect_torch_architecture,
    import_meta_checkpoint_from_torch,
    load_mapped_from_torch,
    load_torch_file,
    shape_matched_load,
)
from e_osvos_torch.parallel import Mesh, make_mesh, multihost
from e_osvos_torch.utils import load_checkpoint, resolve_device
from e_osvos_torch.utils.checkpoint import (
    is_torch_checkpoint,
    load_flax_checkpoint,
)

TORCH_FILES = (".pth", ".pt", ".model")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def distributed_mesh(cfg: Dict) -> Optional[Mesh]:
    """Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment):
    join the process group (``gloo`` where the config's device is the CPU,
    else ``nccl``; unless the program has joined one already), before
    anything touches the card, and return the mesh with every rank on the
    task axis. Otherwise None: the command runs in one process."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    if not torch.distributed.is_initialized():
        cpu = torch.device(cfglib.device_of(cfg)).type == "cpu"
        multihost.initialize(backend="gloo" if cpu else None)
    return make_mesh()


def build_parent_model(cfg: Dict) -> nn.Module:
    """The model of the ``parent_model`` subtree, seeded with ``seed``, on
    the config's device. ``backbone_norm`` and ``decoder_norm_layer`` take
    any norm of ``models.make_norm`` (``batch``: running statistics and a
    learned affine). Under second-order meta-gradients the DeepLab
    family's GroupNorms take their plain (``_xla``) form: the kernels'
    backward supports one level of differentiation, and that family's
    second order differentiates through every norm. Mask R-CNN keeps the
    kernels: its second order is restricted to parameter subtrees
    (``meta_optim_cfg.second_order_subtrees``), and the kernels raise if
    one of them needs a norm's second derivative."""
    pm = cfg.get("parent_model", {})
    arch = pm.get("architecture", "DeepLabV3Plus")
    second_order = (arch != "MaskRCNN" and cfg.get("meta_optim_cfg", {}).get(
        "second_order_gradients"))

    def norm(key: str, default: str) -> str:
        name = str(pm.get(key, default))
        if second_order and name in ("group", "group16", "group4"):
            name += "_xla"
        return name

    kwargs: Dict[str, Any] = dict(
        arch=pm.get("encoder", "resnet50"),
        backbone_norm=norm("backbone_norm", "group"),
        dtype=DTYPES[pm.get("dtype", "bfloat16")],
        seed=int(cfg.get("seed", 1)),
        device=resolve_device(cfglib.device_of(cfg)))
    if arch in ("DeepLabV3", "DeepLabV3Plus"):
        return build_model(
            arch, head_norm=norm("decoder_norm_layer", "group16"),
            output_stride=int(pm.get("output_stride", 8)), num_classes=1,
            **kwargs)
    if arch != "MaskRCNN":
        raise ValueError(f"unknown architecture {arch!r}")
    roi_sizes = pm.get("roi_pool_output_sizes", {})
    roi_kwargs = dict(
        box_roi_size=int(roi_sizes.get("box", 7)),
        nms_thresh=float(pm.get("box_nms_thresh", 0.5)),
        mask_loss=str(pm.get("maskrcnn_loss", "LOVASZ")).lower(),
        detections_per_img=int(pm.get("detections_per_img", 1)))
    if roi_sizes.get("mask") is not None:
        roi_kwargs["mask_out_size"] = int(roi_sizes["mask"])
    # parent_model.{rpn,roi} override any RPNConfig / RoIConfig field
    overrides = []
    for fields, over in ((RPNConfig, pm.get("rpn")), (RoIConfig, pm.get("roi"))):
        over = dict(over or {})
        unknown = set(over) - {f.name for f in dataclasses.fields(fields)}
        if unknown:
            raise KeyError(f"unknown {fields.__name__} keys: {unknown}")
        overrides.append({k: tuple(v) if isinstance(v, list) else v
                          for k, v in over.items()})
    rpn_over, roi_over = overrides
    roi_kwargs.update(roi_over)
    return MaskRCNN(rpn=RPNConfig(**rpn_over), roi=RoIConfig(**roi_kwargs),
                    **kwargs)


def _parent_state(path: str, model: nn.Module) -> Dict[str, torch.Tensor]:
    """One parent checkpoint as the model's full ``state_dict`` (parameters
    and frozen-BN buffers) on the model's device."""
    if path.endswith(TORCH_FILES):
        return _reference_parent_state(path, model)
    if is_torch_checkpoint(path):  # cli.train_parent
        state = load_checkpoint(path)[0]
    else:
        state = state_dict_from_jax(load_flax_checkpoint(path))
    want = model.state_dict()
    if set(state) != set(want):
        raise ValueError(
            f"{path}: checkpoint and model differ in "
            f"{sorted(set(state) ^ set(want))[:8]}")
    return {k: v.to(want[k].device) for k, v in state.items()}


def _reference_parent_state(path: str, model: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """A reference ``.pth``/``.pt`` parent over the model's own state: the
    name-mapped import where the keys name a reference model family,
    the shape-matched copy otherwise; entries it does not fill keep the
    model's values."""
    sd = load_torch_file(path)
    template = model.state_dict()
    if detect_torch_architecture(sd) != "unknown":
        state, _ = load_mapped_from_torch(template, sd)
    else:
        state, _ = shape_matched_load(
            template, sd, buffers=[n for n, _ in model.named_buffers()])
    return {k: v.to(template[k].device) for k, v in state.items()}


def init_model_params(cfg: Dict, model: nn.Module) -> nn.Module:
    """The model's seeded init (``build_parent_model``), replaced by
    ``parent_model.checkpoint`` where one is named. Returns the model."""
    ckpt = cfg.get("parent_model", {}).get("checkpoint")
    if ckpt:
        model.load_state_dict(_parent_state(ckpt, model), strict=True)
    return model


def build_indexes(cfg: Dict, role: str = "train") -> List:
    """Dataset indexes of a config role (train/val/test), for one dataset or
    a list of them."""
    ds = cfg.get("datasets", {}).get(role)
    if ds is None:
        return []

    def as_list(v):
        return v if isinstance(v, list) else [v]

    data = cfg.get("data_cfg", {})
    mode = ("all" if data.get("multi_object", "single_id") in ("all", False)
            else "single_id")
    indexes = []
    for name, split, root in zip(as_list(ds["name"]), as_list(ds["split"]),
                                 as_list(ds["root"])):
        if name.startswith("DAVIS"):
            res = "Full-Resolution" if data.get("full_resolution") else "480p"
            indexes.append(DAVISIndex(root, split=split,
                                      year=name.split("-")[-1],
                                      resolution=res, multi_object=mode))
        elif name == "YouTube-VOS":
            indexes.append(YouTubeVOSIndex(root, split=split,
                                           multi_object=mode))
        elif name == "VOC2012":
            # parent pre-training (binary fg/bg); the VOC2012 named config
            # carries the reference's flip / scale-crop / blur stack
            indexes.append(VOC2012Index(
                root, split=split or "train",
                void=str(cfg.get("voc", {}).get("void", "background"))))
        elif name == "Synthetic":
            syn = cfg.get("synthetic", {})
            indexes.append(SyntheticVOSIndex(
                num_sequences=int(syn.get("num_sequences", 2)),
                num_frames=int(syn.get("num_frames", 4)),
                size=tuple(syn.get("size", (64, 64))),
                num_objects=int(syn.get("num_objects", 1)),
                multi_object=mode, seed=int(cfg.get("seed", 1))))
        else:
            raise ValueError(f"unknown dataset {name!r}")
    return indexes


class ParentStateSelector:
    """Leave-one-out parent selection: several parent checkpoints, each
    trained with a different val split held out; a sequence is evaluated
    from the state whose val split contains it, so the parent never trained
    on it."""

    def __init__(self, states, splits):
        if len(states) != len(splits):
            raise ValueError(
                f"{len(states)} parent states vs {len(splits)} val splits")
        self.states = list(states)
        self.splits = [list(s) for s in splits]

    def select(self, seq_name: str):
        """The state for ``seq_name``; a single state without a split is
        unconditional."""
        if len(self.states) == 1 and not self.splits[0]:
            return self.states[0]
        for state, split in zip(self.states, self.splits):
            if seq_name in split:
                return state
        raise KeyError(
            f"no parent model with {seq_name!r} in its val_split_file")


def build_parent_state_selector(cfg: Dict, role: str, model: nn.Module
                                ) -> Optional[ParentStateSelector]:
    """A ``ParentStateSelector`` over ``parent_model.<role>.paths`` and
    ``val_split_files``, None where no paths are configured."""
    pm = cfg.get("parent_model", {}).get(role, {}) or {}
    paths = pm.get("paths") or []
    if not paths:
        return None
    states = [_parent_state(p, model) for p in paths]
    splits = [read_split_file(p) for p in pm.get("val_split_files") or []]
    splits += [[]] * (len(states) - len(splits))
    return ParentStateSelector(states, splits)


def _read_meta_params(path: str, template: MetaParams) -> MetaParams:
    if path.endswith(TORCH_FILES):  # a reference meta checkpoint
        return import_meta_checkpoint_from_torch(
            template, load_torch_file(path))[0]
    if is_torch_checkpoint(path):  # MetaTrainer.save
        state, _ = load_checkpoint(path)
        return MetaParams(**state["meta_params"])
    return meta_params_from_flax(load_flax_checkpoint(path)["meta_params"])


def _check_keys(path: str, got: MetaParams, want: MetaParams) -> None:
    for field in MetaParams._fields:
        g, w = getattr(got, field), getattr(want, field)
        if (g is None) != (w is None) or (g is not None and set(g) != set(w)):
            raise ValueError(
                f"{path}: {field} does not match this model's meta-parameters")


def resolve_meta_params(cfg: Dict, model: nn.Module) -> MetaParams:
    """Fresh meta-parameters of ``model`` (its current weights as the
    learned init), or those of ``meta_optim_model_file`` / ``resume``. An
    explicitly named file must exist: a random init standing in for it
    would fake an evaluation; ``resume`` may not exist yet."""
    mp = init_meta_params(cfglib.to_meta_optim_config(cfg), model)
    explicit = cfg.get("meta_optim_model_file")
    if explicit and not os.path.exists(explicit):
        raise FileNotFoundError(f"meta_optim_model_file: {explicit!r}")
    path = explicit or cfg.get("resume")
    if not path or not os.path.exists(path):
        return mp
    loaded = _read_meta_params(path, mp)
    _check_keys(path, loaded, mp)
    device = next(model.parameters()).device
    return MetaParams(*(None if d is None else
                        {k: v.to(device) for k, v in d.items()}
                        for d in loaded))
