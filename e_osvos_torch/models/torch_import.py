"""Reference PyTorch checkpoints into the port's state dicts, port of
``e_osvos_tpu/models/torch_import.py``.

The reference seeds its models from torchvision-format state dicts
(ResNet, DeepLabV3/V3+, Mask R-CNN) and saves meta-training checkpoints
(``*.model``) whose learned init and per-neuron log lrs sit under mangled
names. This module maps those keys onto the port's names (the flax module
paths with dots, ``models/jax_weights.py``): an explicit name map a model
family, and the reference's shape-matched copy for anything else.

Layouts: the port keeps torch's (OIHW convolutions, ``[out, in]`` dense
weights), so most tensors copy as they are. Three do not:

  * ``box_head.fc6``: the port flattens a pooled RoI in (h, w, c) order, the
    reference in (c, h, w), so the weight's input axis is reordered;
  * ``mask_head.deconv``: torch's ``ConvTranspose2d`` stores
    ``[in, out, kh, kw]``, the port ``[out, in, kh, kw]`` (and hands the
    transpose back to torch), so the first two axes swap;
  * learning rates: a NEURON lr is one a dim-0 slice of the reference's
    weight, the port's neuron axis is dim 0 too, except for the deconv,
    whose reference dim 0 is the port's dim 1.

BatchNorm running statistics fold into the frozen-BN ``scale``/``bias``
buffers: ``scale = w / sqrt(var + eps)``, ``bias = b − mean·scale``, in
float32 numpy arithmetic, as the JAX importer computes them. A ``batch``
norm (``models.resnet.BatchNorm``) has ``mean``/``var`` buffers of its own:
there the statistics and the affine copy as they are, unfolded.

Inputs are flat dicts of tensors or arrays (a ``state_dict``); outputs are
new flat dicts of float32 CPU tensors keyed like the template.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

BN_EPS = 1e-5  # torch BatchNorm's default, which the reference trains with
# the pooled RoI of the box head (RoIConfig.box_roi_size's default)
BOX_POOLED_HW = (7, 7)

_NORM_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _norm_param(torch_name: str) -> Optional[str]:
    return _NORM_LEAVES.get(torch_name)


def _weight_or_bias(name: str) -> str:
    return "weight" if name == "weight" else "bias"


# ---- name maps: reference key → port key ----------------------------------


def resnet_name_map(torch_key: str) -> Optional[str]:
    """torchvision ResNet key → the port's trunk name (``models/resnet.py``),
    without the model's ``backbone.`` prefix. Norm entries end in
    ``scale``/``bias``/``mean``/``var`` (the last two fold away)."""
    k = torch_key
    for prefix in ("backbone.body.", "backbone."):
        if k.startswith(prefix):
            k = k[len(prefix):]
            break
    if k == "conv1.weight":
        return "stem_conv.weight"
    if k.startswith("bn1."):
        leaf = _norm_param(k.split(".")[-1])
        return f"stem_norm.{leaf}" if leaf else None
    m = re.match(r"layer(\d)\.(\d+)\.(.*)", k)
    if not m:
        return None
    base = f"layer{m.group(1)}_block{m.group(2)}"
    rest = m.group(3)
    cm = re.fullmatch(r"conv(\d)\.weight", rest)
    if cm:
        return f"{base}.conv{cm.group(1)}.weight"
    bm = re.fullmatch(r"bn(\d)\.(\w+)", rest)
    if bm:
        leaf = _norm_param(bm.group(2))
        return f"{base}.norm{bm.group(1)}.{leaf}" if leaf else None
    if rest == "downsample.0.weight":
        return f"{base}.down_conv.weight"
    dn = re.fullmatch(r"downsample\.1\.(\w+)", rest)
    if dn:
        leaf = _norm_param(dn.group(1))
        return f"{base}.down_norm.{leaf}" if leaf else None
    return None


def _norm_key(module: str, torch_name: str) -> Optional[str]:
    leaf = _norm_param(torch_name)
    return f"{module}.{leaf}" if leaf else None


def deeplab_name_map(torch_key: str, variant: str = "v3plus"
                     ) -> Optional[str]:
    """Reference DeepLabV3/V3+ key → the port's name: ``backbone.*`` (the
    torchvision trunk), ``classifier.0.*`` (ASPP: ``convs.0-3`` the 1x1 and
    dilated branches, ``convs.4`` the pooling branch, ``project``), V3+
    ``decoder.*`` (``conv1``/``bn1`` the low-level reduce, ``last_conv``
    0/1/4/5 the two 3x3 blocks and 8 the classifier) and plain V3's
    ``classifier.{1,2,4}``; ``aux_classifier.*`` is dropped."""
    k = torch_key
    if k.startswith("backbone."):
        mapped = resnet_name_map(k)
        return f"backbone.{mapped}" if mapped else None
    m = re.fullmatch(r"classifier\.0\.convs\.(\d)\.(\d)\.(\w+)", k)
    if m:
        branch, idx, pname = int(m.group(1)), int(m.group(2)), m.group(3)
        if branch <= 3:  # Sequential(conv, norm, relu)
            is_conv, mod = idx == 0, f"aspp.b{branch}"
        else:  # Sequential(pool, conv, norm, relu)
            is_conv, mod = idx == 1, "aspp.pool"
        return (f"{mod}_conv.weight" if is_conv
                else _norm_key(f"{mod}_norm", pname))
    m = re.fullmatch(r"classifier\.0\.project\.(\d)\.(\w+)", k)
    if m:
        if m.group(1) == "0":
            return "aspp.proj_conv.weight"
        return _norm_key("aspp.proj_norm", m.group(2))
    if variant == "v3plus":
        if k == "decoder.conv1.weight":
            return "low_conv.weight"
        m = re.fullmatch(r"decoder\.bn1\.(\w+)", k)
        if m:
            return _norm_key("low_norm", m.group(1))
        m = re.fullmatch(r"decoder\.last_conv\.(\d)\.(\w+)", k)
        if not m:
            return None
        idx, pname = int(m.group(1)), m.group(2)
        if idx == 8:  # the final 1x1 classifier (with a bias)
            return f"classifier.{_weight_or_bias(pname)}"
        mod = {0: "dec_conv1", 1: "dec_norm1", 4: "dec_conv2",
               5: "dec_norm2"}.get(idx)
        if mod is None:
            return None
        if "conv" in mod:
            return f"{mod}.weight" if pname == "weight" else None
        return _norm_key(mod, pname)
    if k == "classifier.1.weight":
        return "head_conv.weight"
    m = re.fullmatch(r"classifier\.2\.(\w+)", k)
    if m:
        return _norm_key("head_norm", m.group(1))
    m = re.fullmatch(r"classifier\.4\.(\w+)", k)
    if m:
        return f"classifier.{_weight_or_bias(m.group(1))}"
    return None


def maskrcnn_name_map(torch_key: str) -> Optional[str]:
    """torchvision MaskRCNN key → the port's name: the FPN trunk, the RPN
    head, box head and predictor, mask head and predictor. The reference's
    GroupNorm swap keeps BN's key names, so the map serves both."""
    k = torch_key
    if k.startswith("backbone.body."):
        mapped = resnet_name_map(k)
        return f"backbone.{mapped}" if mapped else None
    m = re.fullmatch(
        r"backbone\.fpn\.(inner|layer)_blocks\.(\d)(?:\.0)?\.(weight|bias)", k)
    if m:
        kind = "lateral" if m.group(1) == "inner" else "output"
        return f"fpn.{kind}{int(m.group(2)) + 2}.{m.group(3)}"
    m = re.fullmatch(
        r"rpn\.head\.(conv|cls_logits|bbox_pred)(?:\.0\.0)?\.(weight|bias)", k)
    if m:
        return f"rpn_head.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"roi_heads\.box_head\.fc([67])\.(weight|bias)", k)
    if m:
        return f"box_head.fc{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(
        r"roi_heads\.box_predictor\.(cls_score|bbox_pred)\.(weight|bias)", k)
    if m:
        return f"box_head.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(
        r"roi_heads\.mask_head\.mask_fcn(\d)(?:\.0)?\.(weight|bias)", k)
    if m:
        return f"mask_head.mask_fcn{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"roi_heads\.mask_predictor\.conv5_mask\.(weight|bias)",
                     k)
    if m:
        return f"mask_head.deconv.{m.group(1)}"
    m = re.fullmatch(
        r"roi_heads\.mask_predictor\.mask_fcn_logits\.(weight|bias)", k)
    if m:
        return f"mask_head.mask_logits.{m.group(1)}"
    return None


def detect_torch_architecture(torch_state_dict: Mapping[str, Any]) -> str:
    """The reference model family of a state dict, from its keys:
    'maskrcnn' | 'deeplab_v3plus' | 'deeplab_v3' | 'resnet' | 'unknown'."""
    keys = list(torch_state_dict)
    if any(k.startswith("roi_heads.") for k in keys):
        return "maskrcnn"
    if any(k.startswith("decoder.last_conv") for k in keys):
        return "deeplab_v3plus"
    if any(k.startswith("classifier.0.convs") for k in keys):
        return "deeplab_v3"
    if any(k.startswith(("layer1.", "conv1.", "backbone.")) for k in keys):
        return "resnet"
    return "unknown"


def name_map_for(architecture: str) -> Callable[[str], Optional[str]]:
    """The name map of a family ``detect_torch_architecture`` names."""
    if architecture == "maskrcnn":
        return maskrcnn_name_map
    if architecture == "deeplab_v3plus":
        return lambda k: deeplab_name_map(k, "v3plus")
    if architecture == "deeplab_v3":
        return lambda k: deeplab_name_map(k, "v3")
    if architecture == "resnet":
        return resnet_name_map
    raise ValueError(f"cannot name-map architecture {architecture!r}")


# ---- layouts ----------------------------------------------------------------


def _is_deconv(name: str) -> bool:
    return name.endswith("deconv.weight")


def fc6_to_port(w: np.ndarray, pooled_hw: Tuple[int, int] = BOX_POOLED_HW
                ) -> np.ndarray:
    """The box head's fc6 ``[out, C·h·w]`` with its input axis reordered
    from the reference's (c, h, w) flatten to the port's (h, w, c)."""
    out_dim, in_dim = w.shape
    h, wd = pooled_hw
    c = in_dim // (h * wd)
    if c * h * wd != in_dim:
        return w
    return w.reshape(out_dim, c, h, wd).transpose(0, 2, 3, 1).reshape(
        out_dim, in_dim)


def _weight_to_port(name: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4 and _is_deconv(name):
        return arr.transpose(1, 0, 2, 3)
    if arr.ndim == 2 and name.endswith("fc6.weight"):
        return fc6_to_port(arr)
    return arr


def _tensor_like(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)


def _copy(state: Mapping[str, torch.Tensor]) -> StateDict:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


# ---- loaders ----------------------------------------------------------------


def load_resnet_from_torch(state: Mapping[str, torch.Tensor],
                           torch_state_dict: Mapping[str, Any],
                           backbone_prefix: str = "backbone"
                           ) -> Tuple[StateDict, int]:
    """Copy a torchvision ResNet state dict into ``state`` (the trunk under
    ``backbone_prefix``, or at the top). Only entries whose mapped name
    exists and whose shape matches are copied; norms copy their
    ``weight``/``bias`` as they are (no folding). Returns (new state,
    copied count)."""
    out = _copy(state)
    copied = 0
    for tk, tv in torch_state_dict.items():
        mapped = resnet_name_map(tk)
        if mapped is None:
            continue
        arr = _to_numpy(tv)
        for cand in (f"{backbone_prefix}.{mapped}", mapped):
            if cand in out and tuple(out[cand].shape) == arr.shape:
                out[cand] = _tensor_like(arr, out[cand])
                copied += 1
                break
    return out, copied


def _collection_rank(name: str, buffers: set) -> int:
    """Where the flax collection of a port entry sorts: ``batch_stats``
    (a ``batch`` norm's ``mean``/``var`` buffers) 0, ``constants`` (the
    other buffers: frozen-BN ``scale``/``bias``) 1, ``params`` 2."""
    if name not in buffers:
        return 2
    return 0 if name.rpartition(".")[2] in ("mean", "var") else 1


def _jax_order(names: Iterable[str], buffers: Iterable[str]) -> list:
    """The order the JAX package's variables flatten in: by collection
    (``batch_stats``, ``constants``, ``params``), then sorted by name
    segment at every level."""
    buffers = set(buffers)
    return sorted(names, key=lambda k: (_collection_rank(k, buffers),
                                        k.split(".")))


def shape_matched_load(state: Mapping[str, torch.Tensor],
                       torch_state_dict: Mapping[str, Any],
                       buffers: Iterable[str] = ()
                       ) -> Tuple[StateDict, int]:
    """The reference's weight surgery generalized: each torch tensor, in its
    order, goes to the first unfilled entry of ``state`` with its shape.
    Entries are visited in the JAX package's order (``buffers`` names the
    model's buffers: ``batch`` norms' statistics and frozen constants,
    which it visits first, in that order), so both packages fill the same
    names. Returns (new state, copied count)."""
    out = _copy(state)
    order = _jax_order(out, buffers)
    used = set()
    copied = 0
    for tv in torch_state_dict.values():
        arr = _to_numpy(tv)
        for k in order:
            if k not in used and tuple(out[k].shape) == arr.shape:
                out[k] = _tensor_like(arr, out[k])
                used.add(k)
                copied += 1
                break
    return out, copied


def load_mapped_from_torch(state: Mapping[str, torch.Tensor],
                           torch_state_dict: Mapping[str, Any],
                           architecture: Optional[str] = None,
                           bn_eps: float = BN_EPS) -> Tuple[StateDict, int]:
    """Name-mapped import of a reference checkpoint into the port's
    ``state`` (a model's ``state_dict``, or its parameters alone).

    A tensor is copied where its mapped name exists and its (port-layout)
    shape matches, so COCO's 91-class heads are skipped for a 2-class
    model, as the reference skips them. A norm's running statistics fold
    into its ``scale``/``bias``, unless ``state`` has the norm's own
    ``mean``/``var`` (a ``batch`` norm): then all four copy as they are.
    Returns (new state, torch tensors consumed: one a weight, two a
    frozen norm, four a ``batch`` norm)."""
    if architecture is None:
        architecture = detect_torch_architecture(torch_state_dict)
    name_map = name_map_for(architecture)
    out = _copy(state)
    copied = 0
    norms: Dict[str, Dict[str, np.ndarray]] = {}
    for tk, tv in torch_state_dict.items():
        if tk.endswith("num_batches_tracked"):
            continue
        mapped = name_map(tk)
        if mapped is None:
            continue
        base, _, leaf = mapped.rpartition(".")
        arr = _to_numpy(tv)
        if "norm" in base.rsplit(".", 1)[-1] and leaf in (
                "scale", "bias", "mean", "var"):
            norms.setdefault(base, {})[leaf] = arr
            continue
        arr = _weight_to_port(mapped, arr)
        if mapped in out and tuple(out[mapped].shape) == arr.shape:
            out[mapped] = _tensor_like(arr, out[mapped])
            copied += 1

    for base, group in norms.items():
        sk, bk = f"{base}.scale", f"{base}.bias"
        w, b = group.get("scale"), group.get("bias")
        if sk not in out or bk not in out or w is None or b is None:
            continue
        if tuple(out[sk].shape) != w.shape:
            continue
        mean, var = group.get("mean"), group.get("var")
        stats = mean is not None and var is not None
        own_stats = f"{base}.mean" in out and f"{base}.var" in out
        if stats and not own_stats:
            s = w / np.sqrt(var + bn_eps)
            w, b = s, b - mean * s
        out[sk] = _tensor_like(w, out[sk])
        out[bk] = _tensor_like(b, out[bk])
        copied += 2
        if stats and own_stats:
            out[f"{base}.mean"] = _tensor_like(mean, out[f"{base}.mean"])
            out[f"{base}.var"] = _tensor_like(var, out[f"{base}.var"])
            copied += 2
    return out, copied


def _lr_to_port(arr: np.ndarray, name: str, param_shape: Tuple[int, ...]
                ) -> Optional[np.ndarray]:
    """A reference NEURON or PARAM lr in the port's lr layout for the
    parameter ``name`` of shape ``param_shape``; None where it cannot be
    read for that shape. PARAM lrs take the weight's own layout change; a
    NEURON lr ``(C, 1, ...)`` lies along the port's dim 0, except the
    deconv's, whose reference dim 0 is the port's dim 1."""
    if arr.ndim == len(param_shape) and arr.size == int(np.prod(param_shape)):
        return _weight_to_port(name, arr)
    flat = arr.reshape(-1)
    c = flat.shape[0]
    if len(param_shape) == 0:
        return flat.reshape(()) if c == 1 else None
    if _is_deconv(name) and len(param_shape) == 4 and c == param_shape[1]:
        return flat.reshape(1, c, 1, 1)
    if c == param_shape[0]:
        return flat.reshape((c,) + (1,) * (len(param_shape) - 1))
    return None


def import_meta_checkpoint_from_torch(meta_params, torch_ckpt: Mapping,
                                      architecture: Optional[str] = None):
    """A reference meta-training checkpoint (``*.model``: ``{
    meta_optim_state_dict, vis_win_names, meta_iter, meta_epoch}``) into
    the port's ``MetaParams``.

    The state dict holds the learned init as ``model_init_<name with . →
    ->`` and the per-neuron log lrs as ``log_init_lr_<...>``; both are
    de-mangled and name-mapped. Only trainable tensors are stored, so the
    frozen-BN buffers of the learned init keep the template's values (pair
    the file with its parent ``.pth``). A single shared ``log_init_lr``
    (SINGLE/TENSOR granularity) raises ``ValueError``. Returns
    ``(meta_params, init_copied, lr_copied)``."""
    sd = torch_ckpt.get("meta_optim_state_dict", torch_ckpt)
    init_sd: Dict[str, Any] = {}
    lr_sd: Dict[str, Any] = {}
    for k, v in sd.items():
        if k.startswith("model_init_"):
            init_sd[k[len("model_init_"):].replace("-", ".")] = v
        elif k.startswith("log_init_lr_"):
            lr_sd[k[len("log_init_lr_"):].replace("-", ".")] = v
        elif k == "log_init_lr":
            raise ValueError(
                "checkpoint uses SINGLE/TENSOR lr granularity (one shared "
                "'log_init_lr' tensor); only NEURON/PARAM per-parameter lrs "
                "are importable (the published configuration, "
                "cfgs/meta.yaml:37)")
    if architecture is None:
        architecture = detect_torch_architecture(init_sd or lr_sd)

    init_copied = 0
    model_init = meta_params.model_init
    if model_init is not None and init_sd:
        model_init, init_copied = load_mapped_from_torch(
            model_init, init_sd, architecture)

    name_map = (resnet_name_map if architecture in ("resnet", "unknown")
                else name_map_for(architecture))
    lrs = _copy(meta_params.log_init_lr)
    shapes = {k: tuple(v.shape) for k, v in
              (meta_params.model_init or {}).items()}
    lr_copied = 0
    for tk, tv in lr_sd.items():
        mapped = name_map(tk)
        if mapped is None or mapped not in lrs or mapped not in shapes:
            continue
        arr = _lr_to_port(_to_numpy(tv), mapped, shapes[mapped])
        if arr is None or arr.shape != tuple(lrs[mapped].shape):
            continue
        lrs[mapped] = _tensor_like(arr, lrs[mapped])
        lr_copied += 1
    return (meta_params._replace(model_init=model_init, log_init_lr=lrs),
            init_copied, lr_copied)


def load_torch_file(path: str) -> Dict[str, Any]:
    """Unpickle a ``.pth``/``.pt``/``.model`` file on the CPU. Reference
    ``.model`` meta checkpoints carry non-tensor metadata (window names,
    iteration counters), which ``weights_only`` loading rejects: such a
    file is read again without it. A ``{"state_dict": ...}`` wrapper is
    unwrapped."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


# ---- the reference's vocabulary, for writing reference-format files -------

_TRUNK_TO_REFERENCE = (
    (r"stem_conv\.weight", r"conv1.weight"),
    (r"stem_norm\.", r"bn1."),
    (r"layer(\d)_block(\d+)\.conv(\d)\.", r"layer\1.\2.conv\3."),
    (r"layer(\d)_block(\d+)\.norm(\d)\.", r"layer\1.\2.bn\3."),
    (r"layer(\d)_block(\d+)\.down_conv\.", r"layer\1.\2.downsample.0."),
    (r"layer(\d)_block(\d+)\.down_norm\.", r"layer\1.\2.downsample.1."),
)
_HEADS_TO_REFERENCE = {
    "deeplab_v3plus": (
        (r"aspp\.b(\d)_conv\.", r"classifier.0.convs.\1.0."),
        (r"aspp\.b(\d)_norm\.", r"classifier.0.convs.\1.1."),
        (r"aspp\.pool_conv\.", r"classifier.0.convs.4.1."),
        (r"aspp\.pool_norm\.", r"classifier.0.convs.4.2."),
        (r"aspp\.proj_conv\.", r"classifier.0.project.0."),
        (r"aspp\.proj_norm\.", r"classifier.0.project.1."),
        (r"low_conv\.", r"decoder.conv1."),
        (r"low_norm\.", r"decoder.bn1."),
        (r"dec_conv1\.", r"decoder.last_conv.0."),
        (r"dec_norm1\.", r"decoder.last_conv.1."),
        (r"dec_conv2\.", r"decoder.last_conv.4."),
        (r"dec_norm2\.", r"decoder.last_conv.5."),
        (r"classifier\.", r"decoder.last_conv.8."),
    ),
    "maskrcnn": (
        (r"fpn\.lateral(\d)\.", lambda m: f"backbone.fpn.inner_blocks."
                                          f"{int(m.group(1)) - 2}."),
        (r"fpn\.output(\d)\.", lambda m: f"backbone.fpn.layer_blocks."
                                         f"{int(m.group(1)) - 2}."),
        (r"rpn_head\.", r"rpn.head."),
        (r"box_head\.(fc[67])\.", r"roi_heads.box_head.\1."),
        (r"box_head\.", r"roi_heads.box_predictor."),
        (r"mask_head\.deconv\.", r"roi_heads.mask_predictor.conv5_mask."),
        (r"mask_head\.mask_logits\.",
         r"roi_heads.mask_predictor.mask_fcn_logits."),
        (r"mask_head\.", r"roi_heads.mask_head."),
    ),
}
_HEADS_TO_REFERENCE["deeplab_v3"] = _HEADS_TO_REFERENCE["deeplab_v3plus"][
    :6] + ((r"head_conv\.", r"classifier.1."),
           (r"head_norm\.", r"classifier.2."),
           (r"classifier\.", r"classifier.4."))


_LEAF_TO_REFERENCE = {"scale": "weight", "mean": "running_mean",
                      "var": "running_var"}


def reference_key(port_key: str, architecture: str) -> str:
    """The reference's key of a port name (the inverse of the family's name
    map, norms named ``weight``/``bias``/``running_mean``/``running_var``):
    what a reference-format file written from the port's weights holds."""
    def sub(rules, key):
        for pattern, repl in rules:
            new, n = re.subn("^" + pattern, repl, key, count=1)
            if n:
                return new
        raise KeyError(f"{port_key}: no reference name ({architecture})")

    leafless, _, leaf = port_key.rpartition(".")
    if leaf in _LEAF_TO_REFERENCE:
        port_key = f"{leafless}.{_LEAF_TO_REFERENCE[leaf]}"
    if architecture == "resnet":
        return sub(_TRUNK_TO_REFERENCE, port_key)
    if port_key.startswith("backbone."):
        trunk = sub(_TRUNK_TO_REFERENCE, port_key[len("backbone."):])
        return ("backbone.body." if architecture == "maskrcnn"
                else "backbone.") + trunk
    return sub(_HEADS_TO_REFERENCE[architecture], port_key)


def _weight_to_reference(name: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4 and _is_deconv(name):
        return arr.transpose(1, 0, 2, 3)
    if arr.ndim == 2 and name.endswith("fc6.weight"):
        out_dim, in_dim = arr.shape
        h, w = BOX_POOLED_HW
        return arr.reshape(out_dim, h, w, in_dim // (h * w)).transpose(
            0, 3, 1, 2).reshape(out_dim, in_dim)
    return arr


def reference_state_dict(state: Mapping[str, torch.Tensor],
                         architecture: str, buffers: Iterable[str] = (),
                         seed: int = 0) -> Dict[str, torch.Tensor]:
    """The port's ``state`` in the reference's vocabulary and layouts, as a
    reference parent ``.pth`` holds it. Each frozen-BN norm (its
    ``scale``/``bias`` named in ``buffers``) becomes a BatchNorm with running
    statistics drawn from ``seed`` (mean ~ N(0, 0.1²), var ~ U(0.5, 2)) and
    the affine that folds back to it; a ``batch`` norm (its ``mean``/``var``
    in ``buffers``) is written with its own statistics and affine. Each
    BatchNorm gets a ``num_batches_tracked``. ``load_mapped_from_torch`` of
    the result gives ``state`` back, to rounding for the folded norms and
    exactly for the ``batch`` ones."""
    buffers = set(buffers)
    rng = np.random.RandomState(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        arr = _to_numpy(value).astype(np.float32)
        ref = reference_key(name, architecture)
        base, _, leaf = name.rpartition(".")
        if name in buffers and leaf in ("mean", "var"):
            out[ref] = arr  # a ``batch`` norm's running statistics
            if leaf == "var":
                out[f"{ref.rpartition('.')[0]}.num_batches_tracked"] = (
                    np.array(0, np.int64))
            continue
        if name in buffers and leaf == "bias":
            continue  # written with its scale below
        if name in buffers and leaf == "scale":
            bias = _to_numpy(state[f"{base}.bias"]).astype(np.float32)
            mean = rng.normal(0.0, 0.1, arr.shape).astype(np.float32)
            var = rng.uniform(0.5, 2.0, arr.shape).astype(np.float32)
            ref_base = ref.rpartition(".")[0]
            out[f"{ref_base}.weight"] = arr * np.sqrt(var + np.float32(BN_EPS))
            out[f"{ref_base}.bias"] = bias + mean * arr
            out[f"{ref_base}.running_mean"] = mean
            out[f"{ref_base}.running_var"] = var
            out[f"{ref_base}.num_batches_tracked"] = np.array(0, np.int64)
            continue
        out[ref] = _weight_to_reference(name, arr)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def _lr_to_reference(arr: np.ndarray, name: str, param_shape) -> np.ndarray:
    if arr.ndim == len(param_shape) and arr.size == int(np.prod(param_shape)):
        return _weight_to_reference(name, arr)
    if arr.ndim == 4 and _is_deconv(name) and arr.shape[0] == 1:
        return arr.reshape(-1, 1, 1, 1)
    return arr


def reference_meta_checkpoint(meta_params, architecture: str
                              ) -> Dict[str, Any]:
    """The port's ``MetaParams`` as a reference ``.model`` file holds them:
    ``meta_optim_state_dict`` with the learned init's trainable tensors (the
    entries that have an lr) under ``model_init_<key with . → ->`` and the
    lrs under ``log_init_lr_<...>`` in the reference's layout, beside the
    run's metadata (window names, iteration counters)."""
    def tensor(arr):
        return torch.from_numpy(np.ascontiguousarray(arr))

    sd = {}
    init = meta_params.model_init or {}
    for name, lr in meta_params.log_init_lr.items():
        mangled = reference_key(name, architecture).replace(".", "-")
        if name in init:
            sd[f"model_init_{mangled}"] = tensor(
                _weight_to_reference(name, _to_numpy(init[name])))
        shape = tuple(init[name].shape) if name in init else tuple(lr.shape)
        sd[f"log_init_lr_{mangled}"] = tensor(
            _lr_to_reference(_to_numpy(lr), name, shape))
    return {"meta_optim_state_dict": sd,
            "vis_win_names": {"meta_loss": "meta loss"},
            "meta_iter": 0, "meta_epoch": 0}
