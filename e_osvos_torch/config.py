"""Layered configuration, port of ``e_osvos_tpu/config.py``: the repo's
``configs/meta.yaml``, then named configs from ``configs/named/`` in order,
then dotted ``key=value`` overrides, as in

    python -m e_osvos_torch.cli.evaluate with DAVIS-2017 e-OSVOS-OnA \\
        num_epochs.eval=50 meta_optim_model_file=models/best.ckpt

The tree is plain dicts. The ``to_*_config`` views build the port's typed
configs from it, key for key as the JAX package builds its own. A key the
port cannot honour yet raises when it is set away from its default; none is
dropped silently.

One key is the port's own: ``device`` (default ``cuda``), where the entry
points run. ``device=cpu`` runs them on the CPU; without a card and without
it they raise.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Sequence

import yaml

from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine.meta_trainer import MetaTrainConfig
from e_osvos_torch.engine.one_shot import OneShotConfig
from e_osvos_torch.meta_optim import MetaOptimConfig
from e_osvos_torch.meta_optim.tasksets import MetaTasksetConfig
from e_osvos_torch.parallel import MetaStepConfig, OuterOptimConfig

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; override wins, subtrees merge."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_dotted(cfg: Dict, path: str, value: Any) -> None:
    """Set ``a.b.c = value`` in a nested dict, creating subtrees."""
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise TypeError(f"{path}: {k} is not a subtree")
    node[keys[-1]] = value


def parse_value(text: str) -> Any:
    """YAML-literal parse of a command-line value ('True' → bool, '1e-3' →
    float …). PyYAML follows YAML 1.1 and reads a bare '1e-3' as a string,
    so numbers are tried first."""
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return yaml.safe_load(text)


def load_yaml(path: str) -> Dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(named: Sequence[str] = (),
                overrides: Optional[Dict[str, Any]] = None,
                config_dir: Optional[str] = None,
                base: str = "meta.yaml") -> Dict:
    """base → named configs (in order) → dotted overrides."""
    cdir = config_dir or CONFIG_DIR
    cfg = load_yaml(os.path.join(cdir, base))
    for name in named:
        path = os.path.join(cdir, "named", f"{name}.yaml")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"unknown named config {name!r} (no {path})")
        cfg = deep_merge(cfg, load_yaml(path))
    for path, value in (overrides or {}).items():
        set_dotted(cfg, path, value)
    return cfg


def parse_cli(argv: Sequence[str], config_dir: Optional[str] = None) -> Dict:
    """``[with] <named>... key=value...``."""
    named: List[str] = []
    overrides: Dict[str, Any] = {}
    for arg in argv:
        if arg == "with":
            continue
        if "=" in arg:
            k, v = arg.split("=", 1)
            overrides[k] = parse_value(v)
        else:
            named.append(arg)
    return load_config(named, overrides, config_dir=config_dir)


def device_of(cfg: Dict) -> str:
    """The port's ``device`` key: ``cuda`` unless the config names
    another."""
    return str(cfg.get("device") or "cuda")


def _architecture(cfg: Dict) -> str:
    return cfg.get("parent_model", {}).get("architecture", "DeepLabV3Plus")


# -- typed views over the dict tree ------------------------------------------


def to_meta_optim_config(cfg: Dict) -> MetaOptimConfig:
    c = cfg.get("meta_optim_cfg", {})
    subtrees = c.get("second_order_subtrees")
    if subtrees is None:
        # the architecture's default: second order restricted to the RoI
        # heads for Mask R-CNN, over every parameter for the DeepLab family
        subtrees = ("roi_heads",) if _architecture(cfg) == "MaskRCNN" else ()
    return MetaOptimConfig(
        lr_hierarchy_level=str(c.get("lr_hierarchy_level", "neuron")).lower(),
        init_lr=float(c.get("init_lr", 1e-3)),
        learn_model_init=bool(c.get("learn_model_init", True)),
        use_log_init_lr=bool(c.get("use_log_init_lr", False)),
        max_lr=float(c["max_lr"]) if c.get("max_lr") is not None else 1.0,
        second_order_gradients=bool(c.get("second_order_gradients", False)),
        second_order_subtrees=tuple(subtrees),
    )


def to_outer_optim_config(cfg: Dict) -> OuterOptimConfig:
    c = cfg.get("meta_optim_optim_cfg", {})
    return OuterOptimConfig(
        model_init_lr=float(c.get("model_init_lr", 1e-5)),
        log_init_lr_lr=float(c.get("log_init_lr_lr", 1e-5)),
        lr=float(c.get("lr", 1e-3)),
        model_init_weight_decay=float(c.get("model_init_weight_decay", 1e-3)),
        grad_clip=(float(c["grad_clip"]) if c.get("grad_clip") is not None
                   else None),
    )


def to_augment_config(cfg: Dict) -> AugmentConfig:
    c = cfg.get("augment", {})
    kwargs = {
        k: c[k]
        for k in ("scale_min scale_max rot_deg brightness contrast saturation "
                  "flip_prob trans_frac blur_prob blur_sigma_max".split())
        if k in c
    }
    return AugmentConfig(**kwargs)


def _normalize_mode(cfg: Dict) -> str:
    return "unit" if cfg.get("data_cfg", {}).get("normalize") else "davis"


def to_meta_step_config(cfg: Dict) -> MetaStepConfig:
    if cfg.get("random_box_coord_perm"):
        # the detection meta-task's box-coordinate permutation
        raise NotImplementedError(
            "random_box_coord_perm is not ported yet: it belongs to the "
            "detection meta-tasks (ROADMAP D11)")
    return MetaStepConfig(
        num_epochs=int(cfg.get("num_epochs", {}).get("train", 5)),
        bptt_epochs=int(cfg.get("bptt_epochs", 5)),
        train_batch_size=int(
            cfg.get("data_cfg", {}).get("batch_sizes", {}).get("train", 3)),
        loss_func=str(cfg.get("loss_func", "dice")),
        normalize_mode=_normalize_mode(cfg),
        remat=bool(cfg.get("remat", True)),
        augment=to_augment_config(cfg),
        frame_transform_per_task=bool(
            cfg.get("random_frame_transform_per_task", False)),
    )


def to_one_shot_config(cfg: Dict) -> OneShotConfig:
    ona = cfg.get("eval_online_adapt", {})
    es = cfg.get("train_early_stopping_cfg", {})
    return OneShotConfig(
        num_epochs=int(cfg.get("num_epochs", {}).get("eval", 10)),
        batch_size=int(
            cfg.get("data_cfg", {}).get("batch_sizes", {}).get("train", 3)),
        loss_func=str(cfg.get("loss_func", "dice")),
        early_stop_patience=int(es.get("patience") or 0),
        online_adapt_step=int(ona.get("step") or 0),
        online_adapt_epochs=int(ona.get("num_epochs", 10)),
        online_adapt_min_prop=float(ona.get("min_prop", 0.5)),
        normalize_mode=_normalize_mode(cfg),
        augment=to_augment_config(cfg),
        pad_multiple=int(cfg.get("eval_pad_multiple", 0) or 0),
        ona_window_bucket=int(cfg.get("eval_ona_window_bucket", 0) or 0),
    )


def to_meta_train_config(cfg: Dict) -> MetaTrainConfig:
    return MetaTrainConfig(
        meta_batch_size=int(cfg.get("meta_batch_size", 4)),
        num_meta_iters=int(cfg.get("num_meta_iters", 1000)),
        vis_interval=int(cfg.get("vis_interval", 10)),
        eval_interval=int(cfg.get("eval_interval", 0)),
        save_dir=cfg.get("save_dir"),
        seed=int(cfg.get("seed", 1)),
        increase_seed_per_meta_run=bool(
            cfg.get("increase_seed_per_meta_run", True)),
    )


def to_taskset_config(cfg: Dict) -> MetaTasksetConfig:
    data = cfg.get("data_cfg", {})
    crop = data.get("crop_sizes", {}).get("train") or (480, 480)
    if isinstance(crop, int):
        crop = (crop, crop)
    return MetaTasksetConfig(
        num_query_frames=int(data.get("batch_sizes", {}).get("meta", 1)),
        crop_size=tuple(crop),
        random_frame_epsilon=cfg.get("random_frame_epsilon"),
        random_support_frame=data.get("frame_ids", {}).get("train") == "random",
        random_flip_label=bool(cfg.get("random_flip_label", False)),
        random_no_label=bool(cfg.get("random_no_label", False)),
        single_obj_seq_mode=str(cfg.get("single_obj_seq_mode", "KEEP")),
        random_object_id_sub_group=bool(
            cfg.get("random_object_id_sub_group", False)),
    )
