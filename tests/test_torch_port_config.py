"""The port's layered configuration (``e_osvos_torch/config.py``) against
the JAX package's on the repo's YAML files: for several command lines,
every ``to_*`` view equals its JAX counterpart field by field, and the
Mask R-CNN model the port builds has the JAX model's RPN and RoI
configuration. Keys the port cannot honour raise."""

import dataclasses

import pytest

from e_osvos_tpu import config as j_config
from e_osvos_tpu.cli.common import build_parent_model as j_build_parent_model
from e_osvos_torch import config
from e_osvos_torch.cli.common import build_parent_model

ARGVS = {
    "davis2017_ona": ["with", "DAVIS-2017", "e-OSVOS-OnA",
                      "num_epochs.eval=50"],
    "synthetic": ["with", "Synthetic", "e-OSVOS", "seed=7",
                  "eval_pad_multiple=16", "eval_ona_window_bucket=0"],
    "youtube_vos": ["with", "YouTube-VOS", "num_meta_iters=5",
                    "augment.flip_prob=0.25", "data_cfg.crop_sizes.train=320",
                    "random_frame_epsilon=8", "single_obj_seq_mode=IGNORE"],
    "maskrcnn": ["with", "DAVIS-2017", "e-OSVOS-OnA",
                 "parent_model.architecture=MaskRCNN",
                 "parent_model.rpn.pre_nms_top_n=50",
                 "parent_model.rpn.anchor_sizes=[8,16,32,64,128]",
                 "parent_model.roi.detections_per_img=2",
                 "eval_online_adapt.only_box_head=True"],
    "second_order": ["with", "DAVIS-2017",
                     "meta_optim_cfg.second_order_gradients=True",
                     "meta_optim_cfg.use_log_init_lr=True",
                     "meta_optim_cfg.max_lr=0.1",
                     "meta_optim_cfg.lr_hierarchy_level=TENSOR",
                     "meta_optim_optim_cfg.grad_clip=10",
                     "train_early_stopping_cfg.patience=3",
                     "data_cfg.normalize=True", "remat=False",
                     "random_frame_transform_per_task=False"],
    "maskrcnn_meta": ["with", "DAVIS-2017",
                      "parent_model.architecture=MaskRCNN",
                      "random_box_coord_perm=True",
                      "meta_optim_cfg.second_order_gradients=True"],
}
VIEWS = ("to_meta_optim_config", "to_outer_optim_config", "to_augment_config",
         "to_meta_step_config", "to_one_shot_config", "to_meta_train_config",
         "to_taskset_config")


def _fields(obj):
    """A dataclass as a dict, nested dataclasses included."""
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("argv", list(ARGVS.values()), ids=list(ARGVS))
def test_view_matches_jax(argv, view):
    """Every field of the port's config equals the JAX one.
    ``profile_dir`` is no key of the YAML: each package keeps its own
    default (the port's under the working directory)."""
    cfg, j_cfg = config.parse_cli(argv), j_config.parse_cli(argv)
    assert cfg == j_cfg
    got = _fields(getattr(config, view)(cfg))
    want = _fields(getattr(j_config, view)(j_cfg))
    if view == "to_meta_train_config":
        assert got.pop("profile_dir") == "profile"
        want.pop("profile_dir")
    assert got == want


@pytest.mark.parametrize("text, value", [
    ("1", 1), ("-3", -3), ("1e-3", 1e-3), ("0.5", 0.5), ("True", True),
    ("false", False), ("null", None), ("[480, 480]", [480, 480]),
    ("DAVIS-2017", "DAVIS-2017"), ("{a: 1}", {"a": 1})])
def test_parse_value(text, value):
    got = config.parse_value(text)
    assert got == value and type(got) is type(value)
    assert got == j_config.parse_value(text)


def test_dotted_overrides_and_unknown_named_config():
    cfg = config.parse_cli(["a.b.c=3", "with", "DAVIS-2017"])
    assert cfg["a"] == {"b": {"c": 3}}
    assert cfg["datasets"]["val"]["name"] == "DAVIS-2017"
    with pytest.raises(TypeError):
        config.set_dotted({"a": 1}, "a.b", 2)
    with pytest.raises(FileNotFoundError):
        config.parse_cli(["NoSuchConfig"])


def test_device_key():
    assert config.device_of(config.parse_cli([])) == "cuda"
    assert config.device_of(config.parse_cli(["device=cpu"])) == "cpu"


def test_maskrcnn_model_config_matches_jax():
    """The ``parent_model.rpn`` / ``roi`` overrides and the RoI keys of the
    YAML land in the port's model as in the JAX one."""
    argv = ARGVS["maskrcnn"] + ["parent_model.encoder=resnet10",
                                "parent_model.dtype=float32", "device=cpu"]
    model = build_parent_model(config.parse_cli(argv))
    j_model = j_build_parent_model(j_config.parse_cli(argv))
    assert _fields(model.rpn) == _fields(j_model.rpn)
    assert _fields(model.roi) == _fields(j_model.roi)
    assert model.roi.detections_per_img == 2
    assert model.rpn.anchor_sizes == (8, 16, 32, 64, 128)
    with pytest.raises(KeyError):
        build_parent_model(config.parse_cli(
            argv + ["parent_model.rpn.no_such_key=1"]))


def test_second_order_picks_plain_group_norms():
    """Under second order the head's GroupNorms take the ``_xla`` (no
    kernel) form, as the JAX package's do."""
    argv = ARGVS["second_order"] + ["parent_model.encoder=resnet10",
                                    "parent_model.dtype=float32",
                                    "device=cpu"]
    model = build_parent_model(config.parse_cli(argv))
    norms = [m for n, m in model.named_modules() if n.endswith("dec_norm1")]
    assert norms and not norms[0].use_kernel
    first = build_parent_model(config.parse_cli(argv[:2] + argv[-3:]))
    assert [m for n, m in first.named_modules()
            if n.endswith("dec_norm1")][0].use_kernel


def test_maskrcnn_second_order_keeps_the_kernel_norms():
    """Mask R-CNN's second order is restricted to parameter subtrees (the
    heads, after every GroupNorm), so its backbone norms stay on the
    kernels; ``random_box_coord_perm`` reaches the meta step's config."""
    cfg = config.parse_cli(ARGVS["maskrcnn_meta"] + [
        "parent_model.encoder=resnet10", "parent_model.backbone_norm=group4",
        "parent_model.dtype=float32", "device=cpu"])
    model = build_parent_model(cfg)
    norms = [m for m in model.modules() if hasattr(m, "use_kernel")]
    assert len(norms) == 17 and all(m.use_kernel for m in norms)  # resnet10
    assert config.to_meta_step_config(cfg).random_box_coord_perm
    assert config.to_meta_optim_config(cfg).second_order_subtrees == (
        "roi_heads",)


@pytest.mark.parametrize("argv, error", [
    (["random_box_coord_perm=True"], ValueError),
    (["parent_model.backbone_norm=batch"], NotImplementedError),
    (["parent_model.architecture=NoSuchNet"], ValueError),
], ids=["box_coord_perm", "batch_norm", "architecture"])
def test_unhonoured_keys_raise(argv, error):
    """A key the port cannot honour raises when set away from its default;
    none is dropped."""
    cfg = config.parse_cli(argv + ["parent_model.encoder=resnet10",
                                   "device=cpu"])
    with pytest.raises(error):
        config.to_meta_step_config(cfg)
        build_parent_model(cfg)
