"""The port's training command lines on a tiny DAVIS-layout tree written
here: ``cli.train_parent`` for both families (its config view equal to the
JAX package's field for field), a Mask R-CNN parent checkpoint read by
``cli.train_meta`` as ``parent_model.checkpoint`` (with
``random_box_coord_perm``), and that meta checkpoint read by
``cli.evaluate`` as ``meta_optim_model_file``.

Tiny models (resnet10; Mask R-CNN with GroupNorm-4 and a small RPN,
DeepLabV3+ frozen-BN with a GN-16 head), fp32, 64x64 frames."""

import json
import os

import numpy as np
import pytest
import torch

from e_osvos_tpu import config as j_config
from e_osvos_tpu.cli import train_parent as j_train_parent
from e_osvos_torch import config
from e_osvos_torch.cli import evaluate, train_meta, train_parent
from e_osvos_torch.cli.common import build_parent_model, init_model_params
from e_osvos_torch.data.synthetic_disk import _write_sequence
from e_osvos_torch.data.transforms import VOC_PARENT_AUGMENT
from e_osvos_torch.utils import load_checkpoint

HW, T = 64, 4
SEQS = {
    "solo": [dict(color=(200, 60, 40), x0=20, y0=18, dx=2.0, dy=1.0, rx=12,
                  ry=10)],
    "pair": [dict(color=(40, 170, 220), x0=16, y0=16, dx=2.0, dy=1.0, rx=10,
                  ry=9),
             dict(color=(230, 200, 50), x0=44, y0=42, dx=-2.0, dy=-1.0,
                  rx=11, ry=10)],
}
DETECTION = ["parent_model.architecture=MaskRCNN",
             "parent_model.backbone_norm=group4",
             "parent_model.rpn.anchor_sizes=[8,16,32,64,128]",
             "parent_model.rpn.pre_nms_top_n=64",
             "parent_model.rpn.post_nms_top_n=32",
             "parent_model.rpn.batch_size_per_image=32",
             "parent_model.roi.batch_size_per_image=16"]
DENSE = ["parent_model.backbone_norm=frozen_bn", "parent_model.output_stride=16"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 command runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_training")
    root = str(d / "DAVIS")
    rng = np.random.RandomState(5)
    for name, objs in SEQS.items():
        _write_sequence(root, name, objs, rng, HW, HW, T)
    os.makedirs(os.path.join(root, "ImageSets", "2017"))
    for split in ("val", "train"):
        with open(os.path.join(root, "ImageSets", "2017", f"{split}.txt"),
                  "w") as f:
            f.write("".join(n + "\n" for n in SEQS))
    argv = ["with", "DAVIS-2017", f"datasets.train.root={root}",
            f"datasets.val.root={root}", "parent_model.encoder=resnet10",
            "parent_model.dtype=float32", "seed=2", "device=cpu",
            f"data_cfg.crop_sizes.train=[{HW},{HW}]"]
    return {"dir": d, "argv": argv}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("extra", [
    [], ["parent_model.architecture=MaskRCNN", "parent.max_objects=2",
         "parent.optimizer=sgd", "parent.weight_decay=1e-4"],
    ["with", "VOC2012", "parent.lr=3e-4", "parent.loss_func=dice"],
], ids=["dense", "detection", "voc"])
def test_parent_config_matches_jax(extra):
    argv = ["with", "DAVIS-2017", "seed=7", "parent.num_iters=3"] + extra
    got = train_parent.to_parent_config(config.parse_cli(argv))
    want = j_train_parent.to_parent_config(j_config.parse_cli(argv))
    assert sorted(vars(got)) == sorted(vars(want))
    for k, v in vars(want).items():
        g = getattr(got, k)
        if k == "augment":
            assert vars(g) == vars(v)
        else:
            assert g == v, k
    if "VOC2012" in extra:  # the reference's VOC stack
        assert got.augment == VOC_PARENT_AUGMENT
        assert got.normalize_mode == "unit"


@pytest.mark.parametrize("family", ["dense", "detection"])
def test_train_parent_writes_loadable_checkpoints(tree, family):
    """Two steps with a snapshot at each: ``parent_final.ckpt`` is the
    trained ``state_dict`` and loads as ``parent_model.checkpoint``."""
    d = tree["dir"] / f"parent_{family}"
    model_argv = tree["argv"] + (DETECTION if family == "detection"
                                 else DENSE)
    trainer = train_parent.main(model_argv + [
        f"save_dir={d}", "parent.num_iters=2", "parent.batch_size=2",
        "parent.max_objects=2", "parent.log_interval=1",
        "parent.snapshot_interval=1"])
    assert trainer.step_num == 2
    logged = [r for r in _records(d / "parent_metrics.jsonl")
              if r["event"] == "parent_train"]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in logged)
    assert (d / "parent_1.ckpt").exists() and (d / "parent_2.ckpt").exists()
    state, meta = load_checkpoint(str(d / "parent_final.ckpt"))
    assert meta == {"step": 2}
    cfg = config.parse_cli(model_argv + [
        f"parent_model.checkpoint={d / 'parent_final.ckpt'}"])
    model = init_model_params(cfg, build_parent_model(cfg))
    fresh = build_parent_model(config.parse_cli(model_argv)).state_dict()
    moved = 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
        moved += not torch.equal(v, fresh[k])
    assert moved == len(state)  # every tensor trained, buffers included


def test_detection_parent_meta_evaluate_round_trip(tree):
    """``train_parent`` → ``train_meta`` from that parent with
    ``random_box_coord_perm`` (the learned init starts at the parent) →
    ``evaluate`` from that meta checkpoint."""
    d = tree["dir"] / "round_trip"
    base = tree["argv"] + DETECTION
    train_parent.main(base + [f"save_dir={d / 'parent'}",
                              "parent.num_iters=1", "parent.batch_size=2",
                              "parent.max_objects=2"])
    parent = d / "parent" / "parent_final.ckpt"
    parent_state, _ = load_checkpoint(str(parent))
    trainer = train_meta.main(base + [
        f"parent_model.checkpoint={parent}", f"save_dir={d / 'meta'}",
        "random_box_coord_perm=True", "num_meta_iters=2",
        "meta_batch_size=2", "num_epochs.train=2", "bptt_epochs=2",
        "vis_interval=1"])
    assert trainer.step.task_fns.sample_shapes is not None  # detection
    assert trainer.step.step_cfg.random_box_coord_perm
    logged = [r for r in _records(d / "meta" / "metrics.jsonl")
              if r["event"] == "meta_train"]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(np.isfinite(r["meta_loss"]) for r in logged)
    init = trainer.meta_params.model_init
    assert set(init) == set(parent_state)
    # two outer steps at lr 1e-5 away from the parent, not from a seed
    assert max(float((init[k] - parent_state[k]).abs().max())
               for k in init) < 1e-3
    assert any(not torch.equal(init[k], parent_state[k]) for k in init)

    ckpt = d / "meta" / "last_meta_iter.ckpt"
    recs = evaluate.main(base + [
        f"parent_model.checkpoint={parent}",
        f"meta_optim_model_file={ckpt}", f"save_dir={d / 'eval'}",
        "num_epochs.eval=2", "eval_online_adapt.step=2",
        "eval_online_adapt.num_epochs=1", "parent_model.detections_per_img=1"])
    assert [r["event"] for r in recs] == ["eval_seq"] * 2 + ["eval_total"]
    assert all(0.0 <= r["J_mean"] <= 1.0 for r in recs[:-1])
