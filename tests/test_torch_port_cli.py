"""The port's command lines against the JAX package's on a tiny DAVIS-layout
tree written here: ``cli.evaluate.main`` of both, from the same
JAX-written parent and meta checkpoints (msgpack), give per-sequence J and
F within 1e-3 and PNG label maps that differ in at most 0.1% of the pixels;
``cli.train_meta.main`` runs two meta-iterations whose checkpoint loads back
through ``meta_optim_model_file``; what the port cannot do yet raises (the
training command lines of both families are in
``test_torch_port_cli_training.py``).

resnet10 frozen-BN DeepLabV3+ with a GN-16 head at os16 in fp32, 32x48
frames, identity augmentation (scale 1, no rotation, jitter or flip), so
neither side's random draws change the result."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from e_osvos_tpu.cli import evaluate as j_evaluate
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.utils import save_checkpoint as j_save_checkpoint
from e_osvos_torch import config
from e_osvos_torch.cli import evaluate, train_meta
from e_osvos_torch.cli.common import (
    build_parent_model,
    meta_params_from_flax,
    resolve_meta_params,
)
from e_osvos_torch.data.synthetic_disk import _write_sequence
from e_osvos_torch.models.jax_weights import state_dict_from_jax
from e_osvos_torch.models.torch_import import (
    reference_meta_checkpoint,
    reference_state_dict,
)
from e_osvos_torch.utils.checkpoint import load_flax_checkpoint
from e_osvos_torch.utils.png import davis_palette, load_indexed_png
from test_torch_port_detection_models import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T = 32, 48, 5
MODEL_KW = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                head_norm="group16", output_stride=16)
SEQS = {
    "solo": [dict(color=(200, 60, 40), x0=14, y0=12, dx=1.5, dy=0.5, rx=7,
                  ry=6)],
    "pair": [dict(color=(40, 170, 220), x0=10, y0=9, dx=2.0, dy=1.0, rx=6,
                  ry=5),
             dict(color=(230, 200, 50), x0=34, y0=22, dx=-2.0, dy=-1.0,
                  rx=7, ry=6)],
}
IDENTITY_AUG = ["augment.scale_min=1.0", "augment.scale_max=1.0",
                "augment.rot_deg=0.0", "augment.brightness=0.0",
                "augment.contrast=0.0", "augment.saturation=0.0",
                "augment.flip_prob=0.0"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The DAVIS-layout tree, a JAX-written parent and meta checkpoint, and
    the command line both packages take."""
    d = tmp_path_factory.mktemp("cli")
    root = str(d / "DAVIS")
    rng = np.random.RandomState(3)
    for name, objs in SEQS.items():
        _write_sequence(root, name, objs, rng, H, W, T)
    os.makedirs(os.path.join(root, "ImageSets", "2017"))
    for split in ("val", "train"):
        with open(os.path.join(root, "ImageSets", "2017", f"{split}.txt"),
                  "w") as f:
            f.write("".join(n + "\n" for n in SEQS))
    jmodel = JDeepLabV3Plus(**MODEL_KW)
    variables = random_variables(jmodel, 5, jax.random.PRNGKey(0),
                                 jnp.zeros((1, H, W, 3)))
    lrs = jax.device_get(j_init_lr_tree(variables, "neuron", use_log=False))
    lr_rng = np.random.RandomState(6)
    lrs = {"params": jax.tree_util.tree_map(
               lambda l: lr_rng.uniform(0.01, 0.1, np.shape(l)).astype(
                   np.float32), lrs["params"]),
           "constants": jax.tree_util.tree_map(np.zeros_like,
                                               lrs["constants"])}
    parent, meta = str(d / "parent.ckpt"), str(d / "meta.ckpt")
    j_save_checkpoint(parent, variables)
    j_save_checkpoint(meta, {"meta_params": JMetaParams(
        model_init=variables, log_init_lr=lrs), "opt_state": None})
    argv = ["with", "DAVIS-2017", "e-OSVOS-OnA",
            f"datasets.val.root={root}", f"datasets.train.root={root}",
            "parent_model.encoder=resnet10", "parent_model.dtype=float32",
            f"parent_model.checkpoint={parent}",
            f"meta_optim_model_file={meta}", "num_epochs.eval=2",
            "eval_online_adapt.step=2", "eval_online_adapt.num_epochs=2",
            f"data_cfg.init_hw=[{H},{W}]", "seed=4"] + IDENTITY_AUG
    return {"dir": d, "root": root, "argv": argv}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_evaluate_matches_jax(tree):
    d, argv = tree["dir"], tree["argv"]
    j_evaluate.main(argv + [f"save_dir={d / 'jax'}",
                            f"save_preds={d / 'jax' / 'preds'}",
                            "eval_init_j=True"])
    recs = evaluate.main(argv + [f"save_dir={d / 'port'}",
                                 f"save_preds={d / 'port' / 'preds'}",
                                 f"save_debug={d / 'port' / 'debug'}",
                                 "eval_init_j=True", "device=cpu"])
    assert recs == _records(d / "port" / "eval_metrics.jsonl")
    want = _records(d / "jax" / "eval_metrics.jsonl")
    assert [r["event"] for r in recs] == [r["event"] for r in want] == (
        ["init_eval_seq", "eval_seq"] * 2 + ["eval_total"])
    for got_r, want_r in zip(recs, want):
        assert got_r.get("seq") == want_r.get("seq")
        for k in ("J_mean", "F_mean", "init_J_mean", "init_F_mean"):
            if k in want_r:
                assert abs(got_r[k] - want_r[k]) <= 1e-3, (got_r, want_r)
        if got_r["event"] == "eval_seq":
            assert got_r["fps"] > 0 and "peak_mem_gib" not in got_r
    assert recs[-1]["num_sequences"] == 2
    assert 0.0 < recs[-1]["J_mean"] < 1.0

    palette = davis_palette().flatten().tolist()
    for name, objs in SEQS.items():
        files = sorted(os.listdir(d / "port" / "preds" / name))
        assert files == [f"{t:05d}.png" for t in range(T)]
        got = np.stack([load_indexed_png(str(d / "port" / "preds" / name / f))
                        for f in files])
        want_maps = np.stack([load_indexed_png(
            str(d / "jax" / "preds" / name / f)) for f in files])
        assert got.shape == (T, H, W)
        assert (got != want_maps).mean() <= 1e-3
        assert set(np.unique(got)) <= set(range(len(objs) + 1))
        img = Image.open(d / "port" / "preds" / name / files[1])
        assert img.mode == "P" and img.getpalette()[:len(palette)] == palette
        assert len(os.listdir(d / "port" / "debug" / name)) == T


def test_train_meta_checkpoint_loads_back(tree):
    """Two meta-iterations from the JAX meta checkpoint under an
    ``env_suffix``; ``last_meta_iter.ckpt`` (the port's format) holds the
    trainer's meta-parameters and loads back through
    ``meta_optim_model_file``."""
    d = tree["dir"]
    argv = tree["argv"] + [
        f"save_dir={d / 'meta'}", "env_suffix=run1", "device=cpu",
        "num_meta_iters=2", "meta_batch_size=2", "num_epochs.train=2",
        "bptt_epochs=2", "vis_interval=1", f"data_cfg.crop_sizes.train=[{H},{H}]"]
    trainer = train_meta.main(argv)
    out = d / "meta" / "run1"
    logged = [r for r in _records(out / "metrics.jsonl")
              if r["event"] == "meta_train"]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(np.isfinite(r["meta_loss"]) for r in logged)
    ckpt = str(out / "last_meta_iter.ckpt")
    cfg = config.parse_cli(tree["argv"] + [f"meta_optim_model_file={ckpt}",
                                           "device=cpu"])
    back = resolve_meta_params(cfg, build_parent_model(cfg))
    start = resolve_meta_params(config.parse_cli(tree["argv"] + ["device=cpu"]),
                                build_parent_model(cfg))
    moved = False
    for field in ("model_init", "log_init_lr"):
        got, want = getattr(back, field), getattr(trainer.meta_params, field)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k].cpu()), k
            moved |= not torch.equal(got[k], getattr(start, field)[k])
    assert moved  # the outer steps changed the meta-parameters


def test_evaluate_reference_checkpoints(tree):
    """The reference's files, a ``.pth`` parent (BatchNorm statistics to
    fold) and a ``.model`` meta checkpoint, written from the JAX
    checkpoints' weights, through ``cli.evaluate``: the records and maps of
    the run on the JAX checkpoints, J and F within 1e-3 (the fold rounds)."""
    d, argv = tree["dir"], tree["argv"] + ["device=cpu"]
    cfg = config.parse_cli(argv)
    model = build_parent_model(cfg)
    source = state_dict_from_jax(load_flax_checkpoint(
        cfg["parent_model"]["checkpoint"]))
    meta = meta_params_from_flax(load_flax_checkpoint(
        cfg["meta_optim_model_file"])["meta_params"])
    pth, meta_file = str(d / "ref_parent.pth"), str(d / "ref_meta.model")
    torch.save(reference_state_dict(
        source, "deeplab_v3plus", [n for n, _ in model.named_buffers()],
        seed=2), pth)
    torch.save(reference_meta_checkpoint(meta, "deeplab_v3plus"), meta_file)
    runs = {}
    for tag, extra in (("flax", []), ("reference", [
            f"parent_model.checkpoint={pth}",
            f"meta_optim_model_file={meta_file}"])):
        runs[tag] = evaluate.main(argv + extra + [
            f"save_dir={d / tag}", f"save_preds={d / tag / 'preds'}"])
    assert [r["event"] for r in runs["reference"]] == [
        r["event"] for r in runs["flax"]] == ["eval_seq"] * 2 + ["eval_total"]
    for got, want in zip(runs["reference"], runs["flax"]):
        assert got.get("seq") == want.get("seq")
        for k in ("J_mean", "F_mean"):
            assert abs(got[k] - want[k]) <= 1e-3, (got, want)
    for name in SEQS:
        maps = [np.stack([load_indexed_png(str(d / tag / "preds" / name
                                               / f"{t:05d}.png"))
                          for t in range(T)]) for tag in runs]
        assert (maps[0] != maps[1]).mean() <= 1e-3


@pytest.mark.parametrize("extra, match", [
    (["eval_frame_parallel=True"], "E1"),
], ids=["frame_parallel"])
def test_evaluate_raises_what_is_not_ported(tree, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        evaluate.main(tree["argv"] + extra + [
            f"save_dir={tree['dir'] / 'nope'}", "device=cpu"])


def test_module_entry_point_needs_a_card_or_cpu(tree):
    """``python -m e_osvos_torch.cli.evaluate`` runs with ``device=cpu``
    and, on a machine without a card, raises without it."""
    argv = tree["argv"][:-len(IDENTITY_AUG)] + [
        "num_epochs.eval=1", f"save_dir={tree['dir'] / 'module'}"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "e_osvos_torch.cli.evaluate"] + argv
    ok = subprocess.run(cmd + ["device=cpu"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert '"event": "eval_total"' in ok.stdout
    if not torch.cuda.is_available():
        bad = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        assert bad.returncode != 0
        assert "no CUDA device" in bad.stderr
