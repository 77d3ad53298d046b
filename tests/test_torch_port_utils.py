"""The port's benchmark-submission packaging and fine-tune-steps sweep
(``e_osvos_torch/utils/submission.py``, ``utils/analysis.py``) against the
JAX package's: the same zip layout and names from one predictions
directory, and the same sweep rows (times apart) from evaluators of a
per-pixel linear model on the same synthetic sequences."""

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.engine import OneShotConfig as JOneShotConfig
from e_osvos_tpu.engine import OneShotEvaluator as JOneShotEvaluator
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.utils import sweep_fine_tune_steps as j_sweep
from e_osvos_tpu.utils.submission import (
    package_ytvos_submission as j_package,
)
from e_osvos_tpu.utils.submission import ytvos_frame_names as j_frame_names
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import OneShotConfig, OneShotEvaluator
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams
from e_osvos_torch.utils import (
    MetricsLogger,
    package_ytvos_submission,
    save_indexed_png,
    sweep_fine_tune_steps,
    ytvos_frame_names,
)

AUG_KW = dict(scale_min=1.0, scale_max=1.0, rot_deg=0.0, brightness=0.0,
              contrast=0.0, saturation=0.0, flip_prob=0.0,
              compute_dtype="float32")
CFG_KW = dict(batch_size=3, loss_func="dice", online_adapt_step=0)
INDEX_KW = dict(num_sequences=2, num_frames=4, size=(30, 44), num_objects=1,
                seed=1)
W0, B0, LR = [[0.3], [-0.2], [0.1]], [0.0], 0.5
STEPS = (2, 30)


def _tree(tmp_path):
    preds = tmp_path / "preds"
    rng = np.random.RandomState(0)
    for seq, n in (("b_seq", 3), ("a_seq", 2)):
        os.makedirs(preds / seq)
        for t in range(n):
            save_indexed_png(str(preds / seq / f"{t:05d}.png"),
                             rng.randint(0, 3, (6, 8)).astype(np.uint8))
    (preds / "b_seq" / "notes.txt").write_text("not a frame")
    (preds / "stray.png").write_bytes(b"")  # a file, not a sequence
    return preds


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return [(i.filename, zf.read(i.filename)) for i in zf.infolist()]


@pytest.mark.parametrize("renamed", [False, True])
def test_package_ytvos_submission_matches_jax(tmp_path, renamed):
    """Sequences sorted, PNGs only, ``Annotations/<seq>/<stem>.png``; with
    ``frame_names`` the i-th PNG takes the i-th official stem (a short list
    leaves the rest as they are)."""
    preds = _tree(tmp_path)
    names = ({"b_seq": ["00000", "00005"], "a_seq": ["00003", "00008"]}
             if renamed else None)
    got, want = tmp_path / "port.zip", tmp_path / "jax.zip"
    n = package_ytvos_submission(str(preds), str(got), frame_names=names)
    assert n == j_package(str(preds), str(want), frame_names=names) == 5
    assert _entries(got) == _entries(want)
    stems = [name for name, _ in _entries(got)]
    assert stems[0] == ("Annotations/a_seq/00003.png" if renamed
                        else "Annotations/a_seq/00000.png")
    assert stems[-1] == "Annotations/b_seq/00002.png"
    only = tmp_path / "only.zip"
    assert package_ytvos_submission(str(preds), str(only), ["a_seq"]) == 2


def test_ytvos_frame_names_matches_jax():
    class Seq:
        image_paths = ["/d/JPEGImages/v1/00000.jpg",
                       "/d/JPEGImages/v1/00005.jpg"]

    class Index:
        sequences = {"v1": Seq()}

    assert ytvos_frame_names(Index(), "v1") == j_frame_names(
        Index(), "v1") == ["00000", "00005"]


def _port_apply(params, imgs):
    return (imgs / 64.0) @ params["w"] + params["b"]


def _jax_apply(variables, imgs):
    return (imgs / 64.0) @ variables["w"] + variables["b"]


def test_sweep_fine_tune_steps_matches_jax(tmp_path):
    """Rows for T = 2 and 30 fine-tune steps over two sequences: the same
    steps and J/F means (within 1e-4: float32 sums in another order), a
    time a frame and fps that agree with each other; the logger gets one
    ``sweep_T`` line a row."""
    meta = MetaParams(
        model_init={"w": torch.tensor(W0), "b": torch.tensor(B0)},
        log_init_lr={"w": torch.full((3, 1), LR), "b": torch.full((1,), LR)})
    j_meta = JMetaParams(
        model_init={"w": jnp.asarray(W0), "b": jnp.asarray(B0)},
        log_init_lr={"w": jnp.full((3, 1), LR), "b": jnp.full((1,), LR)})
    names = ["seq00", "seq01"]
    logger = MetricsLogger(path=str(tmp_path / "sweep.jsonl"))
    got = sweep_fine_tune_steps(
        lambda t: OneShotEvaluator(
            _port_apply, MetaOptimConfig(use_log_init_lr=False),
            OneShotConfig(num_epochs=t, augment=AugmentConfig(**AUG_KW),
                          **CFG_KW), device="cpu"),
        SyntheticVOSIndex(**INDEX_KW), names, meta, 3, steps=STEPS,
        logger=logger)
    logger.close()
    want = j_sweep(
        lambda t: JOneShotEvaluator(
            _jax_apply, JMetaOptimConfig(use_log_init_lr=False),
            JOneShotConfig(num_epochs=t, augment=JAugmentConfig(**AUG_KW),
                           **CFG_KW)),
        JSyntheticVOSIndex(**INDEX_KW), names, j_meta, jax.random.PRNGKey(3),
        steps=STEPS)
    assert [r["fine_tune_steps"] for r in got] == list(STEPS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["fine_tune_steps"] == w["fine_tune_steps"]
        for k in ("J_mean", "F_mean", "JF_mean"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["fps"] * g["time_per_frame"], 1.0,
                                   rtol=1e-6)
    assert got[1]["J_mean"] > got[0]["J_mean"]  # more steps, better masks
    lines = (tmp_path / "sweep.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all('"sweep_T"' in line for line in lines)
