"""Checkpoints of the JAX package read by the port without flax
(``utils.checkpoint.load_flax_checkpoint``): a tiny DeepLab's variables
written by the JAX ``save_checkpoint`` load as the port's parent and give
the JAX forward; a JAX meta checkpoint ``{"meta_params", "opt_state":
None}`` gives the same lrs and learned init; chunked arrays, bfloat16
leaves and numpy scalars round-trip; the port's own ``torch.save``
checkpoints load as before."""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.utils import save_checkpoint as j_save_checkpoint
from e_osvos_torch import config
from e_osvos_torch.cli.common import (
    build_parent_model,
    init_model_params,
    resolve_meta_params,
)
from e_osvos_torch.meta_optim import MetaParams
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.models.torch_import import (
    load_mapped_from_torch,
    reference_meta_checkpoint,
    reference_state_dict,
)
from e_osvos_torch.utils import save_checkpoint
from e_osvos_torch.utils.checkpoint import (
    is_torch_checkpoint,
    load_flax_checkpoint,
)
from test_torch_port_detection_models import random_variables

H, W = 32, 48
MODEL_KW = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                head_norm="group16", output_stride=16)
ARGV = ["parent_model.encoder=resnet10", "parent_model.dtype=float32",
        "parent_model.backbone_norm=frozen_bn",
        "parent_model.decoder_norm_layer=group16",
        "parent_model.output_stride=16", "device=cpu"]


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """A parent and a meta checkpoint written by the JAX package, with the
    variables and lrs they hold."""
    d = tmp_path_factory.mktemp("ckpt")
    jmodel = JDeepLabV3Plus(**MODEL_KW)
    variables = random_variables(jmodel, 3, jax.random.PRNGKey(0),
                                 jnp.zeros((1, H, W, 3)))
    rng = np.random.RandomState(1)
    lrs = jax.device_get(j_init_lr_tree(variables, "neuron", use_log=False))
    lrs = {"params": jax.tree_util.tree_map(
               lambda l: rng.uniform(1e-3, 1e-1, np.shape(l)).astype(
                   np.float32), lrs["params"]),
           "constants": jax.tree_util.tree_map(np.zeros_like,
                                               lrs["constants"])}
    parent, meta = str(d / "parent.ckpt"), str(d / "meta.ckpt")
    j_save_checkpoint(parent, variables, metadata={"step": 3})
    j_save_checkpoint(meta, {"meta_params": JMetaParams(
        model_init=variables, log_init_lr=lrs), "opt_state": None})
    return {"jmodel": jmodel, "variables": variables, "lrs": lrs,
            "parent": parent, "meta": meta, "dir": d}


def test_parent_forward_matches_jax(jax_files):
    """The JAX-written parent replaces the port's seeded init; the forwards
    agree within 1e-5."""
    cfg = config.parse_cli(ARGV)
    seeded = build_parent_model(cfg)
    cfg = config.parse_cli(ARGV + [
        f"parent_model.checkpoint={jax_files['parent']}"])
    model = init_model_params(cfg, build_parent_model(cfg))
    x = np.random.RandomState(2).rand(2, H, W, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax_files["jmodel"].apply(jax_files["variables"], x))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, H, W, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not np.allclose(seeded(torch.from_numpy(x)).detach().numpy(), want)
    sd = state_dict_from_jax(jax_files["variables"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_meta_checkpoint_matches_jax(jax_files):
    """The lrs equal the JAX lrs exactly (the neuron axis moved first) and
    the learned init carries the frozen-BN constants as buffers."""
    cfg = config.parse_cli(ARGV + [
        f"meta_optim_model_file={jax_files['meta']}"])
    model = build_parent_model(cfg)
    mp = resolve_meta_params(cfg, model)
    want_lrs = lr_tree_from_jax(jax_files["lrs"])
    assert set(mp.log_init_lr) == {n for n, _ in model.named_parameters()}
    for k, v in mp.log_init_lr.items():
        assert torch.equal(v, want_lrs[k]), k
    want_init = state_dict_from_jax(jax_files["variables"])
    assert set(mp.model_init) == set(model.state_dict())
    for k, v in mp.model_init.items():
        assert torch.equal(v, want_init[k]), k
    assert any(k.endswith("stem_norm.scale") for k, _ in
               model.named_buffers())


def test_meta_checkpoint_without_learned_init(jax_files):
    path = str(jax_files["dir"] / "no_init.ckpt")
    j_save_checkpoint(path, {"meta_params": JMetaParams(
        model_init=None, log_init_lr=jax_files["lrs"]), "opt_state": None})
    cfg = config.parse_cli(ARGV + [f"meta_optim_model_file={path}",
                                   "meta_optim_cfg.learn_model_init=False"])
    mp = resolve_meta_params(cfg, build_parent_model(cfg))
    assert mp.model_init is None and len(mp.log_init_lr) > 0
    with pytest.raises(ValueError):  # the config learns an init
        cfg = config.parse_cli(ARGV + [f"meta_optim_model_file={path}"])
        resolve_meta_params(cfg, build_parent_model(cfg))


def test_special_leaves_round_trip(tmp_path, monkeypatch):
    """Arrays over flax's ``MAX_CHUNK_SIZE`` (patched small), bfloat16
    leaves, numpy scalars, complex numbers, tuples and None."""
    rng = np.random.RandomState(0)
    big = rng.randn(37, 11).astype(np.float32)
    half = rng.randn(5, 3).astype(np.float32)
    tree = {"big": big, "half": jnp.asarray(half, jnp.bfloat16),
            "scalar": np.float32(2.5), "count": np.int64(7), "c": 1 + 2j,
            "pair": (np.arange(3), None), "nested": {"x": big[:2]}}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    path = tmp_path / "t.msgpack"
    path.write_bytes(flax.serialization.to_bytes(tree))
    assert b"__msgpack_chunked_array__" in path.read_bytes()
    got = load_flax_checkpoint(str(path))
    np.testing.assert_array_equal(got["big"], big)
    np.testing.assert_array_equal(got["nested"]["x"], big[:2])
    assert got["half"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["half"].float().numpy(),
        np.asarray(jnp.asarray(half, jnp.bfloat16).astype(jnp.float32)))
    assert got["scalar"] == np.float32(2.5)
    assert isinstance(got["scalar"], np.float32)
    assert got["count"] == 7 and isinstance(got["count"], np.int64)
    assert got["c"] == 1 + 2j
    np.testing.assert_array_equal(got["pair"]["0"], np.arange(3))
    assert got["pair"]["1"] is None
    # a bfloat16 tree carried onto the port's layout
    sd = state_dict_from_jax({"params": {"m": {"kernel": got["half"]}}})
    assert sd["m.weight"].dtype == torch.float32
    np.testing.assert_array_equal(sd["m.weight"].numpy(),
                                  got["half"].float().numpy().T)
    assert not is_torch_checkpoint(str(path))


def test_port_checkpoints_load_as_before(jax_files, tmp_path):
    """A ``MetaTrainer.save``-style ``torch.save`` checkpoint is told apart
    from a flax file and read as the port's meta-parameters."""
    cfg = config.parse_cli(ARGV + [
        f"meta_optim_model_file={jax_files['meta']}"])
    model = build_parent_model(cfg)
    mp = resolve_meta_params(cfg, model)
    mp.log_init_lr["classifier.bias"].fill_(0.25)
    path = save_checkpoint(str(tmp_path / "last_meta_iter.ckpt"),
                           {"meta_params": mp._asdict(), "opt_state": {}},
                           metadata={"meta_iter": 2})
    assert is_torch_checkpoint(path)
    back = resolve_meta_params(
        config.parse_cli(ARGV + [f"meta_optim_model_file={path}"]), model)
    for field in ("model_init", "log_init_lr"):
        got, want = getattr(back, field), getattr(mp, field)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_missing_and_foreign_checkpoints(jax_files, tmp_path):
    """An explicitly named meta file must exist (``resume`` may not yet);
    the reference's PyTorch files go through the importer: a ``.pth``
    parent in the reference's vocabulary (BatchNorm statistics folded) and
    a ``.model`` meta checkpoint load as ``torch_import`` reads them; a
    parent of another model is refused."""
    model = build_parent_model(config.parse_cli(ARGV))
    with pytest.raises(FileNotFoundError):
        resolve_meta_params(config.parse_cli(
            ARGV + [f"meta_optim_model_file={tmp_path / 'none.ckpt'}"]), model)
    fresh = resolve_meta_params(config.parse_cli(
        ARGV + [f"resume={tmp_path / 'none.ckpt'}"]), model)
    assert set(fresh.log_init_lr) == {n for n, _ in model.named_parameters()}
    source = state_dict_from_jax(jax_files["variables"])
    buffers = [n for n, _ in model.named_buffers()]
    sd = reference_state_dict(source, "deeplab_v3plus", buffers, seed=4)
    pth = str(tmp_path / "parent.pth")
    torch.save(sd, pth)
    cfg = config.parse_cli(ARGV + [f"parent_model.checkpoint={pth}"])
    parent = init_model_params(cfg, build_parent_model(cfg))
    want, n = load_mapped_from_torch(model.state_dict(), sd)
    assert n == len(source)
    got = parent.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    torch.testing.assert_close(got, source, rtol=1e-5, atol=1e-6)

    lrs = lr_tree_from_jax(jax_files["lrs"])
    meta_file = str(tmp_path / "best.model")
    torch.save(reference_meta_checkpoint(
        MetaParams(model_init=source, log_init_lr=lrs), "deeplab_v3plus"),
        meta_file)
    for key in ("meta_optim_model_file", "resume"):
        meta = resolve_meta_params(config.parse_cli(
            ARGV + [f"{key}={meta_file}"]), parent)
        assert all(torch.equal(meta.log_init_lr[k], lrs[k]) for k in lrs)
        assert all(torch.equal(meta.model_init[k], source[k])
                   for k in lrs)  # the trainable entries
        assert all(torch.equal(meta.model_init[b], got[b]) for b in buffers)
    with pytest.raises(ValueError):
        cfg = config.parse_cli(ARGV + [
            "parent_model.architecture=DeepLabV3",
            f"parent_model.checkpoint={jax_files['parent']}"])
        init_model_params(cfg, build_parent_model(cfg))
