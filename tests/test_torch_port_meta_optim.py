"""Port learned optimizer (e_osvos_torch.meta_optim) against the JAX package
on the CPU: the first-order inner loop with non-uniform neuron lrs (so a
transposed lr layout cannot pass), the early-stop latch, and the learned
init staying untouched by a fine-tune."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim import fine_tune as j_fine_tune
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.ops.losses import dice_loss as j_dice
from e_osvos_torch.meta_optim import (
    LOG_LR_MIN,
    MetaOptimConfig,
    MetaParams,
    clamp_lr_tree,
    fine_tune,
    init_lr_tree,
    init_meta_params,
    materialize_lrs,
    reset_params,
)
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.ops.losses import dice_loss


def _jax_params(rng):
    """A two-conv net in flax layout: 3x3 conv 3→6 + bias, 1x1 conv 6→1."""
    return {"params": {
        "conv": {"kernel": (rng.randn(3, 3, 3, 6) * 0.3).astype(np.float32),
                 "bias": (rng.randn(6) * 0.1).astype(np.float32)},
        "head": {"kernel": (rng.randn(1, 1, 6, 1) * 0.3).astype(np.float32),
                 "bias": np.zeros((1,), np.float32)},
    }}


def _jax_loss(variables, batch):
    img, label = batch
    p = variables["params"]
    dn = ("NHWC", "HWIO", "NHWC")
    y = jax.lax.conv_general_dilated(img, p["conv"]["kernel"], (1, 1),
                                     "SAME", dimension_numbers=dn)
    y = jnp.tanh(y + p["conv"]["bias"])
    y = jax.lax.conv_general_dilated(y, p["head"]["kernel"], (1, 1), "SAME",
                                     dimension_numbers=dn)
    return j_dice((y + p["head"]["bias"])[..., 0], label)


def _torch_loss(params, batch):
    img, label = batch
    x = img.permute(0, 3, 1, 2)
    y = torch.tanh(F.conv2d(x, params["conv.weight"], params["conv.bias"],
                            padding=1))
    y = F.conv2d(y, params["head.weight"], params["head.bias"])
    return dice_loss(y[:, 0], label)


def test_fine_tune_matches_jax_with_random_neuron_lrs():
    """3 first-order steps, linear-space neuron lrs drawn per neuron in
    [0.05, 0.5]: params rtol 1e-4 (atol 1e-6), losses rtol 1e-5."""
    rng = np.random.RandomState(0)
    variables = _jax_params(rng)
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(0.05, 0.5, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables, "neuron", use_log=False)))
    img = rng.randn(3, 3, 8, 8, 3).astype(np.float32)
    label = (rng.rand(3, 3, 8, 8) > 0.5).astype(np.float32)

    jcfg = JMetaOptimConfig(use_log_init_lr=False)
    j_params, j_losses = j_fine_tune(
        jcfg, _jax_loss, JMetaParams(model_init=variables, log_init_lr=lrs),
        (img, label), remat=False)

    cfg = MetaOptimConfig(use_log_init_lr=False)
    meta = MetaParams(model_init=state_dict_from_jax(variables),
                      log_init_lr=lr_tree_from_jax(lrs))
    assert meta.log_init_lr["conv.weight"].shape == (6, 1, 1, 1)
    batches = [(torch.from_numpy(img[i]), torch.from_numpy(label[i]))
               for i in range(3)]
    params, losses = fine_tune(cfg, _torch_loss, meta, batches)

    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=1e-5)
    want = state_dict_from_jax(jax.device_get(j_params))
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("patience", [1, 2])
def test_early_stop_latch_matches_jax(patience):
    """Scripted losses 3, 2, 2.5, 2.6, 1, 1: the latch freezes the params
    and reports +inf from the step after the patience runs out."""
    script = np.array([3.0, 2.0, 2.5, 2.6, 1.0, 1.0], np.float32)
    w0 = np.array([1.0, -2.0], np.float32)

    def j_loss(v, c):
        return jnp.sum(v["params"]["w"]["bias"] ** 2) * 1e-3 + c

    jcfg = JMetaOptimConfig(use_log_init_lr=False)
    jv = {"params": {"w": {"bias": w0}}}
    j_params, j_losses = j_fine_tune(
        jcfg, j_loss, JMetaParams(jv, {"params": {"w": {"bias": np.full(2, 0.5, np.float32)}}}),
        script, early_stop_patience=patience, remat=False)

    def t_loss(params, c):
        return (params["w.bias"] ** 2).sum() * 1e-3 + c

    meta = MetaParams({"w.bias": torch.from_numpy(w0)},
                      {"w.bias": torch.full((2,), 0.5)})
    params, losses = fine_tune(
        MetaOptimConfig(use_log_init_lr=False), t_loss, meta,
        [float(c) for c in script], early_stop_patience=patience)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=1e-6)
    assert np.isinf(losses.numpy()).sum() == np.isinf(np.asarray(j_losses)).sum() > 0
    np.testing.assert_allclose(params["w.bias"].detach().numpy(),
                               np.asarray(j_params["params"]["w"]["bias"]),
                               rtol=1e-6)


def test_reset_params_hands_out_a_copy():
    """The inner steps update in place; the learned init must not move."""
    rng = np.random.RandomState(1)
    variables = _jax_params(rng)
    cfg = MetaOptimConfig(init_lr=0.1, use_log_init_lr=False)
    meta = init_meta_params(cfg, state_dict_from_jax(variables))
    before = {k: v.clone() for k, v in meta.model_init.items()}
    img = torch.from_numpy(rng.randn(2, 8, 8, 3).astype(np.float32))
    label = torch.from_numpy((rng.rand(2, 8, 8) > 0.5).astype(np.float32))
    params, _ = fine_tune(cfg, _torch_loss, meta, [(img, label)] * 3)
    assert any(not torch.equal(params[k].detach(), before[k]) for k in before)
    for k in before:
        assert torch.equal(meta.model_init[k], before[k]), k
    fresh = reset_params(cfg, meta, None)
    assert all(fresh[k].data_ptr() != meta.model_init[k].data_ptr()
               for k in fresh)


def test_lr_tree_levels_and_clamp():
    params = {"c.weight": torch.zeros(5, 3, 3, 3), "c.bias": torch.zeros(5)}
    assert init_lr_tree(params, "neuron")["c.weight"].shape == (5, 1, 1, 1)
    assert init_lr_tree(params, "param")["c.weight"].shape == (5, 3, 3, 3)
    assert init_lr_tree(params, "single")["c.weight"].shape == ()
    logs = init_lr_tree(params, "tensor", init_lr=1e-3)
    np.testing.assert_allclose(materialize_lrs(logs)["c.bias"].item(), 1e-3,
                               rtol=1e-6)
    clamped = clamp_lr_tree({"a": torch.tensor([-40.0, 0.0, 3.0])})
    np.testing.assert_allclose(clamped["a"].numpy(), [LOG_LR_MIN, 0.0, 0.0])
    with pytest.raises(ValueError):
        init_lr_tree(params, "layer")


def _jax_lr_pair(rng, use_log):
    """Random neuron lrs for the two-conv net: the JAX tree and the port's
    dict."""
    from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as jinit

    variables = _jax_params(rng)
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(-5.0, -1.0, np.shape(l)).astype(np.float32)
        if use_log else rng.uniform(1e-3, 0.5, np.shape(l)).astype(np.float32),
        jax.device_get(jinit(variables, "neuron", use_log=use_log)))
    return lrs, lr_tree_from_jax(lrs)


@pytest.mark.parametrize("use_log", [True, False])
def test_lr_stats_and_per_tensor_match_jax(use_log):
    """Mean, population std, min and max of the materialized lrs rtol 1e-5;
    per-tensor means keyed by parameter name (JAX: by '/'-joined path)."""
    from e_osvos_tpu.meta_optim.lr_tree import lr_per_tensor as j_per
    from e_osvos_tpu.meta_optim.lr_tree import lr_stats as j_stats
    from e_osvos_torch.meta_optim import lr_per_tensor, lr_stats

    j_lrs, lrs = _jax_lr_pair(np.random.RandomState(3), use_log)
    want = j_stats(j_lrs, use_log)
    got = lr_stats(lrs, use_log)
    for k in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    j_tensor = j_per(j_lrs, use_log)
    per = lr_per_tensor(lrs, use_log)
    assert len(per) == len(j_tensor)
    for path, v in j_tensor.items():
        name = ".".join(path.split("/")[1:]).replace("kernel", "weight")
        np.testing.assert_allclose(per[name], v, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("keep_matching", [True, False])
def test_mask_lrs_by_path_matches_jax(keep_matching):
    from e_osvos_tpu.meta_optim.lr_tree import mask_lrs_by_path as j_mask
    from e_osvos_torch.meta_optim import mask_lrs_by_path

    j_lrs, lrs = _jax_lr_pair(np.random.RandomState(4), True)
    want = lr_tree_from_jax(jax.device_get(
        j_mask(j_lrs, ("HEAD",), keep_matching, zero_value=LOG_LR_MIN)))
    got = mask_lrs_by_path(lrs, ("HEAD",), keep_matching,
                           zero_value=LOG_LR_MIN)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    kept = [k for k in got if not (got[k] == LOG_LR_MIN).all()]
    assert kept == ([k for k in got if k.startswith("head")] if keep_matching
                    else [k for k in got if k.startswith("conv")])


def test_fine_tune_passes_buffers_through():
    """A learned init that carries buffers (frozen-BN constants, no lr):
    the fine-tune hands them to the loss unchanged and updates the rest."""
    rng = np.random.RandomState(5)
    cfg = MetaOptimConfig(init_lr=0.1, use_log_init_lr=False)
    sd = state_dict_from_jax(_jax_params(rng))
    meta = init_meta_params(cfg, sd)
    shift = torch.full((6,), 0.25)
    meta = MetaParams({**meta.model_init, "shift": shift}, meta.log_init_lr)
    seen = []

    def loss(params, batch):
        seen.append(params["shift"])
        p = {k: v for k, v in params.items() if k != "shift"}
        p["conv.bias"] = p["conv.bias"] + params["shift"]
        return _torch_loss(p, batch)

    img = torch.from_numpy(rng.randn(2, 8, 8, 3).astype(np.float32))
    label = torch.from_numpy((rng.rand(2, 8, 8) > 0.5).astype(np.float32))
    params, _ = fine_tune(cfg, loss, meta, [(img, label)] * 2)
    assert torch.equal(params["shift"], shift)
    assert all(torch.equal(s, shift) and not s.requires_grad for s in seen)
    assert not torch.equal(params["conv.bias"], meta.model_init["conv.bias"])
