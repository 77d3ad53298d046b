"""Port models (e_osvos_torch.models) against the JAX package on the CPU:
the JAX ``init`` (with every leaf randomized) goes through
``models.jax_weights`` into the port model, and the forwards must match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.models import DeepLabV3 as JDeepLabV3
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_torch.models import DeepLabV3Plus, build_model
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)


def randomized_variables(variables, seed):
    """Every leaf of a flax variables tree replaced by seeded numpy values:
    conv kernels N(0, 1/fan_in), norm scales near 1, biases near 0 (the
    frozen-BN constants included, so a misrouted constant shows)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = np.shape(x)
        if len(shape) == 4:
            fan_in = int(np.prod(shape[:3]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def port_from_jax(cls, variables, **kwargs):
    model = cls(device="cpu", **kwargs)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


@pytest.mark.parametrize("output_stride", [8, 16])
def test_v3plus_forward_matches_jax(output_stride):
    """resnet10, frozen-BN backbone, group16 head, fp32, 64x64: relative
    max error 1e-4 (f32 convolutions summed in another order)."""
    kw = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
              head_norm="group16", output_stride=output_stride)
    jmodel = JDeepLabV3Plus(**kw)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), output_stride)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = port_from_jax(DeepLabV3Plus, variables, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    assert _rel_err(got, want) < 1e-4


def test_v3_forward_matches_jax():
    """Plain DeepLabV3 through build_model, group4 norms throughout."""
    kw = dict(num_classes=1, arch="resnet10", backbone_norm="group4",
              head_norm="group4", output_stride=8)
    jmodel = JDeepLabV3(**kw)
    x = np.random.RandomState(1).randn(1, 48, 40, 3).astype(np.float32)
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)), 7)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = build_model("DeepLabV3", device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) < 1e-4


def test_converter_lands_every_leaf_once():
    """Every flax leaf (params and constants) lands on exactly one port
    tensor of the same (transposed) shape; neuron lrs transpose with their
    kernels."""
    from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree

    kw = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
              head_norm="group16", output_stride=16)
    variables = jax.device_get(JDeepLabV3Plus(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    sd = state_dict_from_jax(variables)
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(sd) == len(leaves)
    port = DeepLabV3Plus(device="cpu", **kw).state_dict()
    assert set(sd) == set(port)
    for name, t in sd.items():
        assert t.shape == port[name].shape, name
    buffers = {n for n, _ in DeepLabV3Plus(device="cpu", **kw).named_buffers()}
    assert buffers == {k for k in sd if k.startswith("backbone.")
                       and (".norm" in k or "_norm." in k)}

    lrs = lr_tree_from_jax(jax.device_get(init_lr_tree(variables["params"])))
    params = dict(DeepLabV3Plus(device="cpu", **kw).named_parameters())
    assert set(lrs) == set(params)
    for name, lr in lrs.items():
        p = params[name]
        assert lr.shape == (p.shape[0],) + (1,) * (p.dim() - 1), name


@pytest.mark.slow
def test_v3plus_resnet50_480p_forward_matches_jax():
    """Full width: resnet50 os16 frozen-BN DeepLabV3+ at 480x854, fp32,
    relative max error 1e-3."""
    kw = dict(num_classes=1, arch="resnet50", backbone_norm="frozen_bn",
              head_norm="group16", output_stride=16)
    jmodel = JDeepLabV3Plus(**kw)
    x = np.random.RandomState(2).randn(1, 480, 854, 3).astype(np.float32)
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = port_from_jax(DeepLabV3Plus, variables, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 480, 854, 1)
    assert _rel_err(got, want) < 1e-3


def test_entry_points_default_to_cuda():
    """Without a card, a model or an evaluator built without device="cpu"
    raises instead of running on the CPU."""
    from e_osvos_torch.engine import OneShotConfig, OneShotEvaluator
    from e_osvos_torch.meta_optim import MetaOptimConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepLabV3Plus(arch="resnet10", backbone_norm="frozen_bn")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OneShotEvaluator(None, MetaOptimConfig(), OneShotConfig())
