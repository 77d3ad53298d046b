"""The port's importer of reference PyTorch checkpoints
(``e_osvos_torch/models/torch_import.py``) against the JAX package's
(``e_osvos_tpu/models/torch_import.py``): the same reference-vocabulary
state dict goes into both, and the port's result must equal the JAX result
carried into the port's layout (``models/jax_weights.py``) bit for bit.

The state dicts are written by the port's ``reference_state_dict`` /
``reference_meta_checkpoint`` from seeded numpy weights, with BatchNorm
running statistics and ``num_batches_tracked``, plus what the reference
carries and a 1-class model skips: COCO's 91-class heads, DeepLab's
``aux_classifier``. Tiny models: resnet10 trunks, 32x48 DeepLab, the Mask
R-CNN of ``test_torch_port_detection_models.py`` (its fc6 and deconv are
the layouts that change)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models import DeepLabV3 as JDeepLabV3
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.models import torch_import as jti
from e_osvos_tpu.models.resnet import ResNet as JResNet
from e_osvos_torch.meta_optim import MetaParams
from e_osvos_torch.models import DeepLabV3, DeepLabV3Plus, ResNet
from e_osvos_torch.models import torch_import as ti
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from test_torch_port_detection_models import random_variables, tiny_pair


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

H, W = 32, 48
DEEPLAB_KW = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                  head_norm="group16", output_stride=16)
ARCHS = ("resnet", "deeplab_v3", "deeplab_v3plus", "maskrcnn")


def _template(arch):
    """The JAX variables of a tiny model of ``arch`` and the port's state
    carrying them, with the port's buffer names."""
    key, x = jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))
    if arch == "resnet":
        variables = random_variables(
            JResNet(arch="resnet10", norm_layer="frozen_bn"), 1, key, x)
        model = ResNet("resnet10", "frozen_bn")
    elif arch == "maskrcnn":
        _, variables, model = tiny_pair(2)
    else:
        jcls, cls = ((JDeepLabV3, DeepLabV3) if arch == "deeplab_v3"
                     else (JDeepLabV3Plus, DeepLabV3Plus))
        variables = random_variables(jcls(**DEEPLAB_KW), 3, key, x)
        model = cls(device="cpu", **DEEPLAB_KW)
    state = state_dict_from_jax(variables)
    model.load_state_dict(state, strict=True)
    return variables, state, [n for n, _ in model.named_buffers()], model


@pytest.fixture(scope="module", params=ARCHS)
def template(request):
    return (request.param,) + _template(request.param)


def _random_like(state, seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(
        (1.0 + 0.2 * rng.randn(*v.shape) if k.endswith("scale")
         else 0.1 * rng.randn(*v.shape)).astype(np.float32))
        for k, v in state.items()}


def reference_checkpoint(arch, state, buffers, seed=5):
    """A reference-vocabulary state dict of other weights than ``state``:
    BatchNorm statistics on every frozen norm (Mask R-CNN's GroupNorm trunk
    too, which folds them into its affine, as the JAX importer does), and
    heads the 1-class model must skip."""
    stats = set(buffers)
    if arch == "maskrcnn":
        stats |= {k for k in state if k.startswith("backbone.")
                  and k.rsplit(".", 1)[-1] in ("scale", "bias")
                  and "norm" in k}
    sd = ti.reference_state_dict(_random_like(state, seed), arch, stats,
                                 seed=seed)
    rng = np.random.RandomState(seed + 1)

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    if arch == "maskrcnn":  # torchvision's COCO heads
        sd["roi_heads.box_predictor.cls_score.weight"] = rand(91, 1024)
        sd["roi_heads.box_predictor.cls_score.bias"] = rand(91)
        sd["roi_heads.box_predictor.bbox_pred.weight"] = rand(364, 1024)
        sd["roi_heads.mask_predictor.mask_fcn_logits.weight"] = rand(
            91, 256, 1, 1)
    elif arch.startswith("deeplab"):
        last = ("decoder.last_conv.8" if arch == "deeplab_v3plus"
                else "classifier.4")
        sd[f"{last}.weight"] = rand(21, 256, 1, 1)  # VOC's 21 classes
        sd[f"{last}.bias"] = rand(21)
        sd["aux_classifier.0.weight"] = rand(256, 32, 3, 3)
    return sd


def assert_same_state(got, want):
    assert list(got) == list(want) or set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_reference_keys_invert_the_name_maps(template):
    """Every port name has a reference key that its family's name map reads
    back, and the architecture is recognized from those keys."""
    arch, _, state, buffers, _ = template
    name_map = ti.name_map_for(arch)
    for k in state:
        assert name_map(ti.reference_key(k, arch)) == k, k
    sd = ti.reference_state_dict(state, arch, buffers)
    assert ti.detect_torch_architecture(sd) == arch
    assert jti.detect_torch_architecture(sd) == arch


def test_load_mapped_matches_jax(template):
    """Name-mapped import with BatchNorm folding: the port's state equals
    the JAX variables' carried into the port, exactly, with the same count
    of consumed tensors; the skipped heads keep the template's values."""
    arch, variables, state, buffers, _ = template
    sd = reference_checkpoint(arch, state, buffers)
    want_vars, want_n = jti.load_mapped_from_torch(
        jax.device_get(variables), sd)
    got, n = ti.load_mapped_from_torch(state, sd)
    assert n == want_n
    assert_same_state(got, state_dict_from_jax(want_vars))
    changed = {k for k in state if not torch.equal(got[k], state[k])}
    skipped = {"maskrcnn": {"box_head.cls_score.weight",
                            "box_head.cls_score.bias",
                            "box_head.bbox_pred.weight",
                            "mask_head.mask_logits.weight"},
               "resnet": set()}.get(arch, {"classifier.weight",
                                          "classifier.bias"})
    assert not changed & skipped
    assert changed == set(state) - skipped
    if arch != "resnet":  # an explicit architecture is the detected one
        again, n2 = ti.load_mapped_from_torch(state, sd, arch)
        assert n2 == n and all(torch.equal(again[k], got[k]) for k in got)


def test_bn_fold_is_the_frozen_affine():
    """A frozen norm loaded from BatchNorm statistics computes the
    BatchNorm in eval mode: scale = w/sqrt(var+eps), bias = b − mean·scale."""
    _, state, buffers, _ = _template("resnet")
    sd = reference_checkpoint("resnet", state, buffers, seed=8)
    got, _ = ti.load_mapped_from_torch(state, sd)
    x = torch.randn(2, 8, 4, 4)
    bn = torch.nn.BatchNorm2d(8, eps=ti.BN_EPS).eval()
    bn.load_state_dict({k[len("bn1."):]: v for k, v in sd.items()
                        if k.startswith("bn1.")})
    s, b = got["stem_norm.scale"], got["stem_norm.bias"]
    torch.testing.assert_close(x * s[:, None, None] + b[:, None, None],
                               bn(x), rtol=1e-5, atol=1e-6)


def test_load_resnet_matches_jax():
    """``load_resnet_from_torch`` (no folding) into a DeepLab's trunk, the
    checkpoint carrying torchvision's ``fc`` head, which maps nowhere."""
    variables, state, buffers, _ = _template("deeplab_v3plus")
    trunk = {k[len("backbone."):]: v for k, v in state.items()
             if k.startswith("backbone.")}
    sd = ti.reference_state_dict(_random_like(trunk, 4), "resnet",
                                 [b[len("backbone."):] for b in buffers])
    sd["fc.weight"] = torch.randn(1000, 64)
    jparams, jn = jti.load_resnet_from_torch(
        jax.device_get(variables)["constants"], sd)
    got, n = ti.load_resnet_from_torch(state, sd)
    # the JAX function fills one collection at a time: the constants here
    want = dict(state)
    want.update(state_dict_from_jax({"constants": jparams}))
    changed = {k for k in state if not torch.equal(got[k], state[k])}
    assert changed and n > jn
    for k in want:
        if k in buffers:
            assert torch.equal(got[k], want[k]), k


def test_shape_matched_load_matches_jax():
    """The greedy shape-matched copy of keys no name map reads: each tensor
    fills the first unfilled entry of its shape in the JAX package's order
    (constants first, names sorted), in both packages."""
    variables, state, buffers, _ = _template("deeplab_v3plus")
    sd = {f"net.{i}": v for i, v in enumerate(
        _random_like(state, 6).values())}
    sd["net.extra"] = torch.randn(3, 5, 7)  # no entry of its shape
    assert ti.detect_torch_architecture(sd) == "unknown"
    want_vars, want_n = jti.shape_matched_load(jax.device_get(variables), sd)
    got, n = ti.shape_matched_load(state, sd, buffers)
    assert n == want_n == len(state)
    assert_same_state(got, state_dict_from_jax(want_vars))


def _lr_templates(variables, level, seed):
    """Random JAX lrs of ``level`` for ``variables`` and the port's
    equal ones (params only: buffers have no lr)."""
    rng = np.random.RandomState(seed)
    jl = jax.tree_util.tree_map(
        lambda l: rng.uniform(-8, -4, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables, level, use_log=True)))
    return jl, lr_tree_from_jax(jl)


@pytest.mark.parametrize("level", ["neuron", "param"])
@pytest.mark.parametrize("arch", ["deeplab_v3plus", "maskrcnn"])
def test_import_meta_checkpoint_matches_jax(arch, level):
    """A reference ``.model`` (learned init and log lrs under mangled
    names) into the port's ``MetaParams`` equals the JAX import carried
    into the port's layouts, with the same counts: NEURON and PARAM lrs,
    Mask R-CNN's fc6 (reordered input axis) and deconv (swapped axes; its
    NEURON lr lies along the input axis, which neither package's template
    has, so both skip it)."""
    variables, state, buffers, _ = _template(arch)
    jl, lrs = _lr_templates(variables, level, 11)
    j_meta = JMetaParams(model_init=jax.device_get(variables),
                         log_init_lr=jl)
    meta = MetaParams(model_init=state, log_init_lr=lrs)
    other = MetaParams(
        model_init=_random_like(state, 12),
        log_init_lr={k: v - 1.0 for k, v in _random_like(lrs, 13).items()})
    ckpt = ti.reference_meta_checkpoint(other, arch)
    want, want_ic, want_lc = jti.import_meta_checkpoint_from_torch(j_meta,
                                                                   ckpt)
    got, ic, lc = ti.import_meta_checkpoint_from_torch(meta, ckpt)
    assert (ic, lc) == (want_ic, want_lc)
    assert ic > 0 and lc > 0
    assert_same_state(got.model_init, state_dict_from_jax(want.model_init))
    assert_same_state(got.log_init_lr, lr_tree_from_jax(want.log_init_lr))
    moved = {k for k in lrs if not torch.equal(got.log_init_lr[k], lrs[k])}
    deconv = {k for k in lrs if "deconv.weight" in k}
    assert moved == set(lrs) - (deconv if level == "neuron" else set())
    # the frozen buffers keep the template's values
    assert all(torch.equal(got.model_init[b], state[b]) for b in buffers)


def test_shared_log_init_lr_raises():
    variables, state, _, _ = _template("deeplab_v3plus")
    ckpt = {"meta_optim_state_dict": {"log_init_lr": torch.zeros(3)}}
    jl, lrs = _lr_templates(variables, "neuron", 1)
    with pytest.raises(ValueError, match="SINGLE"):
        jti.import_meta_checkpoint_from_torch(
            JMetaParams(model_init=variables, log_init_lr=jl), ckpt)
    with pytest.raises(ValueError, match="SINGLE"):
        ti.import_meta_checkpoint_from_torch(
            MetaParams(model_init=state, log_init_lr=lrs), ckpt)


def test_load_torch_file_matches_jax(tmp_path):
    """A ``.model`` with metadata that ``weights_only`` loading rejects is
    read again without it; a ``{"state_dict": ...}`` wrapper is unwrapped;
    both packages give the same dict."""
    _, state, _, _ = _template("resnet")
    lrs = {k: torch.full((v.shape[0],) + (1,) * (v.dim() - 1), -5.0)
           for k, v in state.items() if k.endswith("weight")}
    ckpt = ti.reference_meta_checkpoint(
        MetaParams(model_init=state, log_init_lr=lrs), "resnet")
    ckpt["run"] = types.SimpleNamespace(meta_iter=np.int64(3))
    path = str(tmp_path / "best.model")
    torch.save(ckpt, path)
    with pytest.raises(Exception):
        torch.load(path, weights_only=True)
    got, want = ti.load_torch_file(path), jti.load_torch_file(path)
    assert set(got) == set(want) == set(ckpt)
    assert got["run"].meta_iter == 3
    for k, v in want["meta_optim_state_dict"].items():
        assert torch.equal(got["meta_optim_state_dict"][k], v)
    wrapped = str(tmp_path / "parent.pth")
    torch.save({"state_dict": state, "epoch": 3}, wrapped)
    got = ti.load_torch_file(wrapped)
    assert set(got) == set(jti.load_torch_file(wrapped)) == set(state)
