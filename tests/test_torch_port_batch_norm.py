"""The ``batch`` norm (flax's ``nn.BatchNorm(use_running_average=True)``:
frozen running statistics, learned affine) in the port against the JAX
package on the CPU, module by module and through the DeepLab and Mask
R-CNN forwards, evaluation and the importer of reference checkpoints.

resnet10 models, 32-64 px, fp32. The norms carry statistics that are far
from the identity (mean ~ N(0, 0.1²), var ~ U(0.5, 2), scale near 1, bias
near 0), so a statistic that lands on the wrong tensor shows. The JAX
variables come from ``jax.eval_shape`` (no eager init). Training with the
norm (meta steps, parent steps, a JAX meta-training run resumed in the
port) is held in ``test_torch_port_batch_norm_training.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.engine import OneShotConfig as JOneShotConfig
from e_osvos_tpu.engine import OneShotEvaluator as JOneShotEvaluator
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models import DeepLabV3 as JDeepLabV3
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.models import MaskRCNN as JMaskRCNN
from e_osvos_tpu.models import torch_import as jti
from e_osvos_tpu.models.mask_rcnn import RoIConfig as JRoIConfig
from e_osvos_tpu.models.rpn import RPNConfig as JRPNConfig
from e_osvos_torch import config
from e_osvos_torch.cli.common import build_parent_model, init_model_params
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import OneShotConfig, OneShotEvaluator
from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    init_meta_params,
)
from e_osvos_torch.models import (
    BatchNorm,
    DeepLabV3,
    DeepLabV3Plus,
    MaskRCNN,
    RoIConfig,
    RPNConfig,
    functional_apply,
    make_norm,
)
from e_osvos_torch.models import torch_import as ti
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.models.stacked import object_stacked_apply, stack_objects
from test_torch_port_detection_models import (
    ROI_KW,
    RPN_KW,
    SIZE,
    frame_draws_from_key,
    jax_sample_key,
    random_variables,
    scene,
)

DEEPLAB_KW = dict(num_classes=1, arch="resnet10", output_stride=16)
# (backbone, head): the backbone alone, the head alone, both
NORMS = {"backbone": ("batch", "group16"), "head": ("frozen_bn", "batch"),
         "both": ("batch", "batch")}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 command runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def with_batch_stats(variables, seed):
    """``variables`` with every ``batch_stats`` leaf drawn from ``seed``:
    mean ~ N(0, 0.1²), var ~ U(0.5, 2)."""
    rng = np.random.RandomState(seed)
    if "batch_stats" not in variables:
        return variables

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, np.shape(x)).astype(np.float32)
        return (0.1 * rng.randn(*np.shape(x))).astype(np.float32)

    return dict(variables, batch_stats=jax.tree_util.tree_map_with_path(
        leaf, variables["batch_stats"]))


def deeplab_variables(jcls, kw, seed, hw):
    """Random JAX variables of a tiny DeepLab (``random_variables`` with
    drawn statistics) and the port model carrying them."""
    variables = with_batch_stats(random_variables(
        jcls(**kw), seed, jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,))),
        seed + 100)
    cls = DeepLabV3 if jcls is JDeepLabV3 else DeepLabV3Plus
    model = cls(device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, model


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


# ------------------------------------------------------------ the module


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 unit in the last place of each value (8 significant
    bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_matches_flax(dtype):
    """``BatchNorm`` against flax's ``nn.BatchNorm(use_running_average=
    True, momentum=0.9)`` on the same ``[2, 5, 7, 16]`` input: the forward
    within 1e-6 of its largest value in float32 and within one bfloat16 ulp
    of each value in bfloat16 (both compute in float32 and round once); the
    gradients of a weighted sum to x, scale, bias, mean and var within 1e-6
    of each gradient's largest magnitude (x's in bfloat16: one ulp)."""
    rng = np.random.RandomState(0)
    c = 16
    x = (3.0 * rng.randn(2, 5, 7, c)).astype(np.float32)
    w = rng.randn(2, 5, 7, c).astype(np.float32)
    params = {"scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
              "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    flax_bn = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                            dtype=jdt)

    def weighted(p, s, xx):
        y = flax_bn.apply({"params": p, "batch_stats": s}, xx)
        return jnp.sum(y.astype(jnp.float32) * w), y

    xj = jnp.asarray(x, jdt)
    (_, want), grads = jax.value_and_grad(weighted, argnums=(0, 1, 2),
                                          has_aux=True)(params, stats, xj)
    assert want.dtype == jdt

    bn = BatchNorm(c)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    bn.mean.requires_grad_(True)
    bn.var.requires_grad_(True)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_(True)
    got = bn(xt)
    assert got.dtype == tdt
    (got.float() * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    got = got.detach().permute(0, 2, 3, 1)
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if dtype == "float32":
        assert _rel_err(got.numpy(), want_t.numpy()) <= 1e-6
    else:
        assert bool(((got.float() - want_t).abs() <= _bf16_ulp(want_t)).all())
    gx = xt.grad.permute(0, 2, 3, 1).float()
    gx_want = torch.from_numpy(np.array(grads[2].astype(jnp.float32)))
    if dtype == "float32":
        assert _rel_err(gx.numpy(), gx_want.numpy()) <= 1e-6
    else:
        assert bool(((gx - gx_want).abs() <= _bf16_ulp(gx_want)).all())
    for name, want_g in {**grads[0], **grads[1]}.items():
        got_g = getattr(bn, name).grad.numpy()
        assert _rel_err(got_g, np.asarray(want_g)) <= 1e-6, name


def test_make_norm_and_defaults():
    """``make_norm("batch")`` is the module: parameters scale (ones) and
    bias (zeros), buffers mean (zeros) and var (ones), eps 1e-5."""
    bn = make_norm("batch")(6)
    assert isinstance(bn, BatchNorm) and bn.eps == 1e-5
    assert dict(bn.named_parameters()).keys() == {"scale", "bias"}
    assert dict(bn.named_buffers()).keys() == {"mean", "var"}
    assert torch.equal(bn.scale, torch.ones(6))
    assert torch.equal(bn.var, torch.ones(6))
    assert not bn.mean.any() and not bn.bias.any()


# ----------------------------------------------------------- the forwards


@pytest.mark.parametrize("case", [("v3plus", "backbone"), ("v3plus", "head"),
                                  ("v3plus", "both"), ("v3", "both")],
                         ids=lambda c: "-".join(c))
def test_deeplab_forward_matches_jax(case):
    """DeepLabV3+/V3 with the ``batch`` norm in the backbone, the head or
    both, 64x48 input: relative max error 1e-4 (f32 convolutions summed in
    another order); every statistic lands on its buffer."""
    arch, norms = case
    jcls = JDeepLabV3Plus if arch == "v3plus" else JDeepLabV3
    kw = dict(DEEPLAB_KW, backbone_norm=NORMS[norms][0],
              head_norm=NORMS[norms][1])
    variables, model = deeplab_variables(jcls, kw, 3, (64, 48))
    assert set(dict(model.named_buffers())) == set(state_dict_from_jax(
        {k: v for k, v in variables.items() if k != "params"}))
    x = np.random.RandomState(1).randn(2, 64, 48, 3).astype(np.float32)
    want = np.asarray(jcls(**kw).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 48, 1)
    assert _rel_err(got, want) < 1e-4


def _fold(variables):
    """A JAX ``batch`` backbone's variables as the ``frozen_bn`` backbone's:
    scale' = scale·rsqrt(var + eps), bias' = bias − mean·scale'."""
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    consts = {}

    def walk(p, s, out):
        for k, v in s.items():
            if "mean" in v:
                scale = p[k]["scale"] / np.sqrt(v["var"] + np.float32(1e-5))
                out[k] = {"scale": scale,
                          "bias": p[k]["bias"] - v["mean"] * scale}
                del p[k]
            else:
                walk(p[k], v, out.setdefault(k, {}))

    walk(params, jax.device_get(variables["batch_stats"]), consts)
    return {"params": params, "constants": consts}


def test_jax_batch_equals_folded_frozen_bn():
    """A check of the reference itself (no JAX test builds this norm): the
    JAX ``batch``-backbone DeepLabV3+ equals the JAX ``frozen_bn`` one whose
    constants are the folded statistics and affine, within 1e-5 of the
    largest logit (the folding rounds once more)."""
    kw = dict(DEEPLAB_KW, head_norm="group16")
    variables, _ = deeplab_variables(JDeepLabV3Plus,
                                     dict(kw, backbone_norm="batch"), 5,
                                     (32, 48))
    x = jnp.asarray(np.random.RandomState(2).randn(1, 32, 48, 3), jnp.float32)
    batch = np.asarray(JDeepLabV3Plus(backbone_norm="batch", **kw).apply(
        variables, x))
    frozen = np.asarray(JDeepLabV3Plus(backbone_norm="frozen_bn", **kw).apply(
        _fold(variables), x))
    assert _rel_err(frozen, batch) < 1e-5
    assert np.abs(batch).max() > 0.1


def tiny_detector(seed=0):
    """The tiny Mask R-CNN of ``test_torch_port_detection_models.py`` with
    a ``batch`` backbone (drawn statistics), in both packages."""
    kw = dict(arch="resnet10", backbone_norm="batch")
    jmodel = JMaskRCNN(rpn=JRPNConfig(**RPN_KW), roi=JRoIConfig(**ROI_KW),
                       **kw)
    variables = with_batch_stats(random_variables(
        jmodel, seed,
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3))), seed + 100)
    model = MaskRCNN(rpn=RPNConfig(**RPN_KW), roi=RoIConfig(**ROI_KW),
                     device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def test_detection_eval_forward_matches_jax():
    """Mask R-CNN inference with the ``batch`` backbone and the EXTEND
    tracking prior, as ``test_eval_detections_match_jax`` holds the
    GroupNorm one: valid flags and classes exactly, boxes atol 1e-3 px,
    scores atol 1e-5, pasted mask probabilities atol 1e-3."""
    jmodel, variables, model = tiny_detector()
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == 17
    imgs, _ = scene(1)
    prev = np.array([[[20, 18, 44, 40], [0, 0, 0, 0]],
                     [[5, 30, 30, 60], [10, 10, 20, 22]]], np.float32)
    prev_valid = np.array([[True, False], [True, True]])
    key = jax.random.PRNGKey(9)
    det_j = jax.jit(lambda v, x, pb, pv: jmodel.apply(
        v, x, prev_boxes=pb, prev_valid=pv, proposal_aug_mode="EXTEND",
        rngs={"sample": key}))(variables, imgs, prev, prev_valid)
    u = frame_draws_from_key(jax_sample_key(jmodel, variables, key), 2,
                             RPN_KW["post_nms_top_n"])
    with torch.no_grad():
        det = model(torch.from_numpy(imgs), prev_boxes=torch.from_numpy(prev),
                    prev_valid=torch.from_numpy(prev_valid),
                    proposal_aug_mode="EXTEND", draws=u)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(det_j.valid))
    np.testing.assert_array_equal(det.classes.numpy(),
                                  np.asarray(det_j.classes))
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(det_j.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(det_j.scores),
                               atol=1e-5)
    np.testing.assert_allclose(det.masks.numpy(), np.asarray(det_j.masks),
                               atol=1e-3)
    assert det.valid.numpy().any()


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_object"])
def test_stacked_batch_norms(shared):
    """An object-stacked ``batch`` DeepLabV3+ (backbone and head) on 2
    objects' weights and statistics against 2 forwards of the model, within
    1e-5 of the largest logit (grouped and ungrouped convolutions sum in
    other orders; no norm rescales the head, so the logits reach about
    10): on frames both objects share (the stem's norm reads the
    ungrouped convolution's 2·8 channels) and on each object's own images
    (a grouped stem)."""
    kw = dict(DEEPLAB_KW, backbone_norm="batch", head_norm="batch")
    _, model = deeplab_variables(JDeepLabV3Plus, kw, 4, (32, 32))
    apply = functional_apply(model)
    rng = np.random.RandomState(2)
    base = dict(model.state_dict())
    per = [{k: v * (1 + 0.1 * torch.from_numpy(
        rng.uniform(-1, 1, v.shape).astype(np.float32)))
        for k, v in base.items()} for _ in range(2)]
    x = torch.from_numpy(rng.uniform(-120, 120, (2, 2, 32, 32, 3)).astype(
        np.float32))
    with torch.no_grad():
        got = object_stacked_apply(apply, 2)(stack_objects(per),
                                             x[0] if shared else x)
        want = torch.stack([apply(p, x[0] if shared else x[o])[..., 0]
                            for o, p in enumerate(per)], -1)
    assert got.shape == want.shape == (2, 32, 32, 2)
    assert _rel_err(got.numpy(), want.numpy()) < 1e-5
    stacked = object_stacked_apply(apply, 2).model
    assert stacked.backbone.stem_norm.mean.shape == (16,)
    assert stacked.dec_norm1.var.shape == (512,)


# ------------------------------------------------------------- evaluation

H, W, T, O = 32, 48, 6, 2
EVAL_KW = dict(DEEPLAB_KW, backbone_norm="batch", head_norm="group16")
AUG_KW = dict(scale_min=1.0, scale_max=1.0, rot_deg=0.0, brightness=0.0,
              contrast=0.0, saturation=0.0, flip_prob=0.0,
              compute_dtype="float32")
CFG_KW = dict(num_epochs=3, batch_size=3, loss_func="dice",
              online_adapt_step=2, online_adapt_epochs=2,
              online_adapt_min_prop=0.75)
INDEX_KW = dict(num_sequences=1, num_frames=T, size=(H, W), num_objects=O,
                seed=5)


def test_one_shot_sequence_matches_jax():
    """A 2-object one-shot sequence with online adaptation (fine-tune on
    frame 0, refits every 2 frames) through the JAX batched evaluator
    (objects vmapped, the host window loop) and the port's, the objects
    batched (one object-stacked model) and in turn (each object its own
    one-shot OnA sequence): probabilities within 1e-4, J/F within 1e-3.
    The learned init carries the statistics, which the inner steps leave
    as they are (the JAX lrs of ``batch_stats`` are 0, the port's have
    none). The augmentation ranges are degenerate (as in
    ``test_torch_port_batched_objects.py``), so neither side's draws change
    the result."""
    variables, model = deeplab_variables(JDeepLabV3Plus, EVAL_KW, 3, (H, W))
    rng = np.random.RandomState(0)
    lrs = jax.device_get(j_init_lr_tree(variables, "neuron", use_log=False))
    lrs = {"params": jax.tree_util.tree_map(
               lambda l: rng.uniform(0.01, 0.1, np.shape(l)).astype(
                   np.float32), lrs["params"]),
           "batch_stats": jax.tree_util.tree_map(np.zeros_like,
                                                 lrs["batch_stats"])}
    j_ev = JOneShotEvaluator(
        JDeepLabV3Plus(**EVAL_KW).apply,
        JMetaOptimConfig(use_log_init_lr=False),
        JOneShotConfig(augment=JAugmentConfig(**AUG_KW), **CFG_KW),
        batch_objects=True)
    want = j_ev.eval_sequence(JSyntheticVOSIndex(**INDEX_KW), "seq00",
                              JMetaParams(variables, lrs),
                              jax.random.PRNGKey(2))
    meta = MetaParams(state_dict_from_jax(variables), lr_tree_from_jax(lrs))
    assert {"backbone.stem_norm.mean", "backbone.stem_norm.var"} <= set(
        meta.model_init) and "backbone.stem_norm.mean" not in meta.log_init_lr
    index = SyntheticVOSIndex(**INDEX_KW)
    cfg = OneShotConfig(augment=AugmentConfig(**AUG_KW), **CFG_KW)
    for batched in (True, False):
        got = OneShotEvaluator(
            functional_apply(model), MetaOptimConfig(use_log_init_lr=False),
            cfg, device="cpu", batch_objects=batched).eval_sequence(
            index, "seq00", meta, 2)
        assert got["probs"].shape == (O, T, H, W)
        np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]),
                                   rtol=0, atol=1e-4)
        for k in ("J_per_object", "F_per_object"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
    assert 0 < float(np.mean(got["probs"] > 0.5)) < 1


# --------------------------------------------- reference checkpoints


def _templates(arch, seed=3):
    """JAX variables of a tiny ``batch``-norm model of ``arch`` and the
    port's state and buffer names."""
    if arch == "maskrcnn":
        _, variables, model = tiny_detector(seed)
    else:
        kw = dict(DEEPLAB_KW, backbone_norm="batch", head_norm="batch")
        variables, model = deeplab_variables(JDeepLabV3Plus, kw, seed,
                                             (32, 48))
    return (variables, model.state_dict(),
            [n for n, _ in model.named_buffers()])


def _random_batch_state(state, seed):
    """Other values for every entry: scales near 1, statistics as
    ``with_batch_stats`` draws them, the rest near 0."""
    rng = np.random.RandomState(seed)

    def draw(k, shape):
        if k.endswith(".var"):
            return rng.uniform(0.5, 2.0, shape)
        if k.endswith(".scale"):
            return 1.0 + 0.2 * rng.randn(*shape)
        return 0.1 * rng.randn(*shape)

    return {k: torch.from_numpy(draw(k, tuple(v.shape)).astype(np.float32))
            for k, v in state.items()}


@pytest.mark.parametrize("arch", ["deeplab_v3plus", "maskrcnn"])
def test_load_mapped_copies_statistics_unfolded(arch):
    """A reference ``.pth`` with BatchNorm statistics into a ``batch``
    model: the port's import equals the JAX importer's carried into the
    port (bit for bit, the same count of consumed tensors: four a norm),
    the statistics and affine copied as they are, and
    ``reference_state_dict`` of the result is the file again."""
    variables, state, buffers = _templates(arch)
    other = _random_batch_state(state, 7)
    sd = ti.reference_state_dict(other, arch, buffers)
    assert any(k.endswith("bn1.running_var") for k in sd)
    want, want_n = jti.load_mapped_from_torch(jax.device_get(variables), sd)
    got, n = ti.load_mapped_from_torch(state, sd)
    assert n == want_n
    want = state_dict_from_jax(want)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    norms = [b[:-len(".mean")] for b in buffers if b.endswith(".mean")]
    for base in norms:
        for leaf in ("scale", "bias", "mean", "var"):
            assert torch.equal(got[f"{base}.{leaf}"],
                               other[f"{base}.{leaf}"]), (base, leaf)
    again = ti.reference_state_dict(got, arch, buffers)
    for k, v in again.items():
        if k in sd and "num_batches_tracked" not in k and k.split(".")[-1] in (
                "running_mean", "running_var"):
            assert torch.equal(v, sd[k]), k


def test_shape_matched_fill_order_matches_jax():
    """The shape-matched copy into a model with ``batch`` norms (and a
    frozen-BN head, so both buffer collections are there): each tensor
    fills the first unfilled entry of its shape in the order flax flattens
    the variables (``batch_stats``, then ``constants``, then ``params``),
    in both packages, bit for bit."""
    kw = dict(DEEPLAB_KW, backbone_norm="batch", head_norm="frozen_bn")
    variables, model = deeplab_variables(JDeepLabV3Plus, kw, 6, (32, 48))
    assert {"batch_stats", "constants", "params"} == set(variables)
    state = model.state_dict()
    buffers = [n for n, _ in model.named_buffers()]
    sd = {f"net.{i}": v for i, v in enumerate(
        _random_batch_state(state, 8).values())}
    want_vars, want_n = jti.shape_matched_load(jax.device_get(variables), sd)
    got, n = ti.shape_matched_load(state, sd, buffers)
    assert n == want_n == len(state)
    want = state_dict_from_jax(want_vars)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reference_meta_checkpoint_leaves_statistics_out():
    """A reference ``.model`` written from a ``batch`` model's
    meta-parameters holds the learned affine and no statistics (they have
    no lr); importing it keeps the template's statistics, as the JAX
    importer does."""
    variables, state, buffers = _templates("deeplab_v3plus")
    model = DeepLabV3Plus(device="cpu", **dict(
        DEEPLAB_KW, backbone_norm="batch", head_norm="batch"))
    model.load_state_dict(state)
    meta = init_meta_params(MetaOptimConfig(), model)
    other = MetaParams(_random_batch_state(state, 9), meta.log_init_lr)
    ckpt = ti.reference_meta_checkpoint(other, "deeplab_v3plus")
    keys = ckpt["meta_optim_state_dict"]
    assert "model_init_backbone-bn1-weight" in keys
    assert not [k for k in keys if "running" in k]
    got, ic, _ = ti.import_meta_checkpoint_from_torch(meta, ckpt)
    jl = jax.device_get(j_init_lr_tree(variables, "neuron", use_log=True))
    want, want_ic, _ = jti.import_meta_checkpoint_from_torch(
        JMetaParams(jax.device_get(variables), jl), ckpt)
    assert ic == want_ic
    want = state_dict_from_jax(want.model_init)
    for k in want:
        assert torch.equal(got.model_init[k], want[k]), k
    for b in buffers:
        assert torch.equal(got.model_init[b], state[b]), b
    assert torch.equal(got.model_init["backbone.stem_norm.scale"],
                       other.model_init["backbone.stem_norm.scale"])


# ------------------------------------------------------------ the CLI


@pytest.mark.parametrize("arch", ["DeepLabV3Plus", "DeepLabV3", "MaskRCNN"])
def test_cli_builds_batch_norms_and_loads_reference_parent(tmp_path, arch):
    """``parent_model.backbone_norm=batch`` (and, for the DeepLab family,
    ``decoder_norm_layer=batch``) builds, also under second-order
    meta-gradients (the ``batch`` norm needs no ``_xla`` form), and a
    reference ``.pth`` parent loads into it with its statistics unfolded."""
    argv = ["parent_model.encoder=resnet10", "parent_model.dtype=float32",
            f"parent_model.architecture={arch}",
            "parent_model.backbone_norm=batch", "device=cpu"]
    if arch != "MaskRCNN":
        argv += ["parent_model.decoder_norm_layer=batch"]
    model = build_parent_model(config.parse_cli(argv))
    norms = [n for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    assert "backbone.stem_norm" in norms
    if arch != "MaskRCNN":
        assert "aspp.proj_norm" in norms
        second = build_parent_model(config.parse_cli(
            argv + ["meta_optim_cfg.second_order_gradients=True"]))
        assert sum(isinstance(m, BatchNorm) for m in second.modules()) == len(
            norms)
    family = {"DeepLabV3Plus": "deeplab_v3plus", "DeepLabV3": "deeplab_v3",
              "MaskRCNN": "maskrcnn"}[arch]
    buffers = [n for n, _ in model.named_buffers()]
    other = _random_batch_state(model.state_dict(), 11)
    path = str(tmp_path / "parent.pth")
    torch.save(ti.reference_state_dict(other, family, buffers), path)
    loaded = init_model_params(
        config.parse_cli(argv + [f"parent_model.checkpoint={path}"]),
        build_parent_model(config.parse_cli(argv))).state_dict()
    for b in buffers:
        assert torch.equal(loaded[b], other[b]), b
