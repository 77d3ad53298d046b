"""Port detection models (e_osvos_torch.models: fpn, rpn, mask_rcnn) against
the JAX package on the CPU, on carried weights.

Tiny configuration of ``tests/test_mask_rcnn.py``: resnet10 with GroupNorm-4,
64x64 images (an odd 72x100 for the FPN crop), fp32. The JAX side draws its
random numbers from keys; the port gets the same uniforms, taken from the
keys along the splits ``MaskRCNN`` makes (``jax_train_draws``,
``frame_draws_from_key``), so both sides sample the same anchors and rois."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models import MaskRCNN as JMaskRCNN
from e_osvos_tpu.models import RoIConfig as JRoIConfig
from e_osvos_tpu.models import RPNConfig as JRPNConfig
from e_osvos_tpu.models.fpn import FPN as JFPN
from e_osvos_tpu.models.mask_rcnn import BoxHead as JBoxHead
from e_osvos_tpu.models.mask_rcnn import MaskHead as JMaskHead
from e_osvos_tpu.models.resnet import ResNet as JResNet
from e_osvos_tpu.models.rpn import generate_anchors as j_generate_anchors
from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig, TrainDraws
from e_osvos_torch.models.fpn import FPN
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.models.mask_rcnn import BoxHead, MaskHead
from e_osvos_torch.models.resnet import ResNet
from e_osvos_torch.models.rpn import generate_anchors

SIZE = 64
RPN_KW = dict(anchor_sizes=(8, 16, 32, 64, 128), pre_nms_top_n=64,
              post_nms_top_n=32, batch_size_per_image=32)
ROI_KW = dict(batch_size_per_image=16, detections_per_img=2)
MODEL_KW = dict(arch="resnet10", backbone_norm="group4")


def random_variables(module, seed, *args):
    """Seeded numpy values for every leaf of ``module.init(*args)``'s
    variables, from the shapes alone: kernels ``N(0, 1/fan_in)`` (dense
    ones included, so the box head's activations stay of order one), norm
    scales near 1, biases near 0."""
    shapes = jax.eval_shape(module.init, *args)
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_sample_key(jmodel, variables, key):
    """The key ``MaskRCNN.__call__`` gets from ``make_rng("sample")``."""
    return jmodel.apply(variables, rngs={"sample": key},
                        method=lambda m: m.make_rng("sample"))


def jax_train_draws(jmodel, variables, key, batch, num_objects=1):
    """The uniforms a JAX training forward draws from ``key``
    (mask_rcnn.py:278, rpn.py:201-206, mask_rcnn.py:172), as ``TrainDraws``
    ``[batch, ...]``."""
    n_anchors = sum(len(a) for a in j_generate_anchors((SIZE, SIZE),
                                                       jmodel.rpn))
    return train_draws_from_key(jax_sample_key(jmodel, variables, key), batch,
                                n_anchors,
                                jmodel.rpn.post_nms_top_n + num_objects)


def train_draws_from_key(key, batch, n_anchors, n_rois):
    keys = jax.random.split(key, batch * 3).reshape(batch, 3, -1)
    fields = [[], [], [], []]
    for i in range(batch):
        k_rpn, k_box, k_msk = keys[i]
        kp, kn = jax.random.split(k_rpn)
        for f, (k, n) in zip(fields, ((kp, n_anchors), (kn, n_anchors),
                                      (k_box, n_rois), (k_msk, n_rois))):
            f.append(np.asarray(jax.random.uniform(k, (n,))))
    return TrainDraws(*(torch.from_numpy(np.stack(f)) for f in fields))


def frame_draws_from_key(key, batch, n):
    """The tracking prior's jitter uniforms ``[batch, n, 4]`` (boxes.py:136
    draws them per image from ``split(key, batch)``)."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (n, 4)))
        for k in jax.random.split(key, batch)]))


def tiny_pair(seed=0, **roi_kw):
    """The JAX tiny MaskRCNN with randomized variables, and the port model
    carrying them."""
    roi = dict(ROI_KW, **roi_kw)
    jmodel = JMaskRCNN(rpn=JRPNConfig(**RPN_KW), roi=JRoIConfig(**roi),
                       **MODEL_KW)
    variables = random_variables(
        jmodel, seed,
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)))
    model = MaskRCNN(rpn=RPNConfig(**RPN_KW), roi=RoIConfig(**roi),
                     device="cpu", **MODEL_KW)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model


def scene(seed, batch=2):
    """Images with a bright rectangle per image and its {0, 1, 255} mask
    (a 255 border ring)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(batch, SIZE, SIZE, 3).astype(np.float32) * 20
    masks = np.zeros((batch, 1, SIZE, SIZE), np.float32)
    for i in range(batch):
        y, x = rng.randint(8, 30, 2)
        h, w = rng.randint(14, 28, 2)
        imgs[i, y:y + h, x:x + w] += 60
        masks[i, 0, y - 1:y + h + 1, x - 1:x + w + 1] = 255
        masks[i, 0, y:y + h, x:x + w] = 1
    return imgs, masks


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-6))


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


# ---- layouts ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def heads():
    rng = np.random.RandomState(0)
    x7 = rng.randn(5, 7, 7, 16).astype(np.float32)
    x14 = rng.randn(3, 14, 14, 16).astype(np.float32)
    jbox, jmask = JBoxHead(num_classes=2), JMaskHead(num_classes=2)
    vb = random_variables(jbox, 1, jax.random.PRNGKey(0), jnp.asarray(x7))
    vm = random_variables(jmask, 2, jax.random.PRNGKey(0), jnp.asarray(x14))
    want_box = [np.asarray(a) for a in jbox.apply(vb, jnp.asarray(x7))]
    want_mask = np.asarray(jmask.apply(vm, jnp.asarray(x14)))
    return x7, x14, vb, vm, want_box, want_mask


def _box_head(vb, flip_fc6=False):
    head = BoxHead(7 * 7 * 16, 2)
    sd = state_dict_from_jax(vb)
    if flip_fc6:  # rows in (c, h, w) order: a torch NCHW flatten
        w = sd["fc6.weight"]
        sd["fc6.weight"] = w.view(1024, 7, 7, 16).permute(0, 3, 1, 2).reshape(
            1024, -1)
    head.load_state_dict(sd, strict=True)
    return head


def _mask_head(vm, unflip_deconv=False):
    head = MaskHead(16, 2)
    sd = state_dict_from_jax(vm)
    if unflip_deconv:  # the plain HWIO → OIHW transpose
        sd["deconv.weight"] = sd["deconv.weight"].flip(2, 3)
    head.load_state_dict(sd, strict=True)
    return head.to(memory_format=torch.channels_last)


def test_fc6_and_deconv_layouts(heads):
    """The box head (fc6 flattens (h, w, c)) and the mask head (the flax
    ConvTranspose as a flipped ``conv_transpose2d``) match flax at rel 1e-5
    on carried weights; the two wrong layouts, which keep every shape,
    do not."""
    x7, x14, vb, vm, want_box, want_mask = heads
    with torch.no_grad():
        got = _box_head(vb)(torch.from_numpy(x7))
        bad = _box_head(vb, flip_fc6=True)(torch.from_numpy(x7))
        got_m = _mask_head(vm)(torch.from_numpy(x14))
        bad_m = _mask_head(vm, unflip_deconv=True)(torch.from_numpy(x14))
    for g, w in zip(got, want_box):
        assert _rel_err(g.numpy(), w) < 1e-5
    assert _rel_err(got_m.numpy(), want_mask) < 1e-5
    assert got_m.shape == (3, 28, 28, 2)
    assert _rel_err(bad[0].numpy(), want_box[0]) > 1e-2
    assert _rel_err(bad_m.numpy(), want_mask) > 1e-2


def test_converter_lands_every_leaf_once_with_lrs(tiny):
    """Every flax leaf of the Mask R-CNN lands on one port tensor of its
    shape; neuron lrs land on the output axis, dense and transposed
    convolutions included; param-level lrs take their kernel's layout."""
    jmodel, variables, model = tiny
    sd = state_dict_from_jax(variables)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    assert set(sd) == set(model.state_dict())
    params = dict(model.named_parameters())
    lrs = lr_tree_from_jax(jax.device_get(j_init_lr_tree(variables["params"])))
    assert set(lrs) == set(params)
    for name, lr in lrs.items():
        p = params[name]
        assert lr.shape == (p.shape[0],) + (1,) * (p.dim() - 1), name
    rng = np.random.RandomState(3)
    plrs = jax.tree_util.tree_map(
        lambda l: rng.rand(*np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables["params"], "param")))
    got = lr_tree_from_jax(plrs)
    # the kernel's own transform: fc6 (in, out) → [out, in]; deconv flipped
    np.testing.assert_array_equal(
        got["box_head.fc6.weight"].numpy(), plrs["box_head"]["fc6"]["kernel"].T)
    np.testing.assert_array_equal(
        got["mask_head.deconv.weight"].numpy(),
        plrs["mask_head"]["deconv"]["kernel"].transpose(3, 2, 0, 1)[:, :, ::-1, ::-1])


def test_deeplab_conversion_unchanged():
    """Convolution kernels keep the plain HWIO → OIHW transpose, norms and
    biases pass through (the DeepLab mapping before dense and transposed
    kernels were added)."""
    from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus

    kw = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
              head_norm="group16", output_stride=16)
    variables = random_variables(JDeepLabV3Plus(**kw), 4,
                                 jax.random.PRNGKey(0),
                                 jnp.zeros((1, 32, 32, 3)))
    sd = state_dict_from_jax(variables)
    n = 0
    for coll in ("params", "constants"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(variables[coll]):
            keys = [p.key for p in path]
            arr = np.asarray(leaf)
            if keys[-1] == "kernel":
                keys[-1], arr = "weight", arr.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(sd[".".join(keys)].numpy(), arr)
            n += 1
    assert n == len(sd)


# ---- FPN and RPN ---------------------------------------------------------------


def test_fpn_on_odd_sizes_matches_jax():
    """ResNet GN-4 trunk + FPN at 72x100 (C3 is 9x13: the upsampled C4
    level is cropped): every level P2..P6 within rel 1e-4 (f32)."""
    x = np.random.RandomState(1).randn(1, 72, 100, 3).astype(np.float32)
    jtrunk, jfpn = JResNet(arch="resnet10", norm_layer="group4"), JFPN()
    vt = random_variables(jtrunk, 5, jax.random.PRNGKey(0), x)
    feats = jtrunk.apply(vt, x)
    vf = random_variables(jfpn, 6, jax.random.PRNGKey(1), feats)
    want = [np.asarray(p) for p in jfpn.apply(vf, feats)]
    trunk = ResNet("resnet10", "group4")
    trunk.load_state_dict(state_dict_from_jax(vt), strict=True)
    fpn = FPN([32, 64, 128, 256])
    fpn.load_state_dict(state_dict_from_jax(vf), strict=True)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = fpn(trunk(xt))
    assert [tuple(p.shape[2:]) for p in got] == [w.shape[1:3] for w in want]
    assert want[1].shape[1:3] == (9, 13)
    for g, w in zip(got, want):
        assert _rel_err(g.permute(0, 2, 3, 1).numpy(), w) < 1e-4


def test_anchors_match_jax():
    cfg = RPNConfig(**RPN_KW)
    got = generate_anchors((72, 100), cfg)
    want = j_generate_anchors((72, 100), JRPNConfig(**RPN_KW))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- the whole detector ----------------------------------------------------------


def test_train_losses_and_grads_match_jax(tiny):
    """Training forward, two images with the JAX key's draws: the five
    losses within rel 1e-4 (f32 convolutions summed in another order, the
    same anchors and rois sampled), every parameter gradient within 1e-3 of
    its tensor's largest magnitude."""
    jmodel, variables, model = tiny
    imgs, masks = scene(0)
    gt_valid = np.ones((2, 1), bool)
    key = jax.random.PRNGKey(7)

    def jloss(params):
        total, parts = jmodel.apply(
            {"params": params}, jnp.asarray(imgs), jnp.asarray(masks),
            jnp.asarray(gt_valid), train=True, rngs={"sample": key})
        return total, parts

    (j_total, j_parts), j_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    draws = jax_train_draws(jmodel, variables, key, 2)
    total, parts = model(torch.from_numpy(imgs), torch.from_numpy(masks),
                         torch.from_numpy(gt_valid), train=True, draws=draws)
    for name, v in j_parts.items():
        np.testing.assert_allclose(parts[name].item(), float(v), rtol=1e-4,
                                   err_msg=name)
        assert float(v) > 0, name  # every loss term is live
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-4)

    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in model.named_parameters()])
    want = state_dict_from_jax({"params": jax.device_get(j_grads)})
    for name, g in zip(names, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-8),
                                   err_msg=name)


def test_eval_detections_match_jax(tiny):
    """Inference with the EXTEND tracking prior: the same detections
    (valid flags and classes exactly, boxes atol 1e-3 px, scores atol 1e-5,
    pasted mask probabilities atol 1e-3: a box edge that moves by 1e-3 px
    moves the paste's bilinear weights by about as much)."""
    jmodel, variables, model = tiny
    imgs, masks = scene(1)
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
    assert det.classes.dtype == torch.int32
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(det_j.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(det_j.scores),
                               atol=1e-5)
    np.testing.assert_allclose(det.masks.numpy(), np.asarray(det_j.masks),
                               atol=1e-3)
    assert det.valid.numpy().all()  # both detections of both images live


@pytest.mark.parametrize("use_fast_nms", [True, False])
def test_rpn_matches_jax(use_fast_nms):
    """RPN head, proposal selection (Fast NMS, or greedy NMS through the
    K3 wrapper's twin), anchor matching with the JAX key's sampling
    uniforms, and the RPN losses: identical proposal validity and sampled
    anchors, boxes atol 1e-3 px, scores atol 1e-6, losses rtol 1e-5."""
    from e_osvos_tpu.models.rpn import RPNHead as JRPNHead
    from e_osvos_tpu.models.rpn import assign_rpn_targets as j_assign
    from e_osvos_tpu.models.rpn import rpn_losses as j_rpn_losses
    from e_osvos_tpu.models.rpn import select_proposals as j_select
    from e_osvos_torch.models.rpn import (
        RPNHead,
        assign_rpn_targets,
        rpn_losses,
        select_proposals,
    )

    kw = dict(RPN_KW, use_fast_nms=use_fast_nms)
    jcfg, cfg = JRPNConfig(**kw), RPNConfig(**kw)
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, s, s, 256).astype(np.float32) for s in
             (16, 8, 4, 2, 1)]
    jhead = JRPNHead(num_anchors=3)
    v = random_variables(jhead, 3, jax.random.PRNGKey(0), feats)
    head = RPNHead(256, 3)
    head.load_state_dict(state_dict_from_jax(v), strict=True)
    anchors = j_generate_anchors((SIZE, SIZE), jcfg)

    @jax.jit
    def jax_side(v, feats, key):
        lg, dl = jhead.apply(v, feats)
        props = j_select(jcfg, [jnp.asarray(a) for a in anchors], lg, dl,
                         (SIZE, SIZE))
        all_a = jnp.concatenate([jnp.asarray(a) for a in anchors])
        tgt = j_assign(jcfg, all_a, jnp.asarray([[20.0, 16, 44, 40]]),
                       jnp.asarray([True]), key)
        losses = j_rpn_losses(jcfg, all_a, jnp.concatenate(lg, 1)[0],
                              jnp.concatenate(dl, 1)[0], tgt)
        return props, tgt, losses

    key = jax.random.PRNGKey(5)
    j_props, j_tgt, j_losses = jax_side(v, feats, key)
    with torch.no_grad():
        lg, dl = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
        t_anchors = [torch.from_numpy(a) for a in anchors]
        props = select_proposals(cfg, t_anchors, lg, dl, (SIZE, SIZE))
        kp, kn = jax.random.split(key)
        n = sum(len(a) for a in anchors)
        tgt = assign_rpn_targets(
            cfg, torch.cat(t_anchors), torch.tensor([[20.0, 16, 44, 40]]),
            torch.tensor([True]),
            torch.from_numpy(np.asarray(jax.random.uniform(kp, (n,)))),
            torch.from_numpy(np.asarray(jax.random.uniform(kn, (n,)))))
        losses = rpn_losses(cfg, torch.cat(t_anchors), torch.cat(lg, 1)[0],
                            torch.cat(dl, 1)[0], tgt)
    np.testing.assert_array_equal(props.valid.numpy(), np.asarray(j_props.valid))
    np.testing.assert_allclose(props.boxes.numpy(), np.asarray(j_props.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(props.scores.numpy(),
                               np.asarray(j_props.scores), atol=1e-6)
    assert props.valid.numpy().sum() > 10
    np.testing.assert_array_equal(tgt.labels.numpy(), np.asarray(j_tgt.labels))
    np.testing.assert_array_equal(tgt.sample_mask.numpy(),
                                  np.asarray(j_tgt.sample_mask))
    for got, want in zip(losses, j_losses):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert float(want) > 0


def test_detection_entry_points_default_to_cuda(tiny):
    """Without a card, the detector and its evaluator built without
    device="cpu" raise instead of running on the CPU; with it, the
    ``ona_only_box_head`` mode builds (the host window loop by default)
    and an unknown reset mode raises."""
    from e_osvos_torch.engine import (
        DetectionOneShotConfig,
        DetectionOneShotEvaluator,
    )
    from e_osvos_torch.meta_optim import MetaOptimConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = tiny[2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskRCNN(**MODEL_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionOneShotEvaluator(model, MetaOptimConfig(),
                                  DetectionOneShotConfig())
    ev = DetectionOneShotEvaluator(
        model, MetaOptimConfig(),
        DetectionOneShotConfig(ona_only_box_head=True, online_adapt_step=5),
        device="cpu")
    assert ev.cfg.ona_only_box_head and not ev.fused_ona
    with pytest.raises(ValueError):
        DetectionOneShotEvaluator(model, MetaOptimConfig(),
                                  DetectionOneShotConfig(ona_reset_mode="NONE"),
                                  device="cpu")
