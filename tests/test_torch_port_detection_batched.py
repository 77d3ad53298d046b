"""Objects as a batch axis in the port's Mask R-CNN evaluation
(``models/stacked.py`` on ``MaskRCNN``, ``DetectionOneShotEvaluator(
batch_objects=True)``) against the JAX package's vmapped objects and the
port's own loop over objects, on the CPU.

The tiny pair of ``test_torch_port_detection_models.py`` (resnet10 with
GroupNorm-4, 64x64, fp32, one detection per frame), the configuration and
degenerate augmentation of ``test_torch_port_detection_slice.py`` (2
fine-tune steps of 3 images, OnA every 2 frames for 2 steps) and a 2-object
6-frame synthetic sequence (seed 2: the host loop segments windows of 2, 2
and 1 frames, the fused loop pads the last).

The JAX batched path draws object o's random numbers from ``fold_in(k_ft,
o)`` (fine-tune), ``fold_in(fold_in(k_win, w), o)`` (window w's frames) and
``fold_in(fold_in(k_ona, w), o)`` (window w's refit), with ``k_ft, k_win,
k_ona = split(key, 3)``; ``ObjectJaxDraws`` hands them to the port through
``sample_draws``, object o's generator being seeded ``fold_in(seed, o)``.

Tolerances, each stated where it is used: the stacked model against O
separate forwards within f32 rounding of grouped against ungrouped
convolutions (totals rtol 1e-5, gradients 1e-4 of each tensor's largest
entry, boxes 1e-3 px, scores 1e-5, masks 1e-3); stages against the JAX
package as ``test_torch_port_detection_slice.py`` holds them (parameters
1e-4 of each tensor's largest entry; boxes 1e-2 px, probabilities 1e-3);
whole sequences within the spread ``scripts/parity_spread.py
detection-batched`` measures for this sequence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data.synthetic import SyntheticVOSIndex as JSyntheticVOSIndex
from e_osvos_tpu.data.transforms import AugmentConfig as JAugmentConfig
from e_osvos_tpu.engine import (
    DetectionOneShotConfig as JDetectionOneShotConfig,
)
from e_osvos_tpu.engine import (
    DetectionOneShotEvaluator as JDetectionOneShotEvaluator,
)
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.ops.boxes import masks_to_boxes as j_masks_to_boxes
from e_osvos_torch.data.datasets import ObjectGroup, binarize_label
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import (
    DetectionOneShotConfig,
    DetectionOneShotEvaluator,
    fold_in,
)
from e_osvos_torch.engine.one_shot import (
    build_pseudo_gt,
    object_generators,
    stack_for_objects,
)
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams
from e_osvos_torch.meta_optim.lr_tree import init_lr_tree
from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig, TrainDraws
from e_osvos_torch.models import functional_apply
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.models.stacked import (
    object_stacked_apply,
    stack_lrs,
    stack_model,
    stack_objects,
    unstack_objects,
)
from test_torch_port_detection_eval import draws_by_seed
from test_torch_port_detection_models import (
    MODEL_KW,
    ROI_KW,
    RPN_KW,
    SIZE,
    tiny_pair,
)
from test_torch_port_detection_slice import AUG_KW, CFG_KW, JaxDraws

O, T = 2, 6
INDEX_KW = dict(num_sequences=1, num_frames=T, size=(SIZE, SIZE),
                num_objects=O, seed=2)
KEY, SEED = 0, 3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs (the tier-1 command
    shares the host's cores among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class ObjectJaxDraws(JaxDraws):
    """``JaxDraws`` of object ``obj`` under the JAX batched schedule: the
    fine-tune from ``fold_in(k_ft, obj)``, window w's frames from
    ``fold_in(fold_in(k_win, w), obj)``, its refit from
    ``fold_in(fold_in(k_ona, w), obj)``."""

    def __init__(self, jmodel, variables, key, cfg, obj):
        super().__init__(jmodel, variables, key, cfg)
        self.obj = obj
        self.k_ft = jax.random.fold_in(self.k_ft, obj)

    def window_key(self, w):
        return jax.random.fold_in(super().window_key(w), self.obj)

    def refit_key(self, w):
        return jax.random.fold_in(super().refit_key(w), self.obj)


def object_draws(pair, key, seed, cfg):
    """A ``sample_draws`` stand-in giving object o's generator (seed
    ``fold_in(seed, o)``) the JAX batched draws of object o under ``key``,
    and those draws objects by object."""
    draws = {fold_in(seed, o): ObjectJaxDraws(pair["jmodel"],
                                              pair["variables"], key, cfg, o)
             for o in range(O)}
    return draws_by_seed(draws), [draws[fold_in(seed, o)] for o in range(O)]


def make_pair(seed=0):
    """The tiny pair with seeded weights and neuron lrs in both packages."""
    rng = np.random.RandomState(0)
    jmodel, variables, model = tiny_pair(seed, detections_per_img=1)
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables["params"], "neuron")))
    sd = state_dict_from_jax(variables)
    names = {n for n, _ in model.named_parameters()}
    return {"jmodel": jmodel, "variables": variables, "model": model,
            "lrs": lrs,
            "j_meta": JMetaParams(model_init=variables,
                                  log_init_lr={"params": lrs}),
            "meta": MetaParams(
                model_init={k: v for k, v in sd.items() if k in names},
                log_init_lr=lr_tree_from_jax(lrs))}


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def evaluators(pair, fused=True, **kw):
    """The JAX evaluator (objects batched) and the port's, with the
    configuration of the slice test."""
    cfg_kw = dict(CFG_KW, **{k: kw.pop(k) for k in list(kw)
                             if k in ("early_stop_patience", "num_epochs")})
    j_ev = JDetectionOneShotEvaluator(
        pair["jmodel"], JMetaOptimConfig(use_log_init_lr=False),
        JDetectionOneShotConfig(augment=JAugmentConfig(**AUG_KW), **cfg_kw),
        batch_objects=True, fused_ona=fused)
    ev = DetectionOneShotEvaluator(
        pair["model"], MetaOptimConfig(use_log_init_lr=False),
        DetectionOneShotConfig(augment=AugmentConfig(**AUG_KW), **cfg_kw),
        device="cpu", fused_ona=fused, **kw)
    return j_ev, ev


def support(index):
    """The support frame and both objects' labels ``[O, H, W]``."""
    seq = index.sequences["seq00"]
    gt = index.get_label("seq00", 0)
    labels = np.stack([binarize_label(gt, g.object_ids)
                       for g in seq.object_groups]).astype(np.int32)
    return index.get_image("seq00", 0), labels


def perturbed(sd, rng, rel):
    return {k: v * (1 + rel * torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32))) for k, v in sd.items()}


def max_rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-8)


# ---- the model layer -------------------------------------------------------


def test_stack_unstack_round_trip():
    """A Mask R-CNN state dict (frozen-BN backbone: buffers too) and its lr
    trees stack along dim 0 and unstack to the same tensors exactly; the
    stacked model has the stacked entries' shapes, its buffers repeated,
    grouped convolutions and deconvolution, batched dense layers and O·C
    channels; every lr, the deconv's neuron lr (neuron axis first) among
    them, broadcasts against its stacked parameter and keeps each object's
    block."""
    model = MaskRCNN(rpn=RPNConfig(**RPN_KW), roi=RoIConfig(**ROI_KW),
                     device="cpu", **dict(MODEL_KW, backbone_norm="frozen_bn"))
    base = dict(model.state_dict())
    rng = np.random.RandomState(1)
    per = [perturbed(base, rng, 0.1) for _ in range(O)]
    stacked = stack_objects(per)
    back = unstack_objects(stacked, O)
    for o in range(O):
        assert set(back[o]) == set(base)
        assert all(torch.equal(back[o][k], per[o][k]) for k in base)

    smodel = stack_model(model, O)
    ssd = smodel.state_dict()
    assert set(ssd) == set(base)
    for k, v in base.items():
        assert ssd[k].shape == (O * v.shape[0],) + tuple(v.shape[1:]), k
    buffers = dict(model.named_buffers())
    assert buffers
    for k, v in buffers.items():
        assert torch.equal(ssd[k], torch.cat([v] * O)), k
    assert smodel.objects == smodel.rpn_head.objects == O
    assert smodel.box_head.fc6.objects == smodel.box_head.bbox_pred.objects == O
    assert smodel.mask_head.objects == O
    assert smodel.mask_head.deconv.groups == smodel.mask_head.mask_logits.groups == O
    assert smodel.fpn.lateral2.groups == smodel.backbone.stem_conv.groups == O
    assert model.box_head.fc6.objects == 1  # the template is untouched

    params = dict(model.named_parameters())
    sparams = dict(smodel.named_parameters())
    for level in ("neuron", "param", "tensor"):
        lrs = init_lr_tree(params, level)
        lrs = {k: v * (1 + torch.arange(v.numel()).reshape(v.shape))
               for k, v in lrs.items()}
        slrs = stack_lrs(lrs, O)
        for k, lr in slrs.items():
            assert torch.broadcast_shapes(lr.shape, sparams[k].shape) == \
                sparams[k].shape, (level, k)
            if lr.dim() and lr.shape[0] > 1:
                for part in lr.chunk(O):
                    assert torch.equal(part, lrs[k]), (level, k)
    deconv = stack_lrs({"w": torch.ones(256, 1, 1, 1)}, O)["w"]
    assert deconv.shape == (O * 256, 1, 1, 1)


def test_stacked_training_forward_equals_separate(pair):
    """The object-stacked training forward on each object's own weights,
    images, GT and draws against O forwards of the model: each object's
    five losses and total within rtol 1e-5 and each object's gradient
    within 1e-4 of its tensor's largest entry (grouped and batched f32
    products summed in another order)."""
    model = pair["model"]
    apply = functional_apply(model)
    rng = np.random.RandomState(2)
    per = [perturbed(pair["meta"].model_init, rng, 0.05) for _ in range(O)]
    B = 2
    imgs = rng.randn(O, B, SIZE, SIZE, 3).astype(np.float32) * 20
    masks = np.zeros((O, B, 1, SIZE, SIZE), np.float32)
    for o in range(O):
        for b in range(B):
            y, x = rng.randint(8, 30, 2)
            h, w = rng.randint(14, 28, 2)
            imgs[o, b, y:y + h, x:x + w] += 60
            masks[o, b, 0, y - 1:y + h + 1, x - 1:x + w + 1] = 255
            masks[o, b, 0, y:y + h, x:x + w] = 1
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
    valid = torch.ones(O, B, 1, dtype=torch.bool)
    shapes = model.draw_shapes((SIZE, SIZE), B)
    gen = torch.Generator().manual_seed(0)
    draws = [TrainDraws(*(torch.rand(s, generator=gen) for s in shapes))
             for _ in range(O)]
    stacked = {k: v.clone().requires_grad_(True)
               for k, v in stack_objects(per).items()}
    total, parts = object_stacked_apply(apply, O)(
        stacked, imgs, masks, valid, train=True,
        draws=TrainDraws(*(torch.stack(f) for f in zip(*draws))))
    assert total.shape == (O,)
    grads = unstack_objects(dict(zip(stacked, torch.autograd.grad(
        total.sum(), list(stacked.values())))), O)
    for o in range(O):
        p = {k: v.clone().requires_grad_(True) for k, v in per[o].items()}
        t, pa = apply(p, imgs[o], masks[o], valid[o], train=True,
                      draws=draws[o])
        for name, v in pa.items():
            np.testing.assert_allclose(parts[name][o].item(), v.item(),
                                       rtol=1e-5, err_msg=name)
            assert v.item() > 0, name
        np.testing.assert_allclose(total[o].item(), t.item(), rtol=1e-5)
        g = torch.autograd.grad(t, list(p.values()))
        for k, want in zip(p, g):
            assert max_rel(grads[o][k], want) < 1e-4, (o, k)


def test_stacked_inference_equals_separate(pair):
    """The object-stacked inference with the EXTEND tracking prior on two
    shared images against O forwards: valid flags and classes exactly,
    boxes within 1e-3 px, scores 1e-5, pasted masks 1e-3. Object 0 carries
    boxes, object 1 carries none (its prior is empty)."""
    model = pair["model"]
    apply = functional_apply(model)
    rng = np.random.RandomState(3)
    per = [perturbed(pair["meta"].model_init, rng, 0.05) for _ in range(O)]
    index = SyntheticVOSIndex(**dict(INDEX_KW, num_sequences=1))
    imgs = torch.from_numpy(np.stack([index.get_image("seq00", t)
                                      for t in (1, 2)])).float() - 100.0
    prev = torch.tensor([[[[20.0, 18, 44, 40]], [[5.0, 30, 30, 60]]],
                         [[[0.0, 0, 0, 0]], [[0.0, 0, 0, 0]]]])
    prev_valid = torch.tensor([[[True], [True]], [[False], [False]]])
    u = torch.rand((O, 2, RPN_KW["post_nms_top_n"], 4),
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        det = object_stacked_apply(apply, O)(
            stack_objects(per), imgs, prev_boxes=prev, prev_valid=prev_valid,
            proposal_aug_mode="EXTEND", draws=u)
        for o in range(O):
            want = apply(per[o], imgs, prev_boxes=prev[o],
                         prev_valid=prev_valid[o],
                         proposal_aug_mode="EXTEND", draws=u[o])
            assert det.masks[o].shape == want.masks.shape
            np.testing.assert_array_equal(det.valid[o], want.valid)
            np.testing.assert_array_equal(det.classes[o], want.classes)
            np.testing.assert_allclose(det.boxes[o], want.boxes, atol=1e-3)
            np.testing.assert_allclose(det.scores[o], want.scores, atol=1e-5)
            np.testing.assert_allclose(det.masks[o], want.masks, atol=1e-3)
    assert det.valid.all()
    assert float(det.masks.amax()) > 0.5


@pytest.mark.parametrize("objects", [2, 3, 4, 5])
@pytest.mark.parametrize("n,m,c", [(3, 240 * 427, 64), (3, 120 * 214, 256),
                                   (4, 60 * 107, 512), (1, 30 * 54, 1024),
                                   (4, 15 * 27, 2048)])
def test_kernel_geometry_at_stacked_backbone_widths(objects, n, m, c):
    """The stacked backbone's GroupNorm-32 of O objects (O·C channels, O·32
    groups, ``models/stacked.py``) at 480x854 passes the K1/K2 wrappers'
    group check; a finalize block takes whole groups within its shared
    memory; the sweep tiling covers each channel once, one wave of blocks
    or so (the invariants ``test_torch_port_gn_coeffs.py`` holds at the
    unstacked shapes)."""
    from e_osvos_torch.ops import cuda_group_norm as K

    c, g = objects * c, objects * 32
    K.check_groups(c, g)
    gpb = K.finalize_groups(c, g)
    assert gpb * (c // g) <= max(K.FINALIZE_CHANNELS, c // g)
    assert (2 * gpb * (c // g) + 4 * gpb) * 4 <= K.MAX_FINALIZE_SMEM
    for min_rows in (K.MIN_CHUNK_ROWS, 1):
        t = K.sweep_tiling(n, m, c, 2, True, min_rows)
        assert t.vec == 8 and t.lanes * t.vec * t.cslices >= c
        assert (t.cslices - 1) * t.lanes * t.vec < c
        assert (t.chunks - 1) * t.rows_per_chunk < m <= t.chunks * t.rows_per_chunk
        assert t.rows_per_chunk % (K.THREADS // t.lanes) == 0
        blocks = t.chunks * t.cslices * n
        assert blocks <= max(K.BLOCKS_PER_SM * K.H100_SMS, n * t.cslices)


# ---- the engine layer ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_stages(pair):
    """The JAX stages of the batched path per object, on the keys the
    vmapped program gives object o: the fine-tune (``_jit_ft`` on
    ``fold_in(k_ft, o)``), window 0 from the fine-tuned params and the
    support boxes (``_jit_window`` on ``fold_in(fold_in(k_win, 0), o)``),
    and the refit after it (``_jit_ona_ft`` on ``fold_in(fold_in(k_ona,
    0), o)``)."""
    j_ev, _ = evaluators(pair)
    index = JSyntheticVOSIndex(**INDEX_KW)
    img, labels = support(index)
    frames = np.stack([index.get_image("seq00", t) for t in (1, 2)])
    k_ft, k_win, k_ona = jax.random.split(jax.random.PRNGKey(KEY), 3)
    kk = min(CFG_KW["online_adapt_step"], CFG_KW["batch_size"])
    out = []
    for o in range(O):
        label = jnp.asarray(labels[o])
        params, _ = j_ev._jit_ft(pair["j_meta"], jax.random.fold_in(k_ft, o),
                                 jnp.asarray(img), label, None)
        boxes0, valid0 = j_masks_to_boxes((label == 1).astype(
            jnp.float32)[None])
        probs, boxes, valid, _, _ = j_ev._jit_window(
            params, jnp.asarray(frames), boxes0, valid0,
            jax.random.fold_in(jax.random.fold_in(k_win, 0), o))
        pseudo = build_pseudo_gt(torch.tensor(np.asarray(probs)[-kk:]),
                                 CFG_KW["online_adapt_min_prop"], None)
        refit, _ = j_ev._jit_ona_ft(
            pair["j_meta"], jax.random.fold_in(jax.random.fold_in(k_ona, 0), o),
            jnp.asarray(img), label, jnp.asarray(frames[-kk:]),
            jnp.asarray(pseudo.numpy()),
            jax.tree_util.tree_map(jnp.copy, params))  # donated
        out.append(dict(params=params, probs=np.asarray(probs),
                        boxes=np.asarray(boxes), valid=np.asarray(valid),
                        boxes0=np.asarray(boxes0), valid0=np.asarray(valid0),
                        pseudo=pseudo, refit=refit))
    return img, labels, frames, out


def _port_params(j_tree):
    return state_dict_from_jax({"params": jax.device_get(j_tree["params"])})


def _assert_params_close(got, want, what):
    """Each tensor within 1e-4 of its largest magnitude (the slice test's
    tolerance: f32 convolutions and their gradients in another order)."""
    for name, p in got.items():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{what}: {name}")


def test_batched_fine_tune_matches_jax(pair, jax_stages):
    """The object-stacked fine-tune, each object on its JAX batched draws
    (``fold_in(k_ft, o)``), against the JAX fine-tune of each object: every
    parameter within 1e-4 of its tensor's largest magnitude; one loss an
    object and step."""
    img, labels, _, stages = jax_stages
    _, ev = evaluators(pair)
    ev.sample_draws, draws = object_draws(pair, jax.random.PRNGKey(KEY),
                                          SEED, ev.cfg)
    _, meta, init = stack_for_objects(ev.model_apply, ev.meta_cfg,
                                      pair["meta"], None, O)
    params, losses = ev._fine_tune(meta, object_generators(SEED, O),
                                   torch.from_numpy(img),
                                   torch.from_numpy(labels), init)
    assert losses.shape == (CFG_KW["num_epochs"], O)
    assert [d.calls["fine_tune"] for d in draws] == [1] * O
    got = unstack_objects(params, O)
    for o in range(O):
        _assert_params_close(got[o], _port_params(stages[o]["params"]),
                             f"object {o}")


def test_batched_window_and_refit_match_jax(pair, jax_stages):
    """On JAX's fine-tuned params of each object, stacked: the stacked
    window (each object's carried boxes and JAX draws) against JAX's window
    of each object (validity exactly, boxes within 1e-2 px, probabilities
    1e-3); the stacked refit on JAX's pseudo labels against JAX's refit of
    each object (parameters within 1e-4 of each tensor's largest
    magnitude)."""
    img, labels, frames, stages = jax_stages
    _, ev = evaluators(pair)
    ev.sample_draws, draws = object_draws(pair, jax.random.PRNGKey(KEY),
                                          SEED, ev.cfg)
    gens = object_generators(SEED, O)
    stacked = stack_objects([_port_params(st["params"]) for st in stages])
    probs, boxes, valid, _, _ = ev._segment_window(
        stacked, torch.from_numpy(frames),
        torch.from_numpy(np.stack([st["boxes0"] for st in stages])),
        torch.from_numpy(np.stack([st["valid0"] for st in stages])),
        ev._draws(gens, "frames", len(frames), (SIZE, SIZE)))
    assert probs.shape == (O, len(frames), SIZE, SIZE)
    for o, st in enumerate(stages):
        np.testing.assert_array_equal(valid[o].numpy(), st["valid"])
        np.testing.assert_allclose(boxes[o].numpy(), st["boxes"], atol=1e-2)
        np.testing.assert_allclose(probs[o].numpy(), st["probs"], atol=1e-3)
    assert any(st["valid"].any() for st in stages)  # a detection, at least

    _, meta, _ = stack_for_objects(ev.model_apply, ev.meta_cfg, pair["meta"],
                                   None, O)
    kk = len(stages[0]["pseudo"])
    refit = ev._ona_fine_tune(
        meta, gens, torch.from_numpy(img), torch.from_numpy(labels),
        torch.from_numpy(frames[-kk:]),
        torch.stack([st["pseudo"] for st in stages]), dict(stacked))
    assert [d.calls for d in draws] == [
        {"fine_tune": 0, "frames": 1, "refit": 1}] * O
    got = unstack_objects(refit, O)
    for o, st in enumerate(stages):
        _assert_params_close(got[o], _port_params(st["refit"]),
                             f"refit of object {o}")


# The port's own loop on this sequence moves its probabilities by up to
# 2.1e-3 when the weights are scaled by 1 ± 1e-6 (by 0.5-0.7 at 1 ± 3e-6
# and on the seeds 0-10 tried, a refit or a proposal changing sides);
# batched and in turn differ by rounding alone (1.3e-4 here, measured by
# scripts/parity_spread.py detection-batched).
LOOP_SPREAD = 2e-3


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_batched_eval_sequence_matches_loop(pair, fused):
    """Batched ``eval_sequence`` against the port's loop over objects on
    the same draws (object o's generator ``fold_in(seed, o)`` either way):
    probabilities within ``LOOP_SPREAD`` with a mean under 1e-5, merged
    maps equal wherever every probability is clear of the threshold by
    1e-2; one fine-tune and one propagate phase batched, one of each an
    object in turn; each object asks for the draws of windows of 2, 2 and
    2 (fused) or 1 (host) frames and two refits."""
    index = SyntheticVOSIndex(**INDEX_KW)
    res, phases, counts = {}, {}, {}
    for batched in (True, False):
        _, ev = evaluators(pair, fused, batch_objects=batched)
        phases[batched], counts[batched] = [], []
        ev.on_phase = phases[batched].append
        sample = ev.sample_draws

        def counting(gen, kind, count, hw, sample=sample, batched=batched):
            counts[batched].append((gen.initial_seed(), kind, count))
            return sample(gen, kind, count, hw)

        ev.sample_draws = counting
        res[batched] = ev.eval_sequence(index, "seq00", pair["meta"], SEED)
    assert phases[True] == ["fine_tune", "propagate", "score"]
    assert phases[False] == ["fine_tune", "propagate"] * O + ["score"]
    tail = 2 if fused else 1
    for o in range(O):
        want = [("fine_tune", 2), ("frames", 2), ("refit", 2), ("frames", 2),
                ("refit", 2), ("frames", tail)]
        for b in (True, False):
            assert [c[1:] for c in counts[b]
                    if c[0] == fold_in(SEED, o)] == want
    got, loop = res[True]["probs"].numpy(), res[False]["probs"].numpy()
    assert got.shape == (O, T, SIZE, SIZE)
    np.testing.assert_allclose(got, loop, rtol=0, atol=LOOP_SPREAD)
    assert np.abs(got - loop).mean() < 1e-5
    assert 0.0 < (loop[:, 1:] >= 0.5).mean() < 1.0
    sure = (np.abs(loop - 0.5) > 1e-2).all(0)
    np.testing.assert_array_equal(res[True]["merged"][sure],
                                  res[False]["merged"][sure])


def _scaled_meta(meta, s):
    return meta._replace(model_init={k: v * np.float32(s)
                                     for k, v in meta.model_init.items()})


@pytest.mark.slow
@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_batched_eval_sequence_matches_jax(pair, fused):
    """Batched ``eval_sequence`` against the JAX evaluator's with
    ``batch_objects=True`` on the same weights, lrs and draws: within the
    JAX reference's own spread on this sequence (its run with the weights
    scaled by 1 ± 1e-6, measured here) plus 1e-3, with a mean error under
    1e-5. About 3 min a loop on two threads (three runs of the vmapped JAX
    programs, whose grouped convolutions XLA:CPU runs slowly), hence slow,
    as the JAX side marks its own batched tests."""
    j_ev, ev = evaluators(pair, fused)
    key = jax.random.PRNGKey(KEY)
    want = j_ev.eval_sequence(JSyntheticVOSIndex(**INDEX_KW), "seq00",
                              pair["j_meta"], key)
    j_probs = np.asarray(want["probs"])
    spread = 0.0
    for s in (1 + 1e-6, 1 - 1e-6):
        variables = jax.tree_util.tree_map(
            lambda x: np.asarray(x) * np.float32(s), pair["variables"])
        other = j_ev.eval_sequence(
            JSyntheticVOSIndex(**INDEX_KW), "seq00",
            pair["j_meta"]._replace(model_init=variables), key)
        spread = max(spread, float(np.abs(np.asarray(other["probs"])
                                          - j_probs).max()))
    ev.sample_draws, draws = object_draws(pair, key, SEED, ev.cfg)
    got = ev.eval_sequence(SyntheticVOSIndex(**INDEX_KW), "seq00",
                           pair["meta"], SEED)
    for d in draws:
        assert d.calls == {"fine_tune": 1, "frames": 3, "refit": 2}
    probs = got["probs"].numpy()
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=spread + 1e-3)
    assert np.abs(probs - j_probs).mean() < 1e-5
    assert 0.0 < (j_probs[:, 1:] >= 0.5).mean() < 1.0


def test_distinct_support_frames_take_the_loop(pair):
    """Groups with different support frames run in turn (a fine-tune and
    a propagate phase each), exactly as ``batch_objects=False`` runs
    them."""
    index = SyntheticVOSIndex(**INDEX_KW)
    seq = index.sequences["seq00"]
    seq.object_groups = [seq.object_groups[0],
                         ObjectGroup(object_ids=(2,), support_frame=1)]
    _, ev = evaluators(pair)
    phases = []
    ev.on_phase = phases.append
    got = ev.eval_sequence(index, "seq00", pair["meta"], SEED)
    assert phases == ["fine_tune", "propagate"] * O + ["score"]
    _, loop = evaluators(pair, batch_objects=False)
    want = loop.eval_sequence(index, "seq00", pair["meta"], SEED)
    np.testing.assert_array_equal(got["probs"].numpy(),
                                  want["probs"].numpy())


def test_batch_objects_default_and_off(pair):
    """Objects are batched by default, in the evaluator and in the one
    ``cli.evaluate`` builds for a Mask R-CNN; ``batch_objects=False`` runs
    the groups in turn."""
    from e_osvos_torch.cli.evaluate import build_evaluator

    _, ev = evaluators(pair)
    assert ev.batch_objects
    cfg = {"parent_model": {"architecture": "MaskRCNN"}, "device": "cpu"}
    built = build_evaluator(cfg, pair["model"])
    assert isinstance(built, DetectionOneShotEvaluator) and built.batch_objects
    _, loop = evaluators(pair, batch_objects=False)
    phases = []
    loop.on_phase = phases.append
    res = loop.eval_sequence(SyntheticVOSIndex(**INDEX_KW), "seq00",
                             pair["meta"], SEED)
    assert phases == ["fine_tune", "propagate"] * O + ["score"]
    assert res["probs"].shape == (O, T, SIZE, SIZE)


def test_early_stop_latch_is_per_object(pair):
    """With the latch on (patience 1, 5 steps, the lrs at a tenth, seed 6:
    object 0 stops after its fourth step, object 1 runs to the end), the
    stacked fine-tune gives each object what its own fine-tune gives: the
    same steps reported +inf, the other losses within rtol 1e-4 and the
    parameters within 1e-4 of each tensor's largest magnitude."""
    index = SyntheticVOSIndex(**INDEX_KW)
    img, labels = (torch.from_numpy(a) for a in support(index))
    meta = pair["meta"]._replace(log_init_lr={
        k: v * 0.1 for k, v in pair["meta"].log_init_lr.items()})
    _, ev = evaluators(pair, early_stop_patience=1, num_epochs=5)
    _, stacked, _ = stack_for_objects(ev.model_apply, ev.meta_cfg, meta,
                                      None, O)
    params, losses = ev._fine_tune(stacked, object_generators(6, O), img,
                                   labels, None)
    got = unstack_objects(params, O)
    for o in range(O):
        p, l = ev._fine_tune(meta, object_generators(6, O)[o], img,
                             labels[o], None)
        np.testing.assert_array_equal(torch.isinf(losses[:, o]),
                                      torch.isinf(l))
        ok = torch.isfinite(l)
        np.testing.assert_allclose(losses[ok, o], l[ok], rtol=1e-4)
        _assert_params_close(got[o], p, f"object {o}")
    assert torch.isinf(losses).sum(0).tolist() == [1, 0], losses
