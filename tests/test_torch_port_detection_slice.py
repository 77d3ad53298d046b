"""The port's detection slice as a whole against the JAX package on the CPU:
Mask R-CNN fine-tune on the support frame, frame-by-frame tracking with the
previous frame's boxes as the EXTEND proposal prior, and fused online
adaptation, on the same weights, lrs, frames and random draws.

Tiny Mask R-CNN (resnet10, GroupNorm-4, 64x64, fp32, one detection per
frame), 2 fine-tune steps, OnA every 2 frames for 2 steps, 5 frames. The
augmentation ranges are degenerate (scale 1, no rotation, jitter or flip,
float32 arithmetic); every other draw (anchor and roi sampling, box jitter)
is taken from the JAX keys along the JAX path's own splits and handed to
the port through its one draw function, ``sample_draws``."""

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
from e_osvos_tpu.engine.one_shot import stack_windows as j_stack_windows
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models.rpn import generate_anchors as j_generate_anchors
from e_osvos_tpu.ops.boxes import masks_to_boxes as j_masks_to_boxes
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig, sample_augment_draws
from e_osvos_torch.engine import (
    DetectionOneShotConfig,
    DetectionOneShotEvaluator,
)
from e_osvos_torch.engine.one_shot import build_pseudo_gt
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from test_torch_port_detection_models import (
    SIZE,
    frame_draws_from_key,
    jax_sample_key,
    tiny_pair,
    train_draws_from_key,
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

T = 5
AUG_KW = dict(scale_min=1.0, scale_max=1.0, rot_deg=0.0, brightness=0.0,
              contrast=0.0, saturation=0.0, flip_prob=0.0,
              compute_dtype="float32")
CFG_KW = dict(num_epochs=2, batch_size=3, online_adapt_step=2,
              online_adapt_epochs=2, online_adapt_min_prop=0.75,
              proposal_aug_mode="EXTEND")


class JaxDraws:
    """Stands in for ``DetectionOneShotEvaluator.sample_draws``: the draws
    the JAX fused path takes from ``k_ft`` (fine-tune), ``fold_in(k_win, w)``
    (window w's frames) and ``fold_in(k_ona, w)`` (window w's refit), in
    the order the port asks for them."""

    def __init__(self, jmodel, variables, key, cfg):
        self.jmodel, self.variables, self.cfg = jmodel, variables, cfg
        self.k_ft, self.k_win, self.k_ona = jax.random.split(key, 3)
        self.n_anchors = sum(len(a) for a in j_generate_anchors(
            (SIZE, SIZE), jmodel.rpn))
        self.n_rois = jmodel.rpn.post_nms_top_n + 1
        self.calls = {"fine_tune": 0, "frames": 0, "refit": 0}

    def window_key(self, w):
        return jax.random.fold_in(self.k_win, w)

    def refit_key(self, w):
        return jax.random.fold_in(self.k_ona, w)

    def _train(self, keys, batch):
        steps = [train_draws_from_key(
            jax_sample_key(self.jmodel, self.variables, k), batch,
            self.n_anchors, self.n_rois) for k in keys]
        return type(steps[0])(*(torch.stack(f) for f in zip(*steps)))

    def __call__(self, generator, kind, count, hw):
        w = self.calls[kind]
        self.calls[kind] += 1
        cfg = self.cfg
        if kind == "fine_tune":
            steps = jax.random.split(self.k_ft, count)
            train = self._train([jax.random.split(k)[1] for k in steps],
                                cfg.batch_size)
            aug = sample_augment_draws(generator, AugmentConfig(**AUG_KW),
                                       (count, cfg.batch_size))
            return aug, train
        if kind == "refit":
            keys = jax.random.split(self.refit_key(w), count)
            return self._train(keys, 1 + min(cfg.online_adapt_step,
                                             cfg.batch_size))
        k = self.window_key(w)
        frames = []
        for _ in range(count):
            k, k_s = jax.random.split(k)
            frames.append(frame_draws_from_key(
                jax_sample_key(self.jmodel, self.variables, k_s), 1,
                self.jmodel.rpn.post_nms_top_n))
        return torch.stack(frames)


# The reference's own spread on this sequence: weights scaled by these
# factors move the JAX run's boxes by 0.0056-0.0156 px at 1 ± 1e-6, 0.41 px at
# 1 - 2e-6, 4.19 px at 1 - 3e-6 and 16.65 px at 1 + 3e-6 (probabilities by up
# to 0.69). A refit about 1e-5 away in its parameters takes another branch
# (the RPN's and the box sampler's discrete choices), so the end-to-end
# boxes carry the reference's conditioning, not the port's error
# (scripts/parity_spread.py slice prints these spreads and the stages').
SPREAD_SCALES = (1 + 3e-6, 1 - 3e-6)


def _jax_group(j_ev, variables, lrs, frames, label, key):
    """The JAX fused path of one object group: fine-tuned and refit params,
    each window's (params, carry in, probs, boxes, valid), probs [T-1]."""
    j_meta = JMetaParams(model_init=variables, log_init_lr={"params": lrs})
    k_ft, k_win, k_ona = jax.random.split(key, 3)
    support = jnp.asarray(frames[0])
    j_params, _ = j_ev._jit_ft(j_meta, k_ft, support, label, None)
    boxes0, valid0 = j_masks_to_boxes((label == 1).astype(jnp.float32)[None])
    windows, r, wn_real = j_stack_windows(jnp.asarray(frames[1:]), 2)
    wn = windows.shape[0]
    w_keys = jnp.stack([jax.random.fold_in(k_win, w) for w in range(wn)])
    ona_keys = jnp.stack([jax.random.fold_in(k_ona, w) for w in range(wn)])
    w_flat, j_final = j_ev._fused_propagate((SIZE, SIZE), batched=False)(
        j_meta, support, label, windows, w_keys, ona_keys,
        jax.tree_util.tree_map(jnp.copy, j_params),  # donated
        boxes0, valid0, jnp.int32(wn_real))
    # the per-frame boxes the fused scan carries, from its window body: two
    # windows with one refit between them, so window 1 runs on the final
    # params
    assert wn == wn_real == 2
    out = []
    boxes, valid = boxes0, valid0
    for w, params in enumerate((j_params, j_final)):
        carry = (np.asarray(boxes), np.asarray(valid))
        w_probs, b, v, boxes, valid = j_ev._jit_window(
            params, windows[w], boxes, valid, w_keys[w])
        out.append(dict(params=params, carry=carry, frames=np.asarray(
            windows[w]), probs=np.asarray(w_probs), boxes=np.asarray(b),
            valid=np.asarray(v)))
    probs = np.asarray(w_flat)[:r]
    np.testing.assert_allclose(np.concatenate([o["probs"] for o in out]),
                               probs, atol=1e-6)
    return j_params, j_final, out, probs


def _port_params(j_tree):
    return state_dict_from_jax({"params": jax.device_get(j_tree["params"])})


def _assert_params_close(got, j_tree, what):
    want = _port_params(j_tree)
    for name, p in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{what}: {name}")


def test_detection_slice_matches_jax():
    """Stage by stage on identical inputs, then end to end.

    Fine-tuned params, and the refit's from JAX's fine-tuned params, within
    1e-4 of each tensor's largest magnitude (f32 convolutions and their
    gradients summed in another order, two steps each). Each window run on
    JAX's params, carried boxes and draws: boxes atol 1e-2 px, validity
    flags exactly, probabilities atol 1e-3 (mean 1e-5). End to end, on the
    port's own params: validity flags exactly, boxes and probabilities
    within the JAX reference's own spread under weights scaled by
    ``SPREAD_SCALES`` (measured here and asserted above the old 5e-2 px)."""
    rng = np.random.RandomState(0)
    jmodel, variables, model = tiny_pair(detections_per_img=1)
    index_j = JSyntheticVOSIndex(num_sequences=1, num_frames=T,
                                 size=(SIZE, SIZE), seed=4)
    frames = np.stack([index_j.get_image("seq00", t) for t in range(T)])
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables["params"], "neuron")))

    # ---- JAX: the fused path of eval_sequence, one object group ----
    j_cfg = JDetectionOneShotConfig(augment=JAugmentConfig(**AUG_KW),
                                    **CFG_KW)
    j_ev = JDetectionOneShotEvaluator(
        jmodel, JMetaOptimConfig(use_log_init_lr=False), j_cfg,
        fused_ona=True)
    key = jax.random.PRNGKey(11)
    label = jnp.asarray((index_j.get_label("seq00", 0) == 1).astype(np.int32))
    j_params, j_final, j_windows, j_rest = _jax_group(
        j_ev, variables, lrs, frames, label, key)
    j_probs = np.zeros((T, SIZE, SIZE), np.float32)
    j_probs[0] = np.asarray(label == 1)
    j_probs[1:] = j_rest
    j_boxes = np.concatenate([o["boxes"] for o in j_windows])
    j_valid = np.concatenate([o["valid"] for o in j_windows])

    # the reference's own spread: the same run on weights scaled by 1 ± eps
    box_spread = prob_spread = 0.0
    for s in SPREAD_SCALES:
        scaled = jax.tree_util.tree_map(lambda x: x * np.float32(s), variables)
        _, _, wins, rest = _jax_group(j_ev, scaled, lrs, frames, label, key)
        np.testing.assert_array_equal(
            np.concatenate([o["valid"] for o in wins]), j_valid)
        box_spread = max(box_spread, np.abs(
            np.concatenate([o["boxes"] for o in wins]) - j_boxes).max())
        prob_spread = max(prob_spread, np.abs(rest - j_rest).max())
    assert box_spread > 5e-2, box_spread

    # ---- the port, on the same weights, lrs and draws ----
    sd = state_dict_from_jax(variables)
    names = {n for n, _ in model.named_parameters()}
    meta = MetaParams(model_init={k: v for k, v in sd.items() if k in names},
                      log_init_lr=lr_tree_from_jax(lrs))
    cfg = DetectionOneShotConfig(augment=AugmentConfig(**AUG_KW), **CFG_KW)
    ev = DetectionOneShotEvaluator(model, MetaOptimConfig(use_log_init_lr=False),
                                   cfg, fused_ona=True, device="cpu")
    draws = JaxDraws(jmodel, variables, key, cfg)
    ev.sample_draws = draws
    seen = {"fine_tune": [], "refit": [], "windows": []}
    fine_tune, refit = ev._fine_tune, ev._ona_fine_tune
    segment = ev._segment_window

    def record_fine_tune(*args):
        out = fine_tune(*args)
        seen["fine_tune"].append({k: v.detach().clone()
                                  for k, v in out[0].items()})
        return out

    def record_refit(*args):
        seen["refit"].append(args[2:4])  # the support image and label
        return refit(*args)

    def record_window(*args):
        out = segment(*args)
        seen["windows"].append(out)
        return out

    ev._fine_tune, ev._ona_fine_tune = record_fine_tune, record_refit
    ev._segment_window = record_window
    index = SyntheticVOSIndex(num_sequences=1, num_frames=T, size=(SIZE, SIZE),
                              seed=4)
    seq = index.sequences["seq00"]
    phases = []
    ev.on_phase = phases.append
    probs = ev._eval_object_group(index, seq, torch.from_numpy(frames),
                                  seq.object_groups[0], meta,
                                  torch.Generator().manual_seed(0), None)
    assert phases == ["fine_tune", "propagate"]
    wn = len(j_windows)
    assert draws.calls == {"fine_tune": 1, "frames": wn, "refit": wn - 1}

    # stage 1: the fine-tune
    (got_ft,) = seen["fine_tune"]
    _assert_params_close(got_ft, j_params, "fine-tune")
    moved = sum(not np.array_equal(_port_params(t)[k].numpy(), sd[k].numpy())
                for t in (j_params, j_final) for k in got_ft)
    assert moved > 1.8 * len(got_ft)  # nearly every tensor took steps

    # stage 2: the refit, from JAX's fine-tuned params on JAX's window 0
    ((img, support_label),) = seen["refit"]
    kk = min(cfg.online_adapt_step, cfg.batch_size)
    pseudo = build_pseudo_gt(torch.tensor(j_windows[0]["probs"][-kk:]),
                             cfg.online_adapt_min_prop, None)
    draws.calls["refit"] = 0
    got_refit = ev._ona_fine_tune(
        meta, None, img, support_label,
        torch.tensor(j_windows[0]["frames"][-kk:]), pseudo,
        dict(_port_params(j_params)))
    _assert_params_close(got_refit, j_final, "refit")

    # stage 3: each window on JAX's params, carried boxes and draws
    for w, jw in enumerate(j_windows):
        draws.calls["frames"] = w
        w_probs, b, v, _, _ = segment(
            _port_params(jw["params"]), torch.tensor(jw["frames"]),
            *(torch.tensor(c) for c in jw["carry"]),
            draws(None, "frames", len(jw["frames"]), None))
        np.testing.assert_array_equal(v.numpy(), jw["valid"])
        np.testing.assert_allclose(b.numpy(), jw["boxes"], atol=1e-2)
        np.testing.assert_allclose(w_probs.numpy(), jw["probs"], atol=1e-3)
        assert np.abs(w_probs.numpy() - jw["probs"]).mean() < 1e-5

    # end to end, on the port's own params: within the reference's spread
    got_boxes = np.concatenate([o[1].numpy() for o in seen["windows"]])
    got_valid = np.concatenate([o[2].numpy() for o in seen["windows"]])
    np.testing.assert_array_equal(got_valid, j_valid)
    np.testing.assert_allclose(got_boxes, j_boxes, atol=box_spread + 1e-2)
    # frames without a detection (the previous boxes carry on) and with one
    assert 0 < got_valid.sum() < len(got_valid)

    probs = probs.numpy()
    assert probs.shape == (T, SIZE, SIZE)
    np.testing.assert_array_equal(probs[0], j_probs[0])
    np.testing.assert_allclose(probs, j_probs, atol=prob_spread + 1e-3)
    assert 0.0 < (j_probs[1:] >= 0.5).mean() < 1.0
