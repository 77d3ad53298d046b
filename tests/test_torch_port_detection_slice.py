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
            keys = jax.random.split(jax.random.fold_in(self.k_ona, w), count)
            return self._train(keys, 1 + min(cfg.online_adapt_step,
                                             cfg.batch_size))
        k = jax.random.fold_in(self.k_win, w)
        frames = []
        for _ in range(count):
            k, k_s = jax.random.split(k)
            frames.append(frame_draws_from_key(
                jax_sample_key(self.jmodel, self.variables, k_s), 1,
                self.jmodel.rpn.post_nms_top_n))
        return torch.stack(frames)


def test_detection_slice_matches_jax():
    """Fine-tuned and refit params within 1e-4 of each tensor's largest
    magnitude (f32 convolutions and their gradients summed in another
    order, two steps each); per-frame detection boxes atol 1e-2 px and validity flags
    exactly; probabilities atol 1e-3 (the pasted masks move with their
    boxes)."""
    rng = np.random.RandomState(0)
    jmodel, variables, model = tiny_pair(detections_per_img=1)
    index_j = JSyntheticVOSIndex(num_sequences=1, num_frames=T,
                                 size=(SIZE, SIZE), seed=4)
    seq_j = index_j.sequences["seq00"]
    frames = np.stack([index_j.get_image("seq00", t) for t in range(T)])
    lrs = jax.tree_util.tree_map(
        lambda l: rng.uniform(1e-3, 1e-2, np.shape(l)).astype(np.float32),
        jax.device_get(j_init_lr_tree(variables["params"], "neuron")))

    # ---- JAX: the fused path of eval_sequence, one object group ----
    j_cfg = JDetectionOneShotConfig(augment=JAugmentConfig(**AUG_KW),
                                    **CFG_KW)
    j_meta = JMetaParams(model_init=variables, log_init_lr={"params": lrs})
    j_ev = JDetectionOneShotEvaluator(
        jmodel, JMetaOptimConfig(use_log_init_lr=False), j_cfg,
        fused_ona=True)
    key = jax.random.PRNGKey(11)
    k_ft, k_win, k_ona = jax.random.split(key, 3)
    label = jnp.asarray((index_j.get_label("seq00", 0) == 1).astype(np.int32))
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
    j_probs = np.zeros((T, SIZE, SIZE), np.float32)
    j_probs[0] = np.asarray(label == 1)
    j_probs[1:] = np.asarray(w_flat)[:r]
    # the per-frame boxes the fused scan carries, from its window body: two
    # windows with one refit between them, so window 1 runs on the final
    # params
    assert wn == wn_real == 2
    j_boxes, j_valid = [], []
    boxes, valid = boxes0, valid0
    for w, params in enumerate((j_params, j_final)):
        w_probs, b, v, boxes, valid = j_ev._jit_window(
            params, windows[w], boxes, valid, w_keys[w])
        j_boxes.append(np.asarray(b))
        j_valid.append(np.asarray(v))
        np.testing.assert_allclose(np.asarray(w_probs),
                                   j_probs[1 + 2 * w:3 + 2 * w], atol=1e-6)

    # ---- the port, on the same weights, lrs and draws ----
    sd = state_dict_from_jax(variables)
    names = {n for n, _ in model.named_parameters()}
    meta = MetaParams(model_init={k: v for k, v in sd.items() if k in names},
                      log_init_lr=lr_tree_from_jax(lrs))
    cfg = DetectionOneShotConfig(augment=AugmentConfig(**AUG_KW), **CFG_KW)
    ev = DetectionOneShotEvaluator(model, MetaOptimConfig(use_log_init_lr=False),
                                   cfg, fused_ona=True, device="cpu")
    ev.sample_draws = JaxDraws(jmodel, variables, key, cfg)
    seen = {"fine_tune": [], "refit": [], "windows": []}
    fine_tune, refit = ev._fine_tune, ev._ona_fine_tune
    segment = ev._segment_window

    def record_fine_tune(*args):
        out = fine_tune(*args)
        seen["fine_tune"].append({k: v.detach().clone()
                                  for k, v in out[0].items()})
        return out

    def record_refit(*args):
        out = refit(*args)
        seen["refit"].append({k: v.detach().clone() for k, v in out.items()})
        return out

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
    assert ev.sample_draws.calls == {"fine_tune": 1, "frames": wn,
                                     "refit": wn_real - 1}

    # the fine-tuned params, then the refit's
    ((got_ft,), (got_refit,)) = seen["fine_tune"], seen["refit"]
    moved = 0
    for got, j_tree in ((got_ft, j_params), (got_refit, j_final)):
        want = state_dict_from_jax({"params": jax.device_get(j_tree["params"])})
        for name, p in got.items():
            w = want[name].numpy()
            np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
            moved += not np.array_equal(w, sd[name].numpy())
    assert moved > 1.8 * len(got_ft)  # nearly every tensor took steps

    got_boxes = np.concatenate([o[1].numpy() for o in seen["windows"]])
    got_valid = np.concatenate([o[2].numpy() for o in seen["windows"]])
    np.testing.assert_array_equal(got_valid, np.concatenate(j_valid))
    np.testing.assert_allclose(got_boxes, np.concatenate(j_boxes), atol=5e-2)
    # frames without a detection (the previous boxes carry on) and with one
    assert 0 < got_valid.sum() < len(got_valid)

    probs = probs.numpy()
    assert probs.shape == (T, SIZE, SIZE)
    np.testing.assert_allclose(probs, j_probs, atol=1e-2)
    assert np.abs(probs - j_probs).mean() < 1e-5
    assert 0.0 < (j_probs[1:] >= 0.5).mean() < 1.0
