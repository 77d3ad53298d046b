"""The port's one-shot slice as a whole against the JAX package on the CPU:
fine-tune on the support frame, windowed online adaptation, threshold and
bit-pack, on the same weights, lrs and frames.

resnet10 frozen-BN backbone, group16 head, os16, fp32, 32x48, 7 frames; the
augmentation ranges are degenerate (scale 1, no rotation, jitter or flip,
float32 arithmetic), so neither side's random draws change the result."""

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
from e_osvos_tpu.meta_optim.lr_tree import init_lr_tree as j_init_lr_tree
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.ops.bits import pack_mask_bits as j_pack
from e_osvos_torch.data.synthetic import SyntheticVOSIndex
from e_osvos_torch.data.transforms import AugmentConfig
from e_osvos_torch.engine import OneShotConfig, OneShotEvaluator
from e_osvos_torch.engine.one_shot import fine_tune_on_support
from e_osvos_torch.meta_optim import MetaOptimConfig, MetaParams
from e_osvos_torch.models import DeepLabV3Plus, functional_apply
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.ops.bits import pack_mask_bits
from test_torch_port_models import randomized_variables


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

H, W, T = 32, 48, 7
MODEL_KW = dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                head_norm="group16", output_stride=16)
AUG_KW = dict(scale_min=1.0, scale_max=1.0, rot_deg=0.0, brightness=0.0,
              contrast=0.0, saturation=0.0, flip_prob=0.0,
              compute_dtype="float32")
CFG_KW = dict(num_epochs=3, batch_size=3, loss_func="dice",
              online_adapt_step=2, online_adapt_epochs=2,
              online_adapt_min_prop=0.75)


def test_one_shot_slice_matches_jax():
    """Fine-tuned params within 1e-4 of each tensor's largest magnitude
    (f32 convolutions and their gradients summed in another order, through
    three steps); window probs atol 1e-4;
    packed masks equal wherever the JAX prob is more than 1e-3 from the
    threshold."""
    rng = np.random.RandomState(0)
    index_j = JSyntheticVOSIndex(num_sequences=1, num_frames=T, size=(H, W),
                                 seed=2)
    seq_j = index_j.sequences["seq00"]
    frames = np.stack([index_j.get_image("seq00", t) for t in range(T)])

    jmodel = JDeepLabV3Plus(**MODEL_KW)
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), 9)
    # random neuron lrs for the params; the frozen constants get lr 0, as
    # JAX init_meta_params gives them (the port keeps them as buffers)
    lrs = jax.device_get(j_init_lr_tree(variables, "neuron", use_log=False))
    lrs = {
        "params": jax.tree_util.tree_map(
            lambda l: rng.uniform(0.01, 0.1, np.shape(l)).astype(np.float32),
            lrs["params"]),
        "constants": jax.tree_util.tree_map(np.zeros_like, lrs["constants"]),
    }
    j_meta_cfg = JMetaOptimConfig(use_log_init_lr=False)
    j_meta = JMetaParams(model_init=variables, log_init_lr=lrs)
    j_cfg = JOneShotConfig(augment=JAugmentConfig(**AUG_KW), **CFG_KW)
    j_ev = JOneShotEvaluator(jmodel.apply, j_meta_cfg, j_cfg, fused_ona=True)
    key = jax.random.PRNGKey(4)
    frames_j = jnp.asarray(frames)
    group_j = seq_j.object_groups[0]
    j_probs = np.asarray(j_ev._eval_object_group(
        index_j, seq_j, frames_j, group_j, j_meta, key, None))
    # the fine-tune alone: the same jitted program _eval_object_group runs
    from e_osvos_tpu.data.datasets import binarize_label as j_binarize

    label_j = jnp.asarray(j_binarize(index_j.get_label("seq00", 0),
                                     group_j.object_ids), jnp.int32)
    j_params, _ = j_ev._jit_ft(j_meta, jax.random.split(key)[0], frames_j[0],
                               label_j, None)

    model = DeepLabV3Plus(device="cpu", **MODEL_KW)
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    names = {n for n, _ in model.named_parameters()}
    meta = MetaParams(model_init={k: v for k, v in sd.items() if k in names},
                      log_init_lr=lr_tree_from_jax(lrs))
    meta_cfg = MetaOptimConfig(use_log_init_lr=False)
    cfg = OneShotConfig(augment=AugmentConfig(**AUG_KW), **CFG_KW)
    apply = functional_apply(model)
    index = SyntheticVOSIndex(num_sequences=1, num_frames=T, size=(H, W),
                              seed=2)
    seq = index.sequences["seq00"]
    frames_t = torch.from_numpy(frames)
    ev = OneShotEvaluator(apply, meta_cfg, cfg, device="cpu", fused_ona=True)
    probs = ev._eval_object_group(index, seq, frames_t, seq.object_groups[0],
                                  meta, torch.Generator().manual_seed(0),
                                  None)

    label_t = torch.from_numpy(np.array(label_j))
    params, _ = fine_tune_on_support(apply, meta_cfg, cfg, meta,
                                     torch.Generator().manual_seed(1),
                                     frames_t[0], label_t)
    want = state_dict_from_jax(jax.device_get(j_params))
    moved = 0
    for name, p in params.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
        moved += not np.array_equal(want[name].numpy(), sd[name].numpy())
    assert moved == len(params)  # every parameter took a step

    probs = probs.numpy()
    assert probs.shape == j_probs.shape == (T, H, W)
    np.testing.assert_allclose(probs, j_probs, atol=1e-4)
    packed = pack_mask_bits(torch.from_numpy(probs >= 0.5)).numpy()
    j_packed = np.asarray(j_pack(j_probs >= 0.5))
    np.testing.assert_array_equal(packed.shape, j_packed.shape)
    sure = np.abs(j_probs - 0.5) > 1e-3
    np.testing.assert_array_equal(
        np.unpackbits(packed, axis=-1)[..., :W][sure],
        np.unpackbits(j_packed, axis=-1)[..., :W][sure])
    # the sequence is not trivially all one class
    assert 0.0 < (j_probs[1:] >= 0.5).mean() < 1.0


def test_packed_ona_equals_evaluator_masks():
    """``one_shot_packed_ona`` (the serving form: fine-tune, windowed OnA,
    threshold, bit-pack) gives the evaluator's masks for the frames after
    the support frame, bit for bit, with the same draws."""
    from e_osvos_torch.engine import one_shot_packed_ona, stack_windows
    from e_osvos_torch.meta_optim import init_meta_params

    index = SyntheticVOSIndex(num_sequences=1, num_frames=T, size=(H, W),
                              seed=2)
    seq = index.sequences["seq00"]
    frames = torch.from_numpy(np.stack(
        [index.get_image("seq00", t) for t in range(T)]))
    model = DeepLabV3Plus(device="cpu", seed=3, **MODEL_KW)
    apply = functional_apply(model)
    meta_cfg = MetaOptimConfig(init_lr=1e-2, use_log_init_lr=False)
    meta = init_meta_params(meta_cfg, model)
    cfg = OneShotConfig(**CFG_KW)  # default augmentation ranges
    phases = []
    ev = OneShotEvaluator(apply, meta_cfg, cfg, device="cpu",
                          on_phase=phases.append, fused_ona=True)
    probs = ev._eval_object_group(index, seq, frames, seq.object_groups[0],
                                  meta, torch.Generator().manual_seed(8), None)
    assert phases == ["fine_tune", "propagate"]
    label = torch.from_numpy(index.get_label("seq00", 0).astype(np.int32))
    windows, r, wn = stack_windows(frames[1:], cfg.online_adapt_step)
    packed = one_shot_packed_ona(apply, meta_cfg, cfg, None, meta,
                                 torch.Generator().manual_seed(8), frames[0],
                                 label, windows, wn)
    assert packed.shape == (wn * cfg.online_adapt_step, H, W // 8)
    np.testing.assert_array_equal(
        packed[:r].numpy(), pack_mask_bits(probs[1:] >= 0.5).numpy())
