"""The port's truncated-BPTT meta-gradient (e_osvos_torch.meta_optim
``meta_loss`` / ``meta_grads``) against the JAX package on the CPU.

A tiny DeepLabV3+ (resnet10 frozen-BN backbone, group4 head, os16, fp32,
32x32) on identical weights, log-lrs and frames: first order (the path on
the card, through the GroupNorm kernels' CPU twins), second order with the
plain ``*_xla`` norms, second order restricted to subtrees, segment
weights, the truncation, the NaN guard, and the frozen-BN constants'
meta-gradient.

Tolerances: the meta-loss and the train losses rtol 1e-5; every
meta-gradient within 1e-4 of its tensor's largest magnitude (f32
convolutions and their gradients summed in another order through a chain
of inner steps). The JAX package moves the frozen constants in the inner
steps by its lr floor e^-33 ≈ 5e-15 times their gradient; the port leaves
them unchanged, far inside these tolerances.
"""

import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.data import transforms as jt
from e_osvos_tpu.meta_optim import MetaOptimConfig as JMetaOptimConfig
from e_osvos_tpu.meta_optim import MetaParams as JMetaParams
from e_osvos_tpu.meta_optim import init_meta_params as j_init_meta_params
from e_osvos_tpu.meta_optim import meta_grads as j_meta_grads
from e_osvos_tpu.meta_optim import meta_loss as j_meta_loss
from e_osvos_tpu.models import DeepLabV3Plus as JDeepLabV3Plus
from e_osvos_tpu.ops import losses as jl
from e_osvos_torch.data import transforms as tt
from e_osvos_torch.meta_optim import (
    MetaOptimConfig,
    MetaParams,
    meta_grads,
    meta_loss,
)
from e_osvos_torch.models import DeepLabV3Plus, functional_apply
from e_osvos_torch.models.jax_weights import (
    lr_tree_from_jax,
    state_dict_from_jax,
)
from e_osvos_torch.ops import losses as tl
from test_torch_port_models import randomized_variables

S = 32
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 command runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_kw(head_norm="group4"):
    return dict(num_classes=1, arch="resnet10", backbone_norm="frozen_bn",
                head_norm=head_norm, output_stride=16)


@functools.lru_cache(maxsize=None)
def jax_pair(head_norm="group4"):
    """(JAX model, variables, JAX meta-params with log lrs) at seeded
    weights; the constants keep the lr floor JAX init_meta_params gives
    them."""
    jmodel = JDeepLabV3Plus(**model_kw(head_norm))
    variables = randomized_variables(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))), 11)
    rng = np.random.RandomState(1)
    j_meta = j_init_meta_params(JMetaOptimConfig(), variables)
    lrs = dict(j_meta.log_init_lr)
    lrs["params"] = jax.tree_util.tree_map(
        lambda l: np.log(rng.uniform(0.02, 0.2, np.shape(l))).astype(
            np.float32), jax.device_get(lrs["params"]))
    return jmodel, variables, JMetaParams(variables, lrs)


def port_meta(head_norm="group4"):
    _, variables, j_meta = jax_pair(head_norm)
    model = DeepLabV3Plus(device="cpu", **model_kw(head_norm))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    meta = MetaParams(state_dict_from_jax(variables),
                      lr_tree_from_jax(j_meta.log_init_lr))
    assert set(meta.log_init_lr) == {n for n, _ in model.named_parameters()}
    return model, meta


def frames(seed, n, b=2):
    """``n`` batches of ``b`` frames; the first k of ``frames(seed, n)``
    are ``frames(seed, k)``."""
    imgs = np.random.RandomState(seed).randint(
        0, 256, (n, b, S, S, 3)).astype(np.float32)
    labels = np.random.RandomState(seed + 1000).choice(
        [0, 1, 255], size=(n, b, S, S), p=[0.5, 0.4, 0.1]).astype(np.int32)
    return imgs, labels


def j_loss_fn(jmodel):
    def loss(variables, batch):
        imgs, labels = batch
        valid = labels != 255
        logits = jmodel.apply(variables, jt.normalize(imgs))[..., 0]
        return jl.compute_loss("dice", logits,
                               jnp.where(valid, labels, 0).astype(jnp.float32),
                               valid)
    return loss


def t_loss_fn(model):
    apply = functional_apply(model)

    def loss(params, batch):
        imgs, labels = batch
        valid = labels != 255
        logits = apply(params, tt.normalize(imgs))[..., 0]
        return tl.compute_loss("dice", logits,
                               torch.where(valid, labels, 0).float(), valid)
    return loss


def run_both(cfg_kw, bptt, head_norm="group4", steps=STEPS):
    """JAX ``meta_grads`` and the port's on the same inputs."""
    jmodel, _, j_meta = jax_pair(head_norm)
    model, meta = port_meta(head_norm)
    imgs, labels = frames(2, steps)
    q_imgs, q_labels = frames(3, 1)
    j_out = j_meta_grads(JMetaOptimConfig(**cfg_kw), j_loss_fn(jmodel),
                         j_loss_fn(jmodel), j_meta, (imgs, labels),
                         (q_imgs[0], q_labels[0]), bptt_epochs=bptt,
                         remat=False)
    batches = [(torch.from_numpy(imgs[i]), torch.from_numpy(labels[i]))
               for i in range(steps)]
    t_out = meta_grads(MetaOptimConfig(**cfg_kw), t_loss_fn(model),
                       t_loss_fn(model), meta, batches,
                       (torch.from_numpy(q_imgs[0]),
                        torch.from_numpy(q_labels[0])),
                       bptt_epochs=bptt, remat=False)
    return j_out, t_out, meta


def assert_grads_match(j_grads, t_grads, tol=1e-4):
    """Every port gradient within ``tol`` of its JAX tensor's largest
    magnitude, the constants' included; returns the names with a non-zero
    gradient."""
    want_init = state_dict_from_jax(jax.device_get(j_grads.model_init))
    want_lr = lr_tree_from_jax(jax.device_get(j_grads.log_init_lr))
    nonzero = set()
    for want, got in ((want_init, t_grads.model_init),
                      (want_lr, t_grads.log_init_lr)):
        assert set(got) == set(want)
        for k, w in want.items():
            w = w.numpy()
            scale = max(np.abs(w).max(), 1e-8)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=tol * scale, err_msg=k)
            if np.abs(w).max() > 0:
                nonzero.add(k)
    return nonzero


@pytest.mark.parametrize("bptt", [STEPS, 2])
def test_first_order_meta_grads_match_jax(bptt):
    """First order, one segment of 4 steps or two of 2 (truncation): loss,
    train losses and every meta-gradient, the frozen-BN constants' too."""
    (j_loss, j_grads, j_tr), (t_loss, t_grads, t_tr), meta = run_both(
        {}, bptt)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(t_tr.numpy(), np.asarray(j_tr), rtol=1e-5)
    nonzero = assert_grads_match(j_grads, t_grads)
    consts = {k for k in meta.model_init if k not in meta.log_init_lr}
    assert consts and consts <= nonzero  # the constants are meta-learned
    assert {k for k in meta.log_init_lr} <= nonzero


def test_truncation_init_grads_from_first_segment_only():
    """Two segments: the init's gradient is the first segment's alone
    (halved by the mean over segments); the lrs' is not."""
    _, (_, two, _), _ = run_both({}, 2)
    _, (_, one, _), _ = run_both({}, 2, steps=2)
    for k, g in two.model_init.items():
        torch.testing.assert_close(g, one.model_init[k] / 2, rtol=1e-5,
                                   atol=1e-9)
    diff = max(float((two.log_init_lr[k] - one.log_init_lr[k] / 2).abs().max())
               for k in two.log_init_lr)
    assert diff > 1e-6


def test_second_order_with_plain_norms_matches_jax():
    """Second order through the ``group4_xla`` head on both sides."""
    (j_loss, j_grads, _), (t_loss, t_grads, _), _ = run_both(
        dict(second_order_gradients=True), 2, head_norm="group4_xla")
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert_grads_match(j_grads, t_grads)


def test_second_order_subtrees_match_jax():
    """Second order kept only for the decoder ('dec_'), detached elsewhere;
    the result differs from first order."""
    cfg = dict(second_order_gradients=True, second_order_subtrees=("DEC_",))
    (_, j_grads, _), (_, t_grads, _), _ = run_both(cfg, STEPS,
                                                   head_norm="group4_xla")
    assert_grads_match(j_grads, t_grads)
    model, meta = port_meta("group4_xla")
    _, (_, first, _), _ = run_both({}, STEPS, head_norm="group4_xla")
    assert any(not torch.allclose(first.log_init_lr[k], t_grads.log_init_lr[k],
                                  rtol=1e-3, atol=1e-9)
               for k in t_grads.log_init_lr)


def test_second_order_remat_equals_no_remat():
    """``torch.utils.checkpoint`` around the second-order inner steps
    recomputes them; the gradients are the same."""
    model, meta = port_meta("group4_xla")
    imgs, labels = frames(2, 2)
    batches = [(torch.from_numpy(imgs[i]), torch.from_numpy(labels[i]))
               for i in range(2)]
    q = (torch.from_numpy(imgs[0]), torch.from_numpy(labels[0]))
    cfg = MetaOptimConfig(second_order_gradients=True)
    outs = [meta_grads(cfg, t_loss_fn(model), t_loss_fn(model), meta, batches,
                       q, bptt_epochs=2, remat=r) for r in (False, True)]
    for d0, d1 in zip(outs[0][1], outs[1][1]):
        for k in d0:
            torch.testing.assert_close(d1[k], d0[k], rtol=1e-5, atol=1e-8)


def test_kernel_norms_raise_under_second_order():
    """The GroupNorm kernels support one level of differentiation: second
    order through them raises instead of giving a first-order result."""
    model, meta = port_meta("group4")
    imgs, labels = frames(2, 1)
    batch = (torch.from_numpy(imgs[0]), torch.from_numpy(labels[0]))
    with pytest.raises(RuntimeError, match="one level of differentiation"):
        meta_grads(MetaOptimConfig(second_order_gradients=True),
                   t_loss_fn(model), t_loss_fn(model), meta, [batch], batch,
                   remat=False)


def test_segment_weights_match_jax_meta_loss():
    """Weights (0.2, 0.8) over two segments: the weighted meta-loss and its
    gradient against ``jax.value_and_grad`` of the JAX ``meta_loss``; the
    port's ``meta_loss`` gives the same value; wrong lengths and
    indivisible step counts raise."""
    jmodel, _, j_meta = jax_pair()
    model, meta = port_meta()
    imgs, labels = frames(4, STEPS)
    q = frames(5, 1)
    w = (0.2, 0.8)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda mp: j_meta_loss(JMetaOptimConfig(), j_loss_fn(jmodel),
                               j_loss_fn(jmodel), mp, (imgs, labels),
                               (q[0][0], q[1][0]), bptt_epochs=2, remat=False,
                               segment_weights=w), has_aux=True)(j_meta)
    batches = [(torch.from_numpy(imgs[i]), torch.from_numpy(labels[i]))
               for i in range(STEPS)]
    qb = (torch.from_numpy(q[0][0]), torch.from_numpy(q[1][0]))
    loss, grads, _ = meta_grads(MetaOptimConfig(), t_loss_fn(model),
                                t_loss_fn(model), meta, batches, qb,
                                bptt_epochs=2, remat=False,
                                segment_weights=w)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    j_grads = JMetaParams(j_grads.model_init, j_grads.log_init_lr)
    assert_grads_match(j_grads, grads)
    total, tr = meta_loss(MetaOptimConfig(), t_loss_fn(model),
                          t_loss_fn(model), meta, batches, qb,
                          bptt_epochs=2, segment_weights=w)
    np.testing.assert_allclose(float(total), float(j_loss), rtol=1e-5)
    assert tr.shape == (STEPS,)
    with pytest.raises(ValueError, match="segment_weights"):
        meta_grads(MetaOptimConfig(), t_loss_fn(model), t_loss_fn(model),
                   meta, batches, qb, bptt_epochs=2, segment_weights=(1.0,))
    with pytest.raises(ValueError, match="divisible"):
        meta_loss(MetaOptimConfig(), t_loss_fn(model), t_loss_fn(model),
                  meta, batches[:3], qb, bptt_epochs=2)


def test_nan_guard_matches_jax():
    """A query loss with an infinite slope at one entry (sqrt at 0): that
    entry's gradient is zeroed and the rest kept; a non-finite loss zeroes
    every gradient."""
    w0 = np.array([0.0, 1.5, -2.0], np.float32)

    def j_train(v, c):
        return jnp.sum(v["params"]["w"] ** 2) * c

    def j_query(v, _):
        return jnp.sum(jnp.sqrt(jnp.abs(v["params"]["w"])))

    j_meta = JMetaParams({"params": {"w": w0}},
                         {"params": {"w": np.full(3, -2.0, np.float32)}})
    j_out = j_meta_grads(JMetaOptimConfig(), j_train, j_query, j_meta,
                         np.ones((2,), np.float32), None, remat=False)

    def t_train(p, c):
        return (p["w"] ** 2).sum() * c

    def t_query(p, _):
        return p["w"].abs().sqrt().sum()

    meta = MetaParams({"w": torch.from_numpy(w0)}, {"w": torch.full((3,), -2.0)})
    loss, grads, _ = meta_grads(MetaOptimConfig(), t_train, t_query, meta,
                                [1.0, 1.0], None)
    np.testing.assert_allclose(float(loss), float(j_out[0]), rtol=1e-6)
    for got, want in ((grads.model_init["w"], j_out[1].model_init["params"]["w"]),
                      (grads.log_init_lr["w"],
                       j_out[1].log_init_lr["params"]["w"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        assert got[0] == 0 and bool(torch.isfinite(got).all())
    assert float(grads.model_init["w"].abs().sum()) > 0

    loss, grads, _ = meta_grads(MetaOptimConfig(), t_train,
                                lambda p, b: t_query(p, b) * float("nan"),
                                meta, [1.0, 1.0], None)
    assert not bool(torch.isfinite(loss))
    assert all(float(g.abs().sum()) == 0 for d in grads for g in d.values())


def test_inner_steps_leave_constants_unchanged():
    """The frozen-BN buffers reach every inner step and the query pass as
    the learned init's own values."""
    model, meta = port_meta()
    consts = [k for k in meta.model_init if k not in meta.log_init_lr]
    loss_fn = t_loss_fn(model)
    seen = []

    def recording(params, batch):
        seen.append({k: params[k].detach().clone() for k in consts})
        return loss_fn(params, batch)

    imgs, labels = frames(6, 2)
    batches = [(torch.from_numpy(imgs[i]), torch.from_numpy(labels[i]))
               for i in range(2)]
    meta_grads(MetaOptimConfig(), recording, recording, meta, batches,
               batches[0], bptt_epochs=2)
    assert len(seen) == 3
    for s in seen:
        for k in consts:
            assert torch.equal(s[k], meta.model_init[k]), k


def test_first_order_meta_graph_does_not_grow_with_inner_steps():
    """First order, one segment of 2 or of 4 inner steps: the meta-graph
    ``meta_loss`` returns holds the same bytes of saved tensors (a gradient
    sum a segment and the query pass, no per-step copy and no inner
    activations)."""
    model, meta = port_meta()
    loss_fn = t_loss_fn(model)
    imgs, labels = frames(8, 4)
    batches = [(torch.from_numpy(imgs[i]), torch.from_numpy(labels[i]))
               for i in range(4)]
    meta = MetaParams(*({k: v.requires_grad_(True) for k, v in d.items()}
                        for d in meta))

    class Held:
        def __init__(self, t):
            self.t = t

    def kept_bytes(steps):
        held = weakref.WeakSet()

        def pack(t):
            h = Held(t)
            held.add(h)
            return h

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h.t):
            loss, _ = meta_loss(MetaOptimConfig(), loss_fn, loss_fn, meta,
                                batches[:steps], batches[0],
                                bptt_epochs=steps)
        kept = {h.t.untyped_storage().data_ptr(): h.t.untyped_storage().nbytes()
                for h in held}
        del loss
        return sum(kept.values())

    two, four = kept_bytes(2), kept_bytes(4)
    assert two > 0 and four == two, (two, four)
