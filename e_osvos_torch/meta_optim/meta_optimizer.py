"""The learned optimizer, port of ``e_osvos_tpu/meta_optim/meta_optimizer.py``.

Parameters are a dict keyed like ``named_parameters()`` and the model is
applied functionally (``torch.func.functional_call``). One inner step is
``p ← p − lr·∇loss``.

The learned init (``MetaParams.model_init``) also carries the model's
frozen-BN buffers under their buffer names, as the JAX package's carries the
``constants`` collection. They have no learning rate: the inner steps pass
them to the model unchanged (the JAX package moves them by its lr floor,
e^-33 ≈ 5e-15, times their gradient), while the query loss's meta-gradient
reaches them and the outer step updates them with the rest of the init.

Two inner loops:

  * ``fine_tune`` (evaluation): first-order steps in place on a copy of the
    init, each step's graph freed by its ``torch.autograd.grad``.
  * ``meta_loss`` / ``meta_grads`` (meta-training): the truncated-BPTT
    meta-objective. First order treats each inner gradient ``g_k`` as a
    constant, so a segment's chain ``p_{k+1} = p_k − lr·g_k`` is linear:
    ``p_K = p_0 − lr·Σ_k g_k``. Its inner steps are the evaluation's
    in-place steps on a copy of ``p_0``, summing the gradients, and the
    segment joins the meta-graph as one node: autograd keeps one f32
    gradient sum of the parameters a segment and no activations, whatever
    the number of steps. Second order differentiates through
    the inner gradients (``create_graph``). The GroupNorm kernels' backward
    supports one level of differentiation and raises under
    ``create_graph``, so a second-order gradient whose backward crosses a
    GroupNorm needs the plain norms (the ``*_xla`` forms). With
    ``second_order_subtrees`` only those parameters' gradients are taken
    with ``create_graph``; the rest are taken in a second pass without it,
    as the JAX package stops their gradient. For Mask R-CNN's heads, which
    sit after every GroupNorm, the backbone's norms then stay on the
    kernels.

Unlike JAX arrays, tensors are mutable: ``fine_tune`` updates in place, so
``reset_params`` hands out a copy of the learned init, never the init
itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from e_osvos_torch.meta_optim.lr_tree import (
    clamp_lr_tree,
    init_lr_tree,
    materialize_lrs,
)

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MetaOptimConfig:
    """The reference's ``meta_optim_cfg``. ``second_order_subtrees``
    restricts second-order gradients to parameters whose name contains one
    of the substrings (empty: all)."""

    lr_hierarchy_level: str = "neuron"
    init_lr: float = 1e-3
    learn_model_init: bool = True
    use_log_init_lr: bool = True
    max_lr: float = 1.0
    second_order_gradients: bool = False
    second_order_subtrees: Tuple[str, ...] = ()


class MetaParams(NamedTuple):
    """Meta-parameters: the learned init (None when not learned), keyed like
    ``named_parameters()`` plus the frozen-BN buffers, and the learned
    (log-)lrs, keyed like ``named_parameters()``."""

    model_init: Optional[Params]
    log_init_lr: Params


def init_meta_params(cfg: MetaOptimConfig,
                     params: Union[nn.Module, Params]) -> MetaParams:
    """Meta-parameters for a model, or for a parameter dict (every entry of
    which gets an lr). A model's buffers join the learned init without
    an lr."""
    buffers: Params = {}
    if isinstance(params, nn.Module):
        buffers = {k: v.detach() for k, v in params.named_buffers()}
        params = dict(params.named_parameters())
    params = {k: v.detach() for k, v in params.items()}
    lrs = init_lr_tree(params, hierarchy_level=cfg.lr_hierarchy_level,
                       init_lr=cfg.init_lr, use_log=cfg.use_log_init_lr)
    init = ({k: v.clone() for k, v in {**params, **buffers}.items()}
            if cfg.learn_model_init else None)
    return MetaParams(model_init=init, log_init_lr=lrs)


@torch.no_grad()
def clamp_meta_params(cfg: MetaOptimConfig, meta_params: MetaParams
                      ) -> MetaParams:
    """The lr clamp after an outer step, into [e^-33, max_lr] (log space:
    [-33, log max_lr]). In place, so an optimizer holding the tensors keeps
    them; returns ``meta_params``."""
    clamped = clamp_lr_tree(meta_params.log_init_lr,
                            use_log=cfg.use_log_init_lr, max_lr=cfg.max_lr)
    for k, v in meta_params.log_init_lr.items():
        v.copy_(clamped[k])
    return meta_params


def reset_params(cfg: MetaOptimConfig, meta_params: MetaParams,
                 params: Optional[Params]) -> Params:
    """Start of an inner loop: a fresh copy of the learned init if there is
    one, else of the caller's params. A copy, because the inner steps update
    in place."""
    src = (meta_params.model_init
           if cfg.learn_model_init and meta_params.model_init is not None
           else params)
    if src is None:
        raise ValueError("no learned init and no init_params given")
    return {k: v.detach().clone() for k, v in src.items()}


def inner_sgd_step(loss_fn: LossFn, params: Params, lrs: Params, batch: Any,
                   grad_sum: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[Params, torch.Tensor]:
    """One learned-optimizer step ``p ← p − lr·∇loss``, in place.

    The entries of ``params`` named in ``lrs`` are leaf tensors that
    require grad; the rest (frozen-BN buffers) pass to the model unchanged.
    ``lrs`` are materialized (positive) and broadcast against the params.
    ``grad_sum`` (one tensor per lr, in the order of ``lrs``), when given,
    accumulates the step's gradients. Returns the same dict and the
    detached loss."""
    names = list(lrs)
    leaves = [params[k] for k in names]
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        torch._foreach_sub_(
            leaves, torch._foreach_mul(grads, [lrs[k] for k in names]))
        if grad_sum is not None:
            torch._foreach_add_(grad_sum, grads)
    return params, loss.detach()


def _full_lrs(lrs: Params, params: Params) -> Params:
    """Lrs expanded to their params' shapes and memory formats, so the
    update runs as one fused multi-tensor pass."""
    return {k: torch.empty_like(params[k]).copy_(lr.expand_as(params[k]))
            for k, lr in lrs.items()}


def fine_tune(cfg: MetaOptimConfig, loss_fn: LossFn, meta_params: MetaParams,
              batches: Sequence[Any], init_params: Optional[Params] = None,
              early_stop_patience: int = 0, reset: bool = True
              ) -> Tuple[Params, torch.Tensor]:
    """The one-shot fine-tune: one inner step per batch of ``batches``.

    ``reset=False`` continues from ``init_params`` (the online-adaptation
    continuation) and updates those tensors in place; the JAX evaluator
    donates them in the same place.

    ``early_stop_patience`` > 0 enables the early-stopping latch: once the
    loss has not made a new minimum for ``patience`` steps, later steps
    leave the params alone and report +inf.

    Returns ``(params, per-step losses)``."""
    lrs = materialize_lrs(meta_params.log_init_lr, cfg.use_log_init_lr)
    if reset:
        params = reset_params(cfg, meta_params, init_params)
    elif init_params is None:
        raise ValueError("reset=False needs init_params")
    else:
        params = init_params
    params = {k: v.detach().requires_grad_(k in lrs)
              for k, v in params.items()}
    lrs = _full_lrs(lrs, params)

    losses = []
    best, since, stopped = math.inf, 0, False
    for batch in batches:
        if stopped:
            losses.append(torch.full((), math.inf, device=losses[-1].device))
            continue
        params, loss = inner_sgd_step(loss_fn, params, lrs, batch)
        losses.append(loss.float())
        if early_stop_patience > 0:
            value = float(loss)  # host sync; only with the latch on
            since = 0 if value < best else since + 1
            best = min(best, value)
            stopped = since >= early_stop_patience
    return params, torch.stack(losses)


class _FirstOrderChain(torch.autograd.Function):
    """A first-order segment as one node of the meta-graph: ``p_K = p_0 −
    lr·G`` with ``G = Σ_k g_k`` a constant. The forward returns ``p_K`` as
    the inner steps computed it (in place, step by step); the backward
    passes the incoming gradient to ``p_0`` and gives each lr ``−grad·G``
    summed over the entries it broadcasts to."""

    @staticmethod
    def forward(ctx, ends, grad_sum, *starts_and_lrs):
        ctx.save_for_backward(*grad_sum)
        ctx.lr_shapes = [lr.shape for lr in starts_and_lrs[len(ends):]]
        return tuple(ends)

    @staticmethod
    def backward(ctx, *grads):
        d_lrs = [None] * len(grads)
        if any(ctx.needs_input_grad[2 + len(grads):]):
            prod = torch._foreach_mul(grads, ctx.saved_tensors)
            torch._foreach_neg_(prod)
            d_lrs = [p.sum_to_size(shape)
                     for p, shape in zip(prod, ctx.lr_shapes)]
        return (None, None, *grads, *d_lrs)


def _first_order_segment(loss_fn: LossFn, params: Params, lrs: Params,
                         batches: Sequence[Any]
                         ) -> Tuple[Params, List[torch.Tensor]]:
    """A segment's inner steps to first order: the evaluation's in-place
    steps (``inner_sgd_step``) on a copy of ``params``, summing their
    gradients; the result joins the meta-graph through ``_FirstOrderChain``.
    The meta-graph keeps the gradient sum and no activations. The entries
    not named in ``lrs`` (frozen-BN buffers) are passed on as given."""
    names = list(lrs)
    work = {k: v.detach().clone().requires_grad_(True) if k in lrs
            else v.detach() for k, v in params.items()}
    full = _full_lrs({k: v.detach() for k, v in lrs.items()}, work)
    grad_sum = [torch.zeros_like(work[k]) for k in names]
    losses = []
    for batch in batches:
        work, loss = inner_sgd_step(loss_fn, work, full, batch, grad_sum)
        losses.append(loss.float())
    ends = _FirstOrderChain.apply([work[k].detach() for k in names],
                                  grad_sum, *(params[k] for k in names),
                                  *(lrs[k] for k in names))
    out = dict(params)
    out.update(zip(names, ends))
    return out, losses


def _second_order_names(cfg: MetaOptimConfig, names: Sequence[str]
                        ) -> List[str]:
    """The parameters whose inner gradient keeps its graph: those whose
    name contains one of ``second_order_subtrees`` (case-insensitive, the
    JAX package's rule), or all when none are given."""
    if not cfg.second_order_subtrees:
        return list(names)
    subs = tuple(s.lower() for s in cfg.second_order_subtrees)
    return [k for k in names if any(s in k.lower() for s in subs)]


def _second_order_step(cfg: MetaOptimConfig, loss_fn: LossFn,
                       params: Params, lrs: Params, batch: Any
                       ) -> Tuple[Params, torch.Tensor]:
    """One inner step of the second-order meta-objective, out of place:
    ``p − lr·g`` for the entries named in ``lrs``, the rest passed on.
    ``g`` keeps its graph for the parameters of ``second_order_subtrees``
    (all when none are given); the others' gradients are taken in a second
    backward without ``create_graph``, so that backward's kernels (the
    GroupNorms of a backbone) run once-differentiable."""
    names = list(lrs)
    # params carried as constants (after a truncation) become leaves
    params = {k: v if v.requires_grad or k not in lrs
              else v.detach().requires_grad_(True)
              for k, v in params.items()}
    loss = loss_fn(params, batch)
    graph = _second_order_names(cfg, names)
    rest = [k for k in names if k not in set(graph)]
    grads = {}
    if graph:
        grads.update(zip(graph, torch.autograd.grad(
            loss, [params[k] for k in graph], create_graph=True,
            retain_graph=True)))
    if rest:
        # the graph stays: the kept gradients' meta backward runs through
        # this step's forward
        grads.update(zip(rest, torch.autograd.grad(
            loss, [params[k] for k in rest], retain_graph=bool(graph))))
    new = dict(params)
    for k in names:
        new[k] = params[k] - lrs[k].to(params[k].dtype) * grads[k]
    return new, loss.detach()


def _checkpointed_step(cfg: MetaOptimConfig, loss_fn: LossFn) -> Callable:
    """``_second_order_step`` under ``torch.utils.checkpoint``: the step's
    activations are recomputed in the meta backward instead of kept."""

    def step(params: Params, lrs: Params, batch: Any):
        keys, names = list(params), list(lrs)

        def flat_step(*flat):
            new, loss = _second_order_step(
                cfg, loss_fn, dict(zip(keys, flat[:len(keys)])),
                dict(zip(names, flat[len(keys):])), batch)
            return (*(new[k] for k in keys), loss)

        out = checkpoint(flat_step, *params.values(), *lrs.values(),
                         use_reentrant=False)
        return dict(zip(keys, out[:-1])), out[-1]

    return step


def _segments(cfg: MetaOptimConfig, train_loss_fn: LossFn,
              meta_loss_fn: LossFn, meta_params: MetaParams,
              train_batches: Sequence[Any], meta_batch: Any,
              bptt_epochs: int, init_params: Optional[Params], remat: bool,
              segment_weights: Optional[Sequence[float]],
              on_phase: Optional[Callable[[str], None]] = None
              ) -> Iterator[Tuple[torch.Tensor, List[torch.Tensor]]]:
    """The truncated-BPTT segments of one task, in turn: each yields its
    weighted query loss (with its graph to the meta-parameters) and its
    inner train losses. After a segment the carried params are detached, so
    the learned init receives gradient through the first segment only and
    the lrs through every segment."""
    num_steps = len(train_batches)
    if num_steps % bptt_epochs != 0:
        raise ValueError(
            f"num inner steps ({num_steps}) must be divisible by bptt_epochs "
            f"({bptt_epochs})")
    num_segments = num_steps // bptt_epochs
    if segment_weights is None:
        weights = [1.0] * num_segments
    elif len(segment_weights) != num_segments:
        raise ValueError(f"segment_weights has {len(segment_weights)} entries "
                         f"for {num_segments} segments")
    else:
        weights = [float(w) * num_segments for w in segment_weights]

    if cfg.learn_model_init and meta_params.model_init is not None:
        params = dict(meta_params.model_init)
    elif init_params is not None:
        params = dict(init_params)
    else:
        raise ValueError("no learned init and no init_params given")
    step = (_checkpointed_step(cfg, train_loss_fn) if remat
            else lambda p, l, b: _second_order_step(cfg, train_loss_fn, p, l,
                                                    b))
    for s in range(num_segments):
        # materialized per segment: each segment's backward frees its graph
        lrs = materialize_lrs(meta_params.log_init_lr, cfg.use_log_init_lr)
        batches = train_batches[s * bptt_epochs:(s + 1) * bptt_epochs]
        if cfg.second_order_gradients:
            losses = []
            for batch in batches:
                params, loss = step(params, lrs, batch)
                losses.append(loss.float())
        else:
            params, losses = _first_order_segment(train_loss_fn, params, lrs,
                                                  batches)
        if on_phase is not None:
            on_phase("inner")
        yield weights[s] * meta_loss_fn(params, meta_batch), losses
        params = {k: v.detach() for k, v in params.items()}


def meta_loss(cfg: MetaOptimConfig, train_loss_fn: LossFn,
              meta_loss_fn: LossFn, meta_params: MetaParams,
              train_batches: Sequence[Any], meta_batch: Any,
              bptt_epochs: int = 1, init_params: Optional[Params] = None,
              remat: bool = True,
              segment_weights: Optional[Sequence[float]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated-BPTT meta-objective of one task.

    Runs one inner step per batch of ``train_batches``; after every
    ``bptt_epochs`` steps the query loss ``meta_loss_fn(params,
    meta_batch)`` is accumulated and the carried params are detached.
    ``segment_weights`` weighs the segments' query losses (the reference's
    ``multi_step_bptt_loss``; one per segment, None = uniform). ``remat``
    checkpoints the second-order inner steps. Returns ``(total /
    num_segments, per-step train losses)``, the total with its graph to the
    meta-parameters, which must require grad to receive it.

    Every segment's graph stays alive until the caller's backward;
    ``meta_grads`` frees each segment's graph as it goes."""
    total, train = None, []
    for q, losses in _segments(cfg, train_loss_fn, meta_loss_fn, meta_params,
                               train_batches, meta_batch, bptt_epochs,
                               init_params, remat, segment_weights):
        total = q if total is None else total + q
        train += losses
    num_segments = len(train_batches) // bptt_epochs
    return total / num_segments, torch.stack(train)


def meta_grads(cfg: MetaOptimConfig, train_loss_fn: LossFn,
               meta_loss_fn: LossFn, meta_params: MetaParams,
               train_batches: Sequence[Any], meta_batch: Any,
               bptt_epochs: int = 1, init_params: Optional[Params] = None,
               remat: bool = True,
               segment_weights: Optional[Sequence[float]] = None,
               on_phase: Optional[Callable[[str], None]] = None
               ) -> Tuple[torch.Tensor, MetaParams, torch.Tensor]:
    """``(meta_loss, d meta_loss / d meta_params, per-step train losses)``
    of one task, every value detached. Each segment's graph is freed by its
    own backward. A NaN guard zeroes non-finite gradient entries, and every
    gradient when the loss is not finite (the reference skips such a task's
    contribution). Entries that no segment reaches (frozen buffers after
    the first segment, say) get zero gradient. ``on_phase``, when set, is
    called with ``inner`` after each segment's inner steps and ``query``
    after its query loss and backward."""
    def leaves(d):
        return None if d is None else {k: v.detach().requires_grad_(True)
                                       for k, v in d.items()}

    mp = MetaParams(leaves(meta_params.model_init),
                    leaves(meta_params.log_init_lr))
    targets = [v for d in mp if d is not None for v in d.values()]
    num_segments = len(train_batches) // bptt_epochs
    total = torch.zeros((), device=targets[0].device)
    grads: List[torch.Tensor] = [torch.zeros_like(t) for t in targets]
    train = []
    for q, losses in _segments(cfg, train_loss_fn, meta_loss_fn, mp,
                               train_batches, meta_batch, bptt_epochs,
                               init_params, remat, segment_weights, on_phase):
        q = q / num_segments
        got = torch.autograd.grad(q, targets, allow_unused=True)
        torch._foreach_add_(grads, [torch.zeros_like(t) if g is None else g
                                    for t, g in zip(targets, got)])
        total = total + q.detach().float()
        train += losses
        if on_phase is not None:
            on_phase("query")
    ok = torch.isfinite(total)
    grads = [torch.where(ok & torch.isfinite(g), g, 0.0) for g in grads]
    it = iter(grads)
    out = MetaParams(*(None if d is None else {k: next(it) for k in d}
                       for d in mp))
    return total, out, torch.stack(train)
