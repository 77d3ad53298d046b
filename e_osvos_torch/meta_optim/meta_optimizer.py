"""The learned optimizer's inner loop, port of the one-shot subset of
``e_osvos_tpu/meta_optim/meta_optimizer.py``.

Parameters are a dict keyed like ``named_parameters()`` and the model is
applied functionally (``torch.func.functional_call``). One inner step is
``p ← p − lr·∇loss`` with first-order gradients: ``torch.autograd.grad``
without ``create_graph``, the counterpart of the JAX ``stop_gradient`` on the
inner grads. Each step's graph is freed by its ``grad``, so no
rematerialization is needed. Second-order meta-gradients and the meta-loss
wait for the meta-training slice.

Unlike JAX arrays, tensors are mutable: the inner step updates the
parameters in place. ``reset_params`` therefore hands out a copy of the
learned init, never the init itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from e_osvos_torch.meta_optim.lr_tree import init_lr_tree, materialize_lrs

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MetaOptimConfig:
    """The one-shot subset of the reference's ``meta_optim_cfg``."""

    lr_hierarchy_level: str = "neuron"
    init_lr: float = 1e-3
    learn_model_init: bool = True
    use_log_init_lr: bool = True


class MetaParams(NamedTuple):
    """Meta-parameters: the learned init (None when not learned) and the
    learned (log-)lrs, both keyed like ``named_parameters()``. Buffers
    (frozen-BN constants) are not parameters and get no lr."""

    model_init: Optional[Params]
    log_init_lr: Params


def _param_dict(params: Union[nn.Module, Params]) -> Params:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {k: v.detach() for k, v in params.items()}


def init_meta_params(cfg: MetaOptimConfig,
                     params: Union[nn.Module, Params]) -> MetaParams:
    """Meta-parameters for a model (or its parameter dict)."""
    params = _param_dict(params)
    lrs = init_lr_tree(params, hierarchy_level=cfg.lr_hierarchy_level,
                       init_lr=cfg.init_lr, use_log=cfg.use_log_init_lr)
    init = ({k: v.clone() for k, v in params.items()}
            if cfg.learn_model_init else None)
    return MetaParams(model_init=init, log_init_lr=lrs)


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


def inner_sgd_step(loss_fn: LossFn, params: Params, lrs: Params, batch: Any
                   ) -> Tuple[Params, torch.Tensor]:
    """One learned-optimizer step ``p ← p − lr·∇loss``, in place.

    ``params`` are leaf tensors that require grad; ``lrs`` are materialized
    (positive) and broadcast against the params. Returns the same dict and
    the detached loss."""
    names = list(params)
    leaves = [params[k] for k in names]
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        torch._foreach_sub_(
            leaves, torch._foreach_mul(grads, [lrs[k] for k in names]))
    return params, loss.detach()


def _full_lrs(lrs: Params, params: Params) -> Params:
    """Lrs expanded to their params' shapes and memory formats, so the
    update runs as one fused multi-tensor pass."""
    return {k: torch.empty_like(p).copy_(lrs[k].expand_as(p))
            for k, p in params.items()}


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
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
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
