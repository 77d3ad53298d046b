"""Weights and learning rates of the JAX package, carried into the port.

The port's modules carry the flax module names, so the mapping is one to one:
the flax leaf ``params/aspp/b0_norm/scale`` becomes the parameter
``aspp.b0_norm.scale``, ``constants/backbone/stem_norm/bias`` the buffer
``backbone.stem_norm.bias`` and ``batch_stats/backbone/stem_norm/mean`` the
buffer ``backbone.stem_norm.mean``. Convolution kernels change layout from
flax's HWIO to torch's OIHW and their leaf name from ``kernel`` to
``weight``.

The JAX meta-trainer's checkpoint ``{"meta_params", "opt_state"}`` carries
over whole: ``meta_params_from_flax`` gives the port's ``MetaParams`` and
``outer_state_from_jax`` the outer optimizer's step counts and moments
(``parallel.OuterRAdam.load_moments``), so a run resumed in the port
continues the JAX run.

Inputs are nested dicts of array-likes (numpy arrays, tensors, or anything
``np.asarray`` takes), as ``flax.core.unfreeze`` and a host transfer, or
``utils.checkpoint.load_flax_checkpoint``, give them; nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from e_osvos_torch.meta_optim.meta_optimizer import MetaParams

COLLECTIONS = ("params", "constants", "batch_stats")
# flax ``nn.ConvTranspose`` modules of the JAX package, by module name
CONV_TRANSPOSE_MODULES = ("deconv",)


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _kernel_to_port(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    """A flax kernel (or a learning rate shaped against one) in the port's
    layout."""
    if arr.ndim == 0:  # a tensor-level learning rate
        return arr
    if arr.ndim == 2:  # dense (in, out) → [out, in]
        return arr.T
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
        if len(path) > 1 and path[-2] in CONV_TRANSPOSE_MODULES:
            arr = arr[:, :, ::-1, ::-1]
        return arr
    raise ValueError(f"{'/'.join(path)}: unexpected kernel shape {arr.shape}")


def _convert_leaf(path: Tuple[str, ...], value) -> Tuple[str, torch.Tensor]:
    if isinstance(value, torch.Tensor):  # e.g. a bfloat16 checkpoint leaf
        value = value.float().numpy()
    arr = np.array(value, dtype=np.float32)  # a writable copy
    leaf = path[-1]
    if leaf == "kernel":
        arr = _kernel_to_port(path, arr)
        leaf = "weight"
    elif arr.ndim in (2, 4):
        # a neuron- or param-level lr of a kernel already renamed upstream
        raise ValueError(f"{'/'.join(path)}: unexpected {arr.ndim}-D leaf")
    name = ".".join(path[:-1] + (leaf,))
    return name, torch.from_numpy(arr.copy())  # C order, positive strides


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``variables`` ({"params": ..., "constants": ...,
    "batch_stats": ...}) → the port model's ``state_dict`` (float32, CPU).
    Every leaf lands exactly once."""
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise ValueError(f"unsupported variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in COLLECTIONS:
        for path, value in _leaves(variables.get(collection, {})):
            name, tensor = _convert_leaf(path, value)
            if name in out:
                raise ValueError(f"two flax leaves map to {name}")
            out[name] = tensor
    return out


def lr_tree_from_jax(lr_tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax learning-rate tree → per-parameter learning rates keyed like
    ``named_parameters()``.

    Accepts the tree of the ``params`` collection or a full variables-shaped
    tree, whose ``constants`` and ``batch_stats`` lrs are dropped: buffers
    get no lr. Flax keeps the neuron axis last (a conv kernel's neuron lr
    is ``(1, 1, 1, O)``); the port keeps it first (``[O, 1, 1, 1]``), the
    kernel's own transpose.
    """
    if "params" in lr_tree:
        lr_tree = lr_tree["params"]
    return dict(_convert_leaf(path, value) for path, value in _leaves(lr_tree))


def meta_params_from_flax(tree: Mapping) -> MetaParams:
    """A JAX ``MetaParams`` read by ``load_flax_checkpoint`` (a dict of its
    fields) in the port's layout: the learned init as a ``state_dict``
    (frozen-BN constants and ``batch`` norms' running statistics as
    buffers), the lrs keyed like ``named_parameters()``."""
    init = tree.get("model_init")
    return MetaParams(
        model_init=None if init is None else state_dict_from_jax(init),
        log_init_lr=lr_tree_from_jax(tree["log_init_lr"]))


def _radam_state(tree: Any) -> Optional[Mapping]:
    """The ``ScaleByRAdamState`` ({"count", "mu", "nu"}) in one group's
    chain state (``chain(clip?, add_decayed_weights?, radam)``; the other
    links hold no state)."""
    if not isinstance(tree, Mapping):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for value in tree.values():
        found = _radam_state(value)
        if found is not None:
            return found
    return None


def outer_state_from_jax(opt_state: Mapping) -> Dict[str, Dict[str, Any]]:
    """The JAX outer optimizer's state (``optax.multi_transform`` over the
    groups ``model_init`` and ``log_init_lr``, as ``load_flax_checkpoint``
    reads it) → ``{group: {"count": int, "mu": {name: tensor}, "nu":
    {...}}}`` in the port's layout. A group's moments are masked trees of
    the whole ``MetaParams``; its own field is kept. Moments of the learned
    init take the weights' layout change, those of the lrs the lrs' (the
    moments of ``constants``/``batch_stats`` lrs drop with those lrs). A
    group without tensors (no learned init) is left out."""
    convert = {"model_init": state_dict_from_jax,
               "log_init_lr": lr_tree_from_jax}
    out: Dict[str, Dict[str, Any]] = {}
    for name, group in opt_state["inner_states"].items():
        if name not in convert:
            raise ValueError(f"unknown outer optimizer group {name!r}")
        state = _radam_state(group)
        if state is None:
            raise ValueError(f"group {name!r} holds no RAdam state")
        if state["mu"][name] is None:
            continue
        out[name] = {"count": int(np.asarray(state["count"])),
                     "mu": convert[name](state["mu"][name]),
                     "nu": convert[name](state["nu"][name])}
    return out
