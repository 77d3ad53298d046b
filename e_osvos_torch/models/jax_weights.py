"""Weights and learning rates of the JAX package, carried into the port.

The port's modules carry the flax module names, so the mapping is one to one:
the flax leaf ``params/aspp/b0_norm/scale`` becomes the parameter
``aspp.b0_norm.scale`` and ``constants/backbone/stem_norm/bias`` the buffer
``backbone.stem_norm.bias``. Convolution kernels change layout from flax's
HWIO to torch's OIHW and their leaf name from ``kernel`` to ``weight``.

Inputs are nested dicts of array-likes (numpy arrays, tensors, or anything
``np.asarray`` takes), as ``flax.core.unfreeze`` and a host transfer, or
``utils.checkpoint.load_flax_checkpoint``, give them; nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

COLLECTIONS = ("params", "constants")
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
    """flax ``variables`` ({"params": ..., "constants": ...}) → the port
    model's ``state_dict`` (float32, CPU). Every leaf lands exactly once."""
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
    tree, whose ``constants`` lrs are dropped: buffers get no lr. Flax keeps
    the neuron axis last (a conv kernel's neuron lr is ``(1, 1, 1, O)``);
    the port keeps it first (``[O, 1, 1, 1]``), the kernel's own transpose.
    """
    if "params" in lr_tree:
        lr_tree = lr_tree["params"]
    return dict(_convert_leaf(path, value) for path, value in _leaves(lr_tree))
