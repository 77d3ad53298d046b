"""Checkpoint and resume of meta-training state, port of
``e_osvos_tpu/utils/checkpoint.py``.

The state (meta-parameters, the outer optimizer's ``state_dict``) is a
nested dict of tensors and plain values, written with ``torch.save`` to a
temporary file and renamed into place, so a crash mid-save never corrupts
the latest checkpoint; metadata goes to a JSON sidecar ``<path>.json`` the
same way. Loading uses ``torch.load(weights_only=True)``, which unpickles
no code.

``load_flax_checkpoint`` reads the JAX package's checkpoints (flax's msgpack
format: parents, and meta checkpoints ``{"meta_params", "opt_state"}``)
with ``msgpack`` alone, as nested dicts of numpy arrays;
``models/jax_weights.py`` carries them onto the port's model and
meta-parameters. ``is_torch_checkpoint`` tells the two formats apart.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import msgpack
import numpy as np
import torch

# flax.serialization's msgpack extension codes
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def save_checkpoint(path: str, state: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Write ``state`` (and the ``metadata`` sidecar) atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        mtmp = path + ".json.tmp"
        with open(mtmp, "w") as f:
            json.dump(metadata, f)
        os.replace(mtmp, path + ".json")
    return path


def load_checkpoint(path: str,
                    map_location: Union[str, torch.device, None] = "cpu"
                    ) -> Tuple[Any, Optional[Dict]]:
    """The state saved by ``save_checkpoint`` (tensors on
    ``map_location``) and its metadata, None without a sidecar."""
    state = torch.load(path, map_location=map_location, weights_only=True)
    return state, load_metadata(path)


def load_metadata(path: str) -> Optional[Dict]:
    """The JSON sidecar ``<path>.json`` of a checkpoint (the port's or the
    JAX package's, which write the same sidecar), None without one."""
    if not os.path.exists(path + ".json"):
        return None
    with open(path + ".json") as f:
        return json.load(f)


def is_torch_checkpoint(path: str) -> bool:
    """Whether ``path`` was written by ``torch.save`` (a zip archive) rather
    than by flax (a msgpack map)."""
    return zipfile.is_zipfile(path)


def _ndarray_from_bytes(data: bytes):
    """flax's array encoding: msgpack ``(shape, dtype name, C-order
    bytes)``. A bfloat16 buffer, which numpy cannot hold, becomes a
    ``torch.bfloat16`` tensor through a uint16 view."""
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        value = _ndarray_from_bytes(data)
        return value.reshape(()) if isinstance(value, torch.Tensor) \
            else value[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    """Arrays flax split into ``__msgpack_chunked_array__`` dicts (those
    over its ``MAX_CHUNK_SIZE``) joined back, recursively."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_checkpoint(path: str) -> Any:
    """A checkpoint the JAX package wrote (``flax.serialization.to_bytes``)
    as nested dicts: arrays as numpy (bfloat16 ones as ``torch.bfloat16``),
    numpy scalars as numpy scalars, NamedTuples (``MetaParams``) as dicts of
    their fields, tuples and lists as dicts keyed "0", "1", ...; None stays
    None."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)
