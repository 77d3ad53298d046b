"""Checkpoint and resume of meta-training state, port of
``e_osvos_tpu/utils/checkpoint.py``.

The state (meta-parameters, the outer optimizer's ``state_dict``) is a
nested dict of tensors and plain values, written with ``torch.save`` to a
temporary file and renamed into place, so a crash mid-save never corrupts
the latest checkpoint; metadata goes to a JSON sidecar ``<path>.json`` the
same way. Loading uses ``torch.load(weights_only=True)``, which unpickles
no code. (Reading the JAX package's flax msgpack checkpoints is separate
work.)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch


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
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta
