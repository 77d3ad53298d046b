"""Seed derivation shared by the port's entry points."""

from __future__ import annotations

import numpy as np


def fold_in(seed: int, i: int) -> int:
    """A child seed of ``(seed, i)``, the port's counterpart of
    ``jax.random.fold_in``: distinct for each ``i`` and stable across runs
    and devices."""
    return int(np.random.SeedSequence(seed, spawn_key=(i,))
               .generate_state(1, np.uint64)[0])
