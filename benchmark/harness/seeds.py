"""Seeds of one run, all derived from ``--seed``.

``--seed`` may exceed 32 bits; each consumer gets its own 32-bit child
from ``numpy.random.SeedSequence``, so torch, numpy and the port all take
it."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_CHILDREN = ("traffic", "weights", "eval", "sample")


class RunSeeds(NamedTuple):
    traffic: int  # the pool of sequences
    weights: int  # weights and learning rates
    eval: int  # the evaluator's seed of window sequence j: fold_in(eval, j)
    sample: int  # which steps and windows the comparison reads


def derive(seed: int) -> RunSeeds:
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    state = np.random.SeedSequence(seed).generate_state(len(_CHILDREN))
    return RunSeeds(*(int(s) for s in state))


def fold_in(seed: int, i: int) -> int:
    """A child seed of ``(seed, i)``: the schedule the port's evaluators
    use for sequence and object seeds (``numpy.random.SeedSequence`` with
    ``spawn_key=(i,)``)."""
    return int(np.random.SeedSequence(seed, spawn_key=(i,))
               .generate_state(1, np.uint64)[0])
