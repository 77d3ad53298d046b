"""The pool of sequences is a function of the seed."""

import numpy as np
import torch

from harness import cells, seeds, traffic


def _pool(seed, objects=2):
    mix = cells.traffic(f"seq67-480p-{objects}obj")
    mix.update(frames=6, height=40, width=72, pool=3)
    return traffic.make_pool(mix, seed, torch.device("cpu"))


def test_same_seed_same_pool():
    a, b = _pool(2 ** 31 + 77), _pool(2 ** 31 + 77)
    assert np.array_equal(a.frames, b.frames)
    assert np.array_equal(a.labels, b.labels)
    c = _pool(2 ** 31 + 78)
    assert not np.array_equal(a.frames, c.frames)


def test_objects_in_every_frame():
    p = _pool(5, objects=2)
    for s in range(p.frames.shape[0]):
        for t in range(p.frames.shape[1]):
            assert set(np.unique(p.labels[s, t])) >= {1, 2} or \
                set(np.unique(p.labels[s, t])) >= {2}


def test_large_seeds_derive():
    rs = seeds.derive(2 ** 33 + 5)
    assert all(0 <= v < 2 ** 32 for v in rs)
    assert seeds.derive(7) == seeds.derive(7)
