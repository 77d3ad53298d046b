"""Each fault a cell can have, planted under the timed path
(``harness/faults.py``), turns ``correct`` false; the sound run at the
same size and seed is correct. At this size the limits are
``tiny.TINY_LIMITS`` (the sound float32 program reads under 1e-4 there);
the cells' own limits are set from full-size readings on the card."""

import pytest

import tiny

FAULTS = ("unchanged", "refit_unchanged", "half_batch", "answer")
CASES = [(fam, 1, f) for fam in ("deeplabv3plus", "maskrcnn") for f in FAULTS]


@pytest.mark.parametrize("family,objects,fault", CASES)
def test_fault_is_caught(family, objects, fault):
    correct, got, *_ = tiny.run(tiny.cell(family, objects), 2 ** 31 + 3,
                                fault=fault)
    assert not correct, got["program"]


@pytest.mark.parametrize("family", ["deeplabv3plus", "maskrcnn"])
def test_sound_run_is_correct(family):
    correct, got, *_ = tiny.run(tiny.cell(family, 1), 2 ** 31 + 3)
    assert correct, got["program"]
