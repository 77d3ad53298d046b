"""The benchmark's CPU tests: ``python -m pytest benchmark/tests`` from the
root of the repo. Tests that need a card carry the ``cuda`` marker and
skip without one."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]
