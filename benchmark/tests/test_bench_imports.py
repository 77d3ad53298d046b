"""No file of the benchmark imports JAX, its relatives or the JAX package,
and the reference imports nothing of the port: each module's top-level
name (before the first dot) is compared whole. A run in whose process
such a module is loaded by the time its result is due, the comparison
included, prints no result."""

import argparse
import ast
import json
import os
import sys
import types

import pytest
import torch

import tiny
from harness import main

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "e_osvos_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH)
               for f in fs if f.endswith(".py"))


def top_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_imports(path):
    names = set(top_names(path))
    assert not names & FORBIDDEN
    if os.path.relpath(path, BENCH).startswith("plainref"):
        assert "e_osvos_torch" not in names


def test_scan_compares_whole_names():
    assert "e_osvos_torch" not in FORBIDDEN  # the port's name begins alike
    assert {"e_osvos_tpu"} & FORBIDDEN


def _run_tiny(capsys):
    args = argparse.Namespace(seed=2 ** 31 + 5, seconds=0.0, trace=0)
    info = {"kind": "cpu", "power_limit": "none"}
    rc = main.measure(tiny.cell("deeplabv3plus", 1), args,
                      torch.device("cpu"), info, 0.0)
    return rc, capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("planted", [False, True])
def test_no_result_once_jax_is_loaded(planted, monkeypatch, capsys):
    for name in list(sys.modules):
        if name.split(".")[0] in main.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    if planted:  # the comparison, the last stage before the result, loads it
        compare = main.Bench.compare

        def loading_jax(self, *a, **kw):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return compare(self, *a, **kw)

        monkeypatch.setattr(main.Bench, "compare", loading_jax)
    rc, out = _run_tiny(capsys)
    if planted:
        assert rc != 0 and not any(line.startswith("{") for line in out)
    else:
        assert rc == 0
        result = json.loads(out[-1])
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(result)
