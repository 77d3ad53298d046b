"""Every configuration, traffic mix, limits file and metric reader that
BENCHMARK.json names loads by its name, and the file keeps to the
contract's shape."""

import json
import os
import re

import pytest

from harness import cells

ROOT = cells.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    c = cells.config(cfg["name"])
    assert c["precision"]["cudnn_allow_tf32"] is False
    assert c["precision"]["matmul_allow_tf32"] is False
    cells.family(c["family"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_load(cell):
    c = cells.load_cell(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "seq_fps"}
    assert c.per_layer and c.limits
    assert c.limits["merged_off"] == 0 and c.limits["passes_off"] == 0
    assert int(c.traffic["frames"]) > 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(metric):
    assert NAME.match(metric["name"])
    assert metric["better"] in ("lower", "higher")
    assert callable(cells.metric_reader(metric["name"]).read)
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    else:
        assert 0.01 <= metric["bound"] <= 0.25
