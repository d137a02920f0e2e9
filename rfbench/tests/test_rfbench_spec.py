"""BENCHMARK.json: its shape, and that every cell resolves to its files."""
from __future__ import annotations

import json
import re

import pytest
from conftest import REPO, TINY_CELL

from rfbench import spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "rfbench/run.py"]
    assert BENCH["paths"] == ["rfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.load_cell(REPO, cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "qps"}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(REPO, m["name"]))
    assert set(c.limits["checks"]) == {
        "unanswered", "out_of_range", "duplicate_ids", "perm_mismatch",
        "bad_edges", "dist_gap", "recall_at_10"}


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    layers = set()
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.add(m["layer"])
        if m["name"].endswith("roofline"):
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("rfbench/")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_deployment_files_say_what_was_cut_and_assumed():
    for c in BENCH["configs"]:
        dep = json.loads((REPO / c["file"]).read_text())
        assert dep["name"] == c["name"]
        assert dep["reduced"] == c["reduced"]
        for key in ("source", "n", "d", "n_clusters", "attr_kind", "build",
                    "storage", "guarantee", "assumed", "why"):
            assert key in dep, key
        assert len(dep["source"]) <= 200


def test_a_missing_file_is_refused(tiny_root):
    (tiny_root / f"rfbench/limits/{TINY_CELL}.json").unlink()
    with pytest.raises(spec.SpecError, match="missing file"):
        spec.load_cell(tiny_root, TINY_CELL)
    with pytest.raises(spec.SpecError, match="no workload"):
        spec.load_cell(tiny_root, "no.such.cell")
