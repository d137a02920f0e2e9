"""A whole run of a cell on the CPU (the program's plain torch paths), the
result line's keys, and the command's refusals."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import REPO, TINY_CELL

from rfbench.cell import run_cell

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
E2E = [m["name"] for m in BENCH["end_to_end"]]
LAYER = [m["name"] for m in BENCH["per_layer"]]
# read from the card's profiler or wall times only: no CPU number under
# a device metric's name
DEVICE_ONLY = {"search_roofline", "hop_roofline", "device.idle_pct"}


def _run(root, trace, seed=987654321012):
    return run_cell(root, TINY_CELL, seed, 0.5, trace, torch.device("cpu"),
                    log=lambda msg: None)


def test_a_run_has_exactly_the_contract_keys(tiny_root):
    r = _run(tiny_root, False)
    # "run" (ignored by the contract) explains a first run's set-up;
    # "checks" comes last
    assert list(r) == CONTRACT_KEYS + ["run", "checks"]
    assert r["run"]["kernels_built_s"] == 0.0
    assert 0 < r["run"]["host"]["thread_cpu_share"] <= 1.05
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0 and r["attempted"] % 64 == 0
    assert set(r["metrics"]) == set(E2E)
    for m in BENCH["end_to_end"]:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
        assert r["metrics"][m["name"]]["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["limit"] is not None
    json.dumps(r, allow_nan=False)


def test_a_traced_run_reports_the_per_layer_metrics(tiny_root):
    r = _run(tiny_root, True)
    assert list(r) == CONTRACT_KEYS + ["run", "checks"]
    assert r["correct"] is True
    assert set(r["metrics"]) == set(LAYER) - DEVICE_ONLY
    assert r["metrics"]["search.dists_per_query"]["value"] > 10


def test_a_metric_mix_and_deployment_are_added_by_new_files(tiny_root):
    """A new deployment, traffic mix and cell (``tiny.small``, made by the
    fixture from new files) run; a new per-layer metric is one new module
    and one entry of BENCHMARK.json."""
    (tiny_root / "rfbench/metrics/search.hops_per_query.py").write_text(
        "def read(ctx):\n"
        "    s = ctx.rec.searches if ctx.rec else []\n"
        "    rows = sum(x.rows for x in s)\n"
        "    return sum(x.n_hops for x in s) / rows if rows else None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "search.hops_per_query", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "beam search", "moves": "qps",
        "workloads": [TINY_CELL]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run(tiny_root, True)
    assert r["metrics"]["search.hops_per_query"]["value"] > 1


def _cli(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "rfbench/run.py", "--workload", "ytaudio1m.mixed",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={**os.environ, **(env or {})})


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    p = _cli(REPO)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copytree(REPO / "rfbench", tmp_path / "rfbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = _cli(tmp_path, env={"PYTHONPATH": str(REPO / "src")})
    assert p.returncode != 0 and p.stdout == ""
    assert "no program" in p.stderr


def test_the_command_refuses_the_programs_knobs():
    p = _cli(REPO, env={"RTORCH_IMPL": "torch"})
    assert p.returncode != 0 and p.stdout == ""
    assert "RTORCH_IMPL" in p.stderr


@pytest.mark.cuda
def test_a_run_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_cell(tiny_root, TINY_CELL, 3, 1.0, True, torch.device("cuda", 0),
                 log=lambda msg: None)
    assert r["correct"] is True
    assert set(r["metrics"]) == set(LAYER)
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert 0 < r["metrics"]["hop_roofline"]["value"] <= 105
