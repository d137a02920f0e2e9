"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest rfbench/tests`` from the repository's root).

``tiny_root`` is a copy of the benchmark with one more cell made of new
files only: a deployment small enough for the CPU, a traffic mix of 64
clients, and that cell's limits. The program runs its plain torch paths
there (``device="cpu"``).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_CELL = "tiny.small"


def make_tiny_root(dst: pathlib.Path, n: int = 2048) -> pathlib.Path:
    """A checkout-like directory: ``BENCHMARK.json`` and ``rfbench/`` with
    the cell ``tiny.small`` added by new files."""
    shutil.copytree(REPO / "rfbench", dst / "rfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny", "source": "tests", "reduced": ["n", "d"],
        "file": "rfbench/deployments/tiny.json", "why": "CPU tests"})
    bench["workloads"].append({
        "name": TINY_CELL, "config": "tiny", "traffic": "small", "chips": 1,
        "why": "CPU tests"})
    for m in bench["per_layer"]:
        m["workloads"].append(TINY_CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    dep = json.loads(
        (REPO / "rfbench/deployments/ytaudio-1m.json").read_text())
    dep.update(name="tiny", n=n, d=16, n_clusters=8,
               build={"m": 8, "ef_construction": 32})
    (dst / "rfbench/deployments/tiny.json").write_text(json.dumps(dep))
    tr = json.loads((REPO / "rfbench/traffic/mixed.json").read_text())
    tr.update(name="small", clients=64, max_batch=64, pool=256)
    (dst / "rfbench/traffic/small.json").write_text(json.dumps(tr))
    lim = json.loads(
        (REPO / "rfbench/limits/ytaudio1m.mixed.json").read_text())
    lim["cell"] = TINY_CELL
    (dst / f"rfbench/limits/{TINY_CELL}.json").write_text(json.dumps(lim))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
