"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

Everything that belongs to one deployment, one traffic mix, one cell's
limits or one metric sits in a file of its own, found by name:

  * ``rfbench/deployments/<config>.json``
  * ``rfbench/traffic/<traffic>.json``
  * ``rfbench/limits/<cell>.json``
  * ``rfbench/metrics/<metric>.py`` (a module with ``read(ctx)``)

so a later change adds a cell, a mix or a metric with new files only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


class SpecError(RuntimeError):
    """A cell, or a file it names, is missing or malformed."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    deployment: dict
    traffic: dict
    limits: dict
    end_to_end: list      # metric entries of BENCHMARK.json for this cell
    per_layer: list


def _load_json(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{path}: {e}") from None


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files under
    ``<root>/rfbench``."""
    root = pathlib.Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"{name}: no config {w['config']!r}")
    base = root / "rfbench"
    dep = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(base / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    for m in e2e + layer:
        metric_path(root, m["name"])  # every metric has its reader
    return Cell(name, int(w["chips"]), dep, traffic, limits, e2e, layer)


def metric_path(root: pathlib.Path, name: str) -> pathlib.Path:
    path = pathlib.Path(root) / "rfbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"metric {name!r} has no reader at {path}")
    return path


def metric_reader(root: pathlib.Path, name: str):
    """The ``read(ctx)`` function of ``rfbench/metrics/<name>.py``."""
    path = metric_path(root, name)
    spec = importlib.util.spec_from_file_location(
        "rfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
