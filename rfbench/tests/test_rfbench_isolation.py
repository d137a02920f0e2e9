"""What a run loads: never ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; and the reference and the comparison load nothing of the
program. Names are compared whole, by the part before the first dot:
``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
CHILD = """
import json, pathlib, sys
sys.path[:0] = [{src!r}, {repo!r}, {tests!r}]
import torch
from conftest import make_tiny_root, TINY_CELL
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body: str, tmp_path) -> set[str]:
    code = CHILD.format(src=str(REPO / "src"), repo=str(REPO),
                        tests=str(REPO / "rfbench/tests"), body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    body = f"""
from rfbench.cell import run_cell
from rfbench import control, run
root = make_tiny_root(pathlib.Path({str(tmp_path)!r}))
r = run_cell(root, TINY_CELL, 1, 0.3, True, torch.device("cpu"),
             log=lambda m: None)
assert r["correct"], r["checks"]
assert run.loaded_forbidden() == []
"""
    mods = _modules(body, tmp_path)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    body = "from rfbench import reference, judge, gen, yardstick"
    mods = _modules(body, tmp_path)
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_the_reference_imports_nothing_of_the_program_in_its_source():
    for name in ("reference.py", "judge.py", "gen.py", "yardstick.py"):
        tree = ast.parse((REPO / "rfbench" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & (FORBIDDEN | {"repro_torch"}), (name, tops)


def test_the_forbidden_check_compares_whole_names():
    from rfbench import run

    saved = dict(sys.modules)
    before = run.loaded_forbidden()
    try:
        sys.modules["repro_torch_like"] = sys
        sys.modules["reprox.y"] = sys
        assert run.loaded_forbidden() == before
        sys.modules["repro.core"] = sys
        assert "repro" in run.loaded_forbidden()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
