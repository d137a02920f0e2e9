"""The port's counterparts of ``repro``'s replint rules R1, R2 and R5
(``src/repro/lint/rules/r{1,2,5}_*.py``), which scan only ``src/repro``.

  * **R1, the knob registry.** No ``os.environ`` / ``os.getenv`` read with
    an ``RTORCH_`` key outside ``core/knobs.py``; every ``RTORCH_*`` name
    written in the port, ``chip_smoke.py`` or ``prune_time.py`` is
    registered; ``docs/KNOBS_torch.md`` is ``generate_markdown()``.
  * **R2, the dispatch contract.** Every op of ``ops.__all__`` checks its
    impl token, reaches a ``_ref.<fn>`` that ``kernels/ref.py`` defines,
    takes a token other than ``cuda``, has a registered
    ``RTORCH_<KIND>_IMPL`` knob, is named by a test file and has a kernel
    record in ``chip_smoke.py``'s ``kernels`` line.
  * **R5, one sentinel.** In the kernels and the core modules that store,
    walk or build the neighbour tables, no ``iinfo(...).max`` and no
    dtype-extreme literal (32767, 65535, 2**31 - 1, 2**32 - 1) in a
    comparison or a fill, except on a line marked ``# allow[R5]:
    <reason>`` (capacity arithmetic, a launch grid's limit).
"""
import ast
import inspect
import pathlib
import re

import pytest

from repro_torch.core import knobs
from repro_torch.kernels import ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "prune_time.py"]
FILES = sorted(PORT.rglob("*.py")) + SCRIPTS
KNOB_RE = re.compile(r"\bRTORCH_[A-Z][A-Z0-9_]*\b")
_ENV_GET = {"os.getenv", "os.environ.get", "environ.get", "getenv"}
_ENV_MAP = {"os.environ", "environ"}
REGISTERED = {k.name for k in knobs.REGISTRY}


def _dotted(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    return ""


def _const_str(node):
    return node.value if isinstance(node, ast.Constant) and \
        isinstance(node.value, str) else None


def _raw_env_reads(tree) -> list[tuple[int, str]]:
    out = []
    for node in ast.walk(tree):
        key = None
        if isinstance(node, ast.Call) and _dotted(node.func) in _ENV_GET \
                and node.args:
            key = _const_str(node.args[0])
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                _dotted(node.value) in _ENV_MAP:
            key = _const_str(node.slice)
        if key and key.startswith(knobs.PREFIX):
            out.append((node.lineno, key))
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_r1_knobs_read_only_through_the_registry(path):
    if path == PORT / "core" / "knobs.py":
        return
    src = path.read_text()
    assert not _raw_env_reads(ast.parse(src)), path
    unregistered = set(KNOB_RE.findall(src)) - REGISTERED
    assert not unregistered, f"{path.name}: {sorted(unregistered)}"


def test_r1_scan_catches_a_raw_read():
    tree = ast.parse("import os\nx = os.environ.get('RTORCH_IMPL')\n"
                     "y = os.environ['RTORCH_STORAGE']\n"
                     "os.environ['RTORCH_IMPL'] = 'torch'\n")
    assert _raw_env_reads(tree) == [(2, "RTORCH_IMPL"),
                                    (3, "RTORCH_STORAGE")]


def test_r1_knobs_md_is_generated():
    doc = ROOT / "docs" / "KNOBS_torch.md"
    assert doc.read_text() == knobs.generate_markdown(), (
        "docs/KNOBS_torch.md drifted from core/knobs.py::REGISTRY")
    for k in knobs.REGISTRY:
        assert f"`{k.name}`" in doc.read_text()


# ---------------------------------------------------------------------------
# R2
# ---------------------------------------------------------------------------

NON_OPS = {"default_impl", "resolve_impl", "resolve_hop", "launch_counts",
           "reset_launch_counts", "layout_counts", "body_counts", "KERNELS"}
OPS = [name for name in ops.__all__ if name not in NON_OPS]
OPS_TREE = ast.parse(inspect.getsource(ops))
FUNCS = {n.name: n for n in OPS_TREE.body if isinstance(n, ast.FunctionDef)}


def _calls(fn, name):
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and _dotted(n.func) == name]


def test_r2_roster():
    assert set(OPS) == set(ops.KERNELS) == {
        "pairwise_dist", "gather_dist", "select_edges", "prune", "hop",
        "flash_attention"}


@pytest.mark.parametrize("op", OPS)
def test_r2_every_op_keeps_the_dispatch_contract(op):
    fn = FUNCS[op]
    checks = _calls(fn, "resolve_impl") + _calls(fn, "resolve_hop")
    assert checks, f"{op} never resolves (checks) its impl token"
    # a registered RTORCH_<KIND>_IMPL knob and a token other than cuda
    if op == "hop":
        body = inspect.getsource(ops.resolve_hop)
        kind_knobs = set(KNOB_RE.findall(body))
        allowed = re.search(r"allowed = \(([^)]*)\)", body).group(1)
        tokens = set(re.findall(r'"(\w+)"', allowed))
    else:
        call = checks[0]
        kind = _const_str(call.args[3]) if len(call.args) > 3 else \
            _const_str(next(k.value for k in call.keywords
                            if k.arg == "kind"))
        kind_knobs = {f"RTORCH_{kind.upper()}_IMPL"}
        kw = {k.arg: k.value for k in call.keywords}
        tokens = ({_const_str(e) for e in kw["allowed"].elts}
                  if "allowed" in kw else {"cuda", "torch"})
    assert kind_knobs and kind_knobs <= REGISTERED, (op, kind_knobs)
    assert tokens - {"cuda"}, f"{op} has no oracle token"
    # the plain version it dispatches to exists in kernels/ref.py
    refs = {n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)
            and _dotted(n.value) == "_ref"}
    assert refs and all(callable(getattr(ref, r, None)) for r in refs), refs
    # named by a test, and recorded in the smoke's kernels line
    pat = re.compile(rf"\b{op}\b")
    assert any(pat.search(p.read_text()) for p in
               (ROOT / "tests").glob("test_*.py")
               if p.name != "test_torch_contracts.py"), op
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert re.search(rf'["\']{op}["\']', smoke), op


# ---------------------------------------------------------------------------
# R5
# ---------------------------------------------------------------------------

MAGIC = {32767, 65535, 2147483647, 4294967295}
FILL = {"where", "full", "full_like", "fill_", "masked_fill", "new_full"}
ALLOW = re.compile(r"#\s*allow\[R5\]:\s*\S")


def _is_iinfo_max(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "max"
            and isinstance(node.value, ast.Call)
            and _dotted(node.value.func).split(".")[-1] == "iinfo")


def _magic(node) -> bool:
    return isinstance(node, ast.Constant) and type(node.value) is int \
        and node.value in MAGIC


def _r5_findings(src: str) -> list[int]:
    lines = []
    for node in ast.walk(ast.parse(src)):
        if _is_iinfo_max(node):
            lines.append(node.lineno)
        elif isinstance(node, ast.Compare) and any(
                _magic(x) for x in [node.left, *node.comparators]):
            lines.append(node.lineno)
        elif isinstance(node, ast.Call) and \
                _dotted(node.func).split(".")[-1] in FILL and \
                any(_magic(a) for a in node.args):
            lines.append(node.lineno)
    text = src.splitlines()
    return sorted(n for n in set(lines) if not ALLOW.search(text[n - 1]))


# R5's scope, as repro's (lint/__init__.py:133-143): the kernels and the
# core modules that store, walk or build the neighbour tables
SENTINEL_PATHS = sorted(PORT.glob("kernels/*.py")) + [
    PORT / "core" / f"{m}.py" for m in (
        "storage", "bitset", "search", "search_ref", "edge_select", "rng",
        "build", "index", "distributed")]


@pytest.mark.parametrize("path", SENTINEL_PATHS,
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_r5_minus_one_is_the_only_sentinel(path):
    assert not _r5_findings(path.read_text()), path


def test_r5_scan_catches_sentinels_and_honours_marks():
    src = ("import numpy as np, torch\n"
           "a = x == 32767\n"
           "b = torch.where(m, 65535, y)\n"
           "c = n <= np.iinfo(np.int16).max  # allow[R5]: capacity\n"
           "d = n <= np.iinfo(np.int16).max\n"
           "e = x == -1\n")
    assert _r5_findings(src) == [2, 3, 5]
    marked = [p.relative_to(PORT).as_posix() for p in SENTINEL_PATHS
              if ALLOW.search(p.read_text())]
    assert sorted(marked) == ["core/storage.py", "kernels/flash_attention.py"]
