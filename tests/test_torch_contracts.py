"""The port's counterparts of ``repro``'s replint rules R1-R6
(``src/repro/lint/rules/r*.py``), which scan only ``src/repro``. This
file is the port's replint: ``pytest tests/test_torch_contracts.py``, on
the CPU. A line is exempt only where it carries ``# allow[R<n>]:
<reason>``; ``bench/ci_gate.py`` fails when those markers grow past
``MAX_ALLOW_MARKERS`` or one lacks its reason.

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
  * **R3, sync discipline** (``repro``'s jit discipline: the port has no
    tracer; what must not happen is a host sync inside the device loop).
    In ``core/search.py::beam_search``'s ``body`` and what it reaches
    every iteration (``R3_SCOPE``: ``_smallest``, the hop and neighbour
    closures, ``core/bitset.py``, the hop, gather and select wrappers and
    their dispatch in ``kernels/ops.py``): no ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``nonzero``, ``synchronize``, no ``int`` /
    ``float`` / ``bool`` of a tensor expression and no truth test of one
    (``if``, ``and``, ``not``), no indexing by a boolean mask; shapes
    (``.shape``, ``.ndim``, ``.dtype``, ``len()``, ...) are host values.
    The loop's one sync, ``bool(state[4].any())`` each ``ITER_BLOCK``, is
    outside ``body``; ``chip_smoke.py``'s ``contracts[sync]`` phase counts
    the syncs of a search on the card.
  * **R4, the shared-memory budget** (``repro``'s VMEM budget):
    ``kernels/smem_budget.py::findings`` is empty: every autotune
    candidate at its probe and production shapes, pairwise_dist's plans
    and both flash bodies fit the H100's block limit; every
    ``CANDIDATES`` kind has a size function; every ``csrc/*.cu`` launch
    with dynamic shared memory is covered. On the card,
    ``contracts[smem]`` holds each Python mirror to its C formula.
  * **R6, import reachability.** Every module under ``src/repro_torch/``
    is reachable through the static import graph from the port's entry
    points (``R6_ENTRY_POINTS``, every ``bench`` module with a ``main``,
    ``chip_smoke.py`` and ``prune_time.py``). No fence: a dead module is
    wired in or deleted.
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


# ---------------------------------------------------------------------------
# R3
# ---------------------------------------------------------------------------

ALL = "*"
# file -> function (``outer.inner`` for a closure) -> its tensor
# parameters: what beam_search's loop runs every iteration
R3_SCOPE = {
    "core/search.py": {
        "beam_search.body": ALL, "_smallest": ("x",),
        "search_improvised.hop_fn": ALL, "search_fixed_layer.nbr_fn": ALL,
        "search_filtered.nbr_fn": ALL, "search_filtered.filt": ALL},
    "core/bitset.py": {"test_and_set": ALL, "lookup": ALL},
    "core/storage.py": {"decode_neighbors": ("nbrs",)},
    "kernels/ops.py": {
        "gather_dist": ("q", "table", "ids"),
        "select_edges": ("nbrs", "us", "L", "R"),
        "hop": ("q", "table", "nbrs", "u", "L", "R", "visited", "exp_ok"),
        "resolve_impl": ("on",), "resolve_hop": ("on",),
        "default_impl": ("on",), "_check_impl": ("on",),
        "_device_auto": ("on",)},
    "kernels/autotune.py": {"merged": (), "get_pick": ()},
    "kernels/gather_distance.py": {
        "gather_dist_cuda": ("q", "table", "ids"), "table_args": ("table",),
        "rows_vec": (), "plan": (), "_plan": ()},
    "kernels/hop.py": {"hop_cuda": ("q", "table", "nbrs", "u", "L", "R",
                                     "visited", "exp_ok")},
    "kernels/edge_select.py": {
        "select_edges_cuda": ("nbrs", "us", "L", "R"),
        "frontier_bounds": ("L", "R"), "_bounds": ("x",),
        "check_table": ("nbrs",)},
    "kernels/_build.py": {"check_tensor": ("t",), "check": (),
                          "stream_of": (), "on_device": ()},
}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
SYNC_FNS = {"nonzero", "argwhere"}
COERCE = {"int", "float", "bool"}
# host values of a tensor: attributes and methods that do not sync
SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout"}
HOST_METHODS = {"size", "dim", "numel", "element_size", "is_contiguous",
                "stride", "data_ptr", "get_device"}
# calls whose results are host values whatever their arguments
HOST_FNS = {"len", "isinstance", "hasattr", "getattr", "str", "tuple",
            "dict", "range", "table_args", "plan", "rows_vec",
            "check_tensor", "check_table", "resolve_impl", "resolve_hop",
            "default_impl", "_device_auto", "_check_impl", "merged",
            "get_pick", "stream_of", "on_device", *COERCE}
MASK_FNS = {"isfinite", "isnan", "isinf", "any", "all", "eq", "ne", "lt",
            "le", "gt", "ge", "logical_and", "logical_or", "logical_not"}
R3_ALLOW = re.compile(r"#\s*allow\[R3\](:?)(.*)")


def _shape_routed(expr) -> bool:
    return any((isinstance(n, ast.Attribute) and n.attr in SHAPE_ATTRS)
               or (isinstance(n, ast.Call) and _dotted(n.func) == "len")
               for n in ast.walk(expr))


class _Taint:
    """Which names of one function hold tensors: its tensor parameters,
    then every name assigned a tensor expression, to a fixed point."""

    def __init__(self, fn, tensor_params):
        a = fn.args
        params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        self.names = set(params if tensor_params == ALL else tensor_params)
        self.masks = set()
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AugAssign))]
        while True:
            before = (len(self.names), len(self.masks))
            for n in assigns:
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                tensor, mask = self.tensor(n.value), self.mask(n.value)
                for t in targets:
                    for name in ast.walk(t):
                        if isinstance(name, ast.Name):
                            if tensor:
                                self.names.add(name.id)
                            if mask:
                                self.masks.add(name.id)
            if (len(self.names), len(self.masks)) == before:
                return

    def tensor(self, e) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            return e.attr not in SHAPE_ATTRS and self.tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.tensor(e.value)
        if isinstance(e, ast.Call):
            f = _dotted(e.func)
            if f.split(".")[-1] in HOST_FNS:
                return False
            if f.startswith("torch.") and not f.startswith("torch.cuda."):
                return True     # torch.cuda.*: devices and streams
            if isinstance(e.func, ast.Attribute):
                if e.func.attr in HOST_METHODS:
                    return False
                if self.tensor(e.func.value):
                    return True
            return any(self.tensor(x) for x in
                       [*e.args, *(k.value for k in e.keywords)])
        if isinstance(e, ast.Compare):
            if all(isinstance(o, (ast.Is, ast.IsNot)) for o in e.ops):
                return False
            return any(self.tensor(x) for x in [e.left, *e.comparators])
        if isinstance(e, (ast.BinOp, ast.BoolOp, ast.UnaryOp, ast.IfExp,
                          ast.Tuple, ast.List)):
            return any(self.tensor(x) for x in ast.iter_child_nodes(e)
                       if isinstance(x, ast.expr))
        return False

    def mask(self, e) -> bool:
        """A boolean tensor expression."""
        if isinstance(e, ast.Name):
            return e.id in self.masks
        if isinstance(e, ast.Compare):
            return self.tensor(e)
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.tensor(e)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self.tensor(e)
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute):
            return e.func.attr in MASK_FNS and self.tensor(e)
        return False


def _r3_function_findings(fn, tensor_params) -> list[tuple[int, str]]:
    t = _Taint(fn, tensor_params)
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = _dotted(node.func)
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            if attr in SYNC_METHODS:
                out.append((node.lineno, f".{attr}()"))
            elif f.split(".")[-1] in SYNC_FNS:
                out.append((node.lineno, f))
            elif f in COERCE and len(node.args) == 1 and \
                    not _shape_routed(node.args[0]) and \
                    t.tensor(node.args[0]):
                out.append((node.lineno, f"{f}() of a tensor"))
        tests = []
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            tests.append(node.test)
        elif isinstance(node, ast.BoolOp):
            tests += node.values
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            tests.append(node.operand)
        for x in tests:
            if not _shape_routed(x) and t.tensor(x):
                out.append((x.lineno, "truth test of a tensor"))
        if isinstance(node, ast.Subscript):
            idx = node.slice.elts if isinstance(node.slice, ast.Tuple) \
                else [node.slice]
            if any(t.mask(i) for i in idx):
                out.append((node.lineno, "indexing by a boolean mask"))
    return out


def _find_function(tree, qualname):
    node = tree
    for part in qualname.split("."):
        node = next((n for n in ast.walk(node)
                     if isinstance(n, ast.FunctionDef) and n.name == part),
                    None)
        if node is None:
            return None
    return node


def _r3_findings(src: str, scope: dict) -> list[tuple[str, int, str]]:
    """``(function, line, what)`` for every sync in ``scope``'s functions
    of ``src``, lines marked ``# allow[R3]: <reason>`` excepted; a marker
    without a reason is itself a finding; a function not found, too."""
    tree, text = ast.parse(src), src.splitlines()
    out = []
    for qualname, params in scope.items():
        fn = _find_function(tree, qualname)
        if fn is None:
            out.append((qualname, 0, "not found"))
            continue
        for line, what in sorted(set(_r3_function_findings(fn, params))):
            m = R3_ALLOW.search(text[line - 1])
            if m and m.group(1) and m.group(2).strip():
                continue
            out.append((qualname, line, what + (
                " (allow[R3] marker without a reason)" if m else "")))
    return out


@pytest.mark.parametrize("rel", sorted(R3_SCOPE))
def test_r3_no_host_sync_in_the_loop(rel):
    got = _r3_findings((PORT / rel).read_text(), R3_SCOPE[rel])
    assert not got, f"{rel}: {got}"


def test_r3_the_loop_check_is_outside_body():
    """The loop's one sync each ITER_BLOCK, and the only one in
    beam_search: the ``while`` test, not inside ``body``."""
    tree = ast.parse((PORT / "core" / "search.py").read_text())
    bs = _find_function(tree, "beam_search")
    whiles = [n for n in ast.walk(bs) if isinstance(n, ast.While)]
    assert len(whiles) == 1
    assert ast.unparse(whiles[0].test) == \
        "it < max_iters and bool(state[4].any())"
    body = _find_function(tree, "beam_search.body")
    assert not body.lineno <= whiles[0].lineno <= body.end_lineno


def _body_copy(extra: str, marker: str = "") -> str:
    """``beam_search`` with ``extra`` added as the first statement of its
    ``body``."""
    src = (PORT / "core" / "search.py").read_text()
    tree = ast.parse(src)
    body = _find_function(tree, "beam_search.body")
    first = body.body[0]
    lines = src.splitlines()
    pad = " " * first.col_offset
    lines.insert(first.lineno - 1, pad + extra + marker)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("extra", [
    "n = cand_ids.max().item()",
    "go = bool(active.any())",
    "lst = cand_ids.tolist()",
    "host = cand_dists.cpu()",
    "idx = torch.nonzero(active)",
    "torch.cuda.synchronize()",
    "live = cand_ids[cand_ids >= 0]",
    "if active.any():\n            pass",
])
def test_r3_fires_in_a_copy_of_body(extra, tmp_path):
    path = tmp_path / "search.py"
    path.write_text(_body_copy(extra))
    got = _r3_findings(path.read_text(), {"beam_search.body": ALL})
    assert got and all(f[0] == "beam_search.body" for f in got), got


def test_r3_marker_needs_a_reason(tmp_path):
    scope = {"beam_search.body": ALL}
    ok = _body_copy("n = cand_ids.max().item()",
                    "  # allow[R3]: a planted exemption")
    assert not _r3_findings(ok, scope)
    bare = _body_copy("n = cand_ids.max().item()", "  # allow[R3]")
    got = _r3_findings(bare, scope)
    assert len(got) == 1 and "without a reason" in got[0][2]


def test_r3_shapes_and_host_values_are_clean():
    src = ("import torch\n"
           "def body(x, mask):\n"
           "    B = int(x.shape[0])\n"
           "    k = int(len(x))\n"
           "    if x.dtype == torch.int32 and x.is_contiguous():\n"
           "        pass\n"
           "    if x is not None:\n"
           "        pass\n"
           "    return torch.where(mask, x, -1)[:, :k]\n")
    assert not _r3_findings(src, {"body": ALL})
    assert _r3_findings(src, {"ghost": ALL}) == [("ghost", 0, "not found")]


# ---------------------------------------------------------------------------
# R4
# ---------------------------------------------------------------------------

from repro_torch.kernels import autotune, smem_budget  # noqa: E402


def test_r4_every_plan_fits_the_card():
    assert not smem_budget.findings()
    kinds = {e["kind"] for e in smem_budget.entries()}
    assert set(autotune.CANDIDATES) <= kinds
    assert {"pairwise_dist", "flash[wgmma]", "flash[cuda_cores]"} <= kinds
    assert all(e["c"] is not None for e in smem_budget.entries())


def test_r4_covers_every_candidate_kind_and_launch():
    assert set(autotune.CANDIDATES) <= set(smem_budget.SIZES)
    got = smem_budget.launches_in()
    assert got == {name: len(fns) for name, fns in
                   smem_budget.LAUNCHES.items()}, got
    # the production shapes include the partial regime
    regimes = {_prune_regime(e) for e in smem_budget.entries()
               if e["kind"] == "prune"}
    assert {"block", "table", "partial"} <= regimes


def _prune_regime(e):
    from repro_torch.kernels import prune

    C, d = e["c"][2][:2]
    return prune.smem_plan(C, d, e["params"] or None).regime


def test_r4_fires_when_budget_shrinks(monkeypatch):
    monkeypatch.setattr(smem_budget, "LIMIT", 48 << 10)
    got = smem_budget.findings()
    assert got, "a shrunk budget must trip plans"
    assert any(f.startswith("prune[") for f in got)
    assert any(f.startswith("flash[wgmma]") for f in got)
    assert any(f.startswith("pairwise_dist") for f in got)
    assert all("refuses" not in f for f in got)


def test_r4_fires_on_a_kind_without_a_size_function():
    cands = {**autotune.CANDIDATES, "toy": lambda p: [{"block": 8}]}
    got = smem_budget.findings(candidates=cands)
    assert any("'toy'" in f and "no size function" in f for f in got), got


def test_r4_fires_on_an_uncovered_launch(tmp_path):
    for p in smem_budget.CSRC.glob("*.cu"):
        (tmp_path / p.name).write_text(p.read_text())
    assert not smem_budget.findings(csrc=tmp_path)
    (tmp_path / "rogue.cu").write_text(
        "void go(int smem, cudaStream_t s) {\n"
        "  rogue_kernel<<<64, 128, smem, s>>>();\n"
        "  quiet_kernel<<<64, 128, 0, s>>>();\n}\n")
    got = smem_budget.findings(csrc=tmp_path)
    assert got == ["rogue.cu: 1 launches with dynamic shared memory, 0 "
                   "covered by smem_budget.LAUNCHES"], got
    hop = tmp_path / "hop.cu"
    hop.write_text(hop.read_text() + "\nvoid more(int smem) {\n"
                   "  kernel<<<1, 32,\n      smem, 0>>>();\n}\n")
    assert any(f.startswith("hop.cu: 2 launches")
               for f in smem_budget.findings(csrc=tmp_path))


# ---------------------------------------------------------------------------
# R6
# ---------------------------------------------------------------------------

R6_ENTRY_POINTS = (
    "repro_torch", "repro_torch.core.index", "repro_torch.core.baselines",
    "repro_torch.core.multiattr", "repro_torch.core.distributed",
    "repro_torch.serve.engine", "repro_torch.serve.loop",
    "repro_torch.serve.executor", "repro_torch.kernels.ops",
    "repro_torch.compressio", "repro_torch.launch.serve",
    "repro_torch.launch.train")


def _module_map(src_dir: pathlib.Path) -> dict[str, pathlib.Path]:
    """Module name -> file for everything under ``src_dir`` (``repro``'s
    ``r6_reachability.py::_module_map``)."""
    out = {}
    for path in sorted(src_dir.rglob("*.py")):
        parts = list(path.relative_to(src_dir).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join([src_dir.name, *parts])] = path
    return out


def _r6_imports(path: pathlib.Path, modname: str, known) -> set[str]:
    """The modules of ``known`` that ``path`` (module ``modname``; a
    script when None) imports, relative imports resolved as ``repro``'s
    ``_imports`` does: an import of a.b.c marks a, a.b and a.b.c."""
    is_pkg = path.name == "__init__.py"
    out = set()

    def add(name):
        parts = name.split(".")
        out.update(c for c in (".".join(parts[:i])
                               for i in range(1, len(parts) + 1))
                   if c in known)

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level and modname:
                parts = modname.split(".")
                drop = node.level - (1 if is_pkg else 0)
                anchor = parts[:len(parts) - drop] if drop else parts
                target = ".".join(anchor + ([node.module] if node.module
                                            else []))
            else:
                target = node.module or ""
            add(target)
            for a in node.names:
                add(f"{target}.{a.name}")
    return out


def _r6_findings(src_dir, entry_points, scripts=()) -> list[str]:
    modules = _module_map(pathlib.Path(src_dir))
    graph = {name: _r6_imports(path, name, modules)
             for name, path in modules.items()}
    out = [f"entry point {e!r} names no module" for e in entry_points
           if e not in modules]
    roots = {e for e in entry_points if e in modules}
    for script in scripts:
        roots |= _r6_imports(pathlib.Path(script), None, modules)
    reach = set()
    for r in roots:   # a module's enclosing packages import first
        parts = r.split(".")
        reach.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
    frontier = list(reach & set(modules))
    while frontier:
        for nxt in graph.get(frontier.pop(), ()):
            if nxt not in reach:
                reach.add(nxt)
                frontier.append(nxt)
    return out + [f"{name} is unreachable from every entry point"
                  for name in sorted(set(modules) - reach)]


def _bench_mains() -> list[str]:
    return sorted(
        f"repro_torch.bench.{p.stem}" for p in (PORT / "bench").glob("*.py")
        if "main" in {n.name for n in ast.parse(p.read_text()).body
                      if isinstance(n, ast.FunctionDef)})


def test_r6_every_module_is_reachable():
    mains = _bench_mains()
    assert {"repro_torch.bench.ci_gate", "repro_torch.bench.hotpath",
            "repro_torch.bench.buildpath", "repro_torch.bench.serve_slo",
            "repro_torch.bench.run"} <= set(mains)
    got = _r6_findings(PORT, R6_ENTRY_POINTS + tuple(mains), SCRIPTS)
    assert not got, got


def _r6_tree(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return tmp_path / "pkg"


def test_r6_fires_on_a_dead_module(tmp_path):
    src = _r6_tree(tmp_path, {"pkg/__init__.py": "from pkg import used\n",
                              "pkg/used.py": "X = 1\n",
                              "pkg/sub/__init__.py": "",
                              "pkg/sub/dead.py": "Y = 2\n"})
    assert _r6_findings(src, ("pkg",)) == [
        "pkg.sub is unreachable from every entry point",
        "pkg.sub.dead is unreachable from every entry point"]
    # wired in by a relative import, or by a script
    (src / "used.py").write_text("from .sub import dead\nX = 1\n")
    assert not _r6_findings(src, ("pkg",))
    (src / "used.py").write_text("X = 1\n")
    script = tmp_path / "run.py"
    script.write_text("def main():\n    from pkg.sub import dead\n")
    assert not _r6_findings(src, ("pkg",), [script])


def test_r6_fires_on_an_entry_point_that_names_no_module(tmp_path):
    src = _r6_tree(tmp_path, {"pkg/__init__.py": "X = 1\n"})
    assert _r6_findings(src, ("pkg", "pkg.ghost")) == [
        "entry point 'pkg.ghost' names no module"]
