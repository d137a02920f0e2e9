"""The shared-memory budget of every launch plan: the port's counterpart
of ``repro``'s replint R4 (``src/repro/lint/rules/r4_vmem_budget.py``).

R4 holds each Pallas kernel's VMEM to its budget for every autotune
candidate, at the probe shapes and at production shapes, and checks that
its table covers every kernel. On the H100 the budget is a block's
dynamic shared memory, at most :data:`LIMIT` (232,448 B: the most
``cudaFuncSetAttribute`` grants). Each launch plan is a Python mirror of
a formula that the C entry computes again for itself (``gather_smem``,
``hop_smem``, ``edge_smem``, ``smem_bytes`` and ``table_bytes``, the
flash bodies' bytes, ``kSmem``): a mirror that drifts from its C formula
lets a plan say that a launch fits, and the card then refuses it. So
each C library exports its formula as a plain ``extern "C"`` function
(``rt_*_smem``), and on the card every entry is held to it: the port's
form of R4's "no parallel bookkeeping".

  * :func:`entries` -- every launch the rule checks, with the bytes of its
    Python mirror and the C size function that gives the C side's
    (library, symbol, arguments): each ``autotune.CANDIDATES[kind]``
    candidate at each ``autotune.PROBES`` shape and each
    :data:`PRODUCTION` shape, pairwise_dist's plan per dtype, and the
    two flash bodies at every head dim from 1 to 256;
  * :func:`findings` -- an entry over the budget, a candidate its plan
    refuses, a ``CANDIDATES`` kind without a size function
    (:data:`SIZES`), and a ``csrc/*.cu`` launch with dynamic shared
    memory (``<<<grid, block, smem, stream>>>``, smem not 0) that
    :data:`LAUNCHES` does not cover, so that a new launch fails until it
    is covered. ``tests/test_torch_contracts.py`` holds it empty;
  * :func:`c_mismatches` -- on the card, each entry's C bytes against its
    mirror's (``chip_smoke.py``'s ``contracts[smem]`` phase).
"""
from __future__ import annotations

import ctypes
import pathlib
import re

import torch

from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import distance as _distance
from repro_torch.kernels import edge_select as _edge
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gather_distance as _gather
from repro_torch.kernels import prune as _prune

__all__ = ["LIMIT", "PRODUCTION", "SIZES", "LAUNCHES", "entries",
           "findings", "c_mismatches", "launches_in"]

LIMIT = _gather.SMEM_LIMIT
CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_K1M, _KLM = 21 * 16, 18 * 16   # hop K: (logn + 1) * m at 1M and 131,072

# the main paths' shapes beside autotune.PROBES: the 1M cell's build,
# entries and frontier (d 128), the lm cell's build chunk and server (d
# 1,024), and the prune's partial regime (prune_time.py's prune_designs)
PRODUCTION = {
    "gather_dist": (
        {"name": "1M build", "B": 32768, "M": 64, "d": 128, "layout": "f32"},
        {"name": "1M entries", "B": 32768, "M": 3, "d": 128,
         "layout": "f32"},
        {"name": "1M frontier bf16", "B": 1000, "M": 64, "d": 128,
         "layout": "bf16"},
        {"name": "lm chunk", "B": 4096, "M": 64, "d": 1024,
         "layout": "f32"}),
    "gather_dist_codec": (
        {"name": "1M frontier pq", "B": 1000, "M": 64, "d": 128,
         "layout": "pq"},
        {"name": "lm chunk int8", "B": 4096, "M": 64, "d": 1024,
         "layout": "int8"}),
    "hop": tuple(
        {"name": f"1M frontier {lay}", "B": 1000, "W": 4, "m_out": 16,
         "d": 128, "layout": lay, "K": _K1M}
        for lay in _gather.LAYOUTS) + (
        {"name": "lm server int8", "B": 64, "W": 4, "m_out": 16, "d": 1024,
         "layout": "int8", "K": _KLM},),
    "prune": (
        {"name": "1M brute C128", "C": 128, "d": 128},
        {"name": "lm chunk", "C": 144, "d": 1024},
        {"name": "lm brute", "C": 128, "d": 1024},
        {"name": "lm reverse", "C": 48, "d": 1024},
        {"name": "partial C48 d4096", "C": 48, "d": 4096},
        {"name": "partial C144 d8192", "C": 144, "d": 8192}),
    "edge_select": (
        {"name": "1M frontier", "F": 4000, "K": _K1M, "m_out": 16},
        {"name": "lm server", "F": 256, "K": _KLM, "m_out": 16}),
}


def _gather_size(p, c):
    plan = _gather.plan(p["B"], p["M"], p["layout"], p["d"], True,
                        override=c or None)
    return (_gather.gather_smem(p["d"], plan.slots),
            ("gather_distance", "rt_gather_smem", (p["d"], plan.slots)))


def _hop_size(p, c):
    d, W, K, m_out = p["d"], p["W"], p["K"], p["m_out"]
    _gather.plan(p["B"], W * m_out, p["layout"], d, True, hop=(W, K),
                 override=c or None)
    return (_gather.hop_smem(d, W, K, m_out),
            ("hop", "rt_hop_smem", (d, W, K, m_out)))


def _prune_size(p, c):
    C, d = p["C"], p["d"]
    plan = _prune.smem_plan(C, d, c or None)
    if plan.regime == "table":
        return (_prune.table_bytes(C, d),
                ("prune", "rt_prune_table_bytes", (C, d)))
    return (_prune.smem_bytes(C, d, plan.staged),
            ("prune", "rt_prune_smem", (C, d, plan.staged)))


def _edge_size(p, c):
    K, m_out = p.get("K", _K1M), p.get("m_out", 16)
    return _edge.edge_smem(K, m_out), ("edge_select", "rt_edge_smem",
                                       (K, m_out))


def _flash_tc_size(Dh, dtype=torch.bfloat16):
    # the embed path's plan; the bytes depend on the head dim alone
    t = _flash.plan_tc(256, 16, 8, 32, 32, Dh, dtype)
    sym = "rt_flash_tf32x3_smem" if dtype == torch.float32 else \
        "rt_flash_tc_smem"
    return t.smem_bytes, ("flash_attention", sym, (t.DP,))


# CANDIDATES kind -> (probe, candidate) -> (bytes, (library, symbol, args))
SIZES = {
    "gather_dist": _gather_size,
    "gather_dist_codec": _gather_size,
    "hop": _hop_size,
    "prune": _prune_size,
    "edge_select": _edge_size,
}

# csrc file -> the C size function of each of its launches that take
# dynamic shared memory
LAUNCHES = {
    "gather_distance.cu": ("gather_smem",),
    "hop.cu": ("hop_smem",),
    "edge_select.cu": ("edge_smem",),
    "prune.cu": ("table_bytes", "smem_bytes"),
    "flash_attention.cu": ("smem_bytes", "tf32x3_smem"),
    "distance.cu": ("kSmem",),
}
_LAUNCH = re.compile(r"<<<(.*?)>>>", re.S)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _entry(kind, shape, params, size):
    try:
        nbytes, c = size()
    except ValueError as e:
        return {"kind": kind, "shape": shape, "params": params,
                "bytes": None, "c": None, "error": str(e)}
    return {"kind": kind, "shape": shape, "params": params,
            "bytes": int(nbytes), "c": c}


def entries(candidates=None) -> list[dict]:
    """Every launch the rule checks: ``{kind, shape, params, bytes, c}``
    (``c`` the C size function as ``(library, symbol, args)``), or with
    ``error`` where a plan refuses its candidate. ``candidates``: the
    kinds' candidate functions (default ``autotune.CANDIDATES``)."""
    candidates = _autotune.CANDIDATES if candidates is None else candidates
    out = []
    for kind, cands in candidates.items():
        size = SIZES.get(kind)
        if size is None:
            continue
        for p in (*_autotune.PROBES.get(kind, ()), *PRODUCTION.get(kind, ())):
            try:
                grid = cands(p)
            except ValueError as e:
                out.append({"kind": kind, "shape": p["name"], "params": None,
                            "bytes": None, "c": None, "error": str(e)})
                continue
            for c in grid:
                out.append(_entry(kind, p["name"], c,
                                  lambda p=p, c=c: size(p, c)))
    for dtype, code in _DTYPE_CODE.items():
        out.append(_entry("pairwise_dist", str(dtype).replace("torch.", ""),
                          {}, lambda dtype=dtype, code=code: (
                              _distance.smem_of(dtype),
                              ("distance", "rt_pairwise_smem", (code,)))))
    for Dh in range(1, _flash.MAX_HEAD_DIM + 1):
        out.append(_entry("flash[wgmma]", f"Dh {Dh}", {},
                          lambda Dh=Dh: _flash_tc_size(Dh)))
        out.append(_entry("flash[tf32x3]", f"Dh {Dh}", {},
                          lambda Dh=Dh: _flash_tc_size(Dh, torch.float32)))
    return out


def launches_in(csrc=CSRC) -> dict[str, int]:
    """Per ``csrc/*.cu`` file, its launches that take dynamic shared
    memory: ``<<<grid, block, smem[, stream]>>>`` with smem not 0."""
    out = {}
    for path in sorted(pathlib.Path(csrc).glob("*.cu")):
        n = 0
        for m in _LAUNCH.finditer(path.read_text()):
            args = [a.strip() for a in m.group(1).split(",")]
            if len(args) >= 3 and args[2] not in ("0", "0u"):
                n += 1
        out[path.name] = n
    return out


def findings(candidates=None, csrc=CSRC) -> list[str]:
    """What breaks the budget of :data:`LIMIT` (see the module
    docstring); empty on a sound tree."""
    candidates = _autotune.CANDIDATES if candidates is None else candidates
    out = [f"CANDIDATES kind {kind!r} has no size function in "
           "smem_budget.SIZES: its grid is unchecked"
           for kind in candidates if kind not in SIZES]
    for e in entries(candidates):
        where = f"{e['kind']}[{e['shape']}] {e['params']}"
        if e["bytes"] is None:
            out.append(f"{where}: the plan refuses it: {e['error']}")
        elif e["bytes"] > LIMIT:
            out.append(f"{where}: {e['bytes']} B of shared memory, over "
                       f"the {LIMIT} B budget")
    for name, n in launches_in(csrc).items():
        covered = LAUNCHES.get(name, ())
        if n > len(covered):
            out.append(f"{name}: {n} launches with dynamic shared memory, "
                       f"{len(covered)} covered by smem_budget.LAUNCHES")
        text = (pathlib.Path(csrc) / name).read_text()
        out += [f"{name}: smem_budget.LAUNCHES names {fn}, which it does "
                "not define" for fn in covered if fn not in text]
    return out


def c_mismatches() -> tuple[int, list[dict]]:
    """On the card: every entry's bytes from its library's exported C
    size function against its Python mirror's. Returns ``(entries
    compared, those that differ)``."""
    from repro_torch.kernels import _build

    fns, bad, n = {}, [], 0
    for e in entries():
        if e["c"] is None:
            continue
        lib, sym, args = e["c"]
        if (lib, sym) not in fns:
            f = getattr(_build.library(lib), sym)
            f.restype = ctypes.c_longlong
            fns[lib, sym] = f
        f = fns[lib, sym]
        f.argtypes = [ctypes.c_int] * len(args)
        got = int(f(*args))
        n += 1
        if got != e["bytes"]:
            bad.append({**e, "c_bytes": got})
    return n, bad
