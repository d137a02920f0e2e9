"""Launch-plan picks for the port's kernels, measured on the card (the
port's counterpart of ``repro/kernels/autotune.py``).

The kernels take their launch plans from fixed Python rules
(``gather_distance.plan``: a gather's ``split``, the hop's ``warps``;
``prune.smem_plan``: the prune's ``regime``, ``staged`` and ``warps``),
each measured once by hand at one shape. The same parameters reach the
kernels at run time, so no kernel source changes; here they are measured:

  * ``CANDIDATES[kind](probe)`` lists a kind's candidates at a probe shape
    (the default plan's own first, then those that fit; a candidate that
    does not fit is not offered, and an override that does not fit raises
    ``ValueError`` in the plan, never falling back to the rule);
    ``PROBES[kind]`` are the main paths' shapes (PERF.md §6): the frontier
    (B 1,000, M 64, W 4, d 128), the server (B 64, d 1,024), the prune at
    B 16,384, C 80, d 128 and at the lm build chunk's B 4,096, C 144, d
    1,024;
  * ``autotune(kind, run)`` runs every candidate on the same inputs,
    refuses one whose outputs differ from the default plan's (``same``),
    times the others by device time with CUDA events
    (``bench/common.py::time_calls``, behind a sleep kernel so no host
    time enters) and returns ``repro``'s record ``{kind, best, best_ms,
    candidates: [{params, ms}]}`` with the default plan's params and time
    beside it;
  * ``set_pick`` / ``install`` put a pick in place; the ``kernels/ops.py``
    wrappers merge :func:`get_pick` for the call's shape underneath an
    explicit override (:func:`merged`). A pick carries ``"at"``, the
    shape it was measured at, and applies only to launches of that shape
    (``KEYS[kind]``: the plan depends on the shape); one without ``"at"``
    applies to every shape. With no pick installed every plan is the
    rule's. ``bench/hotpath.py`` installs the picks for the rest of its
    run and clears them.

``edge_select`` takes no tile at run time (``kernels/edge_select.py``:
one warp a frontier row, eight a CTA, the scanned layers staged at once),
so its record holds the one plan, ``"tunable": false``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gather_distance as _gather
from repro_torch.kernels import prune as _prune

__all__ = [
    "CANDIDATES", "PROBES", "KEYS", "autotune", "set_pick", "get_pick",
    "all_picks", "clear_picks", "install", "merged",
]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gather_candidates(p: dict) -> list[dict]:
    B, M, d, layout = p["B"], p["M"], p["d"], p["layout"]
    default = _gather.plan(B, M, layout, d, True).split
    rows = _gather.rows_in_flight(layout, _gather.vpl_of(layout, d, True))
    top = _cdiv(M, max(rows, 4))
    splits = [default] + [1 << i for i in range(top.bit_length())
                          if 1 << i <= top]
    out, seen = [], set()
    for s in splits:
        try:
            eff = _gather.plan(B, M, layout, d, True,
                               override={"split": s}).split
        except ValueError:
            continue
        if eff not in seen:
            seen.add(eff)
            out.append({"split": s})
    return out


def _hop_candidates(p: dict) -> list[dict]:
    B, W, d, layout = p["B"], p["W"], p["d"], p["layout"]
    M, hop = W * p["m_out"], (W, p["K"])
    default = _gather.plan(B, M, layout, d, True, hop=hop).warps
    out = []
    for w in (default, 4, 8, 16):
        if w < _cdiv(M, 32) or {"warps": w} in out:
            continue
        try:
            _gather.plan(B, M, layout, d, True, hop=hop,
                         override={"warps": w})
        except ValueError:
            continue
        out.append({"warps": w})
    return out


def _prune_candidates(p: dict) -> list[dict]:
    C, d = p["C"], p["d"]
    out = [_prune.plan_params(_prune.smem_plan(C, d))]
    shapes = [{"regime": "block", "staged": C}, {"regime": "table"}]
    if _prune.smem_bytes(C, d, C) > _prune.SMEM_LIMIT:  # partial staging
        base = _prune.smem_bytes(C, d, 0)
        shapes.append({"regime": "block", "staged": (
            _prune.SMEM_LIMIT - base) // ((d + 3) // 4 * 16)})
    for shape in shapes:
        for w in (4, 8):
            o = {**shape, "warps": w}
            try:
                _prune.smem_plan(C, d, o)
            except ValueError:
                continue
            if o not in out:
                out.append(o)
    return out


CANDIDATES = {
    "gather_dist": _gather_candidates,
    # int8 / PQ tables: narrower rows, more of them in flight, the decode
    # in registers: tuned as their own kind, as repro does
    "gather_dist_codec": _gather_candidates,
    "hop": _hop_candidates,
    "prune": _prune_candidates,
    "edge_select": lambda p: [{}],
}

# the main paths' shapes (PERF.md §6); hop K = (logn + 1) * m at n = 1M and
# n = 131,072, m = 16
PROBES = {
    "gather_dist": (
        {"name": "frontier", "B": 1000, "M": 64, "d": 128, "layout": "f32"},
        {"name": "server", "B": 64, "M": 64, "d": 1024, "layout": "f32"}),
    "gather_dist_codec": (
        {"name": "frontier", "B": 1000, "M": 64, "d": 128,
         "layout": "int8"},),
    "hop": (
        {"name": "frontier", "B": 1000, "W": 4, "m_out": 16, "d": 128,
         "layout": "f32", "K": 21 * 16},
        {"name": "server", "B": 64, "W": 4, "m_out": 16, "d": 1024,
         "layout": "f32", "K": 18 * 16}),
    "prune": (
        {"name": "C80", "B": 16384, "C": 80, "d": 128},
        {"name": "d1024", "B": 4096, "C": 144, "d": 1024}),
    "edge_select": ({"name": "frontier", "F": 4000},),
}

# the shape fields a pick is scoped to (what the kind's plan depends on)
KEYS = {
    "gather_dist": ("B", "M", "d"),
    "gather_dist_codec": ("B", "M", "d"),
    "hop": ("B", "W", "d"),
    "prune": ("C", "d"),
    "edge_select": (),
}

_PICKS: dict[str, dict[tuple | None, dict]] = {}


def _check_kind(kind: str) -> None:
    if kind not in CANDIDATES:
        raise ValueError(
            f"autotune: unknown kernel kind {kind!r} "
            f"(expected one of {sorted(CANDIDATES)})")


def set_pick(kind: str, params: dict) -> None:
    """Install ``params`` as the plan of ``kind``'s kernel: at the shape
    ``params["at"]`` names (a dict of ``KEYS[kind]`` fields) or, without
    ``"at"``, at every shape. Explicit overrides still win."""
    _check_kind(kind)
    params = dict(params)
    at = params.get("at")
    key = None if at is None else tuple(sorted(
        (f, int(at[f])) for f in KEYS[kind]))
    _PICKS.setdefault(kind, {})[key] = params


def get_pick(kind: str, **shape) -> dict:
    """The installed plan parameters of ``kind`` for a launch of ``shape``
    (``KEYS[kind]`` fields): the pick measured at that shape, else one
    installed for every shape, else ``{}``."""
    picks = _PICKS.get(kind)
    if not picks:
        return {}
    key = tuple(sorted((f, int(shape[f])) for f in KEYS[kind])) \
        if all(f in shape for f in KEYS[kind]) else None
    pick = picks.get(key, picks.get(None, {}))
    return {k: v for k, v in pick.items() if k != "at"}


def merged(kind: str, plan_kw: dict, **shape) -> dict | None:
    """The override a wrapper passes its kernel: the installed pick for
    ``shape`` under the caller's explicit ``plan_kw``; None when both are
    empty (the rule's plan)."""
    return {**get_pick(kind, **shape), **plan_kw} or None


def all_picks() -> dict:
    """``{kind: [pick, ...]}``, each with its ``"at"`` where scoped."""
    return {k: [dict(p) for p in v.values()] for k, v in _PICKS.items()
            if v}


def clear_picks() -> None:
    _PICKS.clear()


def install(picks: dict) -> None:
    """Install ``{kind: params}`` or ``{kind: [params, ...]}`` (e.g. the
    ``autotune.picks`` of a committed record) wholesale."""
    for kind, ps in picks.items():
        for p in (ps if isinstance(ps, list) else [ps]):
            set_pick(kind, p)


def _identical(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_identical, a, b))
    return torch.equal(a, b)


def autotune(kind: str, run, *, iters: int = 20, candidates=None,
             same=None, reset=None, device=None) -> dict:
    """Run and time ``run(**params)`` for every candidate; the record.

    ``run`` launches the kernel on fixed probe inputs with the given plan
    override and returns its outputs; ``candidates`` default to
    ``CANDIDATES[kind]`` at the kind's first probe, the default plan's
    first. Each candidate's outputs are held against the default plan's
    by ``same(got, want)`` (default: every tensor equal); one that differs
    is refused: listed under ``"refused"`` and never timed or picked.
    ``reset(i)``, where given, runs before every call outside what is
    timed (an input updated in place, a cache flush). Times are the mean
    device ms of ``iters`` calls after one warm-up
    (``bench/common.py::time_calls``; the host clock on the CPU). The
    record is JSON-ready::

        {"kind", "best", "best_ms", "candidates": [{"params", "ms"}],
         "default", "default_ms", "refused", "tunable"}
    """
    from repro_torch.bench.common import time_calls

    _check_kind(kind)
    if candidates is None:
        candidates = CANDIDATES[kind](PROBES[kind][0])
    candidates = [dict(c) for c in candidates]
    if not candidates:
        raise ValueError(f"autotune: no {kind} candidate")
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    same = same or _identical

    def call(params):
        if reset is not None:
            reset(0)
        return run(**params)

    want = call(candidates[0])
    rows, refused = [], []
    for params in candidates:
        if not same(call(params), want):
            refused.append({"params": params,
                            "why": "outputs differ from the default plan's"})
            continue
        s = time_calls(lambda i, p=params: run(**p), device, iters=iters,
                       warmup=1, reset=reset)
        rows.append({"params": params, "ms": s * 1e3})
    if not rows or rows[0]["params"] != candidates[0]:
        raise RuntimeError(f"autotune: the default {kind} plan differs "
                           "from itself")
    best = min(rows, key=lambda r: r["ms"])
    return {
        "kind": kind,
        "best": dict(best["params"]),
        "best_ms": best["ms"],
        "candidates": rows,
        "default": dict(candidates[0]),
        "default_ms": rows[0]["ms"],
        "refused": refused,
        "tunable": len(candidates) > 1,
    }
