"""The comparison that decides ``correct``.

The program's answers are judged against the data and the reference
(``reference.py``); this module imports nothing of the program. Each
number compared has its limit in ``rfbench/limits/<cell>.json``:

  * ``unanswered``: requests of the window with no result (an exception
    from ``flush`` counts), limit 0: no request is dropped;
  * ``out_of_range``: returned ids outside [0, n) or whose attribute lies
    outside the request's [lo, hi], limit 0 (rank mapping, range filter);
  * ``duplicate_ids``: an id twice in one answer, limit 0;
  * ``dist_gap``: the widest gap between a returned distance and the true
    f64 distance of the id returned, over ``|q|^2 + |x|^2`` (search, hop
    kernel); its limit lies between the program's readings and the TF32
    control's;
  * ``recall_at_10``: returned ids in the exact in-range top-k over
    min(k, range size), the mean over every answer (quality), a floor;
  * ``perm_mismatch``: ranks where the index's order differs from this
    benchmark's stable sort of the attributes, limit 0;
  * ``bad_edges``: neighbor-table edges outside their layer's segment,
    self-loops or ids past n, limit 0 (build).
"""
from __future__ import annotations

import math

import torch

from rfbench import reference

# answers judged at once
ROWS = 16384


def judge_answers(data, pool, exact, pidx, ids, dists, *, k: int) -> dict:
    """Numbers of the answers ``ids`` int64 [N, k] (original ids, -1 for
    none) with ``dists`` [N, k] to pool requests ``pidx`` int64 [N].
    ``exact``: ``reference.exact_topk``'s (ids, dists, size)."""
    x, attrs = data.vectors, data.attrs
    n = x.shape[0]
    dev = x.device
    ex_ids, _, size = exact
    out_of_range = dup = 0
    gap = 0.0
    hits = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, ids.shape[0], ROWS):
        p = pidx[s:s + ROWS].to(dev)
        a = ids[s:s + ROWS].to(dev)
        d = dists[s:s + ROWS].to(dev).double()
        got = a >= 0
        inside = (a < n) & got
        a_c = a.clamp(0, n - 1)
        v = attrs[a_c]
        ok = inside & (v >= pool.lo[p][:, None]) & (v <= pool.hi[p][:, None])
        out_of_range += int((got & ~ok).sum())
        srt, _ = torch.sort(a, dim=1)
        dup += int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
        true, scale = reference.true_dists(x, pool.q[p], a_c)
        g = (d - true).abs() / scale
        g = torch.where(torch.isnan(g), torch.inf, g)
        gap = max(gap, float(torch.where(inside, g, 0.0).max()))
        hit = ((a[:, :, None] == ex_ids[p][:, None, :]) & got[:, :, None]
               ).any(-1).sum(1)
        hits += (hit.double() / size[p].clamp(max=k).clamp(min=1)).sum()
    N = ids.shape[0]
    return {
        "out_of_range": out_of_range,
        "duplicate_ids": dup,
        "dist_gap": gap,
        "recall_at_10": float(hits) / N if N else 0.0,
    }


def table_faults(neighbors: torch.Tensor, n: int) -> int:
    """Edges of the ``[n, layers, m]`` rank-space table that leave their
    layer's segment (layer ``l`` has segments of ``2**(logn - l)`` ranks),
    point at their own node or past n. The leaf layer holds none."""
    logn = max(1, math.ceil(math.log2(max(n, 2))))
    if neighbors.shape[0] != n or neighbors.shape[1] != logn + 1:
        return n * neighbors.shape[1] * neighbors.shape[2]
    r = torch.arange(n, device=neighbors.device)
    bad = 0
    for lay in range(logn + 1):
        e = neighbors[:, lay, :].long()
        got = e >= 0
        if lay == logn:
            bad += int(got.sum())
            continue
        shift = logn - lay
        ok = (e < n) & (e != r[:, None]) & ((e >> shift) == (r >> shift)[:, None])
        bad += int((got & ~ok).sum())
    return bad


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit. ``limits``: name -> {"max": x} or
    {"min": x}. A number without a limit, or a limit without a number,
    fails."""
    checks, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        lim = limits.get(name)
        val = numbers.get(name)
        if lim is None or val is None:
            checks[name] = {"value": val, "limit": None}
            ok = False
            continue
        if "max" in lim:
            good = val <= lim["max"]
            checks[name] = {"value": val, "limit": ["<=", lim["max"]]}
        else:
            good = val >= lim["min"]
            checks[name] = {"value": val, "limit": [">=", lim["min"]]}
        ok &= bool(good)
    return ok, checks
