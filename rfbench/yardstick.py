"""The benchmark's arithmetic: the bytes a search needs, the card's
published peak, percentiles and interval unions of a trace.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3, 700 W), never
a figure measured on the card: a share against a measured peak moves with
the card.
"""
from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12

# stored bytes of one vector element, by StorageConfig.vector_dtype
VECTOR_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}

# distances a search computes before its first hop: the midpoint and the
# quartiles of the request's rank range (every range of a mix holds 8 or
# more objects, so all three are distinct and in range)
ENTRIES_PER_QUERY = 3


def layers_of(n: int) -> int:
    """Rows of the neighbor table a node has: one per segment-tree level,
    ``ceil(log2 n) + 1``."""
    return int(math.ceil(math.log2(max(n, 2)))) + 1


def search_bytes(*, n_dists: int, n_hops: int, n_queries: int, n: int,
                 d: int, m: int, vector_dtype: str = "float32",
                 id_bytes: int = 4) -> int:
    """Bytes the searches need from the work they did, not from launches:
    each distance reads one stored row; each expanded node reads its
    ``layers * m`` neighbor ids; each query is read once (f32).

    The ids are an upper bound: the hop copies only the layers that a
    node's range scans, which the counters do not tell, so a share built on
    this count may read high by up to the ids' part of it."""
    row = d * VECTOR_BYTES[vector_dtype]
    return (int(n_dists) * row + int(n_hops) * layers_of(n) * m * id_bytes
            + int(n_queries) * d * 4)


def hop_bytes(*, n_queries: int, d: int, vector_dtype: str = "float32",
              **kw) -> int:
    """``search_bytes`` less the entry points' rows, which the gather
    kernel reads before the first hop (``ENTRIES_PER_QUERY`` a query)."""
    row = d * VECTOR_BYTES[vector_dtype]
    return (search_bytes(n_queries=n_queries, d=d, vector_dtype=vector_dtype,
                         **kw)
            - int(n_queries) * ENTRIES_PER_QUERY * row)


def roofline_pct(nbytes: int, seconds: float) -> float | None:
    """Share of the HBM roofline: the least time ``nbytes`` take at the
    published bandwidth over ``seconds``, in percent."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / (seconds * HBM_BYTES_PER_S)


def p95(values) -> float:
    """The 95th percentile of every value given (numpy's linear rule)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def union(intervals) -> list[tuple[int, int]]:
    """Merged, sorted ``(start, end)`` intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of [lo, hi] that no interval of ``busy`` (merged) covers."""
    out, t = [], lo
    for s, e in clip(busy, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def overlap_by_label(idle, spans) -> dict[str, int]:
    """Idle time within each labelled span: ``spans`` are disjoint,
    sorted ``(start, end, label)``; what no span covers is "other"."""
    out: dict[str, int] = {}
    j = 0
    for s, e in idle:
        covered = 0
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        i = j
        while i < len(spans) and spans[i][0] < e:
            a, b = max(s, spans[i][0]), min(e, spans[i][1])
            if b > a:
                out[spans[i][2]] = out.get(spans[i][2], 0) + (b - a)
                covered += b - a
            i += 1
        if e - s > covered:
            out["other"] = out.get("other", 0) + (e - s - covered)
    return out
