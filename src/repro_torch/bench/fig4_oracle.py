"""Paper Fig. 4 / §5.2.4 (``repro``'s ``benchmarks/fig4_oracle.py``): the
gap to the Oracle, a dedicated graph built from scratch per query range.
QPS at matched recall on a workload of a few distinct ranges (the paper's
10 ranges x 100 queries; here 4 x 24, as in ``repro``), each range's span
``max(n >> i, 64)`` for i drawn from [0, 6) with seed 4, so at n = 1M a
span reaches n. Rows:
  fig4,<dataset>,<method>,<ef>,<qps>,<recall>

The Oracle's graphs are built once, before the first timed search, with
the index's own build config, and shared across the beam sizes; their
build seconds per range go to ``notes["oracle_build_s"]`` (the JSON
record), so the Oracle's QPS is its search alone.

Run: ``python -m repro_torch.bench.fig4_oracle [--quick] [--n N]
[--device cpu]``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import common
from repro_torch.core import baselines
from repro_torch.core.config import SearchConfig

EFS = (16, 48, 96)
COLUMNS = ("table", "dataset", "method", "ef", "qps", "recall")


def run(quick=False, *, n=None, device=None, notes=None):
    rows = []
    ds = list(common.BENCH_DATASETS)[0]
    index = common.build_index(ds, n=n, device=device)
    rng = np.random.default_rng(4)
    nn = index.n
    # 4 distinct ranges, 24 queries each (paper: 10 ranges x 100 queries)
    n_ranges = 2 if quick else 4
    per = 16 if quick else 24
    Ls, Rs = [], []
    for _ in range(n_ranges):
        span = max(nn >> rng.integers(0, 6), 64)
        lo = int(rng.integers(0, nn - span))
        Ls += [lo] * per
        Rs += [lo + span - 1] * per
    wl = common.Workload(
        "oracle-mixed", np.asarray(Ls, np.int32), np.asarray(Rs, np.int32),
        common.make_workload(index, "mixed",
                             n_queries=n_ranges * per).queries,
    )
    cache: dict = {}
    builds = {}
    for i in range(0, len(Ls), per):
        t0 = time.perf_counter()
        baselines.oracle_search(index, wl.queries[i:i + 1], wl.L[i:i + 1],
                                wl.R[i:i + 1], k=10, cache=cache)
        common.sync(index.device)
        builds[f"{int(Ls[i])}-{int(Rs[i])}"] = time.perf_counter() - t0
    if notes is not None:
        notes["oracle_build_s"] = builds
        notes["oracle_spans"] = [int(Rs[i] - Ls[i] + 1)
                                 for i in range(0, len(Ls), per)]
    for ef in EFS[:2] if quick else EFS:
        m = common.measure(
            lambda q, L, R, k, _ef=ef: index.search_ranks(
                q, L, R, k=k, config=SearchConfig(ef=_ef)),
            wl, index)
        rows.append(("fig4", ds, "iRangeGraph", ef,
                     round(m["qps"], 1), round(m["recall"], 4)))
        m = common.measure(
            lambda q, L, R, k, _ef=ef: baselines.oracle_search(
                index, q, L, R, k=k, config=SearchConfig(ef=_ef),
                cache=cache),
            wl, index)
        rows.append(("fig4", ds, "Oracle", ef,
                     round(m["qps"], 1), round(m["recall"], 4)))
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench import run as _run

    sys.exit(_run.main(["--only", "fig4", *sys.argv[1:]]))
