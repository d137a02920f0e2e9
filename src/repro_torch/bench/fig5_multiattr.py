"""Paper Fig. 5 / §5.2.5 (``repro``'s ``benchmarks/fig5_multiattr.py``):
multi-attribute conjunctive RFANN. Compares the §4 extension's modes:
post-filtering, in-filtering and iRangeGraph+ (visit out-of-range
neighbors with p = exp(-t)), plus exact Pre-filtering. Workload: range
fraction 2^-2 on the index's attribute, value ranges 0.25 wide on a second
attribute drawn uniform on [0, 1) with seed 5. Rows:
  fig5,<dataset>,<method>,<ef>,<qps>,<recall>

Run: ``python -m repro_torch.bench.fig5_multiattr [--quick] [--n N]
[--device cpu]``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import common
from repro_torch.core import multiattr
from repro_torch.core.config import SearchConfig
from repro_torch.core.index import recall as recall_fn

EFS = (32, 96)
COLUMNS = ("table", "dataset", "method", "ef", "qps", "recall")


def run(quick=False, *, n=None, device=None, notes=None):
    rows = []
    ds = list(common.BENCH_DATASETS)[0]
    index = common.build_index(ds, n=n, device=device)
    nn = index.n
    rng = np.random.default_rng(5)
    attr2 = rng.uniform(0, 1.0, nn).astype(np.float32)
    B = 48 if quick else 64
    wl = common.make_workload(index, "frac_2", n_queries=B)
    lo2 = rng.uniform(0, 0.5, B).astype(np.float32)
    hi2 = (lo2 + 0.25).astype(np.float32)

    gt, _ = multiattr.brute_force_multiattr(
        index, attr2, wl.queries, wl.L, wl.R, lo2, hi2, k=10)
    for mode, label in (("post", "iRangeGraph-post"),
                        ("in", "iRangeGraph-in"),
                        ("adaptive", "iRangeGraph+")):
        for ef in EFS[:2] if quick else EFS:
            multiattr.search_multiattr(  # warm-up
                index, attr2, wl.queries[:8], wl.L[:8], wl.R[:8],
                lo2[:8], hi2[:8], k=10, mode=mode,
                config=SearchConfig(ef=ef))
            common.sync(index.device)
            t0 = time.perf_counter()
            res = multiattr.search_multiattr(
                index, attr2, wl.queries, wl.L, wl.R, lo2, hi2,
                k=10, mode=mode, config=SearchConfig(ef=ef))
            ids = res.ids.cpu().numpy()
            dt = time.perf_counter() - t0
            rows.append((
                "fig5", ds, label, ef, round(B / dt, 1),
                round(recall_fn(ids, gt), 4),
            ))
    # Pre-filtering, exact
    common.sync(index.device)
    t0 = time.perf_counter()
    multiattr.brute_force_multiattr(
        index, attr2, wl.queries, wl.L, wl.R, lo2, hi2, k=10)
    dt = time.perf_counter() - t0
    rows.append(("fig5", ds, "Pre-filtering", 0, round(B / dt, 1), 1.0))
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench import run as _run

    sys.exit(_run.main(["--only", "fig5", *sys.argv[1:]]))
