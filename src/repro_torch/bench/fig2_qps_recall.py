"""Paper Fig. 2: QPS and recall across methods x datasets x workloads
(``repro``'s ``benchmarks/fig2_qps_recall.py``).

Sweeps the beam size (ef) for every graph-based method; Pre-filtering is
the exact scan. Rows:
  fig2,<dataset>,<workload>,<method>,<ef>,<qps>,<recall>,<mean_dists>

Run: ``python -m repro_torch.bench.fig2_qps_recall [--quick] [--n N]
[--device cpu]`` (or through ``bench/run.py``).
"""
from __future__ import annotations

import functools

from repro_torch.bench import common
from repro_torch.core import baselines
from repro_torch.core.config import SearchConfig

EFS = (16, 48, 96)
WORKLOADS = ("frac_2", "frac_8", "mixed")
COLUMNS = ("table", "dataset", "workload", "method", "ef", "qps", "recall",
           "mean_dists")


def _methods(index):
    def irange(q, L, R, k, ef):
        return index.search_ranks(q, L, R, k=k, config=SearchConfig(ef=ef))

    def pre(q, L, R, k, ef):
        return baselines.prefilter(index, q, L, R, k=k)

    return {
        "iRangeGraph": irange,
        "Pre-filtering": pre,
        "Post-filtering": functools.partial(_wrap, baselines.postfilter,
                                            index),
        "In-filtering": functools.partial(_wrap, baselines.infilter, index),
        "SuperPost": functools.partial(_wrap, baselines.super_postfilter,
                                       index),
    }


def _wrap(fn, index, q, L, R, k, ef):
    return fn(index, q, L, R, k=k, config=SearchConfig(ef=ef))


def run(quick=False, n_queries=64, *, n=None, device=None, notes=None):
    rows = []
    datasets = list(common.BENCH_DATASETS)[:2]
    if quick:
        datasets = datasets[:1]
    for ds in datasets:
        index = common.build_index(ds, n=n, device=device)
        for wl_kind in (WORKLOADS[:2] if quick else WORKLOADS):
            wl = common.make_workload(index, wl_kind, n_queries=n_queries)
            for name, fn in _methods(index).items():
                efs = (64,) if name == "Pre-filtering" else (
                    EFS[:2] if quick else EFS)
                for ef in efs:
                    m = common.measure(
                        lambda q, L, R, k, _ef=ef, _fn=fn: _fn(
                            q, L, R, k, _ef),
                        wl, index)
                    rows.append((
                        "fig2", ds, wl_kind, name, ef,
                        round(m["qps"], 1), round(m["recall"], 4),
                        round(m["mean_dists"], 1),
                    ))
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench import run as _run

    sys.exit(_run.main(["--only", "fig2", *sys.argv[1:]]))
