"""Paper Fig. 3 ablation (``repro``'s ``benchmarks/fig3_ablation.py``): the
improvised dedicated graph against BasicSearch (segment-decomposition
search), and efficient edge selection (skip layers, iRangeGraph) against
the naive scan (iRangeGraph-). Rows:
  fig3,<dataset>,<method>,<ef>,<qps>,<recall>

Run: ``python -m repro_torch.bench.fig3_ablation [--quick] [--n N]
[--device cpu]``.
"""
from __future__ import annotations

from repro_torch.bench import common
from repro_torch.core import baselines
from repro_torch.core.config import SearchConfig

EFS = (32, 96)
COLUMNS = ("table", "dataset", "method", "ef", "qps", "recall")


def run(quick=False, *, n=None, device=None, notes=None):
    rows = []
    for ds in list(common.BENCH_DATASETS)[: 1 if quick else 2]:
        index = common.build_index(ds, n=n, device=device)
        wl = common.make_workload(index, "mixed", n_queries=64)
        for ef in EFS[:2] if quick else EFS:
            m = common.measure(
                lambda q, L, R, k, _ef=ef: index.search_ranks(
                    q, L, R, k=k, config=SearchConfig(ef=_ef)),
                wl, index)
            rows.append(("fig3", ds, "iRangeGraph", ef,
                         round(m["qps"], 1), round(m["recall"], 4)))
            m = common.measure(
                lambda q, L, R, k, _ef=ef: index.search_ranks(
                    q, L, R, k=k,
                    config=SearchConfig(ef=_ef, skip_layers=False)),
                wl, index)
            rows.append(("fig3", ds, "iRangeGraph-", ef,
                         round(m["qps"], 1), round(m["recall"], 4)))
            m = common.measure(
                lambda q, L, R, k, _ef=ef: baselines.basic_search(
                    index, q, L, R, k=k, config=SearchConfig(ef=_ef)),
                wl, index)
            rows.append(("fig3", ds, "BasicSearch", ef,
                         round(m["qps"], 1), round(m["recall"], 4)))
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench import run as _run

    sys.exit(_run.main(["--only", "fig3", *sys.argv[1:]]))
