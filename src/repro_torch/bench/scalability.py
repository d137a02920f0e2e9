"""Paper §5.2.3 scalability (``repro``'s ``benchmarks/scalability.py``):
build time, memory and query metrics against n. ``repro`` builds n =
2,048, 8,192 and 16,384 (quick: 2,048 and 4,096) at d = 64; an ``n``
override builds n / 8, n / 2 and n (quick: n / 8 and n / 4). Rows:
  scalability,n<n>,<build_s>,<index_mb>,<qps>,<recall>

Run: ``python -m repro_torch.bench.scalability [--quick] [--n N]
[--device cpu]``.
"""
from __future__ import annotations

import time

from repro_torch.bench import common
from repro_torch.core import RangeGraphIndex
from repro_torch.core.config import SearchConfig
from repro_torch.data import vector_dataset
from repro_torch.device import resolve_device

COLUMNS = ("table", "size", "build_s", "index_mb", "qps", "recall")


def sizes_for(quick=False, n=None) -> tuple[int, ...]:
    top = 2 * common.BASE_N if n is None else int(n)
    return (top // 8, top // 4) if quick else (top // 8, top // 2, top)


def run(quick=False, *, n=None, device=None, notes=None):
    rows = []
    dev = resolve_device(device)
    for nn in sizes_for(quick, n):
        vectors, attrs, _ = vector_dataset(nn, 64, seed=7, queries=64)
        common.sync(dev)
        t0 = time.perf_counter()
        idx = RangeGraphIndex.build(
            vectors, attrs[:, 0],
            common.build_config(dev, m=12, ef_construction=48), device=dev)
        common.sync(dev)
        build_s = time.perf_counter() - t0
        wl = common.make_workload(idx, "mixed", n_queries=64)
        m = common.measure(
            lambda q, L, R, k: idx.search_ranks(
                q, L, R, k=k, config=SearchConfig(ef=64)),
            wl, idx)
        rows.append((
            "scalability", f"n{nn}", round(build_s, 2),
            round(idx.nbytes / 1e6, 1), round(m["qps"], 1),
            round(m["recall"], 4),
        ))
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench import run as _run

    sys.exit(_run.main(["--only", "scalability", *sys.argv[1:]]))
