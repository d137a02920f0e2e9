"""Paper Table 3 (``repro``'s ``benchmarks/table3_indexing.py``): indexing
time, iRangeGraph's bottom-up build against a from-scratch flat graph (an
HNSW stand-in), and the paper's <= 3x claim. ``repro`` builds n = 8,192
(quick: 4,096) at d = 64; an ``n`` override builds at n (quick: n / 2).
Rows:
  table3,n<n>,<metric>,<value>

Run: ``python -m repro_torch.bench.table3_indexing [--quick] [--n N]
[--device cpu]``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import common
from repro_torch.core.build import build_flat_graph, build_neighbor_table
from repro_torch.data import vector_dataset
from repro_torch.device import resolve_device

COLUMNS = ("table", "size", "metric", "value")


def run(quick=False, *, n=None, device=None, notes=None):
    rows = []
    dev = resolve_device(device)
    size = common.BASE_N if n is None else int(n)
    nn, dim = (size // 2 if quick else size), 64
    vectors, attrs, _ = vector_dataset(nn, dim, seed=3)
    order = np.argsort(attrs[:, 0], kind="stable")
    vs = vectors[order]
    cfg = common.build_config(dev, m=12, ef_construction=48)

    common.sync(dev)
    t0 = time.perf_counter()
    build_neighbor_table(vs, cfg, device=dev)
    common.sync(dev)
    t_full = time.perf_counter() - t0

    t0 = time.perf_counter()
    build_flat_graph(vs, cfg, device=dev)  # root graph only: one HNSW
    common.sync(dev)
    t_flat = time.perf_counter() - t0

    rows.append(("table3", f"n{nn}", "iRangeGraph_s", round(t_full, 2)))
    rows.append(("table3", f"n{nn}", "flat_graph_s", round(t_flat, 2)))
    rows.append((
        "table3", f"n{nn}", "ratio_vs_single_graph",
        round(t_full / max(t_flat, 1e-9), 2),
    ))
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench import run as _run

    sys.exit(_run.main(["--only", "table3", *sys.argv[1:]]))
