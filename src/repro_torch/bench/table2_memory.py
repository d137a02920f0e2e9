"""Paper Table 2 (``repro``'s ``benchmarks/table2_memory.py``): memory
footprint per method (index + raw vectors), with the compact encoding
(bf16 vectors + narrow neighbor ids) and the quantized codecs (int8 / PQ
vectors + split neighbor ids, ``core/storage.py``) of the same index.
Rows:
  table2,<dataset>,<metric>,<value>

Run: ``python -m repro_torch.bench.table2_memory [--quick] [--n N]
[--device cpu]``.
"""
from __future__ import annotations

from repro_torch.bench import common
from repro_torch.core import storage as storage_mod

COLUMNS = ("table", "dataset", "metric", "value")


def run(quick=False, *, n=None, device=None, notes=None):
    rows = []
    for ds in list(common.BENCH_DATASETS)[: 1 if quick else None]:
        index = common.build_index(ds, n=n, device=device,
                                   storage=storage_mod.StorageConfig())
        raw = storage_mod.table_nbytes(index.vectors)
        elemental = storage_mod.table_nbytes(index.neighbors)
        nn, layers, m = index.neighbors.shape
        rows.append(("table2", ds, "raw_vectors_mb", round(raw / 1e6, 2)))
        rows.append((
            "table2", ds, "iRangeGraph_mb",
            round((raw + elemental + index.attrs.nbytes) / 1e6, 2),
        ))
        compact = index.astype_storage(storage_mod.StorageConfig.compact())
        rows.append((
            "table2", ds, "iRangeGraph_compact_mb",
            round(compact.nbytes / 1e6, 2),
        ))
        rows.append((
            "table2", ds, "compact_over_f32",
            round(compact.nbytes / index.nbytes, 3),
        ))
        del compact
        for tag, st in (("int8", storage_mod.StorageConfig.int8()),
                        ("pq", storage_mod.StorageConfig.pq())):
            qidx = index.astype_storage(st)
            rows.append((
                "table2", ds, f"iRangeGraph_{tag}_mb",
                round(qidx.nbytes / 1e6, 2),
            ))
            rows.append((
                "table2", ds, f"{tag}_over_f32",
                round(qidx.nbytes / index.nbytes, 3),
            ))
            del qidx
        # one flat graph (Milvus/HNSW-style baseline): one layer of edges
        rows.append((
            "table2", ds, "flat_graph_mb",
            round((raw + elemental / layers) / 1e6, 2),
        ))
        # the O(n^2) dedicated-graph strawman the paper argues against
        rows.append((
            "table2", ds, "oracle_all_ranges_gb(theoretical)",
            round(nn * nn * m * 4 / 2 / 1e9, 1),
        ))
        rows.append(("table2", ds, "layers", layers))
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench import run as _run

    sys.exit(_run.main(["--only", "table2", *sys.argv[1:]]))
