"""The port's figure and table scripts (``repro_torch.bench``) on the CPU.

Each script's ``run(quick=True)`` at a tiny scale (``n=512``) runs on the
plain versions and gives the rows ``repro``'s script gives: the same first
column, the same number of columns, and only method and metric names that
``repro``'s script names (checked against its source, since running it
compiles every search in JAX). Pre-filtering's recall is 1.0. The ``n``
override scales every dataset and nothing else; ``bench/run.py`` writes one
record per script with its device stamp. No number here is a device
measurement.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.bench import common
from repro_torch.bench import run as bench_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = 512


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors and many operations: one intra-op thread, so that on
    a loaded host no operation waits at a thread-pool barrier for threads
    the other test workers hold (10x and more per operation)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# script -> (repro's file, the column of the method / metric name, columns)
SCRIPTS = {
    "fig2": ("fig2_qps_recall.py", 3, 8),
    "fig3": ("fig3_ablation.py", 2, 6),
    "fig4": ("fig4_oracle.py", 2, 6),
    "fig5": ("fig5_multiattr.py", 2, 6),
    "table2": ("table2_memory.py", None, 4),  # f-string names: see below
    "table3": ("table3_indexing.py", 2, 4),
    "scalability": ("scalability.py", None, 6),
}


@pytest.fixture(scope="module")
def rows():
    """Each script's quick rows at n = 512 on the CPU, one process (the
    scripts share their cached indexes, as in ``bench/run.py``)."""
    import importlib

    out = {}
    for name, mod in bench_run.MODULES.items():
        m = importlib.import_module(f"repro_torch.bench.{mod}")
        notes = {}
        out[name] = (m.run(quick=True, n=TINY, device="cpu", notes=notes),
                     m.COLUMNS, notes)
    return out


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_rows_have_repro_columns_and_names(rows, name):
    got, columns, _ = rows[name]
    src_file, name_col, width = SCRIPTS[name]
    src = (ROOT / "benchmarks" / src_file).read_text()
    assert got, name
    assert len(columns) == width
    for r in got:
        assert len(r) == width, r
        assert r[0] == name
        if name_col is not None:
            assert f'"{r[name_col]}"' in src, r[name_col]
        for x in r[name_col + 1 if name_col is not None else 3:]:
            assert np.isfinite(float(x)), r


def test_method_sets(rows):
    def methods(name, col):
        return {r[col] for r in rows[name][0]}

    assert methods("fig2", 3) == {"iRangeGraph", "Pre-filtering",
                                  "Post-filtering", "In-filtering",
                                  "SuperPost"}
    assert methods("fig3", 2) == {"iRangeGraph", "iRangeGraph-",
                                  "BasicSearch"}
    assert methods("fig4", 2) == {"iRangeGraph", "Oracle"}
    assert methods("fig5", 2) == {"iRangeGraph-post", "iRangeGraph-in",
                                  "iRangeGraph+", "Pre-filtering"}
    assert [r[2] for r in rows["table3"][0]] == [
        "iRangeGraph_s", "flat_graph_s", "ratio_vs_single_graph"]
    # repro/benchmarks/table2_memory.py, in its order (some are f-strings)
    assert [r[2] for r in rows["table2"][0]] == [
        "raw_vectors_mb", "iRangeGraph_mb", "iRangeGraph_compact_mb",
        "compact_over_f32", "iRangeGraph_int8_mb", "int8_over_f32",
        "iRangeGraph_pq_mb", "pq_over_f32", "flat_graph_mb",
        "oracle_all_ranges_gb(theoretical)", "layers"]


def test_prefilter_recall_is_exact(rows):
    pre = [r for r in rows["fig2"][0] if r[3] == "Pre-filtering"]
    assert pre and all(r[6] == 1.0 for r in pre)
    pre5 = [r for r in rows["fig5"][0] if r[2] == "Pre-filtering"]
    assert pre5 and all(r[5] == 1.0 for r in pre5)


def test_graph_methods_find_neighbors(rows):
    """At n = 512 the improvised graph finds nearly every neighbor; the
    oracle's build seconds are recorded."""
    irange = [r[6] for r in rows["fig2"][0] if r[3] == "iRangeGraph"]
    assert min(irange) >= 0.9
    notes = rows["fig4"][2]
    assert len(notes["oracle_build_s"]) == 2
    assert all(s > 0 for s in notes["oracle_build_s"].values())


def test_n_override_scales_every_dataset():
    assert [common.dataset_n(k) for k in common.BENCH_DATASETS] == [
        8192, 4096, 4096]
    assert [common.dataset_n(k, 1_000_000) for k in common.BENCH_DATASETS] \
        == [1_000_000, 500_000, 500_000]
    from repro_torch.bench import scalability

    assert scalability.sizes_for() == (2048, 8192, 16384)
    assert scalability.sizes_for(n=1_000_000) == (125_000, 500_000,
                                                  1_000_000)
    assert scalability.sizes_for(quick=True) == (2048, 4096)
    cfg = common.build_config(torch.device("cpu"), m=12)
    assert cfg.chunk is None and cfg.m == 12
    assert common.build_config(torch.device("cuda", 0)).chunk == \
        common.CUDA_BUILD_CHUNK


def test_make_searcher_buckets_k_and_slices_back():
    from repro_torch.core.config import SearchConfig

    index = common.build_index("ytaudio-like", n=TINY, device="cpu")
    wl = common.make_workload(index, "mixed", n_queries=16)
    cfg = SearchConfig(ef=32, k_bucket=8)
    got = common.make_searcher(index, config=cfg)(wl.queries, wl.L, wl.R, 5)
    want = index.search_ranks(wl.queries, wl.L, wl.R, k=8, config=cfg)
    assert got.ids.shape == (16, 5)
    assert torch.equal(got.ids, want.ids[:, :5])
    plain = common.make_searcher(index, config=cfg, bucket=False)
    assert plain(wl.queries, wl.L, wl.R, 5).ids.shape == (16, 5)
    m = common.measure(common.make_searcher(index, config=cfg), wl, index)
    assert set(m) == {"qps", "recall", "mean_dists"}
    assert 0.9 <= m["recall"] <= 1.0 and m["qps"] > 0


def test_run_writes_stamped_records(tmp_path, capsys):
    assert bench_run.main(["--quick", "--only", "table3", "--n", "256",
                           "--device", "cpu", "--out-dir",
                           str(tmp_path)]) == 0
    doc = json.loads((tmp_path / "BENCH_torch_table3.json").read_text())
    assert doc["columns"] == ["table", "size", "metric", "value"]
    assert doc["device_info"]["device"] == "cpu"
    assert "card_line" in doc and doc["n"] == 256
    assert [r[1] for r in doc["rows"]] == ["n128"] * 3
    assert "table3,n128,iRangeGraph_s" in capsys.readouterr().out


def test_run_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not taken")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_run.main(["--quick", "--only", "table3", "--out-dir",
                        str(tmp_path)])
    assert not list(tmp_path.iterdir())
