"""The port's benchmarks (``repro_torch.bench``) on the CPU, against
``repro``'s ``benchmarks/``.

  * ``bench.roofline --smoke --device cpu --strict`` gives the five kernel
    rows with no error, and its problem, flops and bytes equal ``repro``'s
    ``_mk_problem`` / ``_kernel_rows`` at the same shape, integer for
    integer;
  * ``common.elemental_table`` is ``hotpath._elemental_table``, bit for
    bit, from the same generator;
  * ``bench.buildpath --smoke --device cpu`` reports parity (legacy and
    torch identical, step by step and for a whole build).

No number here is a device measurement: on the CPU the rows time the
plain versions.
"""
import importlib
import json
import pathlib
import sys

import numpy as np
import pytest

from repro_torch.bench import buildpath, common, roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = (8, 4096, 32, 8)     # B, n, d, M of both roofline smokes


@pytest.fixture(scope="module")
def repro_bench():
    """``repro``'s benchmark modules (they import their ``common`` from
    their own directory)."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        yield {name: importlib.import_module(name)
               for name in ("roofline", "hotpath")}
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))


def test_roofline_smoke_on_cpu(tmp_path):
    out = tmp_path / "roofline.json"
    assert roofline.main(["--smoke", "--device", "cpu", "--strict",
                          "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert [r["kernel"] for r in doc["kernels"]] == [
        "pairwise_dist", "gather_dist", "edge_select", "hop", "prune"]
    for r in doc["kernels"]:
        assert "error" not in r
        assert r["time_us"] > 0 and r["bound_us"] > 0
        assert r["bottleneck"] in ("compute", "memory")
    assert doc["host"]["device"] == "cpu"
    assert doc["config"] == {"B": 8, "n": 4096, "d": 32, "M": 8, "iters": 3}


def test_roofline_counts_equal_repro(repro_bench):
    import torch

    jp = repro_bench["roofline"]._mk_problem(*SMOKE)
    tp = roofline.make_problem(*SMOKE, torch.device("cpu"))
    for key in ("q", "table", "nbrs", "u", "L", "gids", "cand_ids",
                "cand_dists"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    want = [(name, int(f), int(b)) for name, _, f, b in
            repro_bench["roofline"]._kernel_rows(jp, 3)]
    got = [(name, int(f), int(b)) for name, _, f, b in
           roofline.kernel_rows(tp, 3)]
    assert got == want


def test_roofline_hop_gets_a_fresh_bitset_per_call():
    """Every timed hop call starts from an empty visited bitset, so it
    does the same distance work as the first."""
    import torch

    p = roofline.make_problem(*SMOKE, torch.device("cpu"))
    hop = dict((r[0], r[1]) for r in roofline.kernel_rows(p, 3))["hop"]
    first, later = hop(0), hop(4)
    for a, b in zip(first, later):
        assert torch.equal(a, b)
    assert bool(first[2].any())


def test_elemental_table_bit_identical(repro_bench):
    for n, m, logn in ((4096, 8, 12), (1000, 4, 10)):
        want = repro_bench["hotpath"]._elemental_table(
            np.random.default_rng(5), n, m, logn)
        got = common.elemental_table(np.random.default_rng(5), n, m, logn)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_buildpath_smoke_parity_on_cpu(tmp_path):
    out = tmp_path / "build.json"
    assert buildpath.main(["--smoke", "--device", "cpu", "--out",
                           str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["parity"] is True
    assert doc["config"]["backends"] == ["legacy", "torch"]
    assert [(r["kind"], r["C"]) for r in doc["prune_step"]] == [
        ("search", 32), ("brute", 32), ("reverse", 24)]
    assert all(r["legacy_torch_identical"] for r in doc["prune_step"])
    assert doc["build_agreement"] == {"legacy_torch_identical": True}
    assert set(doc["build_levels"]) == {"legacy", "torch"}
