"""The reference, the comparison and the yardstick's arithmetic."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from rfbench import gen, judge, reference, yardstick

CPU = torch.device("cpu")
DEP = {"n": 1500, "d": 12, "n_clusters": 6, "attr_kind": "clustered"}
TRAFFIC = {"pool": 96, "clients": 48, "ranges": {"i_min": 0, "i_max": 9, "min_span": 8}}
K = 10


@pytest.fixture(scope="module")
def case():
    data, pool = gen.make(DEP, TRAFFIC, 11, CPU)
    return data, pool, reference.exact_topk(data, pool, K)


def test_exact_topk_equals_a_full_sort(case, monkeypatch):
    data, pool, (ids, dists, size) = case
    x = data.vectors.double()
    for j in range(pool.q.shape[0]):
        ok = (data.attrs >= pool.lo[j]) & (data.attrs <= pool.hi[j])
        cand = ok.nonzero().flatten()
        d = ((x[cand] - pool.q[j].double()) ** 2).sum(1)
        order = torch.argsort(d, stable=True)[:K]
        assert int(size[j]) == cand.numel()
        assert torch.equal(ids[j, :order.numel()], cand[order])
        assert torch.allclose(dists[j, :order.numel()], d[order])
    # the whole-f64 path, taken where the f32 pick might miss, agrees too
    monkeypatch.setattr(reference, "CAND", K)
    ids2, _, _ = reference.exact_topk(data, pool, K)
    assert torch.equal(ids2, ids)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 2**-12), 3.0e-3])
    r = reference.to_tf32(x)
    assert r[0] == 1.0 + 2**-10
    assert r[1] == 1.0                 # a tie goes to even
    assert r[2] == 1.0 + 2**-9         # a tie goes to even, upwards
    assert r[3] == -1.0
    m = r.view(torch.int32) & 0x1FFF
    assert (m == 0).all()


def test_control_and_faults_fail_where_sound_answers_pass(case):
    from rfbench import control

    data, pool, exact = case
    P = pool.q.shape[0]
    pidx = torch.arange(P)
    limits = {"out_of_range": {"max": 0}, "duplicate_ids": {"max": 0},
              "dist_gap": {"max": 2e-5}, "recall_at_10": {"min": 0.15}}
    sound = judge.judge_answers(data, pool, exact, pidx, exact[0],
                                exact[1].float(), k=K)
    assert judge.compare(sound, limits)[0]
    assert sound["recall_at_10"] == 1.0
    for name, ids, dists in control.stand_ins(data, pool, exact, K):
        nums = judge.judge_answers(data, pool, exact, pidx, ids, dists, k=K)
        ok, checks = judge.compare(nums, limits)
        assert not ok, (name, checks)


def test_recall_and_faults_are_counted_over_every_answer(case):
    data, pool, exact = case
    ex_ids, ex_d, size = exact
    P = pool.q.shape[0]
    # every request answered three times; one copy in three loses ids
    pidx = torch.arange(P).repeat(3)
    ids, d = ex_ids[pidx].clone(), ex_d[pidx].float().clone()
    ids[2 * P:, 5:] = -1
    d[2 * P:, 5:] = torch.inf
    nums = judge.judge_answers(data, pool, exact, pidx, ids, d, k=K)
    cut = (size.clamp(max=5) / size.clamp(max=K)).double()
    assert nums["recall_at_10"] == pytest.approx(
        float((2 + cut).mean()) / 3)
    assert nums["out_of_range"] == nums["duplicate_ids"] == 0
    ids[0, 1] = ids[0, 0]                    # a duplicate
    ids[1, 0] = data.order[(int(pool.R[1]) + 1) % DEP["n"]]  # out of range
    d[3, 0] *= 1.001                         # a distance off by 1e-3
    nums = judge.judge_answers(data, pool, exact, pidx, ids, d, k=K)
    assert nums["duplicate_ids"] == 1
    assert nums["out_of_range"] >= 1
    assert nums["dist_gap"] > 1e-4


def test_compare_needs_a_limit_for_every_number():
    ok, checks = judge.compare({"a": 0, "b": 0.5},
                               {"a": {"max": 0}, "b": {"min": 0.4}})
    assert ok and checks["b"]["limit"] == [">=", 0.4]
    assert not judge.compare({"a": 1}, {"a": {"max": 0}})[0]
    assert not judge.compare({"a": 0}, {"a": {"max": 0}, "c": {"max": 0}})[0]
    assert not judge.compare({"a": 0, "z": 3}, {"a": {"max": 0}})[0]


def test_table_faults_counts_edges_that_leave_their_segment():
    n, m = 16, 2                      # logn 4: five layers
    t = torch.full((n, 5, m), -1, dtype=torch.int32)
    r = torch.arange(n, dtype=torch.int32)
    t[:, 0, 0] = (r + 1) % n          # layer 0: one segment, all fine
    t[:, 3, 0] = r ^ 1                # layer 3: pairs, fine
    assert judge.table_faults(t, n) == 0
    t[0, 3, 1] = 2                    # another pair
    t[5, 2, 0] = 5                    # a self-loop
    t[7, 4, 0] = 6                    # the leaf layer holds no edge
    t[9, 1, 1] = 99                   # past n
    assert judge.table_faults(t, n) == 4
    assert judge.table_faults(t[:, :4], n) == n * 4 * m


def test_byte_count_matches_a_hand_count():
    # n 16: logn 4, five neighbor rows a node; d 4 f32 rows of 16 B
    got = yardstick.search_bytes(n_dists=7, n_hops=3, n_queries=2, n=16,
                                 d=4, m=2)
    assert got == 7 * 16 + 3 * 5 * 2 * 4 + 2 * 16
    # the hop's share leaves out the three entry rows of each query
    assert yardstick.hop_bytes(n_dists=7, n_hops=3, n_queries=2, n=16, d=4,
                               m=2) == got - 2 * 3 * 16
    assert yardstick.search_bytes(n_dists=7, n_hops=0, n_queries=0, n=16,
                                  d=4, m=2, vector_dtype="bfloat16") == 56
    assert yardstick.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert yardstick.roofline_pct(0, 1.0) is None


def test_byte_count_of_a_small_search_by_hand():
    """On a real search of the program (CPU), the count equals one row per
    distance the search reports, the ids of every expanded node's rows and
    the queries, worked out here by hand from its counters."""
    from repro_torch.core.build import BuildConfig
    from repro_torch.core.index import RangeGraphIndex

    data, pool = gen.make({**DEP, "n": 512},
                          {**TRAFFIC, "pool": 8, "clients": 8}, 5, CPU)
    ix = RangeGraphIndex.build(data.vectors.numpy(), data.attrs.numpy(),
                               BuildConfig(m=8, ef_construction=16),
                               device="cpu")
    res = ix.search(pool.q, pool.lo.numpy(), pool.hi.numpy(), k=K)
    nd, nh = int(res.n_dists.sum()), int(res.n_hops.sum())
    assert nd > 0 and nh > 0
    hand = nd * 12 * 4 + nh * (9 + 1) * 8 * 4 + 8 * 12 * 4
    assert yardstick.search_bytes(n_dists=nd, n_hops=nh, n_queries=8, n=512,
                                  d=12, m=8) == hand
    # every query computed its three entry distances before the first hop
    assert (res.n_dists >= yardstick.ENTRIES_PER_QUERY).all()
    assert yardstick.hop_bytes(n_dists=nd, n_hops=nh, n_queries=8, n=512,
                               d=12, m=8) == hand - 8 * 3 * 12 * 4


def test_p95_is_over_every_request_not_a_median_of_flushes():
    # 20 flushes of 100 requests: 19 fast, one slow
    lat = np.concatenate([np.full(1900, 0.1), np.full(100, 1.0)])
    assert yardstick.p95(lat) == pytest.approx(
        float(np.percentile(lat, 95)))
    flush_medians = [0.1] * 19 + [1.0]
    assert yardstick.p95(lat) != np.median(flush_medians)
    ctx = types.SimpleNamespace(latencies=lat)
    from rfbench.spec import metric_reader
    from conftest import REPO

    assert metric_reader(REPO, "latency_p95_ms")(ctx) == pytest.approx(
        1e3 * np.percentile(lat, 95))


def test_interval_arithmetic():
    busy = yardstick.union([(0, 5), (3, 8), (10, 12)])
    assert busy == [(0, 8), (10, 12)]
    assert yardstick.gaps(busy, -2, 15) == [(-2, 0), (8, 10), (12, 15)]
    spans = [(-2, 9, "a"), (9, 11, "b")]
    got = yardstick.overlap_by_label(yardstick.gaps(busy, -2, 15), spans)
    assert got == {"a": 3, "b": 1, "other": 3}
