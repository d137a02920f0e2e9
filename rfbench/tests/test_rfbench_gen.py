"""The generator: the same inputs for one seed, others for another."""
from __future__ import annotations

import torch

from rfbench import gen

DEP = {"n": 3000, "d": 8, "n_clusters": 4, "attr_kind": "uniform"}
TRAFFIC = {"pool": 200, "clients": 50,
           "ranges": {"i_min": 0, "i_max": 9, "min_span": 8}}
CPU = torch.device("cpu")


def _all(seed, dep=DEP):
    data, pool = gen.make(dep, TRAFFIC, seed, CPU)
    return [data.vectors, data.attrs, pool.q, pool.L, pool.R, pool.lo,
            pool.hi]


def test_same_seed_same_inputs_and_other_seed_others():
    seed = 2**31 + 12345   # the driver's seeds pass 32 signed bits
    a, b, c = _all(seed), _all(seed), _all(seed + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))


def test_every_batch_of_every_seed_gets_the_same_range_levels():
    blocks = []
    for s in (1, 2, 3):
        lv = gen.make(DEP, TRAFFIC, s, CPU)[1].level.reshape(4, 50)
        blocks += [sorted(row.tolist()) for row in lv]
    assert all(b == blocks[0] for b in blocks)
    assert set(blocks[0]) == set(range(10))


def test_ranges_are_value_bounds_of_rank_spans():
    for kind in ("uniform", "clustered"):
        data, pool = gen.make({**DEP, "attr_kind": kind}, TRAFFIC, 7, CPU)
        n = DEP["n"]
        span = pool.R - pool.L + 1
        want = torch.clamp(n // 2 ** pool.level, min=8)
        assert torch.equal(span, want)
        assert (pool.L >= 0).all() and (pool.R < n).all()
        assert torch.equal(pool.lo, data.sorted_attrs[pool.L])
        assert torch.equal(pool.hi, data.sorted_attrs[pool.R])
        assert torch.equal(data.order[data.rank_of], torch.arange(n))
        assert (data.sorted_attrs[1:] >= data.sorted_attrs[:-1]).all()


def test_clustered_attributes_follow_the_cluster():
    data, _ = gen.make({**DEP, "attr_kind": "clustered"}, TRAFFIC, 3, CPU)
    cluster = (data.attrs // 1000).long()
    # each vector lies nearest its own attribute's centre
    d = torch.cdist(data.vectors, data.centers)
    assert (d.argmin(1) == cluster).float().mean() > 0.95
