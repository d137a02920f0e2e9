"""The port's improvised search against the JAX package's, on one index.

One index is built by ``repro`` (n=512, d=16, m=8, ef_construction=32) and
carried into the port through ``RangeGraphIndex.from_numpy``; both packages
then answer the same queries on the same graph. Float sums run in other
orders in XLA and torch, so near-ties may swap: held on mean top-10 id
agreement (>= 0.98) and recall@10 (within 0.01 of JAX's), at
expand_width 1 and 4. Within the port, the fused-plain and composed hops
give identical ids, and the beam loop's iteration block never changes a
result.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.core import recall as jrecall
from repro.core import search as jsearch
from repro_torch import RangeGraphIndex, SearchConfig, recall
from repro_torch.core import search as tsearch
from repro_torch.data import make_workload, vector_dataset

N, D = 512, 16


@pytest.fixture(scope="module")
def pair():
    vectors, attrs, _ = vector_dataset(N, D, seed=0)
    jidx = JIndex.build(vectors, attrs[:, 0],
                        JBuildConfig(m=8, ef_construction=32))
    fields = dict(
        vectors=np.asarray(jidx.vectors), attrs=jidx.attrs, perm=jidx.perm,
        neighbors=np.asarray(jidx.neighbors), m=jidx.m, logn=jidx.logn,
        build_cfg=dataclasses.asdict(jidx.build_cfg),
        storage=dataclasses.asdict(jidx.storage),
    )
    tidx = RangeGraphIndex.from_numpy(fields, device="cpu")
    wl = make_workload(tidx, "mixed", n_queries=96, seed=1)
    gt, _ = jidx.brute_force(wl.queries, wl.L, wl.R, k=10)
    return jidx, tidx, wl, gt


def _agreement(a, b):
    """Mean per-row share of b's ids that a also returned (an empty row of
    b agrees only with an empty row of a)."""
    a, b = np.asarray(a), np.asarray(b)
    out = []
    for x, y in zip(a, b):
        xs, ys = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(xs & ys) / len(ys) if ys else float(not xs))
    return float(np.mean(out))


@pytest.mark.parametrize("W", [1, 4])
def test_search_matches_jax(pair, W):
    jidx, tidx, wl, gt = pair
    want = jidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                             config=JSearchConfig(expand_width=W))
    got = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                            config=SearchConfig(expand_width=W))
    assert _agreement(got.ids, want.ids) >= 0.98
    r_j = jrecall(np.asarray(want.ids), gt)
    r_t = recall(got.ids, gt)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert r_t >= 0.9


@pytest.mark.parametrize("W", [1, 4])
def test_composed_hop_gives_identical_ids(pair, W):
    _, tidx, wl, _ = pair
    fused = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                              config=SearchConfig(expand_width=W))
    comp = tidx.search_ranks(
        wl.queries, wl.L, wl.R, k=10,
        config=SearchConfig(expand_width=W, hop_impl="composed"))
    for a, b in zip(fused, comp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("iter_block", [1, 5, 50])
def test_iteration_block_does_not_change_results(pair, iter_block,
                                                 monkeypatch):
    _, tidx, wl, _ = pair
    base = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10)
    monkeypatch.setattr(tsearch, "ITER_BLOCK", iter_block)
    other = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10)
    for a, b in zip(base, other):
        assert torch.equal(a, b)


def test_max_iters_cap_is_exact(pair):
    """A cap that is not a multiple of the block stops where JAX stops."""
    jidx, tidx, wl, _ = pair
    want = jidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                             config=JSearchConfig(max_iters=5))
    assert 5 % tsearch.ITER_BLOCK
    got = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                            config=SearchConfig(max_iters=5))
    np.testing.assert_array_equal(got.n_hops.numpy(), np.asarray(want.n_hops))
    assert _agreement(got.ids, want.ids) >= 0.98


def test_degenerate_ranges_match_jax(pair):
    """Full, one-point, empty (L > R), short and past-the-end ranges, in a
    batch shaped like the workload's (so JAX reuses its compiled search)."""
    jidx, tidx, wl, _ = pair
    L, R = wl.L.copy(), wl.R.copy()
    L[:6] = [0, 5, 100, 300, 0, N - 1]
    R[:6] = [N - 1, 5, 99, 300 + 7, 2 * N, N - 1]
    want = jidx.search_ranks(wl.queries, L, R, k=10)
    got = tidx.search_ranks(wl.queries, L, R, k=10)
    np.testing.assert_array_equal(got.ids.numpy()[1:4],
                                  np.asarray(want.ids)[1:4])
    assert (got.ids[2] == -1).all()            # empty range
    assert set(got.ids[1].tolist()) == {5, -1}  # one-point range
    assert _agreement(got.ids, want.ids) >= 0.98
    ids = got.ids.numpy()
    ok = (ids == -1) | ((ids >= L[:, None]) & (ids <= R[:, None]))
    assert ok.all()


def test_value_space_search_and_original_ids(pair):
    jidx, tidx, wl, _ = pair
    lo = tidx.attrs[wl.L]
    hi = tidx.attrs[wl.R]
    want = jidx.search(wl.queries, lo, hi, k=10)
    got = tidx.search(wl.queries, lo, hi, k=10)
    assert _agreement(got.ids, want.ids) >= 0.98
    np.testing.assert_array_equal(
        tidx.original_ids(got.ids),
        jidx.original_ids(np.asarray(got.ids.numpy())))
    for a, b in zip(tidx.ranks_of(lo, hi), jidx.ranks_of(lo, hi)):
        np.testing.assert_array_equal(a, b)


def test_rerank_matches_jax(pair):
    jidx, tidx, wl, gt = pair
    want = jidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                             config=JSearchConfig(rerank=32))
    got = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                            config=SearchConfig(rerank=32))
    assert _agreement(got.ids, want.ids) >= 0.98
    assert abs(recall(got.ids, gt) - jrecall(np.asarray(want.ids), gt)) \
        <= 0.01


def test_brute_force_matches_jax(pair):
    jidx, tidx, wl, gt = pair
    got, dists = tidx.brute_force(wl.queries, wl.L, wl.R, k=10)
    assert _agreement(got, gt) >= 0.99
    assert (np.diff(dists, axis=1)[np.isfinite(dists[:, 1:])] >= 0).all()


def test_search_fixed_layer_matches_jax(pair):
    jidx, tidx, wl, _ = pair
    layer = 2
    size = 1 << (tidx.logn - layer)
    lo = (wl.L[:32] // size * size).astype(np.int32)
    hi = (lo + size - 1).astype(np.int32)
    q = wl.queries[:32]
    want = jsearch.search_fixed_layer(
        jnp.asarray(jidx.vectors), jnp.asarray(jidx.neighbors),
        jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi), layer=layer, k=10,
        config=JSearchConfig(ef=32))
    got = tsearch.search_fixed_layer(
        tidx.vectors, tidx.neighbors, torch.from_numpy(q),
        torch.from_numpy(lo), torch.from_numpy(hi), layer=layer, k=10,
        config=SearchConfig(ef=32))
    assert _agreement(got.ids, want.ids) >= 0.98
    np.testing.assert_array_equal(got.n_hops.numpy(), np.asarray(want.n_hops))
