"""The port's comparison methods against the JAX package's, on one index.

One index is built by ``repro`` (n=512, d=16, m=8, ef_construction=32) and
carried into the port through ``RangeGraphIndex.from_numpy``; both packages
then answer the same 64 mixed queries on the same graph. Float sums run in
other orders in XLA and torch, so near ties may swap: the searches are held
on mean top-10 id agreement (>= 0.98) and recall@10 (within 0.01 of
``repro``'s). Exact: the range helpers (over a hypothesis range of L, R,
logn) and Pre-filtering's ids. The oracle builds its graphs anew in each
package, whose prunes differ at near ties: recall within 0.02. Within the
port, the two-list loop gives the same results at every ``ITER_BLOCK``, and
``hop_fn`` with ``result_filter_fn`` raises.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.core import baselines as jbase
from repro.core import recall as jrecall
from repro.core import search as jsearch
from repro.core import segment_tree as jseg
from repro_torch import RangeGraphIndex, SearchConfig, recall
from repro_torch.core import baselines, segment_tree
from repro_torch.core import search as tsearch
from repro_torch.data import Workload, make_workload, vector_dataset

N, D, B = 512, 16, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors and many operations: one intra-op thread, so that on
    a loaded host no operation waits at a thread-pool barrier for threads
    the other test workers hold (10x and more per operation)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    wl = make_workload(tidx, "mixed", n_queries=B, seed=1)
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


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 12), st.data())
def test_range_helpers_match_repro(logn, data):
    top = (1 << logn) - 1
    L = data.draw(st.integers(0, top))
    R = data.draw(st.integers(L, top))
    want = jseg.decompose_range(L, R, logn)
    got = segment_tree.decompose_range(L, R, logn)
    assert got == want
    assert sum(hi - lo + 1 for _, lo, hi in got) == R - L + 1
    assert segment_tree.covering_segment(L, R, logn) == \
        jseg.covering_segment(L, R, logn)


def test_prefilter_ids_equal(pair):
    jidx, tidx, wl, _ = pair
    want = jbase.prefilter(jidx, wl.queries, wl.L, wl.R, k=10)
    got = baselines.prefilter(tidx, wl.queries, wl.L, wl.R, k=10)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.n_dists.numpy(),
                                  np.asarray(want.n_dists))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5)
    assert got.ids.dtype == torch.int32


def _hold(got, want, gt):
    assert _agreement(got.ids, want.ids) >= 0.98
    r_j = jrecall(np.asarray(want.ids), gt)
    r_t = recall(got.ids, gt)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    return r_t


@pytest.mark.parametrize("mode", ["post", "in"])
@pytest.mark.parametrize("W", [1, 4])
def test_search_filtered_matches_repro(pair, mode, W):
    jidx, tidx, wl, gt = pair
    want = jsearch.search_filtered(
        jnp.asarray(jidx.vectors), jnp.asarray(jidx.neighbors),
        jnp.asarray(wl.queries), jnp.asarray(wl.L), jnp.asarray(wl.R),
        mode=mode, k=10, config=JSearchConfig(ef=32, expand_width=W))
    got = tsearch.search_filtered(
        tidx.vectors, tidx.neighbors, torch.as_tensor(wl.queries),
        torch.as_tensor(wl.L), torch.as_tensor(wl.R), mode=mode, k=10,
        config=SearchConfig(ef=32, expand_width=W))
    _hold(got, want, gt)
    np.testing.assert_array_equal(got.n_hops.numpy() > 0,
                                  np.asarray(want.n_hops) > 0)
    ids = got.ids.numpy()
    ok = (ids == -1) | ((ids >= wl.L[:, None]) & (ids <= wl.R[:, None]))
    assert ok.all()


METHODS = ("postfilter", "infilter", "super_postfilter", "basic_search")


@pytest.mark.parametrize("name", METHODS)
@pytest.mark.parametrize("ef", [16, 48])
def test_baselines_match_repro(pair, name, ef):
    jidx, tidx, wl, gt = pair
    want = getattr(jbase, name)(jidx, wl.queries, wl.L, wl.R, k=10,
                                config=JSearchConfig(ef=ef))
    got = getattr(baselines, name)(tidx, wl.queries, wl.L, wl.R, k=10,
                                   config=SearchConfig(ef=ef))
    _hold(got, want, gt)
    assert got.ids.shape == (B, 10) and got.ids.dtype == torch.int32
    assert got.n_dists.shape == (B,)
    # the distance counts follow the same walk, up to the near-tie swaps
    nd_t = got.n_dists.numpy().astype(float)
    nd_j = np.asarray(want.n_dists).astype(float)
    assert abs(nd_t.mean() - nd_j.mean()) <= 0.02 * nd_j.mean()


def test_oracle_matches_repro(pair):
    jidx, tidx, wl, _ = pair
    rng = np.random.default_rng(4)
    Ls, Rs = [], []
    for span in (160, 96):
        lo = int(rng.integers(0, N - span))
        Ls += [lo] * 16
        Rs += [lo + span - 1] * 16
    L = np.asarray(Ls, np.int32)
    R = np.asarray(Rs, np.int32)
    q = wl.queries[:32]
    gt, _ = jidx.brute_force(q, L, R, k=10)
    want = jbase.oracle_search(jidx, q, L, R, k=10,
                               config=JSearchConfig(ef=32))
    cache = {}
    got = baselines.oracle_search(tidx, q, L, R, k=10,
                                  config=SearchConfig(ef=32), cache=cache)
    assert set(cache) == {(int(L[0]), int(R[0])), (int(L[16]), int(R[16]))}
    r_j = jrecall(np.asarray(want.ids), gt)
    r_t = recall(got.ids, gt)
    assert abs(r_t - r_j) <= 0.02, (r_t, r_j)
    ids = got.ids.numpy()
    assert (((ids >= L[:, None]) & (ids <= R[:, None])) | (ids == -1)).all()
    again = baselines.oracle_search(tidx, q, L, R, k=10,
                                    config=SearchConfig(ef=32), cache=cache)
    assert torch.equal(again.ids, got.ids)  # the cached graphs are reused


@pytest.mark.parametrize("name", ["postfilter", "super_postfilter"])
def test_two_list_loop_ignores_the_iteration_block(pair, name, monkeypatch):
    _, tidx, wl, _ = pair
    fn = getattr(baselines, name)
    runs = []
    for block in (1, 8, 64):
        monkeypatch.setattr(tsearch, "ITER_BLOCK", block)
        runs.append(fn(tidx, wl.queries, wl.L, wl.R, k=10))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_hop_fn_with_result_filter_raises(pair):
    _, tidx, wl, _ = pair
    q = torch.as_tensor(wl.queries)
    entries = torch.zeros((B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="hop_fn"):
        tsearch.beam_search(
            tidx.vectors, q, entries, None, k=10,
            hop_fn=lambda u, e, v: None,
            result_filter_fn=lambda ids: ids >= 0)
    with pytest.raises(ValueError, match="mode"):
        tsearch.search_filtered(
            tidx.vectors, tidx.neighbors, q, torch.as_tensor(wl.L),
            torch.as_tensor(wl.R), mode="pre", k=10)


def test_empty_and_one_point_ranges(pair):
    """Degenerate ranges through every method: an empty range (L > R)
    returns no id, a one-point range only its point."""
    _, tidx, wl, _ = pair
    L, R = wl.L.copy(), wl.R.copy()
    L[:2] = [100, 7]
    R[:2] = [99, 7]
    for name in METHODS + ("prefilter",):
        res = getattr(baselines, name)(tidx, wl.queries, L, R, k=10)
        ids = res.ids.numpy()
        assert (ids[0] == -1).all(), name
        assert set(ids[1].tolist()) <= {7, -1}, name
