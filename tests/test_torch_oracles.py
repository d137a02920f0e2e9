"""The port's oracles against ``repro``'s: the argsort formulation and the
literal Algorithm 1 (``core/edge_select.py``), and the seed engine of beam
search (``core/search_ref.py``).

  * ``select_edges_reference``, ``select_edges`` and
    ``select_edges_batch`` return ``repro``'s ids bit for bit, and those of
    ``ops.select_edges`` (the plain version), on structurally valid random
    tables, degenerate ranges and -1 frontier slots included.
  * ``beam_search_reference`` returns ``repro``'s ids on one
    ``repro``-built index (n = 256), distances to 1e-5 (XLA and torch sum
    the einsum in other orders), in one-list and two-list mode.
  * The port's ``beam_search`` at ``expand_width=1`` reproduces the port's
    reference: ids, ``n_hops`` and ``n_dists`` identical and distances bit
    for bit, since the plain ``gather_dist`` computes ``_pairdist``'s
    expansion in the same order on the same shapes; in the coin mode too,
    both drawing one ``[B, M]`` batch of coins an iteration from one
    seeded ``torch.Generator`` stream.
  * ``SearchConfig(edge_impl="argsort")`` searches hold ``repro``'s
    recall@10 within 0.01; ``-s`` prints the id agreement.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.core import edge_select as jedge
from repro.core import recall as jrecall
from repro.core import search as jsearch
from repro.core import search_ref as jref
from repro_torch import RangeGraphIndex, SearchConfig, recall
from repro_torch.core import edge_select as tedge
from repro_torch.core import search as tsearch
from repro_torch.core import search_ref as tref
from repro_torch.data import make_workload, vector_dataset
from repro_torch.kernels import ops as tops

N, D = 256, 16


def _table(rng, n, m, logn):
    """Edges at a layer stay inside their node's segment there; random
    degrees (some rows empty), duplicates and -1 padding."""
    layers = logn + 1
    u = np.arange(n)[:, None, None]
    shift = (logn - np.arange(layers))[None, :, None]
    lo = (u >> shift) << shift
    nbrs = np.minimum(lo + rng.integers(0, 1 << 30, (n, layers, m))
                      % (1 << shift), n - 1)
    nbrs[rng.random(nbrs.shape) < 0.3] = -1
    nbrs[nbrs == u] = -1
    return nbrs.astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_edge_oracles_bit_identical_to_repro(seed):
    rng = np.random.default_rng(seed)
    logn = 3 + seed
    n, m = 1 << logn, 2 + seed
    nbrs = _table(rng, n, m, logn)
    F = 48
    L = rng.integers(0, n, F).astype(np.int32)
    R = np.minimum(L + rng.integers(-2, n, F), n - 1).astype(np.int32)
    L[:3], R[:3] = [0, 5, n - 1], [n - 1, 5, 0]  # full, one, empty
    us = np.where(rng.random(F) < 0.8,
                  L + rng.integers(0, n, F) % np.maximum(R - L + 1, 1),
                  rng.integers(-1, n, F)).astype(np.int32)
    t = torch.as_tensor
    for skip in (True, False):
        kw = dict(logn=logn, m_out=m, skip_layers=skip)
        want = np.asarray(jedge.select_edges_batch(
            jnp.asarray(nbrs), jnp.asarray(us), jnp.asarray(L),
            jnp.asarray(R), **kw))
        got = tedge.select_edges_batch(t(nbrs), t(us), t(L), t(R), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        plain = tops.select_edges(t(nbrs), t(us), t(L), t(R), impl="torch",
                                  **kw)
        assert torch.equal(got, plain)
        for f in range(0, F, 3):
            # Algorithm 1 walks from u, which the search only expands
            # inside its range
            if not L[f] <= us[f] <= R[f]:
                continue
            one = tedge.select_edges(t(nbrs[us[f]]), int(us[f]), int(L[f]),
                                     int(R[f]), **kw)
            assert torch.equal(one, got[f])
            lit = tedge.select_edges_reference(nbrs[us[f]], us[f], L[f],
                                               R[f], **kw)
            assert lit == jedge.select_edges_reference(
                nbrs[us[f]], us[f], L[f], R[f], **kw)
            assert lit == [int(x) for x in got[f] if x >= 0]


def test_argsort_single_object_matches_repro_jit():
    rng = np.random.default_rng(9)
    logn, m = 5, 4
    nbrs = _table(rng, 1 << logn, m, logn)
    for u, L, R in [(3, 0, 31), (17, 10, 20), (8, 8, 8), (30, 2, 29)]:
        want = np.asarray(jedge.select_edges(
            jnp.asarray(nbrs[u]), u, L, R, logn=logn, m_out=m))
        got = tedge.select_edges(torch.as_tensor(nbrs[u]), u, L, R,
                                 logn=logn, m_out=m)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the seed engine
# ---------------------------------------------------------------------------

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
    wl = make_workload(tidx, "mixed", n_queries=32, seed=1)
    return jidx, tidx, wl


def _entries(L, R, n, xp_search, xp):
    """The improvised search's entries: in-range quartiles of [L, R]."""
    e = xp_search.range_entry_ids(L, xp.where(R < n, R, n - 1), n)
    ok = (e >= L[:, None]) & (e <= R[:, None])
    return xp.where(ok, e, -1)


@functools.partial(jax.jit, static_argnames=("logn", "m", "ef", "k",
                                             "filtered"))
def _jax_reference(vec, nbrs, q, L, R, *, logn, m, ef, k, filtered):
    n = vec.shape[0]
    if filtered:
        mid = jnp.clip((L + R) // 2, 0, n - 1)
        entries = jnp.stack([mid, jnp.zeros_like(mid) + n // 2], axis=1)

        def nbr_fn(u):
            row = nbrs[jnp.maximum(u, 0), 0, :]
            return jnp.where((row >= 0) & (u >= 0)[:, None], row, -1)

        def filt(ids):
            return (ids >= L[:, None]) & (ids <= R[:, None])

        return jref.beam_search_reference(vec, q, entries, nbr_fn, ef=ef,
                                          k=k, result_filter_fn=filt)
    entries = _entries(L, R, n, jsearch, jnp)

    def nbr_fn(u):
        return jedge.select_edges_batch(nbrs, u, L, R, logn=logn, m_out=m)

    return jref.beam_search_reference(vec, q, entries, nbr_fn, ef=ef, k=k)


def _port_reference(tidx, q, L, R, *, ef, k, filtered, **kw):
    vec, nbrs, n = tidx.vectors, tidx.neighbors, tidx.n
    if filtered:
        mid = torch.div(L + R, 2, rounding_mode="floor").clamp(0, n - 1)
        entries = torch.stack([mid, torch.full_like(mid, n // 2)], dim=1)

        def nbr_fn(u):
            row = nbrs[u.clamp(0, n - 1).long(), 0, :]
            return torch.where((row >= 0) & (u >= 0)[:, None], row, -1)

        def filt(ids):
            return (ids >= L[:, None]) & (ids <= R[:, None])

        return tref.beam_search_reference(vec, q, entries, nbr_fn, ef=ef,
                                          k=k, result_filter_fn=filt, **kw)
    entries = _entries(L, R, n, tsearch, torch)

    def nbr_fn(u):
        return tops.select_edges(nbrs, u, L, R, logn=tidx.logn,
                                 m_out=tidx.m, impl="torch")

    return tref.beam_search_reference(vec, q, entries, nbr_fn, ef=ef, k=k,
                                      **kw)


def _inputs(tidx, wl):
    return (torch.as_tensor(wl.queries), torch.as_tensor(wl.L),
            torch.as_tensor(wl.R))


@pytest.mark.parametrize("filtered", [False, True], ids=["one", "two"])
def test_reference_matches_repro(pair, filtered):
    jidx, tidx, wl = pair
    want = _jax_reference(jnp.asarray(jidx.vectors),
                          jnp.asarray(jidx.neighbors),
                          jnp.asarray(wl.queries), jnp.asarray(wl.L),
                          jnp.asarray(wl.R), logn=jidx.logn, m=jidx.m,
                          ef=48, k=10, filtered=filtered)
    q, L, R = _inputs(tidx, wl)
    got = _port_reference(tidx, q, L, R, ef=48, k=10, filtered=filtered)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    wd, gd = np.asarray(want.dists), got.dists.numpy()
    fin = np.isfinite(wd)
    assert (np.isfinite(gd) == fin).all()
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.n_hops.numpy(), np.asarray(want.n_hops))
    np.testing.assert_array_equal(got.n_dists.numpy(),
                                  np.asarray(want.n_dists))


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hop_impl", ["auto", "composed"])
def test_width1_beam_search_reproduces_the_reference(pair, hop_impl):
    """The improvised search at W = 1 (the plain hop, and the composed
    one) against the seed engine: everything identical, distances bit for
    bit."""
    _, tidx, wl = pair
    q, L, R = _inputs(tidx, wl)
    cfg = SearchConfig(ef=48, expand_width=1, hop_impl=hop_impl)
    got = tsearch.search_improvised(tidx.vectors, tidx.neighbors, q, L, R,
                                    logn=tidx.logn, m_out=tidx.m, k=10,
                                    config=cfg)
    _same(got, _port_reference(tidx, q, L, R, ef=48, k=10, filtered=False))


def test_width1_filtered_search_reproduces_the_reference(pair):
    _, tidx, wl = pair
    q, L, R = _inputs(tidx, wl)
    got = tsearch.search_filtered(tidx.vectors, tidx.neighbors, q, L, R,
                                  mode="post", k=10,
                                  config=SearchConfig(ef=48, expand_width=1))
    _same(got, _port_reference(tidx, q, L, R, ef=48, k=10, filtered=True))


def test_width1_coin_mode_reproduces_the_reference(pair):
    """In-filtering with a visit probability: beam_search (W = 1) and the
    reference draw one [B, M] batch of coins an iteration, in the same
    order, so one seeded stream gives both the same coins (the port's
    loop draws more after every query is done, touching no result)."""
    _, tidx, wl = pair
    q, L, R = _inputs(tidx, wl)
    n, nbrs = tidx.n, tidx.neighbors

    def visit_prob(ids, t):
        return torch.exp(-0.5 * t.float())[:, None].expand(ids.shape)

    def nbr_fn(u):
        row = nbrs[u.clamp(0, n - 1).long(), 0, :]
        return torch.where((row >= 0) & (u >= 0)[:, None], row, -1)

    def filt(ids):
        return (ids >= L[:, None]) & (ids <= R[:, None])

    mid = torch.div(L + R, 2, rounding_mode="floor").clamp(0, n - 1)
    entries = torch.stack([mid, torch.full_like(mid, n // 2)], dim=1)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    got = tsearch.beam_search(
        tidx.vectors, q, entries, nbr_fn, k=10,
        config=SearchConfig(ef=48, expand_width=1), result_filter_fn=filt,
        visit_prob_fn=visit_prob, generator=gens[0])
    want = tref.beam_search_reference(
        tidx.vectors, q, entries, nbr_fn, ef=48, k=10,
        result_filter_fn=filt, visit_prob_fn=visit_prob, generator=gens[1])
    _same(got, want)
    # the coins matter: a third stream gives other visits
    other = tref.beam_search_reference(
        tidx.vectors, q, entries, nbr_fn, ef=48, k=10,
        result_filter_fn=filt, visit_prob_fn=visit_prob,
        generator=torch.Generator().manual_seed(12))
    assert not torch.equal(other.n_dists, want.n_dists)


def test_argsort_edge_impl_search_matches_repro(pair):
    jidx, tidx, wl = pair
    gt, _ = jidx.brute_force(wl.queries, wl.L, wl.R, k=10)
    want = jidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                             config=JSearchConfig(edge_impl="argsort"))
    got = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10,
                            config=SearchConfig(edge_impl="argsort"))
    auto = tidx.search_ranks(wl.queries, wl.L, wl.R, k=10)
    assert torch.equal(got.ids, auto.ids)   # argsort == sort-free ids
    a, b = got.ids.numpy(), np.asarray(want.ids)
    agree = np.mean([len(set(x[x >= 0]) & set(y[y >= 0]))
                     / max(len(set(y[y >= 0])), 1) for x, y in zip(a, b)])
    r_t, r_j = recall(got.ids, gt), jrecall(b, gt)
    print(f"argsort search: recall@10 port {r_t:.4f} repro {r_j:.4f}, "
          f"top-10 id agreement {agree:.4f}")
    assert abs(r_t - r_j) <= 0.01
