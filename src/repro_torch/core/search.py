"""Batched greedy beam search on the improvised range graphs (port of
``repro/core/search.py``: ``beam_search`` :114-327, the entry-point helpers
:334-351, the improvised search :358-442, ``search_fixed_layer`` :445-490
and the post-/in-filtering ``search_filtered`` :494-540).

Per-query state is a candidate list ``(ids, dists, visited-flag)`` of size
``ef``, a packed ``int32[B, ceil(n/32)]`` visited bitset and an active
flag. Each iteration expands the top ``expand_width`` unvisited candidates
of every active query at once.

Two things differ from the JAX engine, neither in results:

  * **Ties.** ``lax.top_k`` puts the lower index first on ties and
    ``torch.topk`` does not, so every top-k here is a stable ascending
    ``torch.sort`` and a slice (``+inf`` ties are everywhere in the lists).
  * **The loop.** ``jax.lax.while_loop`` checks ``any(active)`` before
    every iteration; a host sync per hop would serialise the card. Here the
    loop runs blocks of ``ITER_BLOCK`` iterations between syncs, capped
    exactly at ``max_iters``. An iteration after every query went
    inactive changes nothing: no frontier is expanded, nothing is marked
    visited, the out-of-range counter stays, and the stable re-sort of the
    already sorted lists is the identity; the coin of ``visit_prob_fn``
    is still drawn, which advances the generator but touches no result.
    So the block size never changes results.
  * **The coin.** ``jax.random``'s stream cannot be matched: the coins
    come from a ``torch.Generator`` the caller passes, on the queries'
    device, one ``[B, W*M]`` draw per iteration.

Vector tables may be stored in any codec (``core/storage.py``): the hop and
gather-distance dispatch launch the kernel of the stored layout, and the
rerank pass decodes through ``storage.decode_rows``. Neighbor tables
(``SplitNeighbors`` too) widen once, at the top of each search.

``beam_search`` has the two hop bodies of the JAX engine: a bound whole-hop
``hop_fn`` (``kernels/ops.py::hop``) or the composed ``nbr_fn`` body. With
``result_filter_fn`` it keeps two lists: the navigation list accepts every
visited neighbor and a result list ``(res_ids, res_dists)``, merged with
the same stable ``_smallest``, only those that pass the filter (the
post-/in-filtering baselines, ``core/baselines.py``, and the
multi-attribute search, ``core/multiattr.py``). The filter hooks in
between edge selection and the visited update, so it needs the composed
body: ``hop_fn`` with ``result_filter_fn`` raises.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import bitset
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig
from repro_torch.kernels import ops

__all__ = [
    "ITER_BLOCK",
    "SearchResult",
    "beam_search",
    "effective_expand_width",
    "range_entry_ids",
    "tile_frontier",
    "search_improvised",
    "search_fixed_layer",
    "search_filtered",
]


# beam iterations between host checks for a still-active query
ITER_BLOCK = 8


def effective_expand_width(expand_width: int, ef: int) -> int:
    """The W beam_search actually runs: clamped to the ef-sized list."""
    w = int(expand_width)
    if w < 1:
        raise ValueError(f"expand_width must be >= 1, got {w}")
    return min(w, ef)


class SearchResult(NamedTuple):
    ids: torch.Tensor      # int32[B, k] (-1 padded)
    dists: torch.Tensor    # float32[B, k]
    n_hops: torch.Tensor   # int32[B]   nodes expanded
    n_dists: torch.Tensor  # int32[B]   distance computations


def _smallest(x: torch.Tensor, k: int):
    """``lax.top_k(-x, k)`` with its tie rule: the k smallest values of
    each row, lowest index first among equals."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def beam_search(
    vectors,                        # [n, d] in any stored layout, or a codec
                                    # struct (storage.Int8Vectors/PQVectors)
    queries: torch.Tensor,          # f32[B, d]
    entry_ids: torch.Tensor,        # int32[B, E] (-1 for unused)
    nbr_fn: Callable | None,        # int32[B*W] -> int32[B*W, M]
    *,
    k: int,
    config: SearchConfig | None = None,
    hop_fn: Callable | None = None,
    result_filter_fn: Callable | None = None,
    visit_prob_fn: Callable | None = None,
    generator: torch.Generator | None = None,
) -> SearchResult:
    """Generic batched beam search (see the module docstring).

    nbr_fn contract: receives the flattened frontier ``int32[B*W]`` (row
    ``b*W + w`` is query b's w-th expansion, -1 inactive) and returns
    ``int32[B*W, M]``. hop_fn contract: ``(u int32[B, W], exp_ok bool[B,
    W], visited int32[B, words]) -> (nbr, ndist, nvalid, visited')`` with
    ``kernels/ref.py::hop``'s semantics.

    result_filter_fn: optional ``ids[B, K] -> bool[B, K]``; the result
      list then only accepts ids that pass it (two-list mode).
    visit_prob_fn: optional ``(ids[B, K], t int32[B]) -> p f32[B, K]``,
      the probability of visiting a neighbor that fails the result filter,
      ``t`` the query's count of consecutive out-of-range expansions (p = 1
      is post-filtering, p = 0 in-filtering). Without it every such
      neighbor is visited.
    generator: the ``torch.Generator`` the coins ``rand < p`` are drawn
      from, on the queries' device; None draws from a fresh one seeded 0.
    """
    config = config or SearchConfig()
    if hop_fn is not None and result_filter_fn is not None:
        raise ValueError(
            "beam_search: hop_fn is incompatible with result_filter_fn "
            "(filtered searches need the composed hop body)")
    if hop_fn is None and nbr_fn is None:
        raise ValueError("beam_search: need nbr_fn or hop_fn")
    ef = config.ef
    n = storage_mod.table_n(vectors)
    B = queries.shape[0]
    dev = queries.device
    W = effective_expand_width(config.expand_width, ef)
    max_iters = config.max_iters
    if max_iters is None:
        max_iters = 4 * ef + 32
    inf = torch.inf

    def gdist(ids):
        return ops.gather_dist(queries, vectors, ids, metric=config.metric,
                               impl=config.dist_impl)

    e = entry_ids.to(torch.int32)
    valid = e >= 0
    e_masked = torch.where(valid, e, -1)
    dists = gdist(e_masked)
    pad = ef - e.shape[1]
    cand_ids = torch.cat(
        [e_masked, torch.full((B, pad), -1, dtype=torch.int32, device=dev)], 1)
    cand_dists = torch.cat(
        [dists, torch.full((B, pad), inf, device=dev)], 1)
    cand_vis = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    visited, _ = bitset.test_and_set(bitset.make(B, n, device=dev), e, valid)
    n_hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_dists = valid.sum(1, dtype=torch.int32)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    two_lists = result_filter_fn is not None
    if two_lists:
        ok = result_filter_fn(e.clamp_min(0)) & valid
        res_ids = torch.cat([torch.where(ok, e, -1), cand_ids[:, e.shape[1]:]],
                            1)
        res_dists = torch.cat(
            [torch.where(ok, dists, inf), cand_dists[:, e.shape[1]:]], 1)
        if visit_prob_fn is not None and generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
    else:
        res_ids, res_dists = cand_ids, cand_dists
    t = torch.zeros((B,), dtype=torch.int32, device=dev)

    def body(cand_ids, cand_dists, cand_vis, visited, active, n_hops,
             n_dists, res_ids, res_dists, t):
        unvisited = torch.where(cand_vis | (cand_ids < 0), inf, cand_dists)
        # top-W unvisited candidates; slot 0 is the argmin
        sel_dists, slots = _smallest(unvisited, W)           # [B, W]
        best_dist = sel_dists[:, 0]
        worst = torch.where(cand_ids >= 0, cand_dists, -inf).amax(dim=1)
        full = (cand_ids >= 0).all(dim=1)
        progress = torch.isfinite(best_dist) & (~full | (best_dist <= worst))
        active = active & progress

        exp_ok = active[:, None] & torch.isfinite(sel_dists)  # [B, W]
        u = torch.where(exp_ok, cand_ids.gather(1, slots), -1)
        cand_vis = cand_vis.scatter(1, slots,
                                    cand_vis.gather(1, slots) | exp_ok)
        n_hops = n_hops + exp_ok.sum(1, dtype=torch.int32)

        if hop_fn is not None:
            nbr, ndist, nvalid, visited = hop_fn(u, exp_ok, visited)
        else:
            nbr = nbr_fn(u.reshape(B * W))                   # [B*W, M]
            M = nbr.shape[1]
            nbr = nbr.reshape(B, W * M)
            pre_valid = (nbr >= 0) & exp_ok.repeat_interleave(M, dim=1)
            if two_lists:
                in_rng = result_filter_fn(nbr.clamp_min(0))
                if visit_prob_fn is not None:
                    p = visit_prob_fn(nbr.clamp_min(0), t)
                    coin = torch.rand((B, W * M), generator=generator,
                                      device=dev)
                    pre_valid = pre_valid & (in_rng | (coin < p))
                # the consecutive out-of-range counter follows the
                # expanded nodes
                u_in = result_filter_fn(u.clamp_min(0)) & exp_ok
                num_out = (exp_ok & ~u_in).sum(1, dtype=torch.int32)
                t = torch.where(exp_ok.any(1),
                                torch.where(u_in.any(1), 0, t + num_out), t)
            visited, seen = bitset.test_and_set(visited, nbr, pre_valid)
            nvalid = pre_valid & ~seen
            ndist = gdist(torch.where(nvalid, nbr, -1))
        n_dists = n_dists + nvalid.sum(1, dtype=torch.int32)

        # merge into the navigation list (stable: ties keep list order)
        all_ids = torch.cat([cand_ids, torch.where(nvalid, nbr, -1)], 1)
        all_dists = torch.cat([cand_dists, ndist], 1)
        all_vis = torch.cat([cand_vis, torch.zeros_like(nvalid)], 1)
        cand_dists, idx = _smallest(all_dists, ef)
        cand_ids = all_ids.gather(1, idx)
        cand_vis = all_vis.gather(1, idx)
        if two_lists:
            rvalid = nvalid & in_rng
            r_ids = torch.cat([res_ids, torch.where(rvalid, nbr, -1)], 1)
            r_dists = torch.cat(
                [res_dists, torch.where(rvalid, ndist, inf)], 1)
            res_dists, ridx = _smallest(r_dists, ef)
            res_ids = r_ids.gather(1, ridx)
        else:
            res_ids, res_dists = cand_ids, cand_dists
        return (cand_ids, cand_dists, cand_vis, visited, active, n_hops,
                n_dists, res_ids, res_dists, t)

    state = (cand_ids, cand_dists, cand_vis, visited, active, n_hops,
             n_dists, res_ids, res_dists, t)
    it = 0
    while it < max_iters and bool(state[4].any()):
        stop = min(max_iters, it + ITER_BLOCK)
        for _ in range(it, stop):
            state = body(*state)
        it = stop
    _, _, _, _, _, n_hops, n_dists, res_ids, res_dists, _ = state

    out_dists, idx = _smallest(res_dists, k)
    out_ids = res_ids.gather(1, idx)
    out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1)
    return SearchResult(out_ids, out_dists, n_hops, n_dists)


# ---------------------------------------------------------------------------
# Entry-point helpers
# ---------------------------------------------------------------------------

def range_entry_ids(L, R, n, num_entries=3):
    """Deterministic in-range entry points: midpoint + quartiles of [L, R].

    ``span * fracs`` is computed in f32 and rounded half to even, as
    ``jnp.round`` does.
    """
    fracs = torch.tensor([0.5, 0.25, 0.75, 0.0, 1.0][:num_entries],
                         dtype=torch.float32, device=L.device)
    span = (R - L).to(torch.float32)[..., None]
    ids = L[..., None] + torch.round(span * fracs).to(torch.int32)
    ids = ids.clamp(0, n - 1)
    # dedupe within the row: later duplicates -> -1
    sortd, _ = torch.sort(ids, dim=-1)
    dup = torch.cat(
        [torch.zeros_like(sortd[..., :1], dtype=torch.bool),
         sortd[..., 1:] == sortd[..., :-1]], dim=-1)
    return torch.where(dup, -1, sortd)


def tile_frontier(x, expand_width):
    """Repeat per-query values to the flattened [B*W] frontier layout."""
    return x.repeat_interleave(expand_width, dim=0)


# ---------------------------------------------------------------------------
# Concrete searches
# ---------------------------------------------------------------------------

def search_improvised(vectors, nbrs, queries, L, R, *, logn, m_out, k,
                      config: SearchConfig | None = None,
                      rerank_store=None) -> SearchResult:
    """The paper's query path: beam search on the improvised dedicated
    graph. ``vectors`` in any stored layout or a codec struct; ``nbrs`` a
    neighbor table or ``SplitNeighbors`` (widened once here); L, R:
    int32[B] per-query inclusive rank ranges; every tensor on one device.
    ``config.hop_impl`` picks the fused hop kernel, its plain version, or
    the composed three-op path; ``config.rerank > 0`` re-scores the beam's
    top-``r`` against ``rerank_store`` (the index's sidecar) or, without
    one, the stored ``vectors``, decoded to f32, and re-cuts to ``k``.
    """
    config = config or SearchConfig()
    nbrs = storage_mod.decode_neighbors(nbrs)
    n = storage_mod.table_n(vectors)
    L = L.to(torch.int32)
    R = R.to(torch.int32)
    expand_width = effective_expand_width(config.expand_width, config.ef)
    entries = range_entry_ids(L, R.clamp_max(n - 1), n)
    ok = (entries >= L[:, None]) & (entries <= R[:, None])
    entries = torch.where(ok, entries, -1)
    Lw = tile_frontier(L, expand_width)
    Rw = tile_frontier(R, expand_width)

    def hop_fn(u, exp_ok, visited):
        return ops.hop(
            queries, vectors, nbrs, u, Lw, Rw, visited, exp_ok,
            logn=logn, m_out=m_out, skip_layers=config.skip_layers,
            metric=config.metric, impl=config.hop_impl,
            edge_impl=config.edge_impl, dist_impl=config.dist_impl,
        )

    r = max(k, min(config.rerank, config.ef)) if config.rerank else 0
    res = beam_search(vectors, queries, entries, None, k=r or k,
                      config=config, hop_fn=hop_fn)
    if not r:
        return res
    store = vectors if rerank_store is None else rerank_store
    ids = res.ids                                          # [B, r]
    x = storage_mod.decode_rows(store, ids.clamp(0, n - 1).long())  # [B,r,d]
    qf = queries.float()
    if config.metric == "ip":
        dd = -torch.einsum("bd,brd->br", qf, x)
    else:
        dd = ((x - qf[:, None, :]) ** 2).sum(-1)
    dd = torch.where(ids < 0, torch.inf, dd)
    out_dists, take = _smallest(dd, k)
    out_ids = ids.gather(1, take)
    out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1)
    return SearchResult(out_ids, out_dists, res.n_hops, res.n_dists)


def search_fixed_layer(vectors, nbrs, queries, seg_lo, seg_hi, *, layer, k,
                       config: SearchConfig | None = None) -> SearchResult:
    """Beam search on one elemental graph (segment ``[seg_lo, seg_hi]`` at
    ``layer``): the build's sibling search. Its ``nbr_fn`` is a plain row
    gather, so only ``config.dist_impl`` picks a kernel."""
    config = config or SearchConfig()
    nbrs = storage_mod.decode_neighbors(nbrs)
    n = storage_mod.table_n(vectors)
    seg_lo = seg_lo.to(torch.int32)
    seg_hi = seg_hi.to(torch.int32)
    hi_real = seg_hi.clamp_max(n - 1)
    entries = range_entry_ids(seg_lo, hi_real, n)
    # empty / padded-away segments contribute no entry points, and an
    # entry must lie inside its segment
    ok = (
        (seg_lo[:, None] <= hi_real[:, None])
        & (entries >= seg_lo[:, None])
        & (entries <= hi_real[:, None])
    )
    entries = torch.where(ok, entries, -1)
    expand_width = effective_expand_width(config.expand_width, config.ef)
    low = tile_frontier(seg_lo, expand_width)
    hiw = tile_frontier(seg_hi, expand_width)

    def nbr_fn(u):
        row = nbrs[u.clamp(0, n - 1), layer, :]
        ok = (row >= 0) & (row >= low[:, None]) & (row <= hiw[:, None])
        return torch.where(ok & (u >= 0)[:, None], row, -1)

    return beam_search(vectors, queries, entries, nbr_fn, k=k, config=config)


def search_filtered(vectors, nbrs, queries, L, R, *, mode, k,
                    config: SearchConfig | None = None) -> SearchResult:
    """Post-/In-filtering baselines on the root elemental graph (layer 0).

    mode: "post" visits everything and keeps in-range results; "in" only
    traverses in-range neighbors. The two entries are the range's
    midpoint and ``n // 2``, as in ``repro`` (a duplicate when they
    coincide). The ``nbr_fn`` is a layer-0 row gather, so only
    ``config.dist_impl`` picks a kernel (gather_dist on the card).
    """
    if mode not in ("post", "in"):
        raise ValueError(f"search_filtered: unknown mode {mode!r}")
    config = config or SearchConfig()
    nbrs = storage_mod.decode_neighbors(nbrs)
    n = storage_mod.table_n(vectors)
    L = L.to(torch.int32)
    R = R.to(torch.int32)
    mid = torch.div(L + R, 2, rounding_mode="floor").clamp(0, n - 1)
    entries = torch.stack([mid, torch.full_like(mid, n // 2)], dim=1)

    def filt(ids):
        return (ids >= L[:, None]) & (ids <= R[:, None])

    expand_width = effective_expand_width(config.expand_width, config.ef)
    Lw = tile_frontier(L, expand_width)
    Rw = tile_frontier(R, expand_width)

    def nbr_fn(u):
        row = nbrs[u.clamp(0, n - 1), 0, :]
        ok = (row >= 0) & (u >= 0)[:, None]
        if mode == "in":
            ok = ok & (row >= Lw[:, None]) & (row <= Rw[:, None])
        return torch.where(ok, row, -1)

    return beam_search(vectors, queries, entries, nbr_fn, k=k, config=config,
                       result_filter_fn=filt)
