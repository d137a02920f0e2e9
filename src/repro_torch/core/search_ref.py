"""The seed engine of beam search, kept as the oracle of ``core/search.py``
(``repro/core/search_ref.py``).

A dense ``bool[B, n]`` visited map, exactly one node expanded per query
per iteration, distances by a plain gather and einsum (:func:`_pairdist`,
the expansion of ``kernels/ref.py::gather_dist``). ``beam_search`` with
``expand_width=1`` and the plain distance reproduces it: ids always, and
distances bit for bit where both run the plain distance on one device.
The loop checks for an active query before every iteration, as
``lax.while_loop`` does. Do not use it on a production path; it exists to
pin semantics.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.search import SearchResult, _smallest

__all__ = ["beam_search_reference"]


def _pairdist(q, x, metric):
    """Distances of queries q[B, d] to points x[B, M, d] -> f32[B, M]."""
    q = q.float()
    x = x.float()
    if metric == "l2":
        xx = (x * x).sum(-1)
        qq = (q * q).sum(-1, keepdim=True)
        xq = torch.einsum("bd,bmd->bm", q, x)
        return xx - 2.0 * xq + qq
    if metric == "ip":
        return -torch.einsum("bd,bmd->bm", q, x)
    raise ValueError(f"unknown metric {metric!r}")


def beam_search_reference(
    vectors: torch.Tensor,         # f32[n, d]
    queries: torch.Tensor,         # f32[B, d]
    entry_ids: torch.Tensor,       # int32[B, E] (-1 for unused)
    nbr_fn: Callable,              # int32[B] -> int32[B, M]
    *,
    ef: int,
    k: int,
    max_iters: int | None = None,
    metric: str = "l2",
    result_filter_fn: Callable | None = None,
    visit_prob_fn: Callable | None = None,
    generator: torch.Generator | None = None,
) -> SearchResult:
    """Single-expansion dense-visited beam search (the seed's semantics).

    ``result_filter_fn`` (``ids[B, K] -> bool[B, K]``) keeps a second,
    result list of the ids that pass it; ``visit_prob_fn`` (``(ids[B, K],
    t int32[B]) -> p f32[B, K]``) visits a neighbour that fails the filter
    with probability p, the coins ``rand < p`` drawn as one ``[B, M]``
    draw an iteration from ``generator`` (``repro`` takes a JAX key; None
    here draws from a fresh generator seeded 0), ``t`` the query's count
    of consecutive out-of-range expansions.
    """
    n = vectors.shape[0]
    B = queries.shape[0]
    dev = queries.device
    if max_iters is None:
        max_iters = 4 * ef + 32
    inf = torch.inf
    two_lists = result_filter_fn is not None
    rows = torch.arange(B, device=dev)[:, None]

    def mark(visited, ids, valid):
        idx = ids.clamp_min(0).long()
        return visited.scatter_reduce(1, idx, valid.to(torch.uint8), "amax")

    e = entry_ids.to(torch.int32)
    valid = e >= 0
    ex = vectors[e.clamp_min(0).long()]
    dists = torch.where(valid, _pairdist(queries, ex, metric), inf)
    pad = ef - e.shape[1]
    cand_ids = torch.cat(
        [torch.where(valid, e, -1),
         torch.full((B, pad), -1, dtype=torch.int32, device=dev)], 1)
    cand_dists = torch.cat([dists, torch.full((B, pad), inf, device=dev)], 1)
    cand_vis = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    visited = mark(torch.zeros((B, n), dtype=torch.uint8, device=dev), e,
                   valid)
    if two_lists:
        ok = result_filter_fn(e.clamp_min(0)) & valid
        res_ids = torch.cat(
            [torch.where(ok, e, -1),
             torch.full((B, pad), -1, dtype=torch.int32, device=dev)], 1)
        res_dists = torch.cat(
            [torch.where(ok, dists, inf),
             torch.full((B, pad), inf, device=dev)], 1)
        if visit_prob_fn is not None and generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
    else:
        res_ids, res_dists = cand_ids, cand_dists
    t = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_dists = valid.sum(1, dtype=torch.int32)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    slots = torch.arange(ef, device=dev)[None, :]

    it = 0
    while it < max_iters and bool(active.any()):
        unvisited = torch.where(cand_vis | (cand_ids < 0), inf, cand_dists)
        best_slot = torch.argmin(unvisited, dim=1, keepdim=True)
        best_dist = unvisited.gather(1, best_slot)[:, 0]
        worst = torch.where(cand_ids >= 0, cand_dists, -inf).amax(dim=1)
        full = (cand_ids >= 0).all(dim=1)
        progress = torch.isfinite(best_dist) & (~full | (best_dist <= worst))
        active = active & progress

        u = torch.where(active, cand_ids.gather(1, best_slot)[:, 0], -1)
        cand_vis = cand_vis | (active[:, None] & (slots == best_slot))
        n_hops = n_hops + active.to(torch.int32)

        nbr = nbr_fn(u).to(torch.int32)                   # [B, M]
        M = nbr.shape[1]
        nvalid = (nbr >= 0) & active[:, None]
        seen = visited[rows, nbr.clamp_min(0).long()].bool()
        nvalid = nvalid & ~seen

        if two_lists:
            in_rng = result_filter_fn(nbr.clamp_min(0))
            if visit_prob_fn is not None:
                p = visit_prob_fn(nbr.clamp_min(0), t)
                coin = torch.rand((B, M), generator=generator, device=dev)
                visit_out = coin < p
            else:
                visit_out = torch.ones((B, M), dtype=torch.bool, device=dev)
            nvalid = nvalid & (in_rng | visit_out)
            # the consecutive out-of-range counter follows the expanded node
            u_in = result_filter_fn(u.clamp_min(0)[:, None])[:, 0]
            u_out = ~u_in & (u >= 0)
            t = torch.where(active, torch.where(u_out, t + 1, 0), t)

        visited = mark(visited, nbr, nvalid)
        nx = vectors[nbr.clamp_min(0).long()]
        ndist = torch.where(nvalid, _pairdist(queries, nx, metric), inf)
        n_dists = n_dists + nvalid.sum(1, dtype=torch.int32)

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
        it += 1

    out_dists, idx = _smallest(res_dists, k)
    out_ids = res_ids.gather(1, idx)
    out_ids = torch.where(torch.isfinite(out_dists), out_ids, -1)
    return SearchResult(out_ids, out_dists, n_hops, n_dists)
