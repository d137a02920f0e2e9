"""Baseline RFANN strategies from the paper (§2.2, §5), ported from
``repro/core/baselines.py:41-272``.

All baselines share the index's stored tables, so comparisons are like
for like:

  * Pre-filtering  — exact scan of the in-range slice (``brute_force``).
  * Post-filtering — beam search on the root elemental graph (layer 0, a
    plain whole-dataset RNG graph), keeping in-range results.
  * In-filtering   — the same graph, traversing in-range neighbors only.
  * BasicSearch    — the §5.2.2 ablation: decompose [L, R] into O(log n)
    disjoint tree segments, search each elemental graph, merge top-k.
  * SuperPostfiltering-style — the smallest single segment covering [L, R]
    with post-filtering.
  * Oracle         — a dedicated graph built from scratch on the exact
    range (§5.2.4); impractical, it measures the gap.

Range decomposition runs on the host (Python ints); every search runs on
the index's device through ``core/search.py``, so on the card the filtered
searches launch gather_dist, and the oracle's builds the prune too. Each
function returns a ``SearchResult`` of tensors on the index's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import build as build_mod
from repro_torch.core import search as search_mod
from repro_torch.core import segment_tree
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig

__all__ = [
    "prefilter",
    "postfilter",
    "infilter",
    "basic_search",
    "super_postfilter",
    "oracle_search",
]


def _i32(index, x) -> torch.Tensor:
    return index._on_device(x, torch.int32)


def prefilter(index, queries, L, R, *, k=10, **_):
    """Exact in-range top-k; ``n_dists`` counts the range, R - L + 1."""
    ids, dists = index.brute_force(queries, L, R, k=k)
    B = ids.shape[0]
    nd = np.asarray(R, np.int64) - np.asarray(L, np.int64) + 1
    return search_mod.SearchResult(
        _i32(index, ids), index._on_device(dists, torch.float32),
        _i32(index, np.zeros((B,), np.int32)), _i32(index, nd))


def _filtered(index, queries, L, R, mode, k, config):
    return search_mod.search_filtered(
        index.vectors, index.neighbors,
        index._on_device(queries, torch.float32),
        _i32(index, L), _i32(index, R), mode=mode, k=k, config=config)


def postfilter(index, queries, L, R, *, k=10,
               config: SearchConfig | None = None):
    return _filtered(index, queries, L, R, "post", k, config)


def infilter(index, queries, L, R, *, k=10,
             config: SearchConfig | None = None):
    return _filtered(index, queries, L, R, "in", k, config)


def basic_search(index, queries, L, R, *, k=10,
                 config: SearchConfig | None = None):
    """Per query: search every segment of the range's decomposition on its
    elemental graph, then merge.

    Slot s holds each query's s-th segment (an empty one where a query
    has fewer); each slot runs one batched ``search_fixed_layer`` per
    distinct layer over all queries, the others on an empty segment. The
    merge is a stable top-k over the slots' concatenated results.
    """
    config = config or SearchConfig()
    q = index._on_device(queries, torch.float32)
    B = q.shape[0]
    L = np.asarray(L)
    R = np.asarray(R)
    decomps = [segment_tree.decompose_range(int(L[i]), int(R[i]), index.logn)
               for i in range(B)]
    max_segs = max(len(d) for d in decomps)
    dev = index.device
    nbrs = storage_mod.decode_neighbors(index.neighbors)
    all_ids, all_dists = [], []
    nd_total = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s in range(max_segs):
        lay = np.zeros((B,), np.int32)
        lo = np.zeros((B,), np.int32)
        hi = np.full((B,), -1, np.int32)  # an empty segment by default
        for i, d in enumerate(decomps):
            if s < len(d):
                lay[i], lo[i], hi[i] = d[s]
        ids_s = torch.full((B, k), -1, dtype=torch.int32, device=dev)
        dists_s = torch.full((B, k), torch.inf, device=dev)
        for layer in np.unique(lay):
            sel = lay == layer
            res = search_mod.search_fixed_layer(
                index.vectors, nbrs, q, _i32(index, np.where(sel, lo, 0)),
                _i32(index, np.where(sel, hi, -1)), layer=int(layer), k=k,
                config=config)
            selt = torch.as_tensor(sel, device=dev)
            ids_s = torch.where(selt[:, None], res.ids, ids_s)
            dists_s = torch.where(selt[:, None], res.dists, dists_s)
            nd_total = nd_total + torch.where(selt, res.n_dists, 0)
        all_ids.append(ids_s)
        all_dists.append(dists_s)
    ids = torch.cat(all_ids, 1)
    out_dists, take = search_mod._smallest(torch.cat(all_dists, 1), k)
    return search_mod.SearchResult(
        ids.gather(1, take), out_dists,
        torch.zeros((B,), dtype=torch.int32, device=dev), nd_total)


def super_postfilter(index, queries, L, R, *, k=10,
                     config: SearchConfig | None = None):
    """Smallest covering segment + post-filtering: traverse the covering
    segment's elemental graph (the row gather keeps to the segment), keep
    only [L, R] results. One two-list search per distinct layer."""
    config = config or SearchConfig()
    q = index._on_device(queries, torch.float32)
    B = q.shape[0]
    L = np.asarray(L)
    R = np.asarray(R)
    lay = np.zeros((B,), np.int32)
    lo = np.zeros((B,), np.int32)
    hi = np.zeros((B,), np.int32)
    for i in range(B):
        lay[i], lo[i], hi[i] = segment_tree.covering_segment(
            int(L[i]), int(R[i]), index.logn)
    dev = index.device
    n = index.n
    nbrs = storage_mod.decode_neighbors(index.neighbors)
    Lt = _i32(index, L)
    Rt = _i32(index, R)

    def filt(ids):
        return (ids >= Lt[:, None]) & (ids <= Rt[:, None])

    # nbr_fn sees the flattened [B*W] frontier: W as beam_search derives it
    eff_w = search_mod.effective_expand_width(config.expand_width,
                                              config.ef)
    out_ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    out_dists = torch.full((B, k), torch.inf, device=dev)
    nd = torch.zeros((B,), dtype=torch.int32, device=dev)
    for layer in np.unique(lay):
        sel = lay == layer
        use_lo = _i32(index, np.where(sel, lo, 0))
        use_hi = _i32(index, np.where(sel, hi, -1))
        lo_w = search_mod.tile_frontier(use_lo, eff_w)
        hi_w = search_mod.tile_frontier(use_hi, eff_w)

        def nbr_fn(u, _layer=int(layer), _lo=lo_w, _hi=hi_w):
            row = nbrs[u.clamp(0, n - 1), _layer, :]
            ok = ((row >= 0) & (row >= _lo[:, None]) & (row <= _hi[:, None])
                  & (u >= 0)[:, None])
            return torch.where(ok, row, -1)

        hi_real = use_hi.clamp_max(n - 1)
        entries = search_mod.range_entry_ids(use_lo, hi_real, n)
        okent = ((use_lo[:, None] <= hi_real[:, None])
                 & (entries >= use_lo[:, None])
                 & (entries <= hi_real[:, None]))
        entries = torch.where(okent, entries, -1)
        res = search_mod.beam_search(index.vectors, q, entries, nbr_fn, k=k,
                                     config=config, result_filter_fn=filt)
        selt = torch.as_tensor(sel, device=dev)
        out_ids = torch.where(selt[:, None], res.ids, out_ids)
        out_dists = torch.where(selt[:, None], res.dists, out_dists)
        nd = nd + torch.where(selt, res.n_dists, 0)
    return search_mod.SearchResult(
        out_ids, out_dists, torch.zeros((B,), dtype=torch.int32, device=dev),
        nd)


def oracle_search(index, queries, L, R, *, k=10,
                  config: SearchConfig | None = None,
                  cache: dict | None = None):
    """A dedicated graph built from scratch per distinct range (§5.2.4),
    with the index's own ``build_cfg`` on the index's device, searched at
    layer 0; result ids are offset back by the range's start.

    ``cache`` maps ``(L, R)`` to its flat graph; pass a dict to amortise
    the builds across beam sizes, as the paper's Fig. 4 does.
    """
    config = config or SearchConfig()
    q = index._on_device(queries, torch.float32)
    B = q.shape[0]
    L = np.asarray(L)
    R = np.asarray(R)
    dev = index.device
    out_ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    out_dists = torch.full((B, k), torch.inf, device=dev)
    nd = torch.zeros((B,), dtype=torch.int32, device=dev)
    cache = cache if cache is not None else {}
    groups: dict[tuple[int, int], list[int]] = {}
    for i in range(B):
        groups.setdefault((int(L[i]), int(R[i])), []).append(i)
    # the oracle graphs are pruned like the index's own (same config);
    # codec tables decode once here
    vecs = storage_mod.decode_vectors(index.vectors)
    for (lo, hi), idxs in groups.items():
        if (lo, hi) not in cache:
            cache[(lo, hi)] = build_mod.build_flat_graph(
                vecs[lo:hi + 1], index.build_cfg, device=dev)
        g = cache[(lo, hi)]
        sub = vecs[lo:hi + 1]
        nn = sub.shape[0]
        rows = torch.as_tensor(idxs, device=dev)
        res = search_mod.search_fixed_layer(
            sub, g, q[rows],
            torch.zeros((len(idxs),), dtype=torch.int32, device=dev),
            torch.full((len(idxs),), nn - 1, dtype=torch.int32, device=dev),
            layer=0, k=k, config=config)
        out_ids[rows] = torch.where(res.ids >= 0, res.ids + lo, -1)
        out_dists[rows] = res.dists
        nd[rows] = res.n_dists
    return search_mod.SearchResult(
        out_ids, out_dists, torch.zeros((B,), dtype=torch.int32, device=dev),
        nd)
