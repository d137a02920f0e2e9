"""Multi-attribute RFANN (paper §4), ported from
``repro/core/multiattr.py:34-138``.

The index is built on attribute A1; a conjunctive query carries a rank
range [L, R] on A1 and a value range [lo2, hi2] on a second attribute.
Search runs on the improvised dedicated graph for [L, R] (edges by
``ops.select_edges``: the edge_select kernel on the card); neighbors that
fail the second predicate are visited with probability ``p``:

  * ``p = 0``        -> In-filtering (mode ``"in"``);
  * ``p = 1``        -> Post-filtering (mode ``"post"``);
  * ``p = exp(-t)``  -> the paper's adaptive rule, iRangeGraph+ (mode
    ``"adaptive"``), ``t`` the number of consecutive out-of-range objects
    expanded on the search path.

The coins come from a ``torch.Generator`` seeded with ``seed`` on the
index's device, so a seed gives the same result there every time; they
cannot match ``jax.random``'s, so the adaptive mode agrees with ``repro``
in its statistics only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import search as search_mod
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig
from repro_torch.kernels import ops

__all__ = ["search_multiattr", "brute_force_multiattr"]

MODES = ("post", "in", "adaptive")


def search_multiattr(index, attr2, queries, L, R, lo2, hi2, *, k=10,
                     mode="adaptive", seed=0,
                     config: SearchConfig | None = None
                     ) -> search_mod.SearchResult:
    """Conjunctive RFANN query.

    attr2: the second attribute's values in RANK-of-A1 order (aligned with
      ``index.vectors``); lo2/hi2: per-query inclusive value ranges on it.
    mode: "post" | "in" | "adaptive" (iRangeGraph+'s p = exp(-t)).
    Inputs may be numpy or torch; the result is on the index's device.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    config = config or SearchConfig()
    dev = index.device
    nbrs = storage_mod.decode_neighbors(index.neighbors)
    n = index.n
    a2 = index._on_device(attr2, torch.float32)
    q = index._on_device(queries, torch.float32)
    L = index._on_device(L, torch.int32)
    R = index._on_device(R, torch.int32)
    lo2 = index._on_device(lo2, torch.float32)
    hi2 = index._on_device(hi2, torch.float32)
    entries = search_mod.range_entry_ids(L, R.clamp_max(n - 1), n)
    ok = (entries >= L[:, None]) & (entries <= R[:, None])
    entries = torch.where(ok, entries, -1)
    W = search_mod.effective_expand_width(config.expand_width, config.ef)
    Lw = search_mod.tile_frontier(L, W)
    Rw = search_mod.tile_frontier(R, W)

    def nbr_fn(u):
        return ops.select_edges(
            nbrs, u, Lw, Rw, logn=index.logn, m_out=index.m,
            skip_layers=config.skip_layers, impl=config.edge_impl)

    def filt(ids):
        a = a2[ids.long()]
        return (a >= lo2[:, None]) & (a <= hi2[:, None])

    if mode == "post":
        visit_prob_fn = None
    elif mode == "in":
        def visit_prob_fn(ids, t):
            return torch.zeros(ids.shape, device=ids.device)
    else:
        def visit_prob_fn(ids, t):
            return torch.exp(-t.float())[:, None].expand(ids.shape)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return search_mod.beam_search(
        index.vectors, q, entries, nbr_fn, k=k, config=config,
        result_filter_fn=filt, visit_prob_fn=visit_prob_fn, generator=gen)


def brute_force_multiattr(index, attr2, queries, L, R, lo2, hi2, *, k=10):
    """Exact conjunctive top-k (the ground truth, and the Pre-filtering
    row of Fig. 5): plain torch on the index's device over the decoded
    vectors, one query at a time. Returns numpy ``(ids int64[B, k], dists
    f32[B, k])``."""
    q = index._on_device(queries, torch.float32)
    a2 = index._on_device(attr2, torch.float32)
    vecs = storage_mod.decode_vectors(index.vectors)
    B = q.shape[0]
    ids = np.full((B, k), -1, np.int64)
    dists = np.full((B, k), np.inf, np.float32)
    L = np.asarray(L)
    R = np.asarray(R)
    lo2 = np.asarray(lo2, np.float32)
    hi2 = np.asarray(hi2, np.float32)
    for i in range(B):
        lo, hi = int(L[i]), int(R[i])
        if hi < lo:
            continue
        a = a2[lo:hi + 1]
        sel = torch.nonzero((a >= float(lo2[i])) & (a <= float(hi2[i])))[:, 0]
        if sel.numel() == 0:
            continue
        d = ((vecs[lo + sel] - q[i]) ** 2).sum(1)
        kk = min(k, d.shape[0])
        dv, part = torch.sort(d, stable=True)
        ids[i, :kk] = (sel[part[:kk]] + lo).cpu().numpy()
        dists[i, :kk] = dv[:kk].cpu().numpy()
    return ids, dists
