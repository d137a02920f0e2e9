"""Bulk-synchronous bottom-up construction of the iRangeGraph index (port
of ``repro/core/build.py:47-289``).

Paper §3.2.2, one batched pass per segment-tree level. For the segment
``[l, r]`` with children ``[l, mid]`` / ``[mid+1, r]`` and a node ``u`` in
the left child:

  * candidates inside the *own* child are copied from the child graph;
  * candidates from the *sibling* child come from a beam search over the
    sibling's already-built elemental graph — one ``search_fixed_layer``
    call per chunk of nodes, each query carrying its own sibling bounds;
  * the merged candidate set is RNG-pruned (``kernels/ops.py::prune``, the
    CUDA kernel on the card).

Levels whose segments are small (``<= brute_threshold``) take the whole
segment as candidates. A reverse-edge pass mirrors HNSW's bidirectional
insertion. The table, the vectors and every level's scratch live on the
build's device; chunking never changes the built table, only throughput
and peak memory.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import knobs as knobs_mod
from repro_torch.core import search as search_mod
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = [
    "BuildConfig", "auto_chunk", "resolve_chunk", "build_neighbor_table",
    "build_flat_graph",
]


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    m: int = 16                    # max out-degree per elemental graph
    ef_construction: int = 64      # beam/candidates for sibling search (EF)
    alpha: float = 1.0             # RNG alpha (1.0 == paper's rule)
    brute_threshold: int = 128     # segments this small use exact candidates
    add_reverse: bool = True       # bidirectional pass per level
    fill_pruned: bool = True       # keepPrunedConnections
    chunk: int | None = None       # nodes per batched prune call; None = auto
    prune_impl: str = "auto"       # "auto" | "cuda" | "torch" | "legacy"


# The JAX package sizes chunks against a host cache budget (16 MiB by
# default, its REPRO_CHUNK_BUDGET_MB knob); the port keeps the same rule,
# default and knob (RTORCH_CHUNK_BUDGET_MB) so its CPU runs chunk like the
# reference. On the card a larger explicit ``BuildConfig.chunk`` amortizes
# launches better.
_CHUNK_MIN, _CHUNK_MAX = 256, 8192
# search levels never auto-tune their chunk below this floor (their sibling
# beam search amortizes with batch size)
_SEARCH_CHUNK_FLOOR = 2048


def auto_chunk(C: int, d: int, *, budget_bytes: int | None = None) -> int:
    """Per-level build chunk: the largest power of two keeping the gathered
    ``[chunk, C, d]`` f32 candidate block inside the budget (default the
    ``RTORCH_CHUNK_BUDGET_MB`` knob, 16 MiB), clamped to [256, 8192]."""
    if budget_bytes is None:
        budget_bytes = knobs_mod.get_int("RTORCH_CHUNK_BUDGET_MB") << 20
    per_row = max(int(C) * int(d) * 4, 1)
    target = max(budget_bytes // per_row, 1)
    p = 1
    while p * 2 <= target:
        p <<= 1
    return max(_CHUNK_MIN, min(_CHUNK_MAX, p))


def resolve_chunk(cfg: BuildConfig, C: int, d: int, *,
                  floor: int | None = None) -> int:
    """The chunk a level uses: ``cfg.chunk`` when set, else
    :func:`auto_chunk` for that level's candidate width (raised to
    ``floor`` when given)."""
    if cfg.chunk is not None:
        return int(cfg.chunk)
    chunk = auto_chunk(C, d)
    return max(chunk, floor) if floor else chunk


def _level_sizes(n: int) -> tuple[int, int]:
    logn = int(math.ceil(math.log2(max(n, 2))))
    return logn, logn + 1


def _sq_dists(cvec: torch.Tensor, uvec: torch.Tensor) -> torch.Tensor:
    """Squared distances of candidate rows [B, C, d] to their node [B, d]."""
    return ((cvec - uvec[:, None, :]) ** 2).sum(-1)


def _prune(cand, dist, vec, cvec, cfg: BuildConfig):
    return ops.prune(cand, dist, vec, m=cfg.m, alpha=cfg.alpha,
                     fill=cfg.fill_pruned, impl=cfg.prune_impl,
                     cand_vecs=cvec)


def _reverse_pass(nbrs_lay: torch.Tensor, vec: torch.Tensor,
                  seg_of: torch.Tensor, cfg: BuildConfig,
                  chunk: int | None = None) -> torch.Tensor:
    """Add reverse edges, then re-prune each node's list.

    nbrs_lay: int32[n, m] this level's edges; seg_of: int32[n] segment of
    each node at this level. For edge (u, v), u joins v's pool (the first
    ``2m`` in u order); candidates are ``[own m | reverse 2m]``.
    """
    n, m = nbrs_lay.shape
    dev = nbrs_lay.device
    if chunk is None:
        chunk = resolve_chunk(cfg, 3 * m, vec.shape[1])
    us = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(m)
    vs = nbrs_lay.reshape(-1)
    ok = (vs >= 0) & (seg_of[us] == seg_of[vs.clamp_min(0)])
    us, vs = us[ok], vs[ok]
    if us.numel() == 0:
        return nbrs_lay
    vs, order = torch.sort(vs, stable=True)
    us = us[order]
    vs = vs.long()
    counts = torch.bincount(vs, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(vs.numel(), dtype=torch.int64, device=dev) - starts[vs]
    rev_cap = 2 * m
    keep = pos < rev_cap
    C = m + rev_cap
    cand = torch.full((n, C), -1, dtype=torch.int32, device=dev)
    cand[:, :m] = nbrs_lay
    cand[vs[keep], m + pos[keep]] = us[keep]
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        ids = cand[s:e]
        cvec = vec[ids.clamp_min(0)]
        d = torch.where(ids >= 0, _sq_dists(cvec, vec[s:e]), torch.inf)
        out[s:e] = _prune(ids, d, vec, cvec, cfg)
    return out


def build_neighbor_table(
    vectors, cfg: BuildConfig | None = None, *, device=None, verbose=False,
    level_times: list | None = None,
    storage: storage_mod.StorageConfig | None = None,
    dist_impl: str = "auto",
) -> torch.Tensor:
    """Build the packed elemental-graph table ``[n, layers, m]`` on
    ``device`` (the card unless ``device="cpu"``; see ``device.py``).

    ``vectors`` (numpy or torch, ``[n, d]``) must already be in attribute-
    rank order. ``level_times``, if a list, collects per-level dicts
    (layer, segment size, kind, chunks, seconds; the device is synchronised
    for them). With ``storage`` the table is returned in its neighbor
    dtype (int16 when ids fit under "auto"), else int32. ``dist_impl``
    picks the sibling searches' gather-distance backend ("auto" | "cuda" |
    "torch"), as ``cfg.prune_impl`` picks the prune's.
    """
    cfg = cfg or BuildConfig()
    dev = resolve_device(device)
    vec = torch.as_tensor(np.asarray(vectors, np.float32)) \
        if not isinstance(vectors, torch.Tensor) else vectors
    vec = vec.to(device=dev, dtype=torch.float32).contiguous()
    n, d = vec.shape
    logn, layers = _level_sizes(n)
    m = cfg.m
    nbrs = torch.full((n, layers, m), -1, dtype=torch.int32, device=dev)

    ids_all = torch.arange(n, dtype=torch.int32, device=dev)
    for lay in range(logn - 1, -1, -1):  # leaves (logn) have no edges
        size = 1 << (logn - lay)
        seg_of = ids_all >> (logn - lay)
        t0 = time.perf_counter()
        if size <= cfg.brute_threshold:
            chunk = resolve_chunk(cfg, size, d)
            edges = _build_brute_level(vec, n, lay, logn, size, cfg, chunk)
        else:
            chunk = resolve_chunk(cfg, m + cfg.ef_construction, d,
                                  floor=_SEARCH_CHUNK_FLOOR)
            edges = _build_search_level(vec, nbrs, n, lay, logn, size, cfg,
                                        chunk, dist_impl)
        rev_chunk = None
        if cfg.add_reverse:
            rev_chunk = resolve_chunk(cfg, 3 * m, d)
            edges = _reverse_pass(edges, vec, seg_of, cfg, rev_chunk)
        nbrs[:, lay, :] = edges
        if level_times is not None or verbose:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if level_times is not None:
            level_times.append({
                "layer": int(lay), "seg_size": int(size),
                "kind": "brute" if size <= cfg.brute_threshold else "search",
                "chunk": int(chunk),
                "chunk_reverse": rev_chunk if rev_chunk is None
                else int(rev_chunk),
                "seconds": time.perf_counter() - t0,
            })
        if verbose:
            deg = float((edges >= 0).sum(1).float().mean())
            print(f"  layer {lay:2d} seg_size {size:7d} mean_deg {deg:.1f}")
    if storage is not None:
        return storage_mod.encode_neighbors(nbrs, n, storage)
    return nbrs


def _build_brute_level(vec, n, lay, logn, size, cfg: BuildConfig, chunk):
    """Exact candidates = whole segment. One batched prune per chunk."""
    dev = vec.device
    out = torch.empty((n, cfg.m), dtype=torch.int32, device=dev)
    step = max(1, chunk // max(size, 1)) * size  # chunk on segment bounds
    offs = torch.arange(size, dtype=torch.int32, device=dev)
    for s in range(0, n, step):
        e = min(n, s + step)
        u = torch.arange(s, e, dtype=torch.int32, device=dev)
        lo = (u >> (logn - lay)) << (logn - lay)
        cand = lo[:, None] + offs[None, :]
        valid = (cand < n) & (cand != u[:, None])
        cand = torch.where(valid, cand, -1)
        cvec = vec[cand.clamp_min(0)]
        dist = torch.where(valid, _sq_dists(cvec, vec[s:e]), torch.inf)
        out[s:e] = _prune(cand, dist, vec, cvec, cfg)
    return out


def _build_search_level(vec, nbrs, n, lay, logn, size, cfg: BuildConfig,
                        chunk, dist_impl):
    """Own-child copy + sibling beam search, then prune. Paper §3.2.2."""
    dev = vec.device
    efc = cfg.ef_construction
    child_lay = lay + 1
    out = torch.empty((n, cfg.m), dtype=torch.int32, device=dev)
    half = size // 2
    search_cfg = SearchConfig(ef=efc, dist_impl=dist_impl)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        u = torch.arange(s, e, dtype=torch.int32, device=dev)
        lo = (u >> (logn - lay)) << (logn - lay)
        mid = lo + half - 1
        in_left = u <= mid
        sib_lo = torch.where(in_left, mid + 1, lo)
        sib_hi = torch.where(in_left, lo + size - 1, mid)
        res = search_mod.search_fixed_layer(
            vec, nbrs, vec[s:e], sib_lo, sib_hi, layer=child_lay, k=efc,
            config=search_cfg,
        )
        own = nbrs[s:e, child_lay, :]                     # int32[B, m]
        cand = torch.cat([own, res.ids], dim=1)           # [B, m + efc]
        valid = (cand >= 0) & (cand != u[:, None]) & (cand < n)
        cand = torch.where(valid, cand, -1)
        cvec = vec[cand.clamp_min(0)]
        dist = torch.where(valid, _sq_dists(cvec, vec[s:e]), torch.inf)
        out[s:e] = _prune(cand, dist, vec, cvec, cfg)
    return out


def build_flat_graph(vectors, cfg: BuildConfig | None = None, *,
                     device=None) -> torch.Tensor:
    """From-scratch single RNG graph over ``vectors`` (Oracle baseline,
    paper §5.2.4): int32[n, 1, m], layer 0 of the same bottom-up build."""
    tbl = build_neighbor_table(vectors, cfg, device=device)
    return tbl[:, :1, :].contiguous()
