"""Plain torch versions of the port's kernels (the correctness contract).

Each function is the port of its ``repro/kernels/ref.py`` counterpart and
runs on any device: the CPU tests use it, the dispatch in ``ops.py`` takes
it for CPU tensors, and ``chip_smoke.py`` holds every CUDA kernel against
it on the card. Vector tables are f32/bf16/f16 ``[n, d]`` or a codec struct
(``Int8Vectors``, ``PQVectors``); rows decode to f32 through
``storage.decode_rows``, as ``repro/kernels/ref.py:56, :233`` do. That is
the contract the CUDA kernels' in-register decode is held against.

Layouts follow the JAX package's public functions so tests compare like
with like; ``visited`` bitsets are int32 words with the uint32 bit pattern
(``core/bitset.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset as _bitset
from repro_torch.core import segment_tree
from repro_torch.core import storage as _storage

__all__ = [
    "gather_dist", "edge_scan_valid", "select_edges", "hop", "prune",
    "prune_vecs", "attention",
]

_BIG = 2**30
_IMIN = -(2**31)


def _rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Gather and decode rows at non-negative ``ids`` (clamped into the
    table, as a JAX gather clamps) as f32."""
    return _storage.decode_rows(
        table, ids.clamp(0, _storage.table_n(table) - 1).long())


def gather_dist(q, table, ids, metric="l2"):
    """q[B, d], table[n, d] or a codec struct, ids int32[B, M] (-1 masked)
    -> f32[B, M].

    l2: ``‖x‖² − 2x·q + ‖q‖²``; ip: ``−x·q``; ``+inf`` where ids < 0
    (``repro/kernels/ref.py:43``).
    """
    q = q.float()
    x = _rows(table, ids)                                  # [B, M, d]
    if metric == "l2":
        xx = (x * x).sum(-1)
        qq = (q * q).sum(-1, keepdim=True)
        xq = torch.einsum("bd,bmd->bm", q, x)
        d = xx - 2.0 * xq + qq
    elif metric == "ip":
        d = -torch.einsum("bd,bmd->bm", q, x)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids < 0, torch.inf, d)


def edge_scan_valid(flat, us, L, R, lay, *, logn, skip_layers=True):
    """Candidate validity of Algorithm 1, closed form per flat position
    (``repro/kernels/ref.py:69``).

    flat int32[.., K] gathered candidate edges; us/L/R int32[.., 1]; lay
    int32[.., K] (broadcastable) layer of each flat position -> bool[.., K].
    """
    layers = logn + 1
    u = us.clamp_min(0)
    lo, hi = segment_tree.seg_bounds(u, lay, logn)
    terminal = (lo >= L) & (hi <= R)
    # first fully-covered layer; an all-False row degrades to layer 0 only
    ft = torch.where(terminal, lay, layers).amin(dim=-1, keepdim=True)
    ft = torch.where(ft == layers, 0, ft)
    mask = lay <= ft
    if skip_layers:
        lo2, hi2 = segment_tree.seg_bounds(u, (lay + 1).clamp_max(logn), logn)
        skip = (
            (torch.maximum(lo2, L) == torch.maximum(lo, L))
            & (torch.minimum(hi2, R) == torch.minimum(hi, R))
            & (lay < logn)
        )
        mask = mask & ~skip
    return (
        (flat >= 0) & (flat >= L) & (flat <= R) & mask
        & (flat != u) & (us >= 0)
    )


def select_edges(nbrs, us, L, R, *, logn, m_out, skip_layers=True):
    """Sort-free edge improvisation (paper Algorithm 1) for a flat frontier
    (``repro/kernels/ref.py:107``).

    ``nbrs`` int32[n, layers, m]; ``us`` int32[F] frontier ids (-1
    inactive); ``L``/``R`` ints or int32[F] inclusive rank ranges. Returns
    int32[F, m_out]: ``m_out`` masked-argmin steps over the flat position,
    each wiping every position holding the id it selected (lazy dedup).
    """
    n, layers, m = nbrs.shape
    K = layers * m
    F = us.shape[0]
    dev = us.device
    us = us.to(torch.int32)
    L = torch.as_tensor(L, dtype=torch.int32, device=dev).broadcast_to(
        us.shape)[:, None]
    R = torch.as_tensor(R, dtype=torch.int32, device=dev).broadcast_to(
        us.shape)[:, None]
    us = us[:, None]                                       # [F, 1]
    flat = nbrs[us[:, 0].clamp(0, n - 1)].reshape(F, K).to(torch.int32)
    lay = torch.div(torch.arange(K, dtype=torch.int32, device=dev), m,
                    rounding_mode="floor")[None, :]        # [1, K]
    valid = edge_scan_valid(flat, us, L, R, lay, logn=logn,
                            skip_layers=skip_layers)

    # priority == flat position (upper layer first, then slot order)
    pos = torch.arange(K, dtype=torch.int32, device=dev)
    p = torch.where(valid, pos[None, :], _BIG)
    outs = []
    for _ in range(m_out):
        pmin = p.amin(dim=1)                               # [F]
        sel = p == pmin[:, None]                           # one hit unless BIG
        idt = torch.where(sel, flat, _IMIN).amax(dim=1)
        out_t = torch.where(pmin < _BIG, idt, -1)
        taken = (flat == out_t[:, None]) & (p < _BIG)      # all dups of idt
        p = torch.where(sel | taken, _BIG, p)
        outs.append(out_t)
    if not outs:
        return torch.empty((F, 0), dtype=torch.int32, device=dev)
    return torch.stack(outs, dim=1).to(torch.int32)        # [F, m_out]


def hop(q, table, nbrs, u, L, R, visited, exp_ok, *, logn, m_out,
        skip_layers=True, metric="l2"):
    """One whole beam-search hop (``repro/kernels/ref.py:167``): edge
    improvisation for the flattened ``[B*W]`` frontier, the visited
    test-and-set, and the masked gather-distance of the newly visited ids.

    q f32[B, d]; table [n, d] or a codec struct; nbrs int32[n, layers, m];
    u int32[B, W]
    (-1 inactive); L/R int32[B*W]; visited int32[B, words], updated IN
    PLACE; exp_ok bool[B, W].

    Returns ``(nbr int32[B, W*m_out], ndist f32[B, W*m_out],
    nvalid bool[B, W*m_out], visited)``.
    """
    B, W = u.shape
    nbr = select_edges(
        nbrs, u.reshape(B * W), L, R, logn=logn, m_out=m_out,
        skip_layers=skip_layers,
    ).reshape(B, W * m_out)
    exp_rep = exp_ok.repeat_interleave(m_out, dim=1)       # [B, W*m_out]
    pre_valid = (nbr >= 0) & exp_rep
    visited, seen = _bitset.test_and_set(visited, nbr, pre_valid)
    nvalid = pre_valid & ~seen
    ndist = gather_dist(q, table, torch.where(nvalid, nbr, -1), metric=metric)
    return nbr, ndist, nvalid, visited


def prune(cand_ids, cand_dists, table, *, m, alpha=1.0, fill=True):
    """Lazy-column RNG prune (paper Def. 2.1) for a chunk of build nodes
    (``repro/kernels/ref.py:207``).

    ``cand_ids`` int32[B, C] (-1 invalid); ``cand_dists`` f32[B, C] squared
    distance to each node (inf for invalid slots); ``table`` [n, d] or a
    codec struct, decoded per row.
    Returns int32[B, m] kept ids, -1 padded.
    """
    return prune_vecs(cand_ids, cand_dists, _rows(table, cand_ids), m=m,
                      alpha=alpha, fill=fill)


def prune_vecs(cand_ids, cand_dists, cand_vecs, *, m, alpha=1.0, fill=True):
    """``prune`` for callers that already gathered ``cand_vecs`` [B, C, d].

    The batched form of ``_prune_row`` (``repro/kernels/ref.py:250``):
    first-occurrence dedup in (du, position) order, then at most ``m``
    sweeps selecting the live candidate with the least (class, du,
    position) — class 0 unsuppressed, class 1 the HNSW fill — where each
    keep suppresses every candidate with ``alpha * cc < du``, ``cc`` its
    column ``max(xx - 2 x.x_p + xx_p, 0)``.
    """
    ids = cand_ids.to(torch.int32)
    du = cand_dists.float()
    vecs = cand_vecs.float()
    B, C = ids.shape
    dev = ids.device
    pos = torch.arange(C, dtype=torch.int32, device=dev)
    valid = (ids >= 0) & torch.isfinite(du)
    # first-occurrence dedup in (du, position) order: dup[b, j] <=> some
    # valid i with the same id precedes j
    same = ids[:, :, None] == ids[:, None, :]
    earlier = (du[:, :, None] < du[:, None, :]) | (
        (du[:, :, None] == du[:, None, :]) & (pos[:, None] < pos[None, :])
    )
    dup = (same & earlier & valid[:, :, None] & valid[:, None, :]).any(dim=1)
    valid = valid & ~dup
    xx = (vecs * vecs).sum(-1)                             # [B, C]

    supp = torch.zeros_like(valid)
    taken = torch.zeros_like(valid)
    rows = torch.arange(B, device=dev)
    outs = []
    for _ in range(m):
        avail = valid & ~taken
        keepable = avail & ~supp
        fillable = (avail & supp) if fill else torch.zeros_like(avail)
        cls = torch.where(keepable, 0, torch.where(fillable, 1, 2))
        cmin = cls.amin(dim=1, keepdim=True)
        cand = (cls == cmin) & (cmin < 2)
        dmask = torch.where(cand, du, torch.inf)
        dmin = dmask.amin(dim=1, keepdim=True)
        p = torch.where(cand & (dmask == dmin), pos, _BIG).amin(dim=1)
        has = cmin[:, 0] < 2
        p_safe = torch.where(has, p, 0).long()
        out_t = torch.where(has, ids[rows, p_safe], -1)
        # the selected keep's cc column, computed lazily (same expansion)
        xy = torch.einsum("bcd,bd->bc", vecs, vecs[rows, p_safe])
        cc = (xx - 2.0 * xy + xx[rows, p_safe][:, None]).clamp_min(0.0)
        is_keep = has & (cmin[:, 0] == 0)
        supp = supp | (is_keep[:, None] & (alpha * cc < du))
        taken = taken | (pos[None, :] == p[:, None])
        outs.append(out_t)
    if not outs:
        return torch.empty((B, 0), dtype=torch.int32, device=dev)
    return torch.stack(outs, dim=1).to(torch.int32)


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, q_offset=0, block_q=None):
    """Multi-head attention with GQA, a sliding window and a logit softcap
    (``repro/kernels/ref.py:294``), in f32, returned in q's dtype.

    q [B, Hq, Sq, Dh]; k, v [B, Hkv, Skv, Dh] with ``Hq % Hkv == 0``;
    ``window``: query i sees keys j with ``i - window < j``; ``softcap``:
    ``cap * tanh(s / cap)``; ``q_offset``: absolute position of query row
    0. ``block_q`` evaluates the queries in chunks of that many rows
    (``O(block_q * Skv)`` live scores), on by itself (512) from Sq = 2048.
    A row that sees no key gets the mean of V (an additive -1e30 mask), as
    the reference does; the kernel gives 0 there.
    """
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    if block_q is None and Sq >= 2048:
        block_q = 512
    if block_q and Sq > block_q and Sq % block_q == 0:
        out = torch.cat([
            _attn_chunk(q[:, :, s:s + block_q], k, v, g, scale, causal,
                        window, softcap, q_offset + s, Skv)
            for s in range(0, Sq, block_q)], dim=2)
        return out.to(q.dtype)
    return _attn_chunk(q, k, v, g, scale, causal, window, softcap, q_offset,
                       Skv).to(q.dtype)


def _attn_chunk(q, k, v, g, scale, causal, window, softcap, q_offset, Skv):
    """One query block against the full K/V (``repro/kernels/ref.py:339``)."""
    Sq = q.shape[2]
    dev = q.device
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores + torch.where(mask, 0.0, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores - m)
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", probs / denom, vf)
