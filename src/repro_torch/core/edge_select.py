"""The argsort formulation of edge selection and the literal Algorithm 1:
the port's oracles of ``ops.select_edges`` (``repro/core/edge_select.py``).

Given the packed elemental-graph table ``nbrs[n, layers, m]`` (-1
padding), select for object ``u`` up to ``m_out`` out-edges of the graph
improvised for the query range ``[L, R]``: the layers are scanned top-down
(upper layers first), a layer whose child segment meets the range exactly
as it does is skipped (``skip_layers``), the scan ends at the first segment
the range covers, and only in-range neighbours other than ``u`` are kept,
each at its first (highest-priority) occurrence.

:func:`select_edges` and :func:`select_edges_batch` are ``repro``'s
argsort formulation: a gather of every candidate edge, the closed-form scan
mask (``segment_tree.scan_mask``), one stable sort that suppresses
duplicates, then the ``m_out`` smallest priorities. They run wherever the
tensors live; ``ops.select_edges(impl="argsort")`` dispatches to the batch
form. :func:`select_edges_reference` is Algorithm 1 written out one object
at a time in Python. All three return the ids of the sort-free plain
version and of the CUDA kernel, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import segment_tree

__all__ = ["select_edges", "select_edges_batch", "select_edges_reference"]

_BIG = 2**30


def _select_rows(flat, us, L, R, *, logn, m, m_out, skip_layers):
    """Argsort selection over gathered rows ``flat`` int32[F, layers*m] of
    objects ``us`` int32[F] (>= 0) for ranges L, R int32[F] ->
    int32[F, m_out]."""
    F, K = flat.shape
    dev = flat.device
    mask = segment_tree.scan_mask(us, L, R, logn, skip_layers=skip_layers)
    lay_of = torch.arange(K, device=dev) // m
    valid = ((flat >= 0) & (flat >= L[:, None]) & (flat <= R[:, None])
             & mask[:, lay_of] & (flat != us[:, None]))
    # priority: earlier (upper) layer first, then slot order
    pos = torch.arange(K, dtype=torch.int32, device=dev)
    prio = torch.where(valid, pos[None, :], _BIG)
    # one stable sort on (id, invalid -> BIG) keeps equal ids in priority
    # order; an entry equal to its predecessor's key is a duplicate
    key, order = torch.sort(torch.where(valid, flat, _BIG), dim=1,
                            stable=True)
    prio_i = prio.gather(1, order)
    ids_i = flat.gather(1, order)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = key[:, 1:] == key[:, :-1]
    prio_i = torch.where(dup, _BIG, prio_i)
    # the m_out smallest priorities, lower index first among equals
    take = torch.sort(prio_i, dim=1, stable=True)[1][:, :m_out]
    out = torch.where(prio_i.gather(1, take) == _BIG, -1,
                      ids_i.gather(1, take))
    if out.shape[1] < m_out:  # fewer candidate slots than m_out
        out = torch.cat([out, out.new_full((F, m_out - out.shape[1]), -1)],
                        dim=1)
    return out.to(torch.int32)


def select_edges(nbrs_u, u, L, R, *, logn, m_out, skip_layers=True):
    """Select edges for one object: ``nbrs_u`` int[layers, m] (its packed
    rows; int16 widens), ``u``, ``L``, ``R`` ints or 0-d tensors ->
    int32[m_out], -1 padded."""
    layers, m = nbrs_u.shape
    dev = nbrs_u.device
    one = lambda x: torch.as_tensor(x, dtype=torch.int32,  # noqa: E731
                                    device=dev).reshape(1)
    flat = nbrs_u.reshape(1, layers * m).to(torch.int32)
    return _select_rows(flat, one(u), one(L), one(R), logn=logn, m=m,
                        m_out=m_out, skip_layers=skip_layers)[0]


def select_edges_batch(nbrs, us, L, R, *, logn, m_out, skip_layers=True):
    """:func:`select_edges` over a batch: ``nbrs`` [n, layers, m] (int32 or
    int16), ``us`` int32[F] (-1 inactive), ``L``/``R`` ints or int32[F] ->
    int32[F, m_out]."""
    n, layers, m = nbrs.shape
    F = us.shape[0]
    dev = us.device
    us = us.to(torch.int32)
    us_safe = us.clamp(0, n - 1)
    L = torch.as_tensor(L, dtype=torch.int32, device=dev).broadcast_to((F,))
    R = torch.as_tensor(R, dtype=torch.int32, device=dev).broadcast_to((F,))
    flat = nbrs[us_safe.long()].reshape(F, layers * m).to(torch.int32)
    out = _select_rows(flat, us_safe, L, R, logn=logn, m=m, m_out=m_out,
                       skip_layers=skip_layers)
    return torch.where(us[:, None] < 0, -1, out)


def select_edges_reference(nbrs_u, u, L, R, *, logn, m_out,
                           skip_layers=True):
    """Algorithm 1, literally, for one object: ``nbrs_u`` [layers, m] (a
    tensor, an array or nested lists) -> a Python list of at most
    ``m_out`` ids."""
    rows = nbrs_u.tolist() if hasattr(nbrs_u, "tolist") else nbrs_u
    u, L, R = int(u), int(L), int(R)
    lo, hi = 0, (1 << logn) - 1
    lay = 0
    S: list[int] = []
    seen = set()
    while len(S) < m_out:
        if lay < logn:
            mid = (lo + hi) // 2
            if u <= mid:
                lc, rc = lo, mid
            else:
                lc, rc = mid + 1, hi
            same = (
                max(lc, L) == max(lo, L) and min(rc, R) == min(hi, R)
            )
            if skip_layers and same and not (lo >= L and hi <= R):
                lo, hi, lay = lc, rc, lay + 1
                continue
        for v in rows[lay]:
            v = int(v)
            if v >= 0 and L <= v <= R and v != u and v not in seen:
                seen.add(v)
                S.append(v)
        S = S[:m_out]
        if lo >= L and hi <= R:
            break
        if lay >= logn:
            break
        mid = (lo + hi) // 2
        if u <= mid:
            lo, hi = lo, mid
        else:
            lo, hi = mid + 1, hi
        lay += 1
    return S
