"""The plain reference: exact in-range top-k by brute force, in plain torch.

It imports nothing of the program. It works from the data and the pool
that ``gen.py`` made: it maps each request's value bounds to ranks with its
own sort of the attributes, and scores every in-range object.

``exact_topk`` picks candidates with an f32 product (TF32 off), then scores
them again in f64 and keeps a query's answer only where the f32 pick
provably holds the true top-k; a query where it may not is scored whole in
f64. ``tf32_topk`` is the control: the same search in the precision one
step below the deployment's f32, with its own distances as the answer.
"""
from __future__ import annotations

import torch

# rows of queries scored at once: [BLOCK, n] f32 of distances
BLOCK = 256
# candidates the f32 pass keeps before the f64 rescoring
CAND = 32


def value_ranks(sorted_attrs, lo, hi):
    """Inclusive rank range of the objects whose attribute lies in
    [lo, hi] (empty when R < L)."""
    L = torch.searchsorted(sorted_attrs, lo, right=False)
    R = torch.searchsorted(sorted_attrs, hi, right=True) - 1
    return L, R


def true_dists(x, q, ids):
    """Squared l2 distances in f64 of rows ``ids`` [B, k] (valid ids only;
    others may hold anything) to their queries ``q`` [B, d], with the
    scale ``|q|^2 + |x|^2`` an f32 expansion of them would err against."""
    n = x.shape[0]
    rows = x[ids.clamp(0, n - 1)].double()            # [B, k, d]
    qd = q.double()[:, None, :]
    d = ((rows - qd) ** 2).sum(-1)
    scale = (rows ** 2).sum(-1) + (qd ** 2).sum(-1)
    return d, scale


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10-bit mantissa, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _in_range_dists(x, xx, q, L, R, rank_of, tf32):
    """[B, n] squared distances by expansion, inf outside [L, R]; with
    ``tf32`` the product's inputs are rounded to TF32 first."""
    qq = (q * q).sum(1, keepdim=True)
    if tf32:
        x, q = to_tf32(x), to_tf32(q)
    d = qq + xx[None, :] - 2.0 * (q @ x.T)
    ok = (rank_of[None, :] >= L[:, None]) & (rank_of[None, :] <= R[:, None])
    return torch.where(ok, d, torch.inf)


def _matmul_f32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return prev


def _restore(prev):
    torch.backends.cuda.matmul.allow_tf32 = prev[0]
    torch.set_float32_matmul_precision(prev[1])


def exact_topk(data, pool, k: int):
    """The exact in-range top-k of every pool request.

    Returns (ids int64 [P, k] original ids, -1 past the range's size;
    dists f64 [P, k]; size int64 [P], objects in range)."""
    x, rank_of = data.vectors, data.rank_of
    n = x.shape[0]
    L, R = value_ranks(data.sorted_attrs, pool.lo, pool.hi)
    size = (R - L + 1).clamp_min(0)
    P = pool.q.shape[0]
    dev = x.device
    out_ids = torch.full((P, k), -1, dtype=torch.int64, device=dev)
    out_d = torch.full((P, k), torch.inf, dtype=torch.float64, device=dev)
    xx = (x * x).sum(1)
    xx_max = float(xx.max())
    c = min(CAND, n)
    prev = _matmul_f32()
    try:
        for s in range(0, P, BLOCK):
            e = min(P, s + BLOCK)
            q = pool.q[s:e]
            d32 = _in_range_dists(x, xx, q, L[s:e], R[s:e], rank_of, False)
            dc, cand = torch.topk(d32, c, dim=1, largest=False, sorted=True)
            del d32
            exact, _ = true_dists(x, q, cand)
            exact = torch.where(torch.isfinite(dc), exact, torch.inf)
            dk, pos = torch.sort(exact, dim=1, stable=True)
            ids = cand.gather(1, pos)[:, :k]
            dk = dk[:, :k]
            # the f32 pick holds the true top-k when every object it left
            # out is farther in f32 than the k-th is truly, past the f32
            # expansion's error (a few ulps of |q|^2 + |x|^2, taken 100x)
            err = 1e-5 * ((q.double() ** 2).sum(1) + xx_max)
            sure = (size[s:e] <= c) | (dc[:, -1].double() - err > dk[:, -1])
            for j in (~sure).nonzero().flatten().tolist():
                ids[j], dk[j] = _exact_one(x, q[j], L[s + j], R[s + j],
                                           rank_of, k)
            ids = torch.where(torch.isfinite(dk), ids, -1)
            out_ids[s:e], out_d[s:e] = ids, dk
    finally:
        _restore(prev)
    return out_ids, out_d, size


def _exact_one(x, q, L, R, rank_of, k):
    ok = (rank_of >= L) & (rank_of <= R)
    d = ((x.double() - q.double()) ** 2).sum(1)
    d = torch.where(ok, d, torch.inf)
    kk = min(k, d.shape[0])
    dk, ids = torch.topk(d, kk, largest=False, sorted=True)
    out_i = torch.full((k,), -1, dtype=torch.int64, device=x.device)
    out_d = torch.full((k,), torch.inf, dtype=torch.float64, device=x.device)
    out_i[:kk], out_d[:kk] = ids, dk
    return out_i, out_d


def tf32_topk(data, pool, k: int):
    """The control: the in-range top-k with the product in TF32 (inputs
    rounded to TF32, summed in f32), answering with its own distances.
    Returns (ids int64 [P, k], dists f32 [P, k])."""
    x, rank_of = data.vectors, data.rank_of
    L, R = value_ranks(data.sorted_attrs, pool.lo, pool.hi)
    P = pool.q.shape[0]
    xx = (x * x).sum(1)
    ids_out, d_out = [], []
    prev = _matmul_f32()
    try:
        for s in range(0, P, BLOCK):
            e = min(P, s + BLOCK)
            d = _in_range_dists(x, xx, pool.q[s:e], L[s:e], R[s:e], rank_of,
                                True)
            dk, ids = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False,
                                 sorted=True)
            ids_out.append(torch.where(torch.isfinite(dk), ids, -1))
            d_out.append(dk)
    finally:
        _restore(prev)
    return torch.cat(ids_out), torch.cat(d_out)
