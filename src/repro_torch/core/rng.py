"""Eager RNG-style edge pruning: the historical ``[C, C]`` oracle (port of
``repro/core/rng.py``).

Candidates for a node ``u`` are processed in ascending distance-to-``u``
order; candidate ``v`` is pruned iff some already-kept ``w`` satisfies
``alpha * delta(w, v) < delta(u, v)`` (squared L2, so ``alpha`` acts as
the square of DiskANN's alpha; ``alpha = 1`` is the paper's RNG rule).
The whole candidate-candidate matrix is computed first, then a C-step
keep-set scan runs over every node of the batch at once.

Kept as the bit-identical oracle and the build-path benchmark's baseline
(``impl="legacy"`` in ``kernels/ops.py::prune``,
``BuildConfig(prune_impl="legacy")``); builds dispatch to the lazy-column
prune (``kernels/ref.py::prune`` on the CPU, the CUDA kernel on the card).
"""
from __future__ import annotations

import math

import torch

__all__ = ["prune", "prune_batch", "prune_batch_cc", "pairwise_sq_dists"]

_BIG = 2**30


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """x[..., C, d] -> squared L2 distances [..., C, C], clamped at 0.

    Entry ``[i, j]`` is ``(‖x_j‖² − 2 x_j·x_i) + ‖x_i‖²``, with ``x_j·x_i``
    one batched matrix-vector product per column ``i``: the same operations
    in the same order as ``kernels/ref.py::prune_vecs`` computes the column
    of a keep ``i``, so the eager and the lazy prune compare equal values
    and keep equal ids, bit for bit.
    """
    x = x.float()
    lead = x.shape[:-2]
    C, d = x.shape[-2:]
    xb = x.reshape(math.prod(lead), C, d)
    xx = (xb * xb).sum(-1)                                 # [B, C]
    cols = [torch.einsum("bcd,bd->bc", xb, xb[:, i].contiguous())
            for i in range(C)]
    if cols:
        xy = torch.stack(cols, dim=1)                      # [B, i, j]
    else:
        xy = xb.new_zeros((xb.shape[0], 0, 0))
    out = (xx[:, None, :] - 2.0 * xy + xx[:, :, None]).clamp_min(0.0)
    return out.reshape(*lead, C, C)


def prune(cand_ids, cand_dists, cc_dists, *, m, alpha=1.0, fill=True):
    """Prune one node's candidate list to <= m RNG edges.

    cand_ids int32[C] (-1 invalid); cand_dists f32[C] squared distance to
    u (inf for invalid); cc_dists f32[C, C] squared candidate-candidate
    distances. ``fill`` fills the remaining slots with the nearest pruned
    candidates (HNSW's keepPrunedConnections). Returns int32[m], -1 padded.
    """
    return prune_batch_cc(cand_ids[None], cand_dists[None], cc_dists[None],
                          m=m, alpha=alpha, fill=fill)[0]


def prune_batch(cand_ids, cand_dists, cand_vecs, *, m, alpha=1.0,
                fill=True):
    """Batched prune: the ``[B, C, C]`` distances, then :func:`prune` on
    every row at once. cand_ids int32[B, C]; cand_dists f32[B, C];
    cand_vecs f32[B, C, d] -> int32[B, m]."""
    return prune_batch_cc(cand_ids, cand_dists, pairwise_sq_dists(cand_vecs),
                          m=m, alpha=alpha, fill=fill)


def prune_batch_cc(cand_ids, cand_dists, cc_dists, *, m, alpha=1.0,
                   fill=True):
    """:func:`prune` over a batch: cand_ids int32[B, C], cand_dists f32[B,
    C], cc_dists f32[B, C, C] -> int32[B, m]."""
    ids = cand_ids.to(torch.int32)
    du = cand_dists.float()
    cc = cc_dists.float()
    B, C = ids.shape
    dev = ids.device
    ar = torch.arange(C, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    # ascending distance, stable
    order = torch.argsort(du, dim=1, stable=True)
    ids = ids.gather(1, order)
    du = du.gather(1, order)
    cc = cc[rows[:, :, None], order[:, :, None], order[:, None, :]]
    valid = (ids >= 0) & torch.isfinite(du)
    # duplicate ids keep only their first occurrence
    ids_for_dup = torch.where(valid, ids, _BIG + ar.to(torch.int32))
    o2 = torch.argsort(ids_for_dup, dim=1, stable=True)
    srt = ids_for_dup.gather(1, o2)
    head = torch.ones((B, C), dtype=torch.bool, device=dev)
    head[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first = torch.zeros((B, C), dtype=torch.bool, device=dev)
    first.scatter_(1, o2, head)
    valid &= first

    keep = torch.zeros((B, C), dtype=torch.bool, device=dev)
    count = torch.zeros((B,), dtype=torch.int32, device=dev)
    for j in range(C):
        pruned = (keep & (alpha * cc[:, :, j] < du[:, j:j + 1])).any(dim=1)
        add = valid[:, j] & ~pruned & (count < m)
        keep[:, j] = add
        count += add.to(torch.int32)

    if fill:
        key = torch.where(valid, torch.where(keep, ar, C + ar), _BIG)
    else:
        key = torch.where(keep, ar, _BIG)
    kk = min(m, C)
    # top_k of -key: the kk least keys, least first (keys are distinct
    # below _BIG, and every _BIG slot maps to -1)
    kv, take = torch.sort(key, dim=1, stable=True)
    kv, take = kv[:, :kk], take[:, :kk]
    out = torch.where(kv < _BIG, ids.gather(1, take), -1).to(torch.int32)
    if kk < m:
        out = torch.cat([out, torch.full((B, m - kk), -1, dtype=torch.int32,
                                         device=dev)], dim=1)
    return out
