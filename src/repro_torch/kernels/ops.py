"""Backend dispatch for the port's kernels (``repro/kernels/ops.py:111-322``).

``impl`` tokens:

  * ``"cuda"``     — the hand-written Hopper kernel (``csrc/*.cu``); raises
                     on CPU tensors;
  * ``"torch"``    — the plain version (``kernels/ref.py``); allowed on CUDA
                     tensors, so a caller can compare the two on the card,
                     but never chosen there by ``"auto"``;
  * ``"auto"``     — by where the tensors live: CUDA -> ``"cuda"``,
                     CPU -> ``"torch"``;
  * ``"composed"`` — whole hop only: ``select_edges`` ->
                     ``bitset.test_and_set`` -> ``gather_dist``, each
                     dispatched, kept as the fused hop's bit-identical
                     oracle. An explicit ``edge_impl``/``dist_impl`` pin
                     routes any hop through it, as in the JAX package;
  * ``"legacy"``   — construction prune only: the eager ``[C, C]`` oracle
                     (``core/rng.py::prune_batch``) on rows decoded by
                     ``storage.decode_rows``, plain torch wherever the
                     tensors live; kept ids bit-identical to ``"torch"``.

``select_edges`` and ``hop``'s integer outputs are bit-identical across
backends; distances agree to f32 tolerance; ``prune``'s kept ids agree
except where a keep decision is a near tie (dot products summed in another
order). ``flash_attention`` agrees to f32 tolerance (the output rounded
once to q's dtype), except on a row that sees no key (kernel 0, plain
version the mean of V).

Vector tables may be stored in any codec (``core/storage.py``):
``gather_dist``, ``hop`` and ``prune`` launch the kernel of the table's
layout (f32, bf16, f16, int8, PQ), or raise. ``pairwise_dist`` takes dense
f32, bf16 or f16 rows, as the TPU kernel does.

:func:`launch_counts` / :func:`reset_launch_counts` read and zero the
kernel wrappers' launch counters (plain integers on each wrapper, raised
once per launch and nowhere else); :func:`layout_counts` reads the
per-layout counts of ``gather_dist``, ``hop`` and ``prune``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset as _bitset
from repro_torch.core import rng as _rng
from repro_torch.core import storage as _storage
from repro_torch.kernels import distance as _distance
from repro_torch.kernels import edge_select as _edge_select
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gather_distance as _gather
from repro_torch.kernels import hop as _hop
from repro_torch.kernels import prune as _prune
from repro_torch.kernels import ref as _ref

__all__ = [
    "pairwise_dist", "gather_dist", "select_edges", "prune", "hop",
    "flash_attention", "resolve_impl", "launch_counts",
    "reset_launch_counts", "layout_counts", "KERNELS",
]

# kernel name -> its wrapper (each holds a ``launches`` counter)
KERNELS = {
    "pairwise_dist": _distance.pairwise_dist_cuda,
    "gather_dist": _gather.gather_dist_cuda,
    "select_edges": _edge_select.select_edges_cuda,
    "hop": _hop.hop_cuda,
    "prune": _prune.prune_cuda,
    "flash_attention": _flash.flash_attention_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def layout_counts() -> dict[str, int]:
    """Launches per stored layout, as ``"gather_dist[int8]"`` -> count."""
    return {f"{name}[{lay}]": c for name, fn in KERNELS.items()
            for lay, c in getattr(fn, "layout_launches", {}).items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "layout_launches"):
            fn.layout_launches = dict.fromkeys(fn.layout_launches, 0)


def resolve_impl(op: str, impl: str, on: torch.Tensor,
                 allowed=("auto", "cuda", "torch")) -> str:
    """Resolve ``impl`` for tensors living where ``on`` does; reject
    unknown tokens and ``"cuda"`` on CPU tensors."""
    if impl not in allowed:
        raise ValueError(
            f"{op}: unknown impl {impl!r} (expected one of {list(allowed)})"
        )
    if impl == "auto":
        return "cuda" if on.is_cuda else "torch"
    if impl == "cuda" and not on.is_cuda:
        raise RuntimeError(
            f"{op}: impl='cuda' needs CUDA tensors, got {on.device}"
        )
    return impl


def pairwise_dist(q, x, *, metric="l2", impl="auto"):
    """All-pairs distance: q [Bq, D], x [N, D] (f32, bf16 or f16) ->
    f32[Bq, N]; l2 squared or ip negated."""
    if resolve_impl("pairwise_dist", impl, q) == "torch":
        return _ref.pairwise_dist(q, x, metric=metric)
    return _distance.pairwise_dist_cuda(q, x, metric=metric)


def gather_dist(q, table, ids, *, metric="l2", impl="auto"):
    """Fused gather + masked distance: q f32[B, d], table [n, d] in any
    stored layout or a codec struct, ids int32[B, M] (-1 masked) ->
    f32[B, M]."""
    if resolve_impl("gather_dist", impl, q) == "torch":
        return _ref.gather_dist(q, table, ids, metric=metric)
    return _gather.gather_dist_cuda(q, table, ids, metric=metric)


def select_edges(nbrs, us, L, R, *, logn, m_out, skip_layers=True,
                 impl="auto"):
    """Edge improvisation (Algorithm 1) for a flat [F] frontier ->
    int32[F, m_out], bit-identical across backends."""
    nbrs = _storage.decode_neighbors(nbrs)
    if resolve_impl("select_edges", impl, us) == "torch":
        return _ref.select_edges(nbrs, us, L, R, logn=logn, m_out=m_out,
                                 skip_layers=skip_layers)
    return _edge_select.select_edges_cuda(
        nbrs, us, L, R, logn=logn, m_out=m_out, skip_layers=skip_layers)


def prune(cand_ids, cand_dists, table, *, m, alpha=1.0, fill=True,
          impl="auto", cand_vecs=None):
    """Construction prune -> int32[B, m] kept ids.

    ``table`` [n, d] in any stored layout. ``cand_vecs`` [B, C, d]: the
    already-gathered candidate rows, which the plain and legacy versions
    reuse (gathers are exact, so results are the same); the kernel gathers
    and decodes its rows from ``table`` itself.
    """
    impl = resolve_impl("prune", impl, cand_ids,
                        allowed=("auto", "cuda", "torch", "legacy"))
    if impl == "legacy":
        if cand_vecs is None:
            cand_vecs = _storage.decode_rows(table, cand_ids.clamp(
                0, _storage.table_n(table) - 1).long())
        return _rng.prune_batch(cand_ids, cand_dists, cand_vecs, m=m,
                                alpha=alpha, fill=fill)
    if impl == "torch":
        if cand_vecs is not None:
            return _ref.prune_vecs(cand_ids, cand_dists, cand_vecs, m=m,
                                   alpha=alpha, fill=fill)
        return _ref.prune(cand_ids, cand_dists, table, m=m, alpha=alpha,
                          fill=fill)
    return _prune.prune_cuda(cand_ids, cand_dists, table, m=m, alpha=alpha,
                             fill=fill)


def hop(q, table, nbrs, u, L, R, visited, exp_ok, *, logn, m_out,
        skip_layers=True, metric="l2", impl="auto", edge_impl="auto",
        dist_impl="auto"):
    """One whole beam-search hop: edge improvisation + visited test-and-set
    + gather-distance.

    Shapes: q f32[B, d], table [n, d] or a codec struct, nbrs [n, layers,
    m] or ``SplitNeighbors`` (widened once here), u int32[B,
    W], L/R int32[B*W], visited int32[B, words] (updated IN PLACE),
    exp_ok bool[B, W] -> (nbr int32[B, W*m_out], ndist f32[B, W*m_out],
    nvalid bool[B, W*m_out], visited).
    """
    impl = resolve_impl("hop", impl, q,
                        allowed=("auto", "cuda", "torch", "composed"))
    if edge_impl != "auto" or dist_impl != "auto":
        # the fused paths have no per-op backends: a pin routes the hop
        # through the composed oracle
        impl = "composed"
    nbrs = _storage.decode_neighbors(nbrs)
    if impl == "composed":
        B, W = u.shape
        nbr = select_edges(
            nbrs, u.reshape(B * W), L, R, logn=logn, m_out=m_out,
            skip_layers=skip_layers, impl=edge_impl,
        ).reshape(B, W * m_out)
        pre_valid = (nbr >= 0) & exp_ok.repeat_interleave(m_out, dim=1)
        visited, seen = _bitset.test_and_set(visited, nbr, pre_valid)
        nvalid = pre_valid & ~seen
        ndist = gather_dist(q, table, torch.where(nvalid, nbr, -1),
                            metric=metric, impl=dist_impl)
        return nbr, ndist, nvalid, visited
    if impl == "torch":
        return _ref.hop(q, table, nbrs, u, L, R, visited, exp_ok, logn=logn,
                        m_out=m_out, skip_layers=skip_layers, metric=metric)
    return _hop.hop_cuda(q, table, nbrs, u, L, R, visited, exp_ok, logn=logn,
                         m_out=m_out, skip_layers=skip_layers, metric=metric)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, q_offset=0, impl="auto"):
    """Blockwise attention: q [B, Hq, Sq, Dh], k / v [B, Hkv, Skv, Dh]
    (``Hq % Hkv == 0``) -> [B, Hq, Sq, Dh] in q's dtype, f32 inside.
    ``window`` (query i sees keys j with ``i - window < j``) must be None
    or >= 1."""
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if resolve_impl("flash_attention", impl, q) == "torch":
        return _ref.attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale,
                              q_offset=q_offset)
    return _flash.flash_attention_cuda(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        q_offset=q_offset)
