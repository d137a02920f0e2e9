"""Backend dispatch for the port's kernels (``repro/kernels/ops.py:111-322``).

``impl`` tokens:

  * ``"cuda"``     — the hand-written Hopper kernel (``csrc/*.cu``); raises
                     on CPU tensors, never falling back to ``"torch"``;
  * ``"torch"``    — the plain version (``kernels/ref.py``); allowed on CUDA
                     tensors, so a caller can compare the two on the card,
                     but never chosen there by ``"auto"``;
  * ``"auto"``     — :func:`default_impl`: ``RTORCH_<KIND>_IMPL``, then
                     ``RTORCH_IMPL`` (``core/knobs.py``), then where the
                     tensors live: CUDA -> ``"cuda"``, CPU -> ``"torch"``;
  * ``"composed"`` — whole hop only: ``select_edges`` ->
                     ``bitset.test_and_set`` -> ``gather_dist``, each
                     dispatched, kept as the fused hop's bit-identical
                     oracle. An explicit ``edge_impl``/``dist_impl`` pin
                     routes any hop through it, as in the JAX package;
  * ``"legacy"``   — construction prune only: the eager ``[C, C]`` oracle
                     (``core/rng.py::prune_batch``) on rows decoded by
                     ``storage.decode_rows``, plain torch wherever the
                     tensors live; kept ids bit-identical to ``"torch"``;
  * ``"argsort"``  — edge selection only: the argsort formulation
                     (``core/edge_select.py::select_edges_batch``), an
                     oracle wherever the tensors live.

A token that belongs to one op only raises in the others, even through
the global knob. The hop resolves as ``repro``'s does
(:func:`resolve_hop`): ``RTORCH_IMPL`` turns its ``auto`` into
``"composed"`` (``"legacy"`` too, the inner ops then on the device's own
rule), so only ``RTORCH_HOP_IMPL`` or ``auto`` on the card launches the
fused kernel.

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

Launch plans: ``gather_dist``, ``hop`` and ``prune`` take keyword
overrides of their kernels' plans (``split``; ``warps``; ``regime``,
``staged``, ``warps``) and merge the autotuner's installed pick for the
call's shape underneath them (``kernels/autotune.py::get_pick``), as
``repro``'s Pallas branches merge theirs. With no pick installed and no
override, every plan is the fixed rule of ``gather_distance.plan`` and
``prune.smem_plan``. The plain versions ignore them.

:func:`launch_counts` / :func:`reset_launch_counts` read and zero the
kernel wrappers' launch counters (plain integers on each wrapper, raised
once per launch and nowhere else); :func:`layout_counts` reads the
per-layout counts of ``gather_dist``, ``hop`` and ``prune``,
:func:`body_counts` the per-body counts of ``flash_attention``
(``"wgmma"``, ``"tf32x3"``) and ``pairwise_dist`` (``"tf32x3"``,
``"wgmma"``), and :func:`loader_counts` the per-loader counts of
``flash_attention`` (``"tma"``, ``"cp.async"``).
``prune_cuda.regime_launches`` counts the prune's launches per regime
(``prune.REGIMES``: ``"block"``, ``"table"``, ``"partial"``), and
:func:`reset_launch_counts` zeroes it too.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset as _bitset
from repro_torch.core import edge_select as _argsort
from repro_torch.core import knobs as _knobs
from repro_torch.core import rng as _rng
from repro_torch.core import storage as _storage
from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import distance as _distance
from repro_torch.kernels import edge_select as _edge_select
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gather_distance as _gather
from repro_torch.kernels import hop as _hop
from repro_torch.kernels import prune as _prune
from repro_torch.kernels import ref as _ref
from repro_torch.sharding import partitioning as _part

__all__ = [
    "pairwise_dist", "gather_dist", "select_edges", "prune", "hop",
    "flash_attention", "default_impl", "resolve_impl", "resolve_hop",
    "launch_counts", "reset_launch_counts", "layout_counts", "body_counts",
    "loader_counts", "KERNELS",
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
# calls that ran an op on each rank's shards through ``local_map`` (a
# count of calls, not of launches)
MESH_CALLS = {"flash_attention": 0}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def layout_counts() -> dict[str, int]:
    """Launches per stored layout, as ``"gather_dist[int8]"`` -> count."""
    return {f"{name}[{lay}]": c for name, fn in KERNELS.items()
            for lay, c in getattr(fn, "layout_launches", {}).items()}


def body_counts() -> dict[str, int]:
    """Launches per kernel body, as ``"flash_attention[wgmma]"`` -> count."""
    return {f"{name}[{body}]": c for name, fn in KERNELS.items()
            for body, c in getattr(fn, "body_launches", {}).items()}


def loader_counts() -> dict[str, int]:
    """Launches per loader, as ``"flash_attention[cp.async]"`` -> count."""
    return {f"{name}[{how}]": c for name, fn in KERNELS.items()
            for how, c in getattr(fn, "loader_launches", {}).items()}


def reset_launch_counts() -> None:
    MESH_CALLS.update(dict.fromkeys(MESH_CALLS, 0))
    for fn in KERNELS.values():
        fn.launches = 0
        for attr in ("layout_launches", "body_launches", "loader_launches",
                     "regime_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, dict.fromkeys(getattr(fn, attr), 0))


def _device_auto(on) -> str:
    return "cuda" if on is not None and on.is_cuda else "torch"


def default_impl(kind: str | None = None, on=None) -> str:
    """The backend of an ``"auto"`` dispatch of ``kind`` ("dist" | "edge" |
    "prune" | "hop" | "flash"): ``RTORCH_<KIND>_IMPL``, then the global
    ``RTORCH_IMPL``, then the device's rule for tensors living where
    ``on`` does (``"cuda"`` on CUDA, else ``"torch"``). An empty knob is
    unset."""
    if kind:
        forced = _knobs.get_str(f"RTORCH_{kind.upper()}_IMPL")
        if forced:
            return forced
    forced = _knobs.get_str("RTORCH_IMPL")
    if forced:
        return forced
    return _device_auto(on)


def _check_impl(op: str, impl: str, on, allowed) -> None:
    """Reject unknown tokens (a typo, or a token of another op arriving
    through the global knob) and, where ``on`` is given, ``"cuda"`` on CPU
    tensors."""
    if impl not in allowed:
        raise ValueError(
            f"{op}: unknown impl {impl!r} (expected one of "
            f"{['auto', *allowed]})"
        )
    if impl == "cuda" and on is not None and not on.is_cuda:
        raise RuntimeError(
            f"{op}: impl='cuda' needs CUDA tensors, got {on.device}"
        )


def resolve_impl(op: str, impl: str, on, kind: str,
                 allowed=("cuda", "torch")) -> str:
    """Resolve ``impl`` of ``op`` for tensors living where ``on`` does:
    ``"auto"`` by :func:`default_impl` of ``kind``; raise on a token
    outside ``allowed`` and on ``"cuda"`` for CPU tensors."""
    if impl == "auto":
        impl = default_impl(kind, on)
    _check_impl(op, impl, on, allowed)
    return impl


def resolve_hop(impl: str, edge_impl: str, dist_impl: str,
                on) -> tuple[str, str, str]:
    """The hop's ``(impl, edge_impl, dist_impl)`` after ``repro``'s rule
    (``repro/kernels/ops.py:260-297``): ``auto`` takes
    ``RTORCH_HOP_IMPL``; else a set ``RTORCH_IMPL`` makes it
    ``"composed"`` (its job is forcing the per-op kernels, which run
    inside the composition), ``"legacy"`` too, the inner ops then on the
    device's own rule; else the device's rule (the fused kernel on the
    card, the plain hop on the CPU). An explicit ``edge_impl`` /
    ``dist_impl`` pin routes any resolved impl through ``"composed"``."""
    if impl == "auto":
        forced = _knobs.get_str("RTORCH_HOP_IMPL")
        glob = _knobs.get_str("RTORCH_IMPL")
        if forced:
            impl = forced
        elif glob == "legacy":
            impl = "legacy"
        elif glob:
            impl = "composed"
        else:
            impl = _device_auto(on)
    if impl == "legacy":
        impl = "composed"
        inner = _device_auto(on)
        if edge_impl == "auto":
            edge_impl = inner
        if dist_impl == "auto":
            dist_impl = inner
    allowed = ("cuda", "torch", "composed")
    _check_impl("hop", impl, None, allowed)
    if impl != "composed" and (edge_impl != "auto" or dist_impl != "auto"):
        # the fused paths have no per-op backends
        impl = "composed"
    _check_impl("hop", impl, on, allowed)
    return impl, edge_impl, dist_impl


def pairwise_dist(q, x, *, metric="l2", impl="auto"):
    """All-pairs distance: q [Bq, D], x [N, D] (f32, bf16 or f16) ->
    f32[Bq, N]; l2 squared or ip negated."""
    if resolve_impl("pairwise_dist", impl, q, "dist") == "torch":
        return _ref.pairwise_dist(q, x, metric=metric)
    return _distance.pairwise_dist_cuda(q, x, metric=metric)


def gather_dist(q, table, ids, *, metric="l2", impl="auto", **plan_kw):
    """Fused gather + masked distance: q f32[B, d], table [n, d] in any
    stored layout or a codec struct, ids int32[B, M] (-1 masked) ->
    f32[B, M]. ``plan_kw`` (``split``) overrides the kernel's plan, over
    the installed pick of ``"gather_dist"`` (``"gather_dist_codec"`` for
    int8 and PQ tables) at this shape."""
    if resolve_impl("gather_dist", impl, q, "dist") == "torch":
        return _ref.gather_dist(q, table, ids, metric=metric)
    kind = ("gather_dist_codec"
            if isinstance(table, (_storage.Int8Vectors, _storage.PQVectors))
            else "gather_dist")
    return _gather.gather_dist_cuda(
        q, table, ids, metric=metric, override=_autotune.merged(
            kind, plan_kw, B=q.shape[0], M=ids.shape[1], d=q.shape[1]))


def select_edges(nbrs, us, L, R, *, logn, m_out, skip_layers=True,
                 impl="auto"):
    """Edge improvisation (Algorithm 1) for a flat [F] frontier ->
    int32[F, m_out], bit-identical across backends; ``"argsort"`` runs
    the argsort formulation (``core/edge_select.py``), an oracle."""
    nbrs = _storage.decode_neighbors(nbrs)
    impl = resolve_impl("select_edges", impl, us, "edge",
                        allowed=("cuda", "torch", "argsort"))
    if impl == "torch":
        return _ref.select_edges(nbrs, us, L, R, logn=logn, m_out=m_out,
                                 skip_layers=skip_layers)
    if impl == "argsort":
        return _argsort.select_edges_batch(nbrs, us, L, R, logn=logn,
                                           m_out=m_out,
                                           skip_layers=skip_layers)
    return _edge_select.select_edges_cuda(
        nbrs, us, L, R, logn=logn, m_out=m_out, skip_layers=skip_layers)


def prune(cand_ids, cand_dists, table, *, m, alpha=1.0, fill=True,
          impl="auto", cand_vecs=None, **plan_kw):
    """Construction prune -> int32[B, m] kept ids.

    ``table`` [n, d] in any stored layout. ``cand_vecs`` [B, C, d]: the
    already-gathered candidate rows, which the plain and legacy versions
    reuse (gathers are exact, so results are the same); the kernel gathers
    and decodes its rows from ``table`` itself. ``plan_kw`` (``regime``,
    ``staged``, ``warps``) overrides the kernel's plan, over the
    installed pick of ``"prune"`` at this (C, d).
    """
    impl = resolve_impl("prune", impl, cand_ids, "prune",
                        allowed=("cuda", "torch", "legacy"))
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
    return _prune.prune_cuda(
        cand_ids, cand_dists, table, m=m, alpha=alpha, fill=fill,
        override=_autotune.merged("prune", plan_kw, C=cand_ids.shape[1],
                                  d=_storage.table_dim(table)))


def hop(q, table, nbrs, u, L, R, visited, exp_ok, *, logn, m_out,
        skip_layers=True, metric="l2", impl="auto", edge_impl="auto",
        dist_impl="auto", **plan_kw):
    """One whole beam-search hop: edge improvisation + visited test-and-set
    + gather-distance; ``impl`` resolves by :func:`resolve_hop`.

    Shapes: q f32[B, d], table [n, d] or a codec struct, nbrs [n, layers,
    m] or ``SplitNeighbors`` (widened once here), u int32[B,
    W], L/R int32[B*W], visited int32[B, words] (updated IN PLACE),
    exp_ok bool[B, W] -> (nbr int32[B, W*m_out], ndist f32[B, W*m_out],
    nvalid bool[B, W*m_out], visited). ``plan_kw`` (``warps``) overrides
    the fused kernel's plan, over the installed pick of ``"hop"`` at this
    shape.
    """
    impl, edge_impl, dist_impl = resolve_hop(impl, edge_impl, dist_impl, q)
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
    return _hop.hop_cuda(
        q, table, nbrs, u, L, R, visited, exp_ok, logn=logn, m_out=m_out,
        skip_layers=skip_layers, metric=metric, override=_autotune.merged(
            "hop", plan_kw, B=u.shape[0], W=u.shape[1], d=q.shape[1]))


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, q_offset=0, impl="auto"):
    """Blockwise attention: q [B, Hq, Sq, Dh], k / v [B, Hkv, Skv, Dh]
    (``Hq % Hkv == 0``) -> [B, Hq, Sq, Dh] in q's dtype, f32 inside.
    ``window`` (query i sees keys j with ``i - window < j``) must be None
    or >= 1."""
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if _part.is_dtensor(q):
        return _flash_on_mesh(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale,
                              q_offset=q_offset, impl=impl)
    if resolve_impl("flash_attention", impl, q, "flash") == "torch":
        return _ref.attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale,
                              q_offset=q_offset)
    return _flash.flash_attention_cuda(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        q_offset=q_offset)


def _flash_on_mesh(q, k, v, *, impl, **kw):
    """Flash attention on DTensors: each rank runs :func:`flash_attention`
    (the kernel on the card) on its local batch and heads, through
    ``local_map``. A mesh dim may shard the batch (dim 0) of q, k and v
    alike, or the heads (dim 1): q's and k/v's together, or q's alone with
    k/v replicated there, when each rank takes the KV heads its query
    heads read. Any other placement raises: the kernel never sees a
    sequence or head-dim shard, and nothing is gathered for it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qp, kp = tuple(q.placements), tuple(k.placements)
    if tuple(v.placements) != kp:
        raise ValueError(f"flash on a mesh: k {kp} and v {v.placements} "
                         "differ")
    slice_dims = []
    for i, (a, b) in enumerate(zip(qp, kp)):
        for p in (a, b):
            if not isinstance(p, (Shard, Replicate)) or (
                    isinstance(p, Shard) and p.dim not in (0, 1)):
                raise ValueError(f"flash on a mesh: placements q {qp}, "
                                 f"k {kp}: only the batch and the heads "
                                 "may be sharded")
        if a == b:
            continue
        if a == Shard(1) and b == Replicate():
            slice_dims.append(i)
            continue
        raise ValueError(f"flash on a mesh: q {qp} and k {kp} differ on "
                         f"mesh dim {i}")
    if len(slice_dims) > 1:
        raise ValueError(f"flash on a mesh: q's heads on mesh dims "
                         f"{slice_dims} with k/v replicated")

    for i, pl in enumerate(qp):
        if pl == Replicate() and mesh.size(i) > 1:
            _part.note_replicated(
                f"flash attention: batch and heads whole on mesh dim {i}")

    def local(ql, kl, vl):
        if slice_dims:
            i = slice_dims[0]
            r, hq_l = mesh.get_local_rank(i), ql.shape[1]
            g = hq_l * mesh.size(i) // kl.shape[1]
            if hq_l % g and g % hq_l:
                raise ValueError(f"flash on a mesh: {hq_l} query heads a "
                                 f"rank do not map onto GQA groups of {g}")
            lo, hi = r * hq_l // g, ((r + 1) * hq_l - 1) // g + 1
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        MESH_CALLS["flash_attention"] += 1
        return flash_attention(ql, kl, vl, impl=impl, **kw)

    # a list is one output's (or input's) placements; a tuple holds many.
    # K/V replicated where q's heads split get a partial gradient there.
    kg = [Partial() if i in slice_dims else pl for i, pl in enumerate(kp)]
    return local_map(local, out_placements=list(qp),
                     in_placements=(list(qp), list(kp), list(kp)),
                     in_grad_placements=(list(qp), kg, kg),
                     device_mesh=mesh)(q, k, v)
