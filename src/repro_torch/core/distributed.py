"""Sharded RFANN: iRangeGraph split into contiguous attribute-rank shards
and served over ``torch.distributed`` (port of ``repro/core/distributed.py``).

Sharding scheme (DESIGN.md §2): objects are sorted by attribute and cut
into ``S`` contiguous rank ranges, one per shard. Each shard holds its
slice of vectors and a full iRangeGraph built on the slice. A query range
``[L, R]`` is clipped to each shard, every shard improvises its own
dedicated graph for the clipped local range (``shard_topk``), and the
per-shard top-k are merged (``merge_topk``). The only traffic between
ranks is that k-sized merge: O(B * k) per batch, independent of n.

Where ``repro`` lays the shards over the ``data`` axis of a JAX ``Mesh``
and runs ``shard_map``, the port runs one process per rank over an
initialised default process group: :class:`ShardLayout` maps each rank to
``(data_rank, model_rank)`` and creates a group per axis. The data axis
holds shard ``data_rank``; the model axis replicates the shard and splits
the query batch. ``repro``'s optional ``pod`` axis only joins the query
split, so here it is a factor of ``model``.

Backends: NCCL where every rank has a card of its own, gloo otherwise (on
the CPU, and for ranks that share one card). NCCL refuses two ranks on
one card, so :class:`ShardLayout` raises for that layout. Under gloo the
``[B, k]`` pair crosses the ranks as an explicit host copy, whatever the
device of the shard: the pair is small, and the copy never depends on
what the installed gloo accepts.

``repro``'s loose ``ef``/``expand_width``/``*_impl`` keywords are a
deprecation shim (``config.merge``); like the port's search functions,
these take only ``config``. Shards may be ragged (``build_sharded`` pads
the tail, ``bounds`` keep the padding out of every query) and may store
compact dtypes (bf16 vectors, int16 neighbor ids).
"""
from __future__ import annotations

import dataclasses
import datetime
import time
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import build as build_mod
from repro_torch.core import search as search_mod
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig
from repro_torch.device import resolve_device

__all__ = [
    "ShardedRangeIndex", "ShardLayout", "build_sharded", "build_shard",
    "shard_topk", "merge_topk", "rfann_serve_step", "make_serve_step",
]

# every group this module creates waits at most this long for its ranks
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int16: "int16",
                torch.int32: "int32"}


class ShardedRangeIndex:
    """The per-shard tables, stacked on one device.

    vectors:   [S, n_shard, d] in the storage dtype;
    neighbors: [S, n_shard, layers, m] in the neighbor codec dtype;
    bounds:    int32[S, 2], each shard's real global rank range (inclusive;
               a padded tail stays outside it, an all-padding shard has
               ``hi < lo``).
    """

    def __init__(self, vectors, neighbors, bounds, logn, m, storage=None):
        self.vectors = vectors
        self.neighbors = neighbors
        self.bounds = bounds
        self.logn = int(logn)
        self.m = int(m)
        # introspection only: derived from the arrays when not given, so
        # the field can never contradict what is stored
        self.storage = storage or storage_mod.StorageConfig(
            vector_dtype=_DTYPE_NAMES[vectors.dtype],
            neighbor_dtype=_DTYPE_NAMES[neighbors.dtype],
        )

    @property
    def n_shards(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def nbytes(self) -> int:
        """Stored bytes of the stacked per-shard tables."""
        return sum(storage_mod.table_nbytes(t) for t in
                   (self.vectors, self.neighbors, self.bounds))

    @classmethod
    def from_numpy(cls, fields, device="cpu") -> "ShardedRangeIndex":
        """Carry ``repro``'s ``ShardedRangeIndex`` across: ``fields`` is a
        mapping, or any object, with its ``vectors``, ``neighbors``,
        ``bounds``, ``logn``, ``m`` and optional ``storage`` (a mapping or
        an object with ``StorageConfig``'s fields) as numpy. A bf16 table
        may come as ``ml_dtypes.bfloat16`` or as its ``uint16`` bits (no
        vector table of another dtype is stored as ``uint16``); no
        ``jax`` or ``ml_dtypes`` is needed."""
        if isinstance(fields, Mapping):
            get = fields.get
        else:
            def get(key, default=None):
                return getattr(fields, key, default)

        vectors = np.asarray(get("vectors"))
        if vectors.dtype == np.uint16:
            vectors = torch.from_numpy(
                np.ascontiguousarray(vectors).view(np.int16)).view(
                    torch.bfloat16)
        st = get("storage")
        if st is not None and not isinstance(st, storage_mod.StorageConfig):
            names = [f.name for f in
                     dataclasses.fields(storage_mod.StorageConfig)]
            st = storage_mod.StorageConfig(**{
                k: (st[k] if isinstance(st, Mapping) else getattr(st, k))
                for k in names})
        return cls(
            storage_mod.as_tensor(vectors, device),
            storage_mod.as_tensor(get("neighbors"), device),
            storage_mod.as_tensor(
                np.asarray(get("bounds"), np.int32), device),
            get("logn"), get("m"), st,
        )

    def shard(self, s: int, device=None):
        """Shard ``s``'s ``(vectors, neighbors, bounds)`` on ``device``
        (the card unless ``device="cpu"``): what one rank holds."""
        dev = resolve_device(device)
        return tuple(t[s].to(dev).contiguous() for t in
                     (self.vectors, self.neighbors, self.bounds))


def _check_storage(storage: storage_mod.StorageConfig) -> None:
    if (storage.vector_dtype in ("int8", "pq")
            or storage.neighbor_dtype == "split"):
        # codec structs don't stack into the [S, ...] shard-major tables
        raise ValueError(
            "build_sharded does not support codec storage "
            f"(vector_dtype={storage.vector_dtype!r}, "
            f"neighbor_dtype={storage.neighbor_dtype!r}); use a plain "
            "float/compact StorageConfig"
        )


def build_shard(sorted_vectors: np.ndarray, s: int, n_shards: int,
                cfg: build_mod.BuildConfig | None = None,
                storage: storage_mod.StorageConfig | None = None, *,
                device=None):
    """Build shard ``s`` of ``n_shards`` from vectors already in attribute-
    rank order (f32 numpy ``[n, d]``): its rows ``[lo, hi]`` of the
    ``ceil(n / n_shards)``-wide cut, a ragged tail padded by repeating its
    last row (an all-padding shard repeats the last vector and gets
    ``hi < lo``). Returns ``(vectors, neighbors, (lo, hi))`` on
    ``device``: the stored vectors and the neighbor table in the codec
    dtypes of ``storage`` (default ``storage.default_config()``). A rank
    can build its own shard with it."""
    cfg = cfg or build_mod.BuildConfig()
    storage = storage or storage_mod.default_config()
    vs = sorted_vectors
    n = vs.shape[0]
    per = -(-n // n_shards)
    lo = s * per
    hi = min(lo + per, n) - 1
    sl = vs[lo: hi + 1] if hi >= lo else vs[:0]
    if sl.shape[0] < per:
        fill = sl[-1] if sl.shape[0] else vs[-1]
        sl = np.concatenate(
            [sl, np.broadcast_to(fill, (per - sl.shape[0], vs.shape[1]))])
    dev = resolve_device(device)
    rows = torch.from_numpy(np.ascontiguousarray(sl)).to(dev)
    tbl = build_mod.build_neighbor_table(rows, cfg, device=dev,
                                         storage=storage)
    return storage_mod.encode_vectors(rows, storage), tbl, (lo, hi)


def build_sharded(
    vectors, attrs, n_shards: int,
    cfg: build_mod.BuildConfig | None = None,
    storage: storage_mod.StorageConfig | None = None, *, device=None,
    shard_seconds: list | None = None,
) -> ShardedRangeIndex:
    """Sort by attribute (stable, as ``RangeGraphIndex.build`` does, so a
    shard's ranks are the index's ranks), cut into ``n_shards`` contiguous
    shards of ``ceil(n / n_shards)`` rows and build one index per shard
    with ``core/build.py::build_neighbor_table``, on the card unless
    ``device="cpu"`` (:func:`build_shard`).

    ``storage=None`` means ``storage.default_config()``, which the
    ``RTORCH_STORAGE`` knob moves, as ``repro`` reads ``REPRO_STORAGE``
    here. Raises ``ValueError`` for codec storage (int8, PQ, split ids),
    whether passed or from the knob, and for ``n_shards`` outside
    ``[1, n]``. ``shard_seconds``, if a list,
    collects each shard's build seconds (the device synchronised).
    """
    cfg = cfg or build_mod.BuildConfig()
    storage = storage or storage_mod.default_config()
    _check_storage(storage)
    n = vectors.shape[0]
    if not 1 <= n_shards <= n:
        raise ValueError(f"need 1 <= n_shards <= n, got S={n_shards} n={n}")
    order = np.argsort(np.asarray(attrs), kind="stable")
    vs = np.asarray(vectors, np.float32)[order]
    parts = []
    for s in range(n_shards):
        t0 = time.perf_counter()
        parts.append(build_shard(vs, s, n_shards, cfg, storage,
                                 device=device))
        if shard_seconds is not None:
            if parts[-1][0].is_cuda:
                torch.cuda.synchronize(parts[-1][0].device)
            shard_seconds.append(time.perf_counter() - t0)
    dev = parts[0][0].device
    bounds = torch.tensor([p[2] for p in parts], dtype=torch.int32,
                          device=dev)
    return ShardedRangeIndex(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        bounds, parts[0][1].shape[1] - 1, cfg.m, storage,
    )


def shard_topk(vec, nbr, bnd, q, Lq, Rq, *, logn, m, k,
               config: SearchConfig | None = None):
    """One shard's clipped local search -> global-id top-k candidates.

    vec ``[n_shard, d]`` (any float storage dtype); nbr ``[n_shard,
    layers, m]`` (int16 or int32); bnd int32[2], the shard's real global
    rank range; q f32[B, d]; Lq/Rq int32[B] global rank ranges; every
    tensor on one device. Returns ``(ids, dists)`` [B, k]: ids global (-1
    where missing), dists ``+inf`` there. A query whose range misses the
    shard becomes the empty range ``L=1, R=0``: no entry point, no result.
    """
    # compact ids widen once, through the -1-preserving decode
    nbr = storage_mod.decode_neighbors(nbr)
    Lq = Lq.to(torch.int32)
    Rq = Rq.to(torch.int32)
    lo, hi = bnd[0], bnd[1]
    # clip to this shard, local coordinates; hi is the REAL end, so a
    # padded tail stays > Rl and is never entered, traversed or returned
    Ll = (Lq - lo).clamp(0, vec.shape[0] - 1).to(torch.int32)
    Rl = (torch.minimum(Rq, hi) - lo).to(torch.int32)
    empty = (Rq < lo) | (Lq > hi)
    Ll = torch.where(empty, 1, Ll)
    Rl = torch.where(empty, 0, Rl)
    res = search_mod.search_improvised(vec, nbr, q, Ll, Rl, logn=logn,
                                       m_out=m, k=k, config=config)
    ids = torch.where((res.ids >= 0) & ~empty[:, None], res.ids + lo, -1)
    dists = torch.where(ids >= 0, res.dists, torch.inf)
    return ids, dists


def merge_topk(all_ids, all_d, k):
    """Merge stacked per-shard candidates ``[S, B, k]`` into the global
    top-k ``[B, k]``. ``lax.top_k(-d)`` puts the lower flat index first
    among equal distances; a stable ascending sort does the same."""
    S, B = all_ids.shape[0], all_ids.shape[1]
    flat_i = all_ids.movedim(0, 1).reshape(B, S * all_ids.shape[2])
    flat_d = all_d.movedim(0, 1).reshape(B, S * all_d.shape[2])
    vals, take = torch.sort(flat_d, dim=1, stable=True)
    return flat_i.gather(1, take[:, :k]), vals[:, :k]


class ShardLayout:
    """The ``(data, model)`` layout of the ranks of the initialised default
    process group: rank ``r`` is ``(r // model, r % model)``, as a JAX
    mesh of those axes lays its devices. It holds the group of its data
    axis (the ranks that hold the other shards) and of its model axis
    (the ranks that share its shard and split the batch); every rank
    creates every group, in one order.

    ``device`` is where this rank's shard lives (``resolve_device``: the
    card unless ``device="cpu"``). Under NCCL every rank needs a card of
    its own; two ranks on one card raise ``ValueError``."""

    def __init__(self, data: int, model: int = 1, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError("ShardLayout needs an initialised default "
                               "process group (init_process_group)")
        world, rank = dist.get_world_size(), dist.get_rank()
        if data < 1 or model < 1 or data * model != world:
            raise ValueError(f"layout data={data} x model={model} does not "
                             f"match the world size {world}")
        self.data, self.model = data, model
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, model)
        self.device = resolve_device(device)
        self.backend = str(dist.get_backend())
        if self.backend == "nccl":
            self._check_one_card_a_rank()
        for j in range(model):  # data groups: one per model rank
            g = dist.new_group([i * model + j for i in range(data)],
                               timeout=GROUP_TIMEOUT)
            if j == self.model_rank:
                self.data_group = g
        for i in range(data):   # model groups: one per shard
            g = dist.new_group([i * model + j for j in range(model)],
                               timeout=GROUP_TIMEOUT)
            if i == self.data_rank:
                self.model_group = g

    def _check_one_card_a_rank(self) -> None:
        if self.device.type != "cuda":
            raise ValueError(f"NCCL ranks need a card; rank {self.rank} is "
                             f"on {self.device}")
        ctl = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
        cards = [None] * dist.get_world_size()
        dist.all_gather_object(
            cards, str(torch.cuda.get_device_properties(self.device).uuid),
            group=ctl)
        if len(set(cards)) != len(cards):
            raise ValueError(
                "NCCL cannot run two ranks on one card (cards by rank: "
                f"{cards}); use the gloo backend for ranks that share one")

    def __repr__(self) -> str:
        return (f"ShardLayout(data={self.data}, model={self.model}, rank="
                f"{self.rank} -> ({self.data_rank}, {self.model_rank}), "
                f"{self.backend}, {self.device})")


def _all_gather(t: torch.Tensor, group, backend: str) -> torch.Tensor:
    """Stack ``t`` from every rank of ``group`` (group-rank order) on
    ``t``'s device; under gloo through an explicit host copy."""
    src = t.cpu() if backend == "gloo" else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def rfann_serve_step(vec, nbr, bnd, queries, L, R, *, layout: ShardLayout,
                     logn, m, k, config: SearchConfig | None = None):
    """One batch of sharded RFANN queries, called on every rank with this
    rank's shard (``ShardedRangeIndex.shard(layout.data_rank, ...)``) and
    the whole batch: queries f32[B, d], L/R int32[B] global rank ranges.

    The rank searches its shard for its model rank's ``B / model`` queries
    (``shard_topk``), all-gathers ids and distances over its data group
    and merges them (``merge_topk``), then all-gathers the merged slices
    over its model group. Every rank returns the whole ``(ids, dists)``
    [B, k] on ``layout.device``. Raises ``ValueError`` unless B divides
    by ``layout.model`` and the shard lives on ``layout.device``."""
    dev = layout.device
    if vec.device != dev or nbr.device != dev or bnd.device != dev:
        raise ValueError(f"the shard is on {vec.device}, the layout's rank "
                         f"on {dev}")
    q = storage_mod.as_tensor(queries, dev).to(torch.float32)
    B = q.shape[0]
    if B % layout.model:
        raise ValueError(f"batch {B} does not divide over model="
                         f"{layout.model}")
    b = B // layout.model
    sl = slice(layout.model_rank * b, (layout.model_rank + 1) * b)
    Lq = storage_mod.as_tensor(L, dev).to(torch.int32)[sl]
    Rq = storage_mod.as_tensor(R, dev).to(torch.int32)[sl]
    ids, dists = shard_topk(vec, nbr, bnd, q[sl], Lq, Rq, logn=logn, m=m,
                            k=k, config=config)
    out_i, out_d = merge_topk(
        _all_gather(ids, layout.data_group, layout.backend),
        _all_gather(dists, layout.data_group, layout.backend), k)
    if layout.model == 1:
        return out_i, out_d
    return (_all_gather(out_i, layout.model_group, layout.backend)
            .reshape(B, k),
            _all_gather(out_d, layout.model_group, layout.backend)
            .reshape(B, k))


def make_serve_step(layout: ShardLayout, *, logn, m, k,
                    config: SearchConfig | None = None):
    """``rfann_serve_step`` with the layout and knobs bound: the
    counterpart of ``repro``'s ``make_serve_jit`` (no jit here)."""
    def step(vec, nbr, bnd, queries, L, R):
        return rfann_serve_step(vec, nbr, bnd, queries, L, R, layout=layout,
                                logn=logn, m=m, k=k, config=config)

    return step
