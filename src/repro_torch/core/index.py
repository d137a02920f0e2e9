"""Public iRangeGraph index API of the port (``repro/core/index.py:38-365``).

``RangeGraphIndex.build(vectors, attrs)`` sorts objects by attribute value
(stable), builds the packed elemental-graph table on the card (or on
``device="cpu"``), and exposes:

  * ``search(queries, lo_val, hi_val)`` — RFANN in attribute-VALUE space;
  * ``search_ranks(queries, L, R)`` — RFANN in rank space;
  * value<->rank mapping by binary search (paper §2.2);
  * ``save``/``load`` in the JAX package's file format (msgpack envelope,
    sha256, per-array crc32, zstd or zlib), so an index written by either
    package loads in the other;
  * ``from_numpy``/``to_numpy``, the plain-array form of the same fields.

The two hot-path tables (``vectors``, ``neighbors``) are torch tensors on
the index's device; ``attrs`` and ``perm`` stay numpy on the host, where
rank mapping runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import warnings
import zlib

import numpy as np
import torch

from repro_torch import compressio
from repro_torch.core import build as build_mod
from repro_torch.core import search as search_mod
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig
from repro_torch.device import resolve_device

__all__ = ["IndexCorruptionError", "RangeGraphIndex", "recall"]

# codec leaves of the file format that this slice cannot hold yet
_CODEC_FIELDS = ("vec_scales", "vec_codebook", "neighbors_lo", "rerank",
                 "rerank_scales")


class IndexCorruptionError(IOError):
    """A saved index failed an integrity check on load.

    ``field`` names the offending array (``"vectors"``, ``"neighbors"``,
    ...) or ``"envelope"`` for whole-file damage.
    """

    def __init__(self, field: str, message: str):
        super().__init__(f"corrupt index [{field}]: {message}")
        self.field = field


def _pack_array(a: np.ndarray) -> dict:
    data = a.tobytes()
    return {"dtype": str(a.dtype), "shape": list(a.shape), "data": data,
            "crc32": zlib.crc32(data)}


def _unpack_array(d: dict, field: str) -> np.ndarray:
    data = d["data"]
    dtype = storage_mod.np_dtype(d["dtype"])
    want = int(np.prod(d["shape"], dtype=np.int64)) * dtype.itemsize
    if len(data) != want:
        raise IndexCorruptionError(
            field, f"truncated: {len(data)} bytes, expected {want} "
            f"for shape {d['shape']} {d['dtype']}"
        )
    crc = d.get("crc32")
    if crc is None:
        warnings.warn(
            f"index file predates per-array checksums ({field} unchecked); "
            "re-save to add them", stacklevel=3,
        )
    elif zlib.crc32(data) != crc:
        raise IndexCorruptionError(field, "checksum mismatch (bit flip?)")
    return np.frombuffer(data, dtype=dtype).reshape(d["shape"]).copy()


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@dataclasses.dataclass
class RangeGraphIndex:
    vectors: torch.Tensor      # f32[n, d], rank order, on the device
    attrs: np.ndarray          # f64[n], sorted attribute values
    perm: np.ndarray           # original index of rank i
    neighbors: torch.Tensor    # [n, layers, m] int32/int16, on the device
    m: int
    logn: int
    build_cfg: build_mod.BuildConfig
    storage: storage_mod.StorageConfig = dataclasses.field(
        default_factory=storage_mod.StorageConfig
    )

    # -- construction -------------------------------------------------------
    @classmethod
    def build(
        cls,
        vectors,
        attrs,
        cfg: build_mod.BuildConfig | None = None,
        *,
        device=None,
        verbose: bool = False,
        prune_impl: str | None = None,
        dist_impl: str = "auto",
        storage: storage_mod.StorageConfig | None = None,
        level_times: list | None = None,
    ) -> "RangeGraphIndex":
        """Sort by attribute and build on ``device`` (the card unless
        ``device="cpu"``). ``prune_impl`` overrides ``cfg.prune_impl``
        ("auto" | "cuda" | "torch") and ``dist_impl`` the sibling
        searches' gather-distance backend (same set; not saved with the
        index); ``storage`` picks the stored dtypes
        (f32 vectors; int32, int16 or "auto" ids); ``level_times``, if a
        list, collects per-level timings (``build_neighbor_table``)."""
        cfg = cfg or build_mod.BuildConfig()
        if prune_impl is not None:
            cfg = dataclasses.replace(cfg, prune_impl=prune_impl)
        storage = (storage or storage_mod.StorageConfig()).check_supported()
        dev = resolve_device(device)
        vectors = np.asarray(vectors, np.float32)
        attrs = np.asarray(attrs, np.float64)
        n = vectors.shape[0]
        perm = np.argsort(attrs, kind="stable").astype(np.int64)
        vectors = storage_mod.encode_vectors(vectors[perm], storage)
        attrs = attrs[perm]
        vec = torch.from_numpy(vectors).to(dev)
        nbrs = build_mod.build_neighbor_table(
            vec, cfg, device=dev, verbose=verbose, storage=storage,
            level_times=level_times, dist_impl=dist_impl,
        )
        logn = int(math.ceil(math.log2(max(n, 2))))
        return cls(vec, attrs, perm, nbrs, cfg.m, logn, cfg,
                   storage=storage)

    @classmethod
    def from_numpy(cls, fields: dict, *, device=None) -> "RangeGraphIndex":
        """An index from the plain arrays and scalars a ``repro`` index
        holds, placed on ``device`` (the card unless ``device="cpu"``).

        ``fields``: ``vectors`` f32[n, d] and ``neighbors`` int32/int16[n,
        layers, m] (rank order), ``attrs`` f64[n], ``perm`` int64[n],
        ``m`` and ``logn`` ints, ``build_cfg`` and ``storage`` as dicts of
        ``BuildConfig`` / ``StorageConfig`` fields. This slice refuses the
        codecs with ``NotImplementedError`` (ROADMAP queue 1 item 7): a
        ``storage`` other than f32 vectors with int32/int16 ids, a codec
        struct in ``vectors``/``neighbors``, or a ``rerank`` sidecar.
        """
        if fields.get("rerank") is not None:
            raise NotImplementedError(
                "rerank sidecars are not ported yet: see ROADMAP queue 1 "
                "item 7 (storage codecs)")
        storage = storage_mod.StorageConfig(
            **dict(fields.get("storage") or {})).check_supported()
        vectors = fields["vectors"]
        neighbors = fields["neighbors"]
        for name, a in (("vectors", vectors), ("neighbors", neighbors)):
            if not isinstance(a, (np.ndarray, torch.Tensor)):
                raise NotImplementedError(
                    f"{name} is a {type(a).__name__}: codec structs are not "
                    "ported yet (ROADMAP queue 1 item 7, storage codecs)")
        vectors = _to_numpy(vectors)
        if vectors.dtype != np.float32:
            raise NotImplementedError(
                f"vectors of dtype {vectors.dtype}: only float32 is ported "
                "(ROADMAP queue 1 item 7, storage codecs)")
        neighbors = _to_numpy(neighbors)
        if neighbors.dtype not in (np.int32, np.int16):
            raise NotImplementedError(
                f"neighbors of dtype {neighbors.dtype}: only int32/int16 "
                "are ported (ROADMAP queue 1 item 7, storage codecs)")
        dev = resolve_device(device)
        cfg = fields.get("build_cfg") or {}
        if isinstance(cfg, dict):
            cfg = build_mod.BuildConfig(**cfg)
        return cls(
            vectors=torch.from_numpy(np.ascontiguousarray(vectors)).to(dev),
            attrs=np.asarray(fields["attrs"], np.float64),
            perm=np.asarray(fields["perm"], np.int64),
            neighbors=torch.from_numpy(
                np.ascontiguousarray(neighbors)).to(dev),
            m=int(fields["m"]),
            logn=int(fields["logn"]),
            build_cfg=cfg,
            storage=storage,
        )

    def to_numpy(self) -> dict:
        """The index as the plain arrays and scalars of :meth:`from_numpy`
        (tables copied to the host; configs as dicts)."""
        return {
            "vectors": _to_numpy(self.vectors),
            "attrs": np.asarray(self.attrs),
            "perm": np.asarray(self.perm),
            "neighbors": _to_numpy(self.neighbors),
            "m": int(self.m),
            "logn": int(self.logn),
            "build_cfg": dataclasses.asdict(self.build_cfg),
            "storage": dataclasses.asdict(self.storage),
        }

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def n(self) -> int:
        return storage_mod.table_n(self.vectors)

    @property
    def dim(self) -> int:
        return storage_mod.table_dim(self.vectors)

    @property
    def nbytes(self) -> int:
        """Stored footprint of the tables and the attributes."""
        return (storage_mod.table_nbytes(self.vectors)
                + storage_mod.table_nbytes(self.neighbors)
                + self.attrs.nbytes)

    # -- range mapping -------------------------------------------------------
    def ranks_of(self, lo_val, hi_val):
        """Map inclusive attribute-value ranges to inclusive rank ranges."""
        L = np.searchsorted(self.attrs, np.asarray(lo_val), side="left")
        R = np.searchsorted(self.attrs, np.asarray(hi_val), side="right") - 1
        return L.astype(np.int32), R.astype(np.int32)

    # -- query ---------------------------------------------------------------
    def _on_device(self, x, dtype) -> torch.Tensor:
        """Caller input (numpy or torch) as a contiguous tensor on the
        index's device, the layout the kernels take."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device=self.device, dtype=dtype).contiguous()

    def search_ranks(self, queries, L, R, *, k=10,
                     config: SearchConfig | None = None
                     ) -> search_mod.SearchResult:
        """RFANN in rank space: per-query inclusive rank ranges [L, R].
        Inputs may be numpy or torch; results are tensors on the index's
        device."""
        return search_mod.search_improvised(
            self.vectors, self.neighbors,
            self._on_device(queries, torch.float32),
            self._on_device(L, torch.int32), self._on_device(R, torch.int32),
            logn=self.logn, m_out=self.m, k=k, config=config,
        )

    def search(self, queries, lo_val, hi_val, **kw) -> search_mod.SearchResult:
        L, R = self.ranks_of(lo_val, hi_val)
        return self.search_ranks(queries, L, R, **kw)

    def original_ids(self, rank_ids):
        """Map rank-space result ids back to the caller's original ids."""
        rank_ids = _to_numpy(rank_ids)
        return np.where(rank_ids >= 0, self.perm[np.maximum(rank_ids, 0)], -1)

    # -- ground truth ---------------------------------------------------------
    def brute_force(self, queries, L, R, *, k=10, metric="l2"):
        """Exact in-range top-k (the Pre-filtering strategy), computed with
        plain torch on the index's device, one query at a time. Returns
        numpy ``(ids int64[B, k], dists f32[B, k])``."""
        q = self._on_device(queries, torch.float32)
        L = np.asarray(L)
        R = np.asarray(R)
        ids = np.full((q.shape[0], k), -1, np.int64)
        dists = np.full((q.shape[0], k), np.inf, np.float32)
        for i in range(q.shape[0]):
            lo, hi = int(L[i]), int(R[i])
            if hi < lo:
                continue
            x = self.vectors[lo:hi + 1]
            if metric == "l2":
                d = ((x - q[i]) ** 2).sum(1)
            else:
                d = -(x @ q[i])
            kk = min(k, d.shape[0])
            dv, part = torch.sort(d, stable=True)
            ids[i, :kk] = part[:kk].cpu().numpy() + lo
            dists[i, :kk] = dv[:kk].cpu().numpy()
        return ids, dists

    # -- serialization ---------------------------------------------------------
    def save(self, path: str):
        """Write the JAX package's format (msgpack payload, sha256 envelope,
        per-array crc32, zstd when installed else zlib)."""
        import msgpack

        payload = {
            "attrs": _pack_array(np.asarray(self.attrs)),
            "perm": _pack_array(np.asarray(self.perm)),
            "m": int(self.m),
            "logn": int(self.logn),
            "cfg": dataclasses.asdict(self.build_cfg),
            "storage": dataclasses.asdict(self.storage),
            "vectors": _pack_array(_to_numpy(self.vectors)),
            "neighbors": _pack_array(_to_numpy(self.neighbors)),
        }
        raw = msgpack.packb(payload)
        digest = hashlib.sha256(raw).hexdigest()
        blob = msgpack.packb({"sha256": digest, "payload": raw})
        with open(path, "wb") as f:
            f.write(compressio.compress(blob, level=3))

    @classmethod
    def load(cls, path: str, *, device=None) -> "RangeGraphIndex":
        """Load with integrity checking: whole-file (envelope sha256) and
        per-array (crc32 + size); a mismatch raises
        :class:`IndexCorruptionError` naming the field. Codec files raise
        ``NotImplementedError`` (ROADMAP queue 1 item 7)."""
        import msgpack

        with open(path, "rb") as f:
            blob = f.read()
        try:
            blob = compressio.decompress(blob)
            outer = msgpack.unpackb(blob)
            raw = outer["payload"]
            digest = outer["sha256"]
        except Exception as e:  # zlib/zstd/msgpack: the file is not ours
            raise IndexCorruptionError(
                "envelope", f"unreadable file {path}: {e}"
            ) from e
        if hashlib.sha256(raw).hexdigest() != digest:
            raise IndexCorruptionError(
                "envelope", f"payload checksum mismatch loading {path}"
            )
        try:
            p = msgpack.unpackb(raw)
        except Exception as e:
            raise IndexCorruptionError(
                "envelope", f"payload unpack failed loading {path}: {e}"
            ) from e
        vectors = _unpack_array(p["vectors"], "vectors")
        neighbors = _unpack_array(p["neighbors"], "neighbors")
        codec = [f for f in _CODEC_FIELDS if f in p]
        if codec:
            raise NotImplementedError(
                f"{path} holds codec fields {codec}: not ported yet (ROADMAP "
                "queue 1 item 7, storage codecs)")
        st = p.get("storage")
        if st is None:  # pre-storage files: the stored dtypes ARE the config
            st = {"vector_dtype": str(vectors.dtype),
                  "neighbor_dtype": str(neighbors.dtype)}
        return cls.from_numpy({
            "vectors": vectors,
            "attrs": _unpack_array(p["attrs"], "attrs"),
            "perm": _unpack_array(p["perm"], "perm"),
            "neighbors": neighbors,
            "m": p["m"],
            "logn": p["logn"],
            "build_cfg": p["cfg"],
            "storage": st,
        }, device=device)


def recall(result_ids, gt_ids) -> float:
    """Mean recall@k of result ids vs ground-truth ids (both [B, k])."""
    result_ids = _to_numpy(result_ids)
    gt_ids = _to_numpy(gt_ids)
    hits = 0
    total = 0
    for r, g in zip(result_ids, gt_ids):
        gset = set(int(x) for x in g if x >= 0)
        if not gset:
            continue
        hits += len(gset & set(int(x) for x in r if x >= 0))
        total += len(gset)
    return hits / max(total, 1)
