"""Public iRangeGraph index API of the port (``repro/core/index.py:38-365``).

``RangeGraphIndex.build(vectors, attrs)`` sorts objects by attribute value
(stable), builds the packed elemental-graph table on the card (or on
``device="cpu"``) in f32, encodes the tables under ``storage``, and
exposes:

  * ``search(queries, lo_val, hi_val)`` — RFANN in attribute-VALUE space;
  * ``search_ranks(queries, L, R)`` — RFANN in rank space;
  * value<->rank mapping by binary search (paper §2.2);
  * ``astype_storage`` — re-encode under another codec, no rebuild;
  * ``save``/``load`` in the JAX package's file format (msgpack envelope,
    sha256, per-array crc32, zstd or zlib; codec structs flatten to one
    checked field per leaf), so an index written by either package loads
    in the other. The envelope is packed by the port's own
    ``core/msgpack_lite.py``: no ``msgpack`` is needed;
  * ``from_numpy``/``to_numpy``, the plain-array form of the same fields.

The hot-path tables (``vectors``, ``neighbors``, the ``rerank`` sidecar)
are tensors, or codec structs of tensors, on the index's device; ``attrs``
and ``perm`` stay numpy on the host, where rank mapping runs.
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
from repro_torch.core import msgpack_lite
from repro_torch.core import search as search_mod
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig
from repro_torch.device import resolve_device

__all__ = ["IndexCorruptionError", "RangeGraphIndex", "recall"]


class IndexCorruptionError(IOError):
    """A saved index failed an integrity check on load.

    ``field`` names the offending array (``"vectors"``, ``"vec_scales"``,
    ``"neighbors_lo"``, ...) or ``"envelope"`` for whole-file damage.
    """

    def __init__(self, field: str, message: str):
        super().__init__(f"corrupt index [{field}]: {message}")
        self.field = field


def _pack_array(a) -> dict:
    """Tensor or numpy -> the file's array record (bf16 as its bits,
    named "bfloat16")."""
    bf16 = isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
    a = storage_mod.to_numpy(a)
    data = a.tobytes()
    return {"dtype": "bfloat16" if bf16 else str(a.dtype),
            "shape": list(a.shape), "data": data, "crc32": zlib.crc32(data)}


def _unpack_array(d: dict, field: str) -> torch.Tensor:
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
    a = np.frombuffer(data, dtype=dtype).reshape(d["shape"]).copy()
    if d["dtype"] == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _float_table(a, dtype_name: str, device):
    """A float table from numpy or torch; a ``uint16`` array is the bit
    pattern of a bf16 table when the config says "bfloat16"."""
    if (dtype_name == "bfloat16" and isinstance(a, np.ndarray)
            and a.dtype == np.uint16):
        a = a.view(np.int16)
        return torch.from_numpy(np.ascontiguousarray(a)).view(
            torch.bfloat16).to(device)
    return storage_mod.as_table(a, device)


def _fields_numpy(table):
    """A table as numpy leaves (codec structs keep their type)."""
    if table is None:
        return None
    if isinstance(table, tuple):
        return type(table)(*(storage_mod.to_numpy(x) for x in table))
    return storage_mod.to_numpy(table)


@dataclasses.dataclass
class RangeGraphIndex:
    vectors: object            # [n, d] tensor or codec struct, rank order
    attrs: np.ndarray          # f64[n], sorted attribute values
    perm: np.ndarray           # original index of rank i
    neighbors: object          # [n, layers, m] tensor or SplitNeighbors
    m: int
    logn: int
    build_cfg: build_mod.BuildConfig
    storage: storage_mod.StorageConfig = dataclasses.field(
        default_factory=storage_mod.StorageConfig
    )
    # rerank sidecar (storage.rerank_dtype): None, an [n, d] tensor or
    # Int8Vectors — what SearchConfig.rerank re-scores against
    rerank: object = None

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
        index); ``level_times``, if a list, collects per-level timings
        (``build_neighbor_table``). The build runs in f32; ``storage``
        (default f32 / int32) then encodes the neighbor ids, the rerank
        sidecar and the vectors, in that order, as ``repro`` does."""
        cfg = cfg or build_mod.BuildConfig()
        if prune_impl is not None:
            cfg = dataclasses.replace(cfg, prune_impl=prune_impl)
        storage = storage or storage_mod.StorageConfig()
        dev = resolve_device(device)
        vectors = np.asarray(vectors, np.float32)
        attrs = np.asarray(attrs, np.float64)
        n = vectors.shape[0]
        perm = np.argsort(attrs, kind="stable").astype(np.int64)
        attrs = attrs[perm]
        vec = torch.from_numpy(np.ascontiguousarray(vectors[perm])).to(dev)
        nbrs = build_mod.build_neighbor_table(
            vec, cfg, device=dev, verbose=verbose, storage=storage,
            level_times=level_times, dist_impl=dist_impl,
        )
        logn = int(math.ceil(math.log2(max(n, 2))))
        rerank = storage_mod.encode_rerank(vec, storage)
        vec = storage_mod.encode_vectors(vec, storage)
        return cls(vec, attrs, perm, nbrs, cfg.m, logn, cfg,
                   storage=storage, rerank=rerank)

    def astype_storage(
        self, storage: storage_mod.StorageConfig
    ) -> "RangeGraphIndex":
        """Re-encode the stored tables under ``storage``, on the index's
        device: no rebuild, so neighbor ids are identical across codecs
        and only vector precision changes. The source is the rerank
        sidecar when there is one, else the stored vectors, decoded to
        f32 (``repro/core/index.py:134-155``)."""
        src = storage_mod.decode_vectors(
            self.rerank if self.rerank is not None else self.vectors)
        return dataclasses.replace(
            self,
            vectors=storage_mod.encode_vectors(src, storage),
            neighbors=storage_mod.encode_neighbors(
                storage_mod.decode_neighbors(self.neighbors), self.n, storage
            ),
            rerank=storage_mod.encode_rerank(src, storage),
            storage=storage,
        )

    @classmethod
    def from_numpy(cls, fields: dict, *, device=None) -> "RangeGraphIndex":
        """An index from the plain arrays and scalars a ``repro`` index
        holds, placed on ``device`` (the card unless ``device="cpu"``).

        ``fields``: ``vectors`` [n, d] (f32, f16, bf16 — ``ml_dtypes`` or
        its ``uint16`` bits) or a codec struct (``Int8Vectors`` /
        ``PQVectors``, ``repro``'s or the port's: any ``NamedTuple`` with
        their fields); ``neighbors`` int32/int16 [n, layers, m] or
        ``SplitNeighbors``; optional ``rerank`` (None, [n, d] or
        ``Int8Vectors``); ``attrs`` f64[n], ``perm`` int64[n], ``m`` and
        ``logn`` ints, ``build_cfg`` and ``storage`` as dicts of
        ``BuildConfig`` / ``StorageConfig`` fields. Tensors are accepted
        wherever numpy is.
        """
        storage = storage_mod.StorageConfig(
            **dict(fields.get("storage") or {}))
        dev = resolve_device(device)
        cfg = fields.get("build_cfg") or {}
        if isinstance(cfg, dict):
            cfg = build_mod.BuildConfig(**cfg)
        return cls(
            vectors=_float_table(fields["vectors"], storage.vector_dtype,
                                 dev),
            attrs=np.asarray(fields["attrs"], np.float64),
            perm=np.asarray(fields["perm"], np.int64),
            neighbors=storage_mod.as_table(fields["neighbors"], dev),
            m=int(fields["m"]),
            logn=int(fields["logn"]),
            build_cfg=cfg,
            storage=storage,
            rerank=_float_table(fields.get("rerank"), storage.rerank_dtype,
                                dev),
        )

    def to_numpy(self) -> dict:
        """The index as the plain arrays and scalars of :meth:`from_numpy`
        (tables copied to the host, codec structs of numpy arrays, bf16 as
        ``uint16`` bits; configs as dicts)."""
        return {
            "vectors": _fields_numpy(self.vectors),
            "attrs": np.asarray(self.attrs),
            "perm": np.asarray(self.perm),
            "neighbors": _fields_numpy(self.neighbors),
            "m": int(self.m),
            "logn": int(self.logn),
            "build_cfg": dataclasses.asdict(self.build_cfg),
            "storage": dataclasses.asdict(self.storage),
            "rerank": _fields_numpy(self.rerank),
        }

    @property
    def device(self) -> torch.device:
        return storage_mod.table_device(self.vectors)

    @property
    def n(self) -> int:
        return storage_mod.table_n(self.vectors)

    @property
    def dim(self) -> int:
        return storage_mod.table_dim(self.vectors)

    @property
    def nbytes(self) -> int:
        """Stored footprint: the tables' leaves, the rerank sidecar and the
        attributes."""
        return (storage_mod.table_nbytes(self.vectors)
                + storage_mod.table_nbytes(self.neighbors)
                + storage_mod.table_nbytes(self.rerank)
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
            rerank_store=self.rerank,
        )

    def search(self, queries, lo_val, hi_val, **kw) -> search_mod.SearchResult:
        L, R = self.ranks_of(lo_val, hi_val)
        return self.search_ranks(queries, L, R, **kw)

    def original_ids(self, rank_ids):
        """Map rank-space result ids back to the caller's original ids."""
        rank_ids = storage_mod.to_numpy(rank_ids)
        return np.where(rank_ids >= 0, self.perm[np.maximum(rank_ids, 0)], -1)

    # -- ground truth ---------------------------------------------------------
    def brute_force(self, queries, L, R, *, k=10, metric="l2"):
        """Exact in-range top-k (the Pre-filtering strategy) over the
        decoded vectors, computed with plain torch on the index's device,
        one query at a time. Returns numpy ``(ids int64[B, k], dists
        f32[B, k])``."""
        q = self._on_device(queries, torch.float32)
        vecs = storage_mod.decode_vectors(self.vectors)
        L = np.asarray(L)
        R = np.asarray(R)
        ids = np.full((q.shape[0], k), -1, np.int64)
        dists = np.full((q.shape[0], k), np.inf, np.float32)
        for i in range(q.shape[0]):
            lo, hi = int(L[i]), int(R[i])
            if hi < lo:
                continue
            x = vecs[lo:hi + 1]
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
        per-array crc32, zstd when installed else zlib). Codec structs
        flatten to one checked field per leaf (``vectors``/``vec_scales``/
        ``vec_codebook``, ``neighbors``/``neighbors_lo``, ``rerank``/
        ``rerank_scales``), so a bit flip is named on load."""
        payload = {
            "attrs": _pack_array(np.asarray(self.attrs)),
            "perm": _pack_array(np.asarray(self.perm)),
            "m": int(self.m),
            "logn": int(self.logn),
            "cfg": dataclasses.asdict(self.build_cfg),
            "storage": dataclasses.asdict(self.storage),
        }
        if isinstance(self.vectors, storage_mod.Int8Vectors):
            payload["vectors"] = _pack_array(self.vectors.codes)
            payload["vec_scales"] = _pack_array(self.vectors.scales)
        elif isinstance(self.vectors, storage_mod.PQVectors):
            payload["vectors"] = _pack_array(self.vectors.codes)
            payload["vec_codebook"] = _pack_array(self.vectors.codebook)
        else:
            payload["vectors"] = _pack_array(self.vectors)
        if isinstance(self.neighbors, storage_mod.SplitNeighbors):
            payload["neighbors"] = _pack_array(self.neighbors.hi)
            payload["neighbors_lo"] = _pack_array(self.neighbors.lo)
        else:
            payload["neighbors"] = _pack_array(self.neighbors)
        if isinstance(self.rerank, storage_mod.Int8Vectors):
            payload["rerank"] = _pack_array(self.rerank.codes)
            payload["rerank_scales"] = _pack_array(self.rerank.scales)
        elif self.rerank is not None:
            payload["rerank"] = _pack_array(self.rerank)
        raw = msgpack_lite.packb(payload)
        digest = hashlib.sha256(raw).hexdigest()
        blob = msgpack_lite.packb({"sha256": digest, "payload": raw})
        with open(path, "wb") as f:
            f.write(compressio.compress(blob, level=3))

    @classmethod
    def load(cls, path: str, *, device=None) -> "RangeGraphIndex":
        """Load with integrity checking: whole-file (envelope sha256) and
        per-array (crc32 + size); a mismatch raises
        :class:`IndexCorruptionError` naming the field. A zstd file on a
        host without ``zstandard`` raises ``RuntimeError`` (it is not
        corrupt)."""
        with open(path, "rb") as f:
            blob = f.read()
        try:
            blob = compressio.decompress(blob)
            outer = msgpack_lite.unpackb(blob)
            raw = outer["payload"]
            digest = outer["sha256"]
        except RuntimeError:
            raise  # compressio: the file's codec is not installed here
        except Exception as e:  # zlib/zstd/msgpack: the file is not ours
            raise IndexCorruptionError(
                "envelope", f"unreadable file {path}: {e}"
            ) from e
        if hashlib.sha256(raw).hexdigest() != digest:
            raise IndexCorruptionError(
                "envelope", f"payload checksum mismatch loading {path}"
            )
        try:
            p = msgpack_lite.unpackb(raw)
        except ValueError as e:
            raise IndexCorruptionError(
                "envelope", f"payload unpack failed loading {path}: {e}"
            ) from e
        vectors = _unpack_array(p["vectors"], "vectors")
        if "vec_scales" in p:
            vectors = storage_mod.Int8Vectors(
                vectors, _unpack_array(p["vec_scales"], "vec_scales"))
        elif "vec_codebook" in p:
            vectors = storage_mod.PQVectors(
                vectors, _unpack_array(p["vec_codebook"], "vec_codebook"))
        neighbors = _unpack_array(p["neighbors"], "neighbors")
        if "neighbors_lo" in p:
            neighbors = storage_mod.SplitNeighbors(
                neighbors, _unpack_array(p["neighbors_lo"], "neighbors_lo"))
        rerank = None
        if "rerank" in p:
            rerank = _unpack_array(p["rerank"], "rerank")
            if "rerank_scales" in p:
                rerank = storage_mod.Int8Vectors(
                    rerank, _unpack_array(p["rerank_scales"],
                                          "rerank_scales"))
        st = p.get("storage")
        if st is None:  # pre-storage files: the stored dtypes ARE the config
            st = {"vector_dtype": p["vectors"]["dtype"],
                  "neighbor_dtype": p["neighbors"]["dtype"]}
        return cls.from_numpy({
            "vectors": vectors,
            "attrs": _unpack_array(p["attrs"], "attrs").numpy(),
            "perm": _unpack_array(p["perm"], "perm").numpy(),
            "neighbors": neighbors,
            "m": p["m"],
            "logn": p["logn"],
            "build_cfg": p["cfg"],
            "storage": st,
            "rerank": rerank,
        }, device=device)


def recall(result_ids, gt_ids) -> float:
    """Mean recall@k of result ids vs ground-truth ids (both [B, k])."""
    result_ids = storage_mod.to_numpy(result_ids)
    gt_ids = storage_mod.to_numpy(gt_ids)
    hits = 0
    total = 0
    for r, g in zip(result_ids, gt_ids):
        gset = set(int(x) for x in g if x >= 0)
        if not gset:
            continue
        hits += len(gset & set(int(x) for x in r if x >= 0))
        total += len(gset)
    return hits / max(total, 1)
