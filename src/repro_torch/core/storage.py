"""Storage codecs of the hot-path tables: the uncompressed subset.

The port's counterpart of ``repro/core/storage.py``. This slice carries the
full-width layouts only:

  * vectors as ``float32``;
  * neighbor ids as ``int32``, or ``int16`` when every id fits
    (``neighbor_dtype="auto"`` / ``"int16"``).

``-1`` is the absent-edge marker in every neighbor dtype, so decoding a
narrow table is a widening cast. The compact and quantized codecs (bf16/f16
vectors, ``Int8Vectors``, ``PQVectors``, ``SplitNeighbors``, the rerank
sidecar) raise ``NotImplementedError``: they are ROADMAP queue 1 item 7
(storage codecs).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "StorageConfig",
    "np_dtype",
    "resolve_neighbor_dtype",
    "encode_vectors",
    "encode_neighbors",
    "decode_neighbors",
    "table_n",
    "table_dim",
    "table_nbytes",
    "NEIGHBOR_SENTINEL",
]

# The one absent-edge marker, in every storage dtype.
NEIGHBOR_SENTINEL = -1

_VECTOR_DTYPES = ("float32", "bfloat16", "float16", "int8", "pq")
_NEIGHBOR_DTYPES = ("auto", "int16", "int32", "split")
_RERANK_DTYPES = ("none", "int8", "bfloat16", "float16", "float32")

_NP_DTYPES = {
    "float32": np.dtype(np.float32),
    "float16": np.dtype(np.float16),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
}

_CODEC_TODO = "ROADMAP queue 1 item 7 (storage codecs)"


def _codec_missing(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: see {_CODEC_TODO}"
    )


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    """Storage codecs for the hot-path tables (same fields and validation
    as ``repro``'s, so a saved index's ``storage`` dict round-trips).

    This slice stores ``vector_dtype="float32"``, ``rerank_dtype="none"``
    and ``neighbor_dtype`` in ``"int32" | "int16" | "auto"``; the other
    values validate but raise ``NotImplementedError`` when used.
    """

    vector_dtype: str = "float32"
    neighbor_dtype: str = "int32"
    rerank_dtype: str = "none"
    pq_m: int = 0

    def __post_init__(self):
        if self.vector_dtype not in _VECTOR_DTYPES:
            raise ValueError(
                f"vector_dtype {self.vector_dtype!r} not in {_VECTOR_DTYPES}"
            )
        if self.neighbor_dtype not in _NEIGHBOR_DTYPES:
            raise ValueError(
                f"neighbor_dtype {self.neighbor_dtype!r} not in "
                f"{_NEIGHBOR_DTYPES}"
            )
        if self.rerank_dtype not in _RERANK_DTYPES:
            raise ValueError(
                f"rerank_dtype {self.rerank_dtype!r} not in {_RERANK_DTYPES}"
            )
        if self.pq_m < 0:
            raise ValueError(f"pq_m must be >= 0, got {self.pq_m}")

    def check_supported(self) -> "StorageConfig":
        """Raise ``NotImplementedError`` for the codecs this slice lacks."""
        if self.vector_dtype != "float32":
            raise _codec_missing(f"vector_dtype={self.vector_dtype!r}")
        if self.neighbor_dtype == "split":
            raise _codec_missing("neighbor_dtype='split' (SplitNeighbors)")
        if self.rerank_dtype != "none":
            raise _codec_missing(f"rerank_dtype={self.rerank_dtype!r}")
        return self


def np_dtype(name: str) -> np.dtype:
    """Resolve a serialized dtype string; bf16 needs the codec slice."""
    if name in _NP_DTYPES:
        return _NP_DTYPES[name]
    if name == "bfloat16":
        raise _codec_missing("bfloat16 arrays")
    return np.dtype(name)


def resolve_neighbor_dtype(n: int, spec: str = "auto") -> np.dtype:
    """Narrowest id dtype for an ``n``-object table under ``spec``."""
    fits16 = n - 1 <= np.iinfo(np.int16).max
    if spec == "int32":
        return _NP_DTYPES["int32"]
    if spec == "int16":
        if not fits16:
            raise ValueError(
                f"neighbor_dtype=int16 cannot hold ids up to {n - 1} "
                f"(max {np.iinfo(np.int16).max})"
            )
        return _NP_DTYPES["int16"]
    if spec == "auto":
        return _NP_DTYPES["int16" if fits16 else "int32"]
    if spec == "split":
        raise _codec_missing("neighbor_dtype='split' (SplitNeighbors)")
    raise ValueError(f"neighbor_dtype {spec!r} not in {_NEIGHBOR_DTYPES}")


def encode_vectors(vectors, cfg: StorageConfig) -> np.ndarray:
    """Vector table -> its storage representation (f32 only here)."""
    cfg.check_supported()
    return np.ascontiguousarray(np.asarray(vectors, np.float32))


def encode_neighbors(nbrs, n: int, cfg: StorageConfig):
    """Neighbor table (numpy, or torch on any device) -> its storage
    dtype, same kind as the input. ``-1`` stays ``-1``."""
    dt = resolve_neighbor_dtype(n, cfg.neighbor_dtype)
    if isinstance(nbrs, torch.Tensor):
        top = int(nbrs.max()) if nbrs.numel() else -1
        if top >= n:
            raise ValueError(f"neighbor id {top} out of range for n={n}")
        tdt = torch.int16 if dt == np.int16 else torch.int32
        return nbrs if nbrs.dtype == tdt else nbrs.to(tdt).contiguous()
    nbrs = np.asarray(nbrs)
    if nbrs.size and int(nbrs.max(initial=-1)) >= n:
        raise ValueError(
            f"neighbor id {int(nbrs.max())} out of range for n={n}"
        )
    if nbrs.dtype == dt:
        return nbrs
    return np.ascontiguousarray(nbrs.astype(dt))


def decode_neighbors(nbrs):
    """Neighbor table (numpy or torch) -> int32; a no-op when already
    int32. ``-1`` is the sentinel in every dtype, so this is a cast."""
    if isinstance(nbrs, torch.Tensor):
        return nbrs if nbrs.dtype == torch.int32 else nbrs.to(torch.int32)
    nbrs = np.asarray(nbrs)
    return nbrs if nbrs.dtype == np.int32 else nbrs.astype(np.int32)


def table_n(table) -> int:
    """Row count of a vector or neighbor table."""
    return int(table.shape[0])


def table_dim(table) -> int:
    """Vector dimensionality of a vector table."""
    return int(table.shape[1])


def table_nbytes(table) -> int:
    """Stored bytes of a table (numpy or torch); 0 for None."""
    if table is None:
        return 0
    if isinstance(table, torch.Tensor):
        return table.numel() * table.element_size()
    return int(np.asarray(table).nbytes)
