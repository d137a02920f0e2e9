"""Storage codecs of the hot-path tables: compact floats, quantized vectors,
narrow and split neighbor ids.

The port's counterpart of ``repro/core/storage.py``. Every table is a torch
tensor, or a ``NamedTuple`` of tensors, on the index's device:

  * **Vectors** store as ``float32``, ``bfloat16`` (``torch.bfloat16``),
    ``float16``, per-vector scaled ``int8`` (:class:`Int8Vectors`: ``codes
    int8[n, d]`` + ``scales f32[n]``) or product quantization (:class:`PQVectors`:
    ``codes uint8[n, M]`` + ``codebook f32[M, 256, d/M]``). Distances are
    f32 everywhere: the CUDA kernels decode each row in registers
    (``csrc/common.cuh``), the plain versions through :func:`decode_rows`.
  * **Neighbor ids** store as ``int16`` when every id fits, ``int32``, or
    the segment-offset codec :class:`SplitNeighbors` (int8 offsets from the
    node's segment base on the layers whose segments hold <= 128 nodes).
    ``-1`` is the absent-edge marker in every dtype, the int8 offsets
    included, so decoding widens (and rebases) without a special case.
  * **Rerank sidecar**: an optional table (``rerank_dtype``) the search
    re-scores its top-``r`` candidates against.

Every encoding is bit-identical to ``repro``'s on the same f32 input. bf16
needs no ``ml_dtypes``: ``Tensor.to(torch.bfloat16)`` rounds to nearest
even as ``ml_dtypes`` does, and a bf16 table crosses numpy (files,
``to_numpy``) as its ``uint16`` bit pattern (:func:`to_numpy`,
:func:`as_tensor`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = [
    "StorageConfig",
    "np_dtype",
    "resolve_neighbor_dtype",
    "resolve_pq_m",
    "train_pq",
    "encode_vectors",
    "decode_vectors",
    "encode_neighbors",
    "decode_neighbors",
    "encode_rerank",
    "decode_rows",
    "table_n",
    "table_dim",
    "table_nbytes",
    "table_device",
    "to_device",
    "as_tensor",
    "as_table",
    "to_numpy",
    "split_layer",
    "Int8Vectors",
    "PQVectors",
    "SplitNeighbors",
    "NEIGHBOR_SENTINEL",
    "PQ_CENTROIDS",
]

# The one absent-edge marker, in every storage dtype.
NEIGHBOR_SENTINEL = -1

# Centroids per PQ subspace: one uint8 code book.
PQ_CENTROIDS = 256

# rows per step of the PQ encode on the device (memory: rows * M * 256 * 12 B)
PQ_ENCODE_CHUNK = 8192

_VECTOR_DTYPES = ("float32", "bfloat16", "float16", "int8", "pq")
_NEIGHBOR_DTYPES = ("auto", "int16", "int32", "split")
_RERANK_DTYPES = ("none", "int8", "bfloat16", "float16", "float32")

# bf16 crosses numpy as its uint16 bit pattern (no ml_dtypes needed)
_NP_DTYPES = {
    "float32": np.dtype(np.float32),
    "bfloat16": np.dtype(np.uint16),
    "float16": np.dtype(np.float16),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
}

_TORCH_FLOATS = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


class Int8Vectors(NamedTuple):
    """Per-vector symmetric int8 quantization: ``x ≈ codes * scales[:,None]``.

    codes:  int8[n, d], values in [-127, 127]
    scales: f32[n], ``max|x_i| / 127`` per row (1.0 for all-zero rows)
    """

    codes: Any
    scales: Any


class PQVectors(NamedTuple):
    """Product quantization: ``x[i] ≈ concat_j codebook[j, codes[i, j]]``.

    codes:    uint8[n, M] — per-subspace centroid index
    codebook: f32[M, 256, dsub] — per-subspace centroids, ``dsub = d // M``
    """

    codes: Any
    codebook: Any


class SplitNeighbors(NamedTuple):
    """Segment-offset neighbor codec.

    hi: int16/int32[n, split, m] — absolute ids, layers [0, split)
    lo: int8[n, logn+1-split, m] — offsets from the node's own layer-``l``
        segment base ``(u >> (logn-l)) << (logn-l)``, layers [split, logn];
        ``-1`` stays the absent-edge sentinel.
    """

    hi: Any
    lo: Any


_STRUCTS = (Int8Vectors, PQVectors, SplitNeighbors)


def split_layer(logn: int) -> int:
    """First layer whose segment offsets fit int8 (segment width <= 128)."""
    return max(0, logn - 7)


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    """Storage codecs for the hot-path tables (same fields, validation and
    presets as ``repro``'s, so a saved index's ``storage`` dict round-trips).

    vector_dtype:   "float32" | "bfloat16" | "float16" | "int8" | "pq".
    neighbor_dtype: "auto" | "int16" | "int32" | "split".
    rerank_dtype:   "none" | "int8" | "bfloat16" | "float16" | "float32".
    pq_m:           PQ subspaces (0 = auto: ``d // 4`` when 4 divides d).
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

    @classmethod
    def compact(cls, vector_dtype: str = "bfloat16") -> "StorageConfig":
        """The halved-footprint configuration (bf16 + narrow ids)."""
        return cls(vector_dtype=vector_dtype, neighbor_dtype="auto")

    @classmethod
    def int8(cls) -> "StorageConfig":
        """Scaled-int8 vectors + split neighbor offsets."""
        return cls(vector_dtype="int8", neighbor_dtype="split")

    @classmethod
    def pq(cls, pq_m: int = 0) -> "StorageConfig":
        """PQ navigation vectors + split offsets + int8 rerank sidecar."""
        return cls(vector_dtype="pq", neighbor_dtype="split",
                   rerank_dtype="int8", pq_m=pq_m)


def np_dtype(name: str) -> np.dtype:
    """Resolve a serialized dtype string; "bfloat16" resolves to its
    ``uint16`` bit pattern."""
    if name in _NP_DTYPES:
        return _NP_DTYPES[name]
    return np.dtype(name)


def resolve_neighbor_dtype(n: int, spec: str = "auto") -> np.dtype:
    """Narrowest id dtype for an ``n``-object table under ``spec``; for
    "split" the dtype of the wide (absolute-id) layers."""
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
    if spec in ("auto", "split"):
        return _NP_DTYPES["int16" if fits16 else "int32"]
    raise ValueError(f"neighbor_dtype {spec!r} not in {_NEIGHBOR_DTYPES}")


def _torch_int(dt: np.dtype) -> torch.dtype:
    return torch.int16 if dt == np.int16 else torch.int32


# ---------------------------------------------------------------------------
# numpy <-> torch (bf16 as its uint16 bit pattern)
# ---------------------------------------------------------------------------

def as_tensor(a, device=None) -> torch.Tensor:
    """numpy array or tensor -> contiguous tensor on ``device`` (default:
    where it is). A numpy ``bfloat16`` array (``ml_dtypes``) becomes a
    ``torch.bfloat16`` tensor through its bit pattern."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype.name == "bfloat16":
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            a = torch.from_numpy(a)
    return a.to(device=device).contiguous() if device is not None \
        else a.contiguous()


def to_numpy(t) -> np.ndarray:
    """Tensor -> numpy on the host; ``torch.bfloat16`` as ``uint16`` bits."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def as_table(table, device=None):
    """A table as the port holds it: tensors on ``device``, and any
    ``NamedTuple`` with the fields of a codec struct (``repro``'s too) as
    the port's struct. None stays None."""
    if table is None:
        return None
    fields = getattr(table, "_fields", None)
    for cls in _STRUCTS:
        if fields == cls._fields:
            return cls(*(as_tensor(leaf, device) for leaf in table))
    return as_tensor(table, device)


def to_device(table, device):
    """Move every leaf of a (possibly codec-struct) table to ``device``:
    the counterpart of ``repro``'s ``as_device``."""
    if table is None:
        return None
    if isinstance(table, _STRUCTS):
        return type(table)(*(leaf.to(device) for leaf in table))
    return table.to(device)


# ---------------------------------------------------------------------------
# vector codecs
# ---------------------------------------------------------------------------

def _f32(vectors) -> torch.Tensor:
    return as_tensor(vectors).to(torch.float32)


def _encode_int8(vectors) -> Int8Vectors:
    v = _f32(vectors)
    amax = v.abs().amax(dim=1)
    # divide by a tensor: a Python-scalar divisor on CUDA becomes a product
    # with its rounded reciprocal, which is not numpy's quotient
    scales = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                         torch.ones_like(amax)).to(torch.float32)
    codes = torch.clamp(torch.round(v / scales[:, None]), -127, 127)
    return Int8Vectors(codes.to(torch.int8).contiguous(), scales.contiguous())


def resolve_pq_m(d: int, pq_m: int = 0) -> int:
    """Subspace count: explicit (must divide d) or auto ``d // 4``."""
    if pq_m:
        if d % pq_m:
            raise ValueError(f"pq_m={pq_m} does not divide d={d}")
        return pq_m
    return d // 4 if d % 4 == 0 and d >= 4 else d


def _numpy_sum_last(terms: list) -> torch.Tensor:
    """Sum ``terms`` (equal-shape tensors, one per position of a last axis)
    in the order numpy's ``sum(-1)`` adds a contiguous float32 axis: left
    to right below 8 terms; 8 running sums combined pairwise, then the
    remainder left to right, up to 128; halves (a multiple of 8 first)
    above that. Each add is one IEEE operation, so any device gives
    numpy's bits."""
    n = len(terms)
    if n < 8:
        res = terms[0]
        for t in terms[1:]:
            res = res + t
        return res
    if n <= 128:
        r = list(terms[:8])
        i = 8
        while i < n - n % 8:
            r = [r[j] + terms[i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for t in terms[i:]:
            res = res + t
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _numpy_sum_last(terms[:n2]) + _numpy_sum_last(terms[n2:])


def _pq_assign(sub: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row, per subspace: sub f32[c, M, dsub],
    cent f32[M, K, dsub] -> int64[c, M]. Squared distances summed in
    numpy's order (:func:`_numpy_sum_last`); ties to the lowest index, as
    ``argmin`` promises in both libraries."""
    terms = []
    for t in range(sub.shape[2]):
        diff = sub[:, :, None, t] - cent[None, :, :, t]     # [c, M, K]
        terms.append(diff * diff)
    return _numpy_sum_last(terms).argmin(dim=2)


def train_pq(vectors, pq_m: int = 0, *, seed: int = 0, iters: int = 8,
             sample: int = 4096, chunk: int = PQ_ENCODE_CHUNK) -> PQVectors:
    """Deterministic per-subspace k-means PQ, bit-identical to ``repro``'s
    ``train_pq`` (same seeded sample, init and ``iters`` Lloyd iterations).

    The training runs in numpy on the host exactly as ``repro`` runs it,
    on at most ``sample`` rows fetched from the table's device. The encode
    of all n rows runs on the table's device, ``chunk`` rows at a time,
    with every subspace's squared distances summed in numpy's own order
    for any ``dsub`` (left to right below 8 terms, pairwise above:
    :func:`_numpy_sum_last`), so the codes are numpy's. Returns the codes
    and codebook on the table's device.
    """
    v = _f32(vectors)
    dev = v.device
    n, d = v.shape
    M = resolve_pq_m(d, pq_m)
    dsub = d // M
    rng = np.random.default_rng(seed)
    train_idx = (np.arange(n) if n <= sample
                 else rng.choice(n, sample, replace=False))
    train_all = to_numpy(v[torch.as_tensor(train_idx, device=dev)])
    codebook = np.empty((M, PQ_CENTROIDS, dsub), np.float32)
    for j in range(M):
        train = np.ascontiguousarray(train_all[:, j * dsub:(j + 1) * dsub])
        init = rng.choice(train.shape[0], PQ_CENTROIDS,
                          replace=train.shape[0] < PQ_CENTROIDS)
        cent = train[init].copy()
        for _ in range(iters):
            d2 = ((train[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(1)
            for c in range(PQ_CENTROIDS):
                sel = assign == c
                if sel.any():
                    cent[c] = train[sel].mean(0)
        codebook[j] = cent
    cb = torch.from_numpy(codebook).to(dev)
    codes = torch.empty((n, M), dtype=torch.uint8, device=dev)
    for s in range(0, n, max(1, int(chunk))):
        e = min(n, s + max(1, int(chunk)))
        sub = v[s:e].reshape(e - s, M, dsub)
        codes[s:e] = _pq_assign(sub, cb).to(torch.uint8)
    return PQVectors(codes, cb.contiguous())


def encode_vectors(vectors, cfg: StorageConfig):
    """f32 vector table (tensor or numpy) -> its storage representation on
    the same device: a tensor for the float codecs, :class:`Int8Vectors` /
    :class:`PQVectors` for the quantized ones."""
    if cfg.vector_dtype == "int8":
        return _encode_int8(vectors)
    if cfg.vector_dtype == "pq":
        return train_pq(vectors, cfg.pq_m)
    v = as_tensor(vectors)
    return v.to(_TORCH_FLOATS[cfg.vector_dtype]).contiguous()


def decode_vectors(vectors) -> torch.Tensor:
    """Whole vector table -> f32 tensor on its device (``brute_force``,
    re-encoding)."""
    if isinstance(vectors, (Int8Vectors, PQVectors)):
        n = table_n(vectors)
        return decode_rows(vectors, torch.arange(
            n, device=table_device(vectors)))
    return as_tensor(vectors).to(torch.float32)


def decode_rows(table, ids) -> torch.Tensor:
    """Gather + decode rows -> f32, for non-negative ``ids`` (callers clamp
    and mask). The contract the CUDA kernels' in-register decode is held
    against: int8 is ``float(code) * scale``, one rounding; PQ concatenates
    the codebook rows of each subspace."""
    if isinstance(table, Int8Vectors):
        x = table.codes[ids].to(torch.float32)
        return x * table.scales[ids][..., None]
    if isinstance(table, PQVectors):
        cb = table.codebook
        M, _, dsub = cb.shape
        codes = table.codes[ids].long()                       # [..., M]
        out = cb[torch.arange(M, device=cb.device), codes]    # [..., M, dsub]
        return out.reshape(*codes.shape[:-1], M * dsub).to(torch.float32)
    return table[ids].to(torch.float32)


def encode_rerank(vectors, cfg: StorageConfig):
    """f32 vector table -> the rerank sidecar, or None for "none"."""
    if cfg.rerank_dtype == "none":
        return None
    if cfg.rerank_dtype == "int8":
        return _encode_int8(vectors)
    return as_tensor(vectors).to(_TORCH_FLOATS[cfg.rerank_dtype]).contiguous()


# ---------------------------------------------------------------------------
# neighbor codecs
# ---------------------------------------------------------------------------

def _encode_split(nbrs: torch.Tensor, n: int) -> SplitNeighbors:
    nodes, layers, m = nbrs.shape
    logn = layers - 1
    split = split_layer(logn)
    dev = nbrs.device
    hi = nbrs[:, :split, :].to(
        _torch_int(resolve_neighbor_dtype(n, "split"))).contiguous()
    u = torch.arange(nodes, dtype=torch.int64, device=dev)
    shifts = logn - torch.arange(split, layers, dtype=torch.int64,
                                 device=dev)                  # [nl], <= 7
    base = (u[:, None] >> shifts[None, :]) << shifts[None, :]  # [nodes, nl]
    narrow = nbrs[:, split:, :].to(torch.int64)
    off = narrow - base[:, :, None]
    absent = narrow < 0
    width = (1 << shifts)[None, :, None]                     # <= 128
    bad = ~absent & ((off < 0) | (off > width - 1))
    if bool(bad.any()):
        l_bad = split + int(torch.nonzero(bad)[0][1])
        raise ValueError(
            f"neighbor_dtype='split' requires segment-aligned edges: layer "
            f"{l_bad} has an edge outside its node's segment"
        )
    lo = torch.where(absent, -1, off).to(torch.int8)
    return SplitNeighbors(hi, lo.contiguous())


def encode_neighbors(nbrs, n: int, cfg: StorageConfig):
    """Neighbor table (tensor or numpy) -> its storage codec on the same
    device. ``-1`` stays ``-1``."""
    nbrs = as_tensor(nbrs)
    if nbrs.numel():
        top = int(nbrs.max())
        if top >= n:
            raise ValueError(f"neighbor id {top} out of range for n={n}")
    if cfg.neighbor_dtype == "split":
        return _encode_split(nbrs, n)
    tdt = _torch_int(resolve_neighbor_dtype(n, cfg.neighbor_dtype))
    return nbrs if nbrs.dtype == tdt else nbrs.to(tdt).contiguous()


def _decode_split(sn: SplitNeighbors) -> torch.Tensor:
    hi, lo = sn.hi, sn.lo
    nodes = hi.shape[0]
    split = hi.shape[1]
    layers = split + lo.shape[1]
    logn = layers - 1
    dev = lo.device
    u = torch.arange(nodes, dtype=torch.int32, device=dev)
    shifts = logn - torch.arange(split, layers, dtype=torch.int32, device=dev)
    base = (u[:, None] >> shifts[None, :]) << shifts[None, :]  # [nodes, nl]
    narrow = lo.to(torch.int32)
    absn = torch.where(narrow < 0, -1, narrow + base[:, :, None])
    return torch.cat([hi.to(torch.int32), absn], dim=1)


def decode_neighbors(nbrs) -> torch.Tensor:
    """Neighbor table -> int32 tensor; a no-op when already int32. Split
    tables widen and rebase (offset plus the closed-form segment base)."""
    if isinstance(nbrs, SplitNeighbors):
        return _decode_split(nbrs)
    nbrs = as_tensor(nbrs)
    return nbrs if nbrs.dtype == torch.int32 else nbrs.to(torch.int32)


# ---------------------------------------------------------------------------
# table introspection: the struct-safe shape / bytes / device accessors
# ---------------------------------------------------------------------------

def table_n(table) -> int:
    """Row count of a (possibly codec-struct) vector or neighbor table."""
    if isinstance(table, (Int8Vectors, PQVectors)):
        return int(table.codes.shape[0])
    if isinstance(table, SplitNeighbors):
        return int(table.hi.shape[0])
    return int(table.shape[0])


def table_dim(table) -> int:
    """Decoded vector dimensionality of a (possibly codec-struct) table."""
    if isinstance(table, Int8Vectors):
        return int(table.codes.shape[1])
    if isinstance(table, PQVectors):
        M, _, dsub = table.codebook.shape
        return int(M * dsub)
    return int(table.shape[1])


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def table_nbytes(table) -> int:
    """Stored bytes of a table, summed over codec-struct leaves; 0 for
    None."""
    if table is None:
        return 0
    if isinstance(table, _STRUCTS):
        return sum(_leaf_nbytes(leaf) for leaf in table)
    return _leaf_nbytes(table)


def table_device(table) -> torch.device:
    """The device a (possibly codec-struct) table lives on."""
    return (table[0] if isinstance(table, _STRUCTS) else table).device
