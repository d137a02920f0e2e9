"""Gather + masked distance: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/gather_distance.py::
_gather_dist_kernel`` (line 48) in every stored layout: f32, bf16 and f16
tables, ``Int8Vectors`` and ``PQVectors`` (the TPU kernel's static
``codec`` bodies, lines 98-110). The kernel is ``csrc/gather_distance.cu``;
its header says what bounds it on the H100 (memory: one random stored row
per valid id) and what its design does about that (one warp per id,
coalesced loads, the decode in registers, no padding and no MXU-style
diagonal extract). The plain version is ``kernels/ref.py::gather_dist``
(``plain`` here).

:func:`table_args` checks a table's every leaf and names its layout; the
hop's wrapper uses it too. Each wrapper counts its launches in total
(``launches``) and per layout (``layout_launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import storage as _storage
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["gather_dist_cuda", "plain", "LAYOUTS", "table_args"]

plain = _ref.gather_dist
_METRICS = {"l2": 0, "ip": 1}
# the stored layouts, in the order of csrc/common.cuh's Layout codes
LAYOUTS = ("f32", "bf16", "f16", "int8", "pq")
_FLOAT_LAYOUTS = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.float16: "f16"}


class TableArgs(NamedTuple):
    """A vector table as the kernels take it (``rt::Rows``)."""

    layout: str          # one of LAYOUTS
    data: torch.Tensor   # rows, or the int8 / PQ codes
    aux: torch.Tensor | None  # int8 scales, PQ codebook, else None
    n: int
    d: int
    sub: int             # PQ subspaces, else 0

    @property
    def code(self) -> int:
        return LAYOUTS.index(self.layout)

    @property
    def aux_ptr(self) -> int | None:
        return None if self.aux is None else self.aux.data_ptr()


def table_args(table, device: torch.device) -> TableArgs:
    """Check every leaf of ``table`` (dtype, rank, device, contiguity,
    agreeing shapes) and name its layout; raise on anything the kernels do
    not take."""
    if isinstance(table, _storage.Int8Vectors):
        _build.check_tensor(table.codes, "table.codes", torch.int8, 2, device)
        _build.check_tensor(table.scales, "table.scales", torch.float32, 1,
                            device)
        n, d = table.codes.shape
        if table.scales.shape[0] != n:
            raise ValueError(
                f"table: {n} code rows but {table.scales.shape[0]} scales")
        return TableArgs("int8", table.codes, table.scales, n, d, 0)
    if isinstance(table, _storage.PQVectors):
        _build.check_tensor(table.codes, "table.codes", torch.uint8, 2,
                            device)
        _build.check_tensor(table.codebook, "table.codebook", torch.float32,
                            3, device)
        n, M = table.codes.shape
        Mc, K, dsub = table.codebook.shape
        if Mc != M or K != _storage.PQ_CENTROIDS or dsub < 1:
            raise ValueError(
                f"table: codes [{n}, {M}] and codebook "
                f"{list(table.codebook.shape)} do not agree")
        return TableArgs("pq", table.codes, table.codebook, n, M * dsub, M)
    if isinstance(table, torch.Tensor) and table.dtype in _FLOAT_LAYOUTS:
        _build.check_tensor(table, "table", table.dtype, 2, device)
        n, d = table.shape
        return TableArgs(_FLOAT_LAYOUTS[table.dtype], table, None, n, d, 0)
    what = table.dtype if isinstance(table, torch.Tensor) \
        else type(table).__name__
    raise TypeError(
        f"table: {what} is not a stored layout the kernels take "
        "(float32/bfloat16/float16 tensor, Int8Vectors or PQVectors)")


@functools.cache
def _entry():
    f = _build.library("gather_distance").rt_gather_dist
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def gather_dist_cuda(q, table, ids, *, metric="l2"):
    """q f32[B, d], table in any stored layout (see :func:`table_args`),
    ids int32[B, M] (-1 masked), all on one CUDA device -> f32[B, M].
    Launches the kernel of the table's layout or raises."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dev = q.device
    _build.check_tensor(q, "q", torch.float32, 2, dev)
    t = table_args(table, dev)
    _build.check_tensor(ids, "ids", torch.int32, 2, dev)
    B, d = q.shape
    M = ids.shape[1]
    if t.d != d or ids.shape[0] != B:
        raise ValueError(
            f"shapes q{tuple(q.shape)} table[{t.n}, {t.d}] "
            f"ids{tuple(ids.shape)} do not agree"
        )
    out = torch.empty((B, M), dtype=torch.float32, device=dev)
    if B == 0 or M == 0:
        return out
    with torch.cuda.device(dev):
        rc = _entry()(q.data_ptr(), t.data.data_ptr(), t.aux_ptr,
                      ids.data_ptr(), out.data_ptr(), B, M, d, t.n, t.sub,
                      t.code, _METRICS[metric], _build.stream_of(dev))
    _build.check(rc, "gather_distance", "gather_dist")
    gather_dist_cuda.launches += 1
    gather_dist_cuda.layout_launches[t.layout] += 1
    return out


gather_dist_cuda.launches = 0
gather_dist_cuda.layout_launches = dict.fromkeys(LAYOUTS, 0)
