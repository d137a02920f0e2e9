"""Gather + masked distance: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/gather_distance.py::
_gather_dist_kernel`` (line 48). The kernel is ``csrc/gather_distance.cu``;
its header says what bounds it on the H100 (memory: one random d*4-byte
row per valid id) and what its design does about that (one warp per id,
16-byte coalesced loads, no padding and no MXU-style diagonal extract).
The plain version is ``kernels/ref.py::gather_dist`` (``plain`` here).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["gather_dist_cuda", "plain"]

plain = _ref.gather_dist
_METRICS = {"l2": 0, "ip": 1}


@functools.cache
def _entry():
    f = _build.library("gather_distance").rt_gather_dist
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def gather_dist_cuda(q, table, ids, *, metric="l2"):
    """q f32[B, d], table f32[n, d], ids int32[B, M] (-1 masked), all on
    one CUDA device -> f32[B, M]. Launches the kernel or raises."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dev = q.device
    _build.check_tensor(q, "q", torch.float32, 2, dev)
    _build.check_tensor(table, "table", torch.float32, 2, dev)
    _build.check_tensor(ids, "ids", torch.int32, 2, dev)
    B, d = q.shape
    n = table.shape[0]
    M = ids.shape[1]
    if table.shape[1] != d or ids.shape[0] != B:
        raise ValueError(
            f"shapes q{tuple(q.shape)} table{tuple(table.shape)} "
            f"ids{tuple(ids.shape)} do not agree"
        )
    out = torch.empty((B, M), dtype=torch.float32, device=dev)
    if B == 0 or M == 0:
        return out
    with torch.cuda.device(dev):
        rc = _entry()(q.data_ptr(), table.data_ptr(), ids.data_ptr(),
                      out.data_ptr(), B, M, d, n, _METRICS[metric],
                      _build.stream_of(dev))
    _build.check(rc, "gather_distance", "gather_dist")
    gather_dist_cuda.launches += 1
    return out


gather_dist_cuda.launches = 0
