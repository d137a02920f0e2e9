"""All-pairs distance: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/distance.py::_dist_kernel`` (line
26). The kernel is ``csrc/distance.cu``; its header says what bounds it on
the H100 (operations: D/2 flops per output byte) and what its design does
about that (64x64 output tiles, K-tiles staged in shared memory as f32, a
4x4 register tile of f32 FFMAs per thread, the norms summed in the same
K-loop; no TF32). The plain version is ``kernels/ref.py::pairwise_dist``
(``plain`` here).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["pairwise_dist_cuda", "plain"]

plain = _ref.pairwise_dist
_METRICS = {"l2": 0, "ip": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_BQ = 65535 * 64      # the grid's y extent times the tile


@functools.cache
def _entry():
    f = _build.library("distance").rt_pairwise_dist
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def pairwise_dist_cuda(q, x, *, metric="l2"):
    """q [Bq, D], x [N, D], both f32, bf16 or f16 of one dtype, contiguous
    on one CUDA device -> f32[Bq, N]. Launches the kernel or raises."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if not isinstance(q, torch.Tensor) or q.dtype not in _DTYPES:
        raise TypeError("pairwise_dist: q must be a float32, bfloat16 or "
                        "float16 tensor")
    dev = q.device
    _build.check_tensor(q, "q", q.dtype, 2, dev)
    _build.check_tensor(x, "x", q.dtype, 2, dev)
    Bq, D = q.shape
    N, Dx = x.shape
    if Dx != D:
        raise ValueError(f"shapes q{tuple(q.shape)} x{tuple(x.shape)} do "
                         "not agree")
    if Bq > _MAX_BQ:
        raise ValueError(f"pairwise_dist: Bq={Bq} above {_MAX_BQ}")
    out = torch.empty((Bq, N), dtype=torch.float32, device=dev)
    if Bq == 0 or N == 0:
        return out
    if D == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        rc = _entry()(q.data_ptr(), x.data_ptr(), out.data_ptr(), Bq, N, D,
                      _DTYPES[q.dtype], _METRICS[metric],
                      _build.stream_of(dev))
    _build.check(rc, "distance", "pairwise_dist")
    pairwise_dist_cuda.launches += 1
    return out


pairwise_dist_cuda.launches = 0
