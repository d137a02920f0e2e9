"""All-pairs distance: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/distance.py::_dist_kernel`` (line
26). The kernel is ``csrc/distance.cu``; its header says what bounds it on
the H100 and what its two bodies do about that:

  * ``"tf32x3"``: f32 inputs on the tensor cores -- persistent blocks over
    64 x 128 output tiles, each value split into a tf32 part and an f32
    rest and three TF32 products summed in f32, the norms in the same
    K-loop, the output written straight from the accumulator;
  * ``"cuda_cores"``: bf16 / f16 inputs, widened to f32, every dot one f32
    FMA chain in k order (the plain version's order, which the half types'
    card gate needs where a dot cancels to near 0).

``pairwise_dist_cuda.body_launches`` counts the launches of each body. The
plain version is ``kernels/ref.py::pairwise_dist`` (``plain`` here).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["pairwise_dist_cuda", "plain", "grid_of", "TILE"]

plain = _ref.pairwise_dist
_METRICS = {"l2": 0, "ip": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BODY = {torch.float32: "tf32x3", torch.bfloat16: "cuda_cores",
         torch.float16: "cuda_cores"}
TILE = (64, 128)          # tf32x3: queries x rows of x per output tile
_MAX_TILES = 2 ** 31 - 1
_MAX_BQ_CUDA_CORES = 65535 * 64   # the grid's y extent times the tile


def grid_of(Bq: int, N: int) -> int:
    """Output tiles of the tf32x3 body (its blocks walk them)."""
    return -(-Bq // TILE[0]) * -(-N // TILE[1])


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
    if _BODY[q.dtype] == "tf32x3" and grid_of(Bq, N) > _MAX_TILES:
        raise ValueError(f"pairwise_dist: Bq={Bq} x N={N} needs more than "
                         f"{_MAX_TILES} tiles")
    if _BODY[q.dtype] == "cuda_cores" and Bq > _MAX_BQ_CUDA_CORES:
        raise ValueError(f"pairwise_dist: Bq={Bq} above "
                         f"{_MAX_BQ_CUDA_CORES}")
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
    pairwise_dist_cuda.body_launches[_BODY[q.dtype]] += 1
    return out


pairwise_dist_cuda.launches = 0
pairwise_dist_cuda.body_launches = {"tf32x3": 0, "cuda_cores": 0}
