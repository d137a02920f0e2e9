"""Edge improvisation (Algorithm 1): the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/edge_select.py::
_edge_select_kernel`` (line 52), lazy dedup. The kernel is
``csrc/edge_select.cu``; its header says what bounds it on the H100
(memory: each frontier node's scanned edge ids, in two dependent round
trips) and what its design does about that (CTAs of eight warps, one
frontier row a warp; the scanned layers' ids copied into shared memory at
once, then selected there, as the fused hop's phase 1 does). The plain
version is ``kernels/ref.py::select_edges`` (``plain`` here); the two are
bit-identical.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["select_edges_cuda", "plain", "frontier_bounds", "edge_smem"]

plain = _ref.select_edges
MAX_LOGN = 30  # layers <= 31 fit one ballot; 1 << logn fits int32
WARPS = 8      # warps a CTA, one frontier row each (edge_select.cu kWarps)


def edge_smem(K: int, m_out: int) -> int:
    """Dynamic shared memory of one CTA (``csrc/edge_select.cu::
    edge_smem``): per warp its row's K edge ids, its m_out selected ids
    and the 32 scanned layers' indices; the CTA's (u, L, R)."""
    return (WARPS * (K + m_out + 32) + 3 * WARPS) * 4


@functools.cache
def _entry():
    f = _build.library("edge_select").rt_edge_select
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def frontier_bounds(L, R, F: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Broadcast scalar or [F] ranges to contiguous int32[F] on ``device``
    (ranges that already are, as the search passes them, pass as they
    are)."""
    return _bounds(L, F, device), _bounds(R, F, device)


def _bounds(x, F: int, device) -> torch.Tensor:
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32
            and x.shape == (F,) and x.device == device
            and x.is_contiguous()):
        return x
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.broadcast_to((F,)).contiguous()


def check_table(nbrs: torch.Tensor, logn: int, m_out: int, dev) -> None:
    _build.check_tensor(nbrs, "nbrs", torch.int32, 3, dev)
    if not 0 <= logn <= MAX_LOGN or nbrs.shape[1] != logn + 1:
        raise ValueError(
            f"nbrs has {nbrs.shape[1]} layers for logn={logn} "
            f"(the kernel takes logn <= {MAX_LOGN})"
        )
    if m_out < 1:
        raise ValueError(f"m_out must be >= 1, got {m_out}")


def select_edges_cuda(nbrs, us, L, R, *, logn, m_out, skip_layers=True):
    """nbrs int32[n, layers, m], us int32[F], L/R ints or int32[F] (CUDA)
    -> int32[F, m_out]. Launches the kernel or raises."""
    dev = us.device
    check_table(nbrs, logn, m_out, dev)
    _build.check_tensor(us, "us", torch.int32, 1, dev)
    F = us.shape[0]
    L, R = frontier_bounds(L, R, F, dev)
    n, layers, m = nbrs.shape
    out = torch.empty((F, m_out), dtype=torch.int32, device=dev)
    if F == 0:
        return out
    with torch.cuda.device(dev):
        rc = _entry()(nbrs.data_ptr(), us.data_ptr(), L.data_ptr(),
                      R.data_ptr(), out.data_ptr(), F, n, layers, m, logn,
                      int(bool(skip_layers)), m_out, _build.stream_of(dev))
    _build.check(rc, "edge_select", "select_edges")
    select_edges_cuda.launches += 1
    return out


select_edges_cuda.launches = 0
