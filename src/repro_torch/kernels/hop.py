"""One whole beam-search hop: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/hop.py::_hop_kernel`` (line 61)
in every stored layout of the vector table (f32, bf16, f16, ``Int8Vectors``,
``PQVectors``: the TPU kernel's static ``codec`` bodies, lines 180-232).
The kernel is ``csrc/hop.cu``; it runs the selection of the edge-select
kernel and the distances of the gather-distance kernel (``csrc/common.cuh``),
so its outputs are bit-identical to the composed hop's. Its header says
what bounds it on the H100 (memory and a chain of dependent round trips:
edge ids, visited words, the stored rows of newly visited ids) and what its
design does about that (one CTA per query; the scanned layers' edge ids
copied into shared memory at once; the visited row read and ``atomicOr``-ed
in global memory, one thread a slot; the new rows' loads all in flight).
Its launch plan is ``gather_distance.plan`` with the hop's edges. The plain
version is ``kernels/ref.py::hop`` (``plain`` here).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import edge_select as _edge
from repro_torch.kernels import gather_distance as _gather
from repro_torch.kernels import ref as _ref

__all__ = ["hop_cuda", "plain"]

plain = _ref.hop
_METRICS = {"l2": 0, "ip": 1}


@functools.cache
def _entry():
    f = _build.library("hop").rt_hop
    f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 14 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def hop_cuda(q, table, nbrs, u, L, R, visited, exp_ok, *, logn, m_out,
             skip_layers=True, metric="l2"):
    """The fused hop on CUDA tensors: q f32[B, d], table in any stored
    layout (``gather_distance.table_args``), nbrs int32[n, layers, m],
    u int32[B, W], L/R int32[B*W] (or ints), visited int32[B,
    ceil(n/32)], exp_ok bool[B, W].

    Returns ``(nbr int32[B, W*m_out], ndist f32[B, W*m_out],
    nvalid bool[B, W*m_out], visited)``; ``visited`` is updated IN PLACE
    and returned. Launches the kernel of the table's layout or raises.
    """
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dev = q.device
    _build.check_tensor(q, "q", torch.float32, 2, dev)
    t = _gather.table_args(table, dev)
    _edge.check_table(nbrs, logn, m_out, dev)
    _build.check_tensor(u, "u", torch.int32, 2, dev)
    _build.check_tensor(visited, "visited", torch.int32, 2, dev)
    _build.check_tensor(exp_ok, "exp_ok", torch.bool, 2, dev)
    B, W = u.shape
    n, d = t.n, t.d
    words = visited.shape[1]
    if (q.shape[0] != B or tuple(exp_ok.shape) != (B, W)
            or visited.shape[0] != B or words * 32 < n
            or nbrs.shape[0] != n or q.shape[1] != d):
        raise ValueError("hop: shapes do not agree")
    L, R = _edge.frontier_bounds(L, R, B * W, dev)
    WM = W * m_out
    nbr = torch.empty((B, WM), dtype=torch.int32, device=dev)
    ndist = torch.empty((B, WM), dtype=torch.float32, device=dev)
    nvalid = torch.empty((B, WM), dtype=torch.bool, device=dev)
    if B == 0 or W == 0:
        return nbr, ndist, nvalid, visited
    layers, m = nbrs.shape[1], nbrs.shape[2]
    p = _gather.plan(B, WM, t.layout, d, _gather.rows_vec(t),
                     hop=(W, layers * m))
    with _build.on_device(dev):
        rc = _entry()(q.data_ptr(), t.data.data_ptr(), t.aux_ptr,
                      nbrs.data_ptr(), u.data_ptr(), L.data_ptr(),
                      R.data_ptr(), visited.data_ptr(), exp_ok.data_ptr(),
                      nbr.data_ptr(), ndist.data_ptr(), nvalid.data_ptr(),
                      B, W, n, d, t.sub, t.code, layers, m, logn,
                      int(bool(skip_layers)), m_out, words, _METRICS[metric],
                      p.warps, _build.stream_of(dev))
    _build.check(rc, "hop", "hop")
    hop_cuda.launches += 1
    hop_cuda.layout_launches[t.layout] += 1
    return nbr, ndist, nvalid, visited


hop_cuda.launches = 0
hop_cuda.layout_launches = dict.fromkeys(_gather.LAYOUTS, 0)
