"""alpha-RNG construction prune: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/prune.py::_prune_kernel`` (line
44). The kernel is ``csrc/prune.cu``; its header says what bounds it on the
H100 (memory: each build node's C candidate rows) and what its design does
about that (one block per node, the rows gathered once into shared memory,
every sweep served from there). The plain version is
``kernels/ref.py::prune`` (``plain`` here).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["prune_cuda", "plain", "smem_bytes"]

plain = _ref.prune
SMEM_LIMIT = 232448  # the H100's per-block shared-memory ceiling


def smem_bytes(C: int, d: int) -> int:
    """Dynamic shared memory the kernel needs for C candidates of dim d."""
    dp = (d + 3) // 4 * 4
    return C * dp * 4 + C * 13


@functools.cache
def _entry():
    f = _build.library("prune").rt_prune
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def prune_cuda(cand_ids, cand_dists, table, *, m, alpha=1.0, fill=True):
    """cand_ids int32[B, C], cand_dists f32[B, C], table f32[n, d] (CUDA)
    -> int32[B, m] kept ids, -1 padded. Launches the kernel or raises."""
    dev = cand_ids.device
    _build.check_tensor(cand_ids, "cand_ids", torch.int32, 2, dev)
    _build.check_tensor(cand_dists, "cand_dists", torch.float32, 2, dev)
    _build.check_tensor(table, "table", torch.float32, 2, dev)
    B, C = cand_ids.shape
    n, d = table.shape
    if tuple(cand_dists.shape) != (B, C):
        raise ValueError("prune: cand_ids and cand_dists shapes differ")
    if smem_bytes(C, d) > SMEM_LIMIT:
        raise ValueError(
            f"prune: C={C} candidates of d={d} need {smem_bytes(C, d)} B "
            f"of shared memory (limit {SMEM_LIMIT})"
        )
    out = torch.empty((B, m), dtype=torch.int32, device=dev)
    if B == 0 or m == 0:
        return out
    if C == 0:
        return out.fill_(-1)
    with torch.cuda.device(dev):
        rc = _entry()(cand_ids.data_ptr(), cand_dists.data_ptr(),
                      table.data_ptr(), out.data_ptr(), B, C, d, n, m,
                      float(alpha), int(bool(fill)), _build.stream_of(dev))
    _build.check(rc, "prune", "prune")
    prune_cuda.launches += 1
    return out


prune_cuda.launches = 0
