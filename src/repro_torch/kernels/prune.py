"""alpha-RNG construction prune: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/prune.py::_prune_kernel`` (line
44) with its codec body (lines 95-105, set-up 207-219): the table may be
stored in any layout the search kernels take (f32, bf16, f16,
``Int8Vectors``, ``PQVectors``). The kernel is ``csrc/prune.cu``; its
header says what bounds it on the H100 (memory: each build node's C
candidate rows) and what its design does about that (one block per node,
the rows gathered and decoded once, as many as fit into shared memory as
f32 and the rest decoded from global memory by the sweeps). The plain
version is ``kernels/ref.py::prune`` (``plain`` here), which decodes
through ``storage.decode_rows``. The wrapper counts its launches in total
(``launches``) and per layout (``layout_launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gather_distance as _gather
from repro_torch.kernels import ref as _ref

__all__ = ["prune_cuda", "plain", "smem_plan"]

plain = _ref.prune
# the H100's per-block shared-memory ceiling (232,448 B), less what the
# kernel declares statically (its argmin scratch)
SMEM_LIMIT = 232448 - 256


def smem_plan(C: int, d: int) -> tuple[int, int]:
    """``(staged, bytes)``: how many of the C candidate rows of dim d the
    kernel stages in dynamic shared memory, and the bytes it asks for.

    All C rows when they fit (C * 13 bytes of per-candidate state beside
    them); else as many as fit beside a one-row buffer for the keep, the
    rest read from global memory. Raises ``ValueError`` only where not
    even the per-candidate state and that buffer fit: C above 17,000 or so
    at small d, or d above 57,000 or so."""
    row = (d + 3) // 4 * 4 * 4
    state = C * 13
    if state + C * row <= SMEM_LIMIT:
        return C, state + C * row
    if state + row > SMEM_LIMIT:
        raise ValueError(
            f"prune: C={C} candidates of d={d} need {state + row} B of "
            f"shared memory even with no row staged (limit {SMEM_LIMIT})")
    staged = (SMEM_LIMIT - state - row) // row
    return staged, state + (staged + 1) * row


@functools.cache
def _entry():
    f = _build.library("prune").rt_prune
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def prune_cuda(cand_ids, cand_dists, table, *, m, alpha=1.0, fill=True):
    """cand_ids int32[B, C], cand_dists f32[B, C], table [n, d] in any
    stored layout (``gather_distance.table_args``), all on one CUDA device
    -> int32[B, m] kept ids, -1 padded. Launches the kernel of the table's
    layout or raises."""
    dev = cand_ids.device
    _build.check_tensor(cand_ids, "cand_ids", torch.int32, 2, dev)
    _build.check_tensor(cand_dists, "cand_dists", torch.float32, 2, dev)
    t = _gather.table_args(table, dev)
    B, C = cand_ids.shape
    n, d = t.n, t.d
    if tuple(cand_dists.shape) != (B, C):
        raise ValueError("prune: cand_ids and cand_dists shapes differ")
    staged, _ = smem_plan(C, d)
    out = torch.empty((B, m), dtype=torch.int32, device=dev)
    if B == 0 or m == 0:
        return out
    if C == 0:
        return out.fill_(-1)
    with torch.cuda.device(dev):
        rc = _entry()(cand_ids.data_ptr(), cand_dists.data_ptr(),
                      t.data.data_ptr(), t.aux_ptr, out.data_ptr(), B, C, d,
                      n, t.sub, t.code, m, float(alpha), int(bool(fill)),
                      staged, _build.stream_of(dev))
    _build.check(rc, "prune", "prune")
    prune_cuda.launches += 1
    prune_cuda.layout_launches[t.layout] += 1
    return out


prune_cuda.launches = 0
prune_cuda.layout_launches = dict.fromkeys(_gather.LAYOUTS, 0)
