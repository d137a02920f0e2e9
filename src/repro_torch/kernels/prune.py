"""alpha-RNG construction prune: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/prune.py::_prune_kernel`` (line
44) with its codec body (lines 95-105, set-up 207-219): the table may be
stored in any layout the search kernels take (f32, bf16, f16,
``Int8Vectors``, ``PQVectors``). The kernel is ``csrc/prune.cu``; its
header says what bounds it on the H100 (memory: each build node's C
candidate rows) and what its design does about that: every candidate
row crosses into the SM once per node, into the shared memory of one
CTA or through a table of dots with the node's 16 nearest candidates,
and each of the m sweeps passes one barrier. :func:`smem_plan` picks
the regime for (C, d). The plain version is ``kernels/ref.py::prune``
(``plain`` here), which decodes through ``storage.decode_rows``. The
wrapper counts its launches in total (``launches``), per layout
(``layout_launches``) and per regime (``regime_launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gather_distance as _gather
from repro_torch.kernels import ref as _ref

__all__ = ["prune_cuda", "plain", "smem_plan", "Plan", "warps_of",
           "REGIMES"]

plain = _ref.prune
# the H100's per-block shared-memory ceiling (232,448 B) less a margin;
# the kernel declares no static shared memory
SMEM_LIMIT = 232448 - 256
# shared memory of one SM, for all its blocks, and what each block reserves
SM_SMEM, BLOCK_RESERVED = 233472, 1024
MAX_WARPS = 8     # csrc/prune.cu::kMaxWarps: the argmin exchange's room
TABLE_K = 16      # csrc/prune.cu::kK: the table regime's columns
# block: all C rows in one CTA; table: one CTA stages the TABLE_K nearest
# candidates beside a [C, TABLE_K] table of their dots with every row;
# partial: one CTA stages the first rows that fit, the sweeps decode the
# rest from global memory
REGIMES = ("block", "table", "partial")


class Plan(NamedTuple):
    staged: int   # rows the CTA stages in shared memory, as f32
    bytes: int    # dynamic shared memory of the CTA
    regime: str   # one of REGIMES


def _row_bytes(d: int) -> int:
    return (d + 3) // 4 * 4 * 4


def table_bytes(C: int, d: int) -> int:
    """Dynamic shared memory of one table CTA (``csrc/prune.cu::
    table_bytes``): the argmin exchange, min(C, TABLE_K) staged rows and
    the lazy keep's row (f32), 78 B a candidate (its TABLE_K dots,
    ||x||^2, du, id, slot and flags) and the slots' positions."""
    return (2 * MAX_WARPS * 16 + (min(C, TABLE_K) + 1) * _row_bytes(d)
            + C * (TABLE_K * 4 + 14) + TABLE_K * 4)


def smem_bytes(C: int, d: int, staged: int) -> int:
    """Dynamic shared memory of one staged-rows CTA (``csrc/prune.cu::
    smem_bytes``): the staged rows and, where some are left unstaged, a
    one-row buffer for the keep's row, all f32; 17 B a candidate (||x||^2,
    du, id, its place in (du, position) order and the order, flags)."""
    return (staged + (staged < C)) * _row_bytes(d) + 17 * C


def smem_plan(C: int, d: int) -> Plan:
    """How the kernel prunes one build node with C candidate rows of dim
    d, in one CTA: ``Plan(staged, bytes, regime)``.

    All C rows staged where three such CTAs fit on an SM (d = 128: the
    sweeps' dots read shared memory); else the table regime where its CTA
    fits (d = 1,024-3,072: every row read once, the sweeps read the
    table); else all C rows staged where they fit; else as many rows as
    fit beside a one-row buffer for the keep, the rest read from global
    memory (d = 4,096 and up at C = 48-144). (On the H100 the block regime
    beat the table at C = 80, d = 128, and the table beat the block and a
    cluster of 3-8 CTAs at C = 48-144, d = 1,024; PERF.md §6.)
    Raises ``ValueError`` where not even the per-candidate state and the
    keep's row fit: C above 13,600 or so at small d, or d above 57,000 or
    so."""
    if C >= 1 << 16:
        raise ValueError(f"prune: C={C} candidates (the kernel takes "
                         "fewer than 65,536)")
    block = Plan(C, smem_bytes(C, d, C), "block")
    if SM_SMEM // (block.bytes + BLOCK_RESERVED) >= 3:
        return block
    if table_bytes(C, d) <= SMEM_LIMIT:
        return Plan(min(C, TABLE_K), table_bytes(C, d), "table")
    if block.bytes <= SMEM_LIMIT:
        return block
    base = smem_bytes(C, d, 0)
    if base > SMEM_LIMIT:
        raise ValueError(
            f"prune: C={C} candidates of d={d} need {base} B of shared "
            f"memory even with no row staged (limit {SMEM_LIMIT})")
    staged = (SMEM_LIMIT - base) // _row_bytes(d)
    return Plan(staged, smem_bytes(C, d, staged), "partial")


def warps_of(plan: Plan) -> int:
    """Warps a CTA: 8 where its shared memory lets at most two CTAs onto
    an SM, fewer where more share it, never under 4. (On the H100, 8 beat
    4 at d = 1,024 and 4 beat 8 at d = 128: a sweep's fixed cost is paid
    by every warp, its dots are few; PERF.md §6.)"""
    per_sm = max(1, SM_SMEM // (plan.bytes + BLOCK_RESERVED))
    return max(4, min(MAX_WARPS, 16 // per_sm))


@functools.cache
def _entry():
    f = _build.library("prune").rt_prune
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def prune_cuda(cand_ids, cand_dists, table, *, m, alpha=1.0, fill=True):
    """cand_ids int32[B, C], cand_dists f32[B, C], table [n, d] in any
    stored layout (``gather_distance.table_args``), all on one CUDA device
    -> int32[B, m] kept ids, -1 padded. Launches the kernel of the table's
    layout in the regime ``smem_plan`` names for (C, d), or raises (a plan
    that does not fit, a launch that fails)."""
    dev = cand_ids.device
    _build.check_tensor(cand_ids, "cand_ids", torch.int32, 2, dev)
    _build.check_tensor(cand_dists, "cand_dists", torch.float32, 2, dev)
    t = _gather.table_args(table, dev)
    B, C = cand_ids.shape
    n, d = t.n, t.d
    if tuple(cand_dists.shape) != (B, C):
        raise ValueError("prune: cand_ids and cand_dists shapes differ")
    plan = smem_plan(C, d)
    out = torch.empty((B, m), dtype=torch.int32, device=dev)
    if B == 0 or m == 0:
        return out
    if C == 0:
        return out.fill_(-1)
    with torch.cuda.device(dev):
        rc = _entry()(cand_ids.data_ptr(), cand_dists.data_ptr(),
                      t.data.data_ptr(), t.aux_ptr, out.data_ptr(), B, C, d,
                      n, t.sub, t.code, m, float(alpha), int(bool(fill)),
                      int(plan.regime == "table"), plan.staged,
                      warps_of(plan), _build.stream_of(dev))
    _build.check(rc, "prune", "prune")
    prune_cuda.launches += 1
    prune_cuda.layout_launches[t.layout] += 1
    prune_cuda.regime_launches[plan.regime] += 1
    return out


prune_cuda.launches = 0
prune_cuda.layout_launches = dict.fromkeys(_gather.LAYOUTS, 0)
prune_cuda.regime_launches = dict.fromkeys(REGIMES, 0)
