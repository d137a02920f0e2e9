"""Gather + masked distance: the CUDA kernel's wrapper and launch plan.

Replaces the TPU kernel ``repro/kernels/gather_distance.py::
_gather_dist_kernel`` (line 48) in every stored layout: f32, bf16 and f16
tables, ``Int8Vectors`` and ``PQVectors`` (the TPU kernel's static
``codec`` bodies, lines 98-110). The kernel is ``csrc/gather_distance.cu``;
its header says what bounds it on the H100 (memory: one random stored row
per valid id, and enough of them in flight) and what its design does about
that (one warp a query row's slots, the valid ids compacted by ballot, R
rows' loads in flight a warp, the decode in registers, no block barrier,
no padding and no MXU-style diagonal extract). The plain version is
``kernels/ref.py::gather_dist`` (``plain`` here).

:func:`plan` makes the kernels' shape decisions, this one's and the
hop's (``kernels/hop.py``): the tasks a query row's slots are split over
and, for the hop, the warps a CTA; the C entries take those and derive
the row width's instantiation, the rows in flight and the shared memory
from the table themselves. The plan mirrors those three (``vpl_of``,
``rows_in_flight``, ``gather_smem``, ``hop_smem``) for its split's floor,
for its report and to raise ``ValueError`` before a launch that cannot
fit. :func:`table_args` checks a table's
every leaf and names its layout; the hop's wrapper uses it too. Each
wrapper counts its launches in total (``launches``) and per layout
(``layout_launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import storage as _storage
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["gather_dist_cuda", "plain", "LAYOUTS", "table_args", "plan",
           "Plan", "rows_vec"]

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


SMS = 132                  # the H100's SMs
FILL = 2 * SMS             # hop CTAs below which a CTA takes MAX_WARPS warps
WARPS_PER_SM = 32          # csrc/common.cuh::kMinWarpsPerSM (64 registers)
TASKS = SMS * WARPS_PER_SM  # gather tasks (one a warp) that fill the card
MAX_WARPS = 16             # csrc/common.cuh::kMaxWarps
WARPS = 4                  # warps a CTA: gather_distance.cu::kWarps; the hop
                           # where B >= FILL
MAX_SLOTS = 64             # slots a gather task takes at most (two a lane)
SMEM_LIMIT = 232448        # the H100's per-block shared-memory ceiling
VPLS = (1, 8)              # row widths with unrolled instantiations (d/128)


class Plan(NamedTuple):
    """One launch of gather_distance.cu (one warp a task: a query row's
    slots or a part of them, WARPS tasks a CTA) or hop.cu (one CTA a
    query)."""

    vpl: int     # 4-element units a lane reads of a row: 1, 8, 0 (any d)
    rows: int    # rows a warp keeps in flight (rows_in_flight)
    split: int   # tasks a query row's slots are split over (gather)
    slots: int   # slots of a query row a task takes
    warps: int   # warps a CTA
    smem: int    # dynamic shared memory of a CTA, bytes
    grid: int    # CTAs


def rows_vec(t: TableArgs) -> bool:
    """Whether the kernels' vector loads of ``t``'s rows are aligned
    (``csrc/common.cuh::rows_vec``)."""
    if t.layout == "pq":
        return t.sub > 0 and (t.d // t.sub) % 4 == 0 \
            and t.aux.data_ptr() % 16 == 0
    align = {"f32": 16, "bf16": 8, "f16": 8, "int8": 4}[t.layout]
    return t.d % 4 == 0 and t.data.data_ptr() % align == 0


def vpl_of(layout: str, d: int, vec: bool) -> int:
    """The instantiation of a row width: d / 128 where that is in VPLS and
    the rows are dense and aligned, else 0 (a loop over any d)."""
    if layout == "pq" or not vec or d % 128:
        return 0
    return d // 128 if d // 128 in VPLS else 0


def rows_in_flight(layout: str, vpl: int) -> int:
    """Rows a warp keeps in flight (``csrc/common.cuh::rows_in_flight``):
    16 registers of row data a lane, a 4-element unit taking 4 in f32 and
    2 in the other dense layouts, between 1 and 8 rows; 4 for PQ and the
    loop over any d."""
    if layout == "pq" or vpl == 0:
        return 4
    unit = 4 if layout == "f32" else 2
    return max(1, min(8, 16 // (vpl * unit)))


def _dp(d: int) -> int:
    return (d + 3) // 4 * 4


def gather_smem(d: int, slots: int) -> int:
    """Dynamic shared memory of one gather CTA (``csrc/gather_distance.cu::
    gather_smem``): per warp its query row and its work list (8 B a slot),
    padded to 16 bytes."""
    return WARPS * (_dp(d) + (2 * slots + 3) // 4 * 4) * 4


def hop_smem(d: int, W: int, K: int, m_out: int) -> int:
    """Dynamic shared memory of one hop CTA (``csrc/hop.cu::hop_smem``):
    the query row and its norm, the frontier rows' edge ids (K each), 16 B
    a candidate slot, 32 scanned layers a frontier row, the count."""
    return _dp(d) * 4 + 16 + W * K * 4 + W * m_out * 16 + W * 128 + 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, M: int, layout: str, d: int, vec: bool,
         hop: tuple[int, int] | None = None,
         override: dict | None = None) -> Plan:
    """How gather_distance.cu covers B query rows of M slots over a table
    of ``layout`` rows of width d (``vec``: :func:`rows_vec`), or, with
    ``hop=(W, K)``, how hop.cu runs B queries of W frontier rows with K
    edge ids each and M = W * m_out candidate slots.

    Gather: one warp a task of at most MAX_SLOTS slots of one query row;
    where B such tasks would leave the card short of TASKS warps (the
    server's B = 64, the frontier's 1,000), a query row's slots split over
    more tasks, as many as fit in one wave of TASKS, down to max(rows, 4)
    slots a task (a task loads its query row whatever its slots); so a
    CTA serves WARPS / split query rows. The hop: one CTA a query (its
    visited row is its own), WARPS warps where B >= FILL, else
    MAX_WARPS.

    ``override`` replaces the rule's choice: ``{"split": s}`` for the
    gather (its slots follow, ``cdiv(M, s)``), ``{"warps": w}`` for the
    hop (``kernels/autotune.py`` measures them); it enters the plans'
    cache key. Raises ``ValueError`` where the shared memory does not fit
    (d above 14,000 or so for the gather's 4 query rows a CTA), where a
    hop's slots or W * K edge ids do not, and where an override does not
    fit or names another key: it is never replaced by the rule's plan."""
    key = tuple(sorted(override.items())) if override else None
    return _plan(B, M, layout, d, vec, hop, key)


@functools.lru_cache(maxsize=256)
def _plan(B, M, layout, d, vec, hop, override) -> Plan:
    o = dict(override or ())
    unknown = set(o) - ({"warps"} if hop is not None else {"split"})
    if unknown:
        raise ValueError(f"{'hop' if hop else 'gather_dist'}: no plan "
                         f"parameter {sorted(unknown)}")
    vpl = vpl_of(layout, d, vec)
    rows = rows_in_flight(layout, vpl)
    if hop is not None:
        W, K = hop
        warps = max(WARPS if B >= FILL else MAX_WARPS, _cdiv(M, 32))
        warps = int(o.get("warps", warps))
        smem = hop_smem(d, W, K, M // max(W, 1))
        if not _cdiv(M, 32) <= warps <= MAX_WARPS or smem > SMEM_LIMIT:
            raise ValueError(
                f"hop: {M} candidate slots and {W} x {K} edge ids at d={d} "
                f"on {warps} warps need {_cdiv(M, 32)} to {MAX_WARPS} "
                f"warps and {smem} B of shared memory (limit {SMEM_LIMIT})")
        return Plan(vpl, rows, 1, M, warps, smem, B)
    if "split" in o:
        split = int(o["split"])
        if split < 1 or _cdiv(M, split) > MAX_SLOTS:
            raise ValueError(
                f"gather_dist: split={split} leaves {_cdiv(M, max(split, 1))}"
                f" of M={M} slots a task (at least 1, at most {MAX_SLOTS})")
    else:
        split = _cdiv(M, MAX_SLOTS)
        if B * split < TASKS:  # at most TASKS tasks: one wave
            split = max(split,
                        min(TASKS // max(B, 1), _cdiv(M, max(rows, 4))))
    slots = _cdiv(M, split)
    split = _cdiv(M, slots)
    smem = gather_smem(d, slots)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gather_dist: d={d} needs {smem} B of shared "
                         f"memory (limit {SMEM_LIMIT})")
    return Plan(vpl, rows, split, slots, WARPS, smem,
                _cdiv(B * split, WARPS))


@functools.cache
def _entry():
    f = _build.library("gather_distance").rt_gather_dist
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def gather_dist_cuda(q, table, ids, *, metric="l2", override=None):
    """q f32[B, d], table in any stored layout (see :func:`table_args`),
    ids int32[B, M] (-1 masked), all on one CUDA device -> f32[B, M].
    Launches the kernel of the table's layout and width by :func:`plan`
    (``override``: its ``{"split": s}``), or raises."""
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
    p = plan(B, M, t.layout, d, rows_vec(t), override=override)
    with _build.on_device(dev):
        rc = _entry()(q.data_ptr(), t.data.data_ptr(), t.aux_ptr,
                      ids.data_ptr(), out.data_ptr(), B, M, d, t.n, t.sub,
                      t.code, _METRICS[metric], p.split, p.slots,
                      _build.stream_of(dev))
    _build.check(rc, "gather_distance", "gather_dist")
    gather_dist_cuda.launches += 1
    gather_dist_cuda.layout_launches[t.layout] += 1
    return out


gather_dist_cuda.launches = 0
gather_dist_cuda.layout_launches = dict.fromkeys(LAYOUTS, 0)
