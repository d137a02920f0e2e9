"""Blockwise (flash) attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(line 34). The kernel is ``csrc/flash_attention.cu``; its header says what
bounds it on the H100 (memory at the embed path's S = 32, operations at
long S) and what its two bodies do about that. Which body runs depends on
the dtype and the head dim alone (:func:`body_of`):

  * ``"wgmma"``: bf16 / f16 with ``Dh % 16 == 0`` -- the tensor-core body
    (64-row query tiles, TMA into a two-stage K/V ring, wgmma with P split
    into hi and lo halves). Its tiling is :func:`plan_tc`, pure Python;
    its tensor maps need every stride of q, k and v that spans more than
    one element to be a multiple of 16 bytes, and 16-byte aligned
    pointers, or the wrapper raises;
  * ``"cuda_cores"``: f32, and 16-bit inputs with another head dim -- f32
    FMAs on 32-row query tiles.

``flash_attention_cuda.launches`` counts every launch and
``flash_attention_cuda.body_launches`` each body's. The plain version is
``kernels/ref.py::attention`` (``plain`` here); the two differ only on a
row that sees no key, where the kernel gives 0 as the TPU kernel does and
the plain version the mean of V, as ``repro``'s reference does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["flash_attention_cuda", "plain", "MAX_HEAD_DIM", "BODIES",
           "body_of", "plan_tc", "TcPlan", "tc_smem", "cuda_cores_smem"]

plain = _ref.attention
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BQ = 32           # query rows per block (csrc/flash_attention.cu kBQ)
_BK = 32           # keys per tile of the CUDA-core body (kBK)
BODIES = ("wgmma", "cuda_cores")
_TC_ROWS = 64      # query rows per tensor-core tile (one warpgroup)
_TC_BK = 32        # keys per K/V tile (csrc/flash_attention.cu tc::kKeys)


def cuda_cores_smem(Dh: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core body
    (``csrc/flash_attention.cu::cuda_cores_smem``): the query tile and one
    K and one V tile in f32, rows of Dh rounded up to 4 plus 4 floats."""
    return (_BQ + 2 * _BK) * ((Dh + 3) // 4 * 4 + 4) * 4


def tc_smem(DP: int) -> int:
    """Dynamic shared memory of one block of the tensor-core body at DP
    (``csrc/flash_attention.cu::tc::smem_bytes``): 1 KB for alignment, Q
    and two K/V stages in 64-column chunks of 128-byte rows, three
    barriers."""
    return 1024 + (DP // 64) * 128 * (64 + 4 * _TC_BK) + 64


def body_of(dtype: torch.dtype, Dh: int) -> str:
    """The body that runs for inputs of ``dtype`` and head dim ``Dh``."""
    if dtype in (torch.bfloat16, torch.float16) and Dh % 16 == 0:
        return "wgmma"
    return "cuda_cores"


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """The tensor-core body's tiling (``csrc/flash_attention.cu`` tc)."""
    DP: int          # Dh rounded up to 64: 64-column chunks of Q, K and V
    BK: int          # keys per K/V tile (32)
    P: int           # query heads packed in one 64-row tile
    RQ: int          # positions per head in one tile (P * RQ <= 64)
    grid: tuple      # (B * Hkv * ceil(g / P), ceil(Sq / RQ))
    smem_bytes: int  # dynamic shared memory of one block


def plan_tc(B, Hq, Hkv, Sq, Skv, Dh) -> TcPlan:
    """Tiling of the tensor-core body. At Sq <= 32 the 64 rows hold the
    Sq positions of P = min(g, 64 // Sq) query heads of one GQA group, so
    the group's K/V tile is read once (g = 2, S = 32 fills the tile);
    else 64 positions of one head. Key tiles of 32: a block then needs
    at most 96 KB of shared memory (Dh 256) and 48 KB at Dh 128, so four
    blocks share an SM, and one block's softmax runs under another's
    wgmmas (64-key tiles, two blocks an SM, took 0.47 ms at S = 4,096
    where 32-key tiles took 0.36 on the H100)."""
    if Dh % 16 or not 16 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"tensor-core body: head dim {Dh} is not a "
                         f"multiple of 16 in [16, {MAX_HEAD_DIM}]")
    g = Hq // Hkv
    DP = -(-Dh // 64) * 64
    BK = _TC_BK
    if 2 * Sq <= _TC_ROWS and g > 1:
        P, RQ = min(g, _TC_ROWS // Sq), Sq
    else:
        P, RQ = 1, _TC_ROWS
    grid = (B * Hkv * -(-g // P), -(-Sq // RQ))
    return TcPlan(DP, BK, P, RQ, grid, tc_smem(DP))


def tma_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """The batch, head and position strides of ``t`` in elements as a
    tensor map takes them, or None when TMA cannot read ``t``: the
    pointer must be 16-byte aligned and every stride of a dim longer than
    1 a multiple of 16 bytes (a dim of length 1 is never stepped, so its
    stride is replaced by one that is)."""
    es = t.element_size()
    if t.data_ptr() % 16:
        return None
    out = []
    for n, st in zip(t.shape[:3], t.stride()[:3]):
        if n == 1:
            st = 16 // es
        if (st * es) % 16 or st <= 0:
            return None
        out.append(st)
    return tuple(out)


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int]


@functools.cache
def _entry():
    f = _build.library("flash_attention").rt_flash_attention
    f.argtypes = _ARGS + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


@functools.cache
def _entry_tc():
    f = _build.library("flash_attention").rt_flash_attention_tc
    f.argtypes = _ARGS + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check(t: torch.Tensor, name: str, dtype, dev) -> None:
    """A CUDA tensor of rank 4 on ``dev`` whose last dim is dense (batch,
    head and position may have any stride: the layout the projections'
    transposes leave)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name}: rank {t.dim()}, expected 4")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be dense")


def flash_attention_cuda(q, k, v, *, causal=True, window=None, softcap=None,
                         scale=None, q_offset=0):
    """q [B, Hq, Sq, Dh], k / v [B, Hkv, Skv, Dh] (CUDA; f32, bf16 or
    f16, one dtype; ``Hq % Hkv == 0``; ``Dh <= 256``) -> [B, Hq, Sq, Dh]
    dense, in q's dtype. Launches the body :func:`body_of` names, or
    raises; raises too when autograd would need its gradient (grad mode
    on and q, k or v requiring grad), since the kernel has no backward."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward: its output would carry "
            "no gradient to q, k and v. Train with "
            "attention_impl=\"torch\" (the plain attention, "
            "differentiated by autograd, as repro trains with \"xla\"), "
            "or call it under torch.no_grad()")
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected one of "
                        f"{list(_DTYPES)}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, q.dtype, dev)
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} outside [1, {MAX_HEAD_DIM}]")
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    out = torch.empty((B, Hq, Sq, Dh), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    body = body_of(q.dtype, Dh)
    if body == "wgmma":
        strides = [tma_strides(t) for t in (q, k, v)]
        for st, name in zip(strides, "qkv"):
            if st is None:
                raise ValueError(
                    f"{name}: the tensor-core body reads it by TMA, which "
                    "needs a 16-byte aligned pointer and strides that are "
                    "multiples of 16 bytes (make it contiguous)")
        plan = plan_tc(B, Hq, Hkv, Sq, Skv, Dh)
        entry, extra = _entry_tc(), (plan.DP, plan.P, plan.RQ, *plan.grid)
    else:
        if -(-Sq // _BQ) > 65535:  # allow[R5]: the grid's y limit
            raise ValueError(f"Sq={Sq} needs more than 65,535 query tiles")
        strides = [t.stride()[:3] for t in (q, k, v)]
        entry, extra = _entry(), ()
    with torch.cuda.device(dev):
        rc = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, Dh,
            *strides[0], *strides[1], *strides[2],
            float(scale), int(bool(causal)),
            0 if window is None else int(window),
            int(softcap is not None),
            0.0 if softcap is None else float(softcap),
            int(q_offset), *extra, _build.stream_of(dev))
    _build.check(rc, "flash_attention", f"flash_attention[{body}]")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.body_launches[body] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.body_launches = dict.fromkeys(BODIES, 0)
