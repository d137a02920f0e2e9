"""Blockwise (flash) attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(line 34). The kernel is ``csrc/flash_attention.cu``; its header says what
bounds it on the H100 (memory at the embed path's S = 32, operations at
long S) and what its two bodies do about that. Which body runs depends on
the dtype alone (:func:`body_of`), at every head dim from 1 to 256:

  * ``"wgmma"``: bf16 / f16 -- the tensor-core body (64-row query tiles,
    a two-stage K/V ring, wgmma with P split into hi and lo halves);
  * ``"tf32x3"``: f32 -- the same tiling in f32, each product as three
    tf32 wgmmas on the big and small halves of its operands (full f32
    precision).

Both take the tiling of :func:`plan_tc` (pure Python), the head dim
zero-filled to DP, a multiple of 64. Which loader fills their shared
memory depends on the inputs' pointers and strides alone
(:func:`loader_of`):

  * ``"tma"`` where :func:`tma_strides` accepts q, k and v (16-byte
    aligned pointers, every stride of a dim longer than 1 a multiple of 16
    bytes);
  * ``"cp.async"`` otherwise (a row of Dh values that is no multiple of 16
    bytes in the projections' transposed layout, a view off 16 bytes):
    pieces of :func:`copy_bytes` each.

``flash_attention_cuda.launches`` counts every launch,
``flash_attention_cuda.body_launches`` each body's and
``flash_attention_cuda.loader_launches`` each loader's. The plain version
is ``kernels/ref.py::attention`` (``plain`` here); the two differ only on
a row that sees no key, where the kernel gives 0 as the TPU kernel does
and the plain version the mean of V, as ``repro``'s reference does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["flash_attention_cuda", "plain", "MAX_HEAD_DIM", "BODIES",
           "LOADERS", "body_of", "loader_of", "copy_bytes", "plan_tc",
           "TcPlan", "tc_smem", "tf32x3_smem"]

plain = _ref.attention
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BODIES = ("wgmma", "tf32x3")
LOADERS = ("tma", "cp.async")  # csrc/flash_attention.cu enum Loader
_TC_ROWS = 64      # query rows per tensor-core tile (one warpgroup)
_TC_BK = 32        # keys per K/V tile (csrc/flash_attention.cu tc::kKeys)


def tc_smem(DP: int) -> int:
    """Dynamic shared memory of one block of the tensor-core body at DP
    (``csrc/flash_attention.cu::tc::smem_bytes``): 1 KB for alignment, Q
    and two K/V stages in 64-column chunks of 128-byte rows, three
    barriers."""
    return 1024 + (DP // 64) * 128 * (64 + 4 * _TC_BK) + 64


def tf32x3_smem(DP: int) -> int:
    """Dynamic shared memory of one block of the 3xTF32 body at DP
    (``csrc/flash_attention.cu::x3::tf32x3_smem``): Q and its small half
    (64 rows), the K and V tiles and the scratch tile X (32 keys), all f32
    at DP columns; three barriers in 64 bytes; 896 bytes of headroom to
    align a 128-byte-aligned base to 1,024 bytes."""
    return (2 * _TC_ROWS + 3 * _TC_BK) * DP * 4 + 64 + 896


def body_of(dtype: torch.dtype, Dh: int) -> str:
    """The body that runs for inputs of ``dtype`` (the head dim ``Dh``,
    any in [1, 256], does not choose: it is zero-filled to a multiple of
    64)."""
    return "tf32x3" if dtype == torch.float32 else "wgmma"


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """The tiling of the two bodies (``csrc/flash_attention.cu`` tc and
    x3)."""
    DP: int          # Dh rounded up to 64, zero-filled by either loader
    BK: int          # keys per K/V tile (32)
    P: int           # query heads packed in one 64-row tile
    RQ: int          # positions per head in one tile (P * RQ <= 64)
    grid: tuple      # (B * Hkv * ceil(g / P), ceil(Sq / RQ))
    smem_bytes: int  # dynamic shared memory of one block


@functools.lru_cache(maxsize=1024)   # a call's host time: plans repeat
def plan_tc(B, Hq, Hkv, Sq, Skv, Dh, dtype=torch.bfloat16) -> TcPlan:
    """Tiling of the tensor-core body (bf16 / f16 ``dtype``) or of the
    3xTF32 body (f32: the same tiles, its own shared memory,
    :func:`tf32x3_smem`), at any head dim in [1, 256], zero-filled to DP.
    At Sq <= 32 the 64 rows hold the Sq positions of P = min(g, 64 // Sq)
    query heads of one GQA group, so the group's K/V tile is read once (g
    = 2, S = 32 fills the tile); else 64 positions of one head. Key tiles
    of 32: a 16-bit block then needs at most 96 KB of shared memory (Dh
    256) and 48 KB at Dh 128, so four blocks share an SM, and one block's
    softmax runs under another's wgmmas (64-key tiles, two blocks an SM,
    took 0.47 ms at S = 4,096 where 32-key tiles took 0.36 on the H100);
    an f32 block 115,648 B at Dh 128, two an SM."""
    f32 = dtype == torch.float32
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"{'3xTF32' if f32 else 'tensor-core'} body: head "
                         f"dim {Dh} outside [1, {MAX_HEAD_DIM}]")
    g = Hq // Hkv
    DP = -(-Dh // 64) * 64
    BK = _TC_BK
    if 2 * Sq <= _TC_ROWS and g > 1:
        P, RQ = min(g, _TC_ROWS // Sq), Sq
    else:
        P, RQ = 1, _TC_ROWS
    grid = (B * Hkv * -(-g // P), -(-Sq // RQ))
    return TcPlan(DP, BK, P, RQ, grid,
                  tf32x3_smem(DP) if f32 else tc_smem(DP))


def tma_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """The batch, head and position strides of ``t`` in elements as a
    tensor map takes them, or None when TMA cannot read ``t``: the
    pointer must be 16-byte aligned and every stride of a dim longer than
    1 a multiple of 16 bytes (a dim of length 1 is never stepped, so its
    stride is replaced by one that is)."""
    if t.data_ptr() % 16:
        return None
    es = t.element_size()
    (n0, n1, n2, _), (s0, s1, s2, _) = t.shape, t.stride()
    out = (16 // es if n0 == 1 else s0, 16 // es if n1 == 1 else s1,
           16 // es if n2 == 1 else s2)
    for st in out:
        if st <= 0 or (st * es) % 16:
            return None
    return out


def copy_bytes(t: torch.Tensor) -> int:
    """The cp.async loader's piece of ``t``: the widest of 16, 8 and 4
    bytes (2 for a 16-bit tensor that allows no wider) that its pointer
    and the byte stride of every dim longer than 1 are multiples of."""
    es = t.element_size()
    steps = [t.data_ptr()] + [st * es for n, st in
                              zip(t.shape[:3], t.stride()[:3]) if n > 1]
    for u in (16, 8, 4):
        if all(x % u == 0 for x in steps):
            return u
    return es


def loader_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The loader that fills the body's shared memory: ``"tma"`` where
    :func:`tma_strides` accepts q, k and v, else ``"cp.async"``."""
    return _load_plan(q, k, v)[0]


def _load_plan(q, k, v):
    """(loader, each tensor's batch, head and position strides in
    elements as the loader takes them, each tensor's copy width in
    bytes). TMA takes :func:`tma_strides`; cp.async the strides as they
    are, 0 for a dim of length 1 (never stepped), and :func:`copy_bytes`
    pieces."""
    qkv = (q, k, v)
    strides = [tma_strides(t) for t in qkv]
    if None not in strides:
        return "tma", strides, (16, 16, 16)
    strides = [tuple(st if n > 1 else 0 for n, st in
                     zip(t.shape[:3], t.stride()[:3])) for t in qkv]
    return "cp.async", strides, tuple(copy_bytes(t) for t in qkv)


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_int]


@functools.cache
def _entry(body: str):
    name = {"wgmma": "rt_flash_attention_tc",
            "tf32x3": "rt_flash_attention_tf32x3"}[body]
    f = getattr(_build.library("flash_attention"), name)
    f.argtypes = _ARGS + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    dense, in q's dtype. Launches the body :func:`body_of` names with the
    loader :func:`loader_of` names, or raises; raises too when autograd
    would need its gradient (grad mode on and q, k or v requiring grad),
    since the kernel has no backward."""
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
    loader, strides, widths = _load_plan(q, k, v)
    plan = plan_tc(B, Hq, Hkv, Sq, Skv, Dh, q.dtype)
    if plan.grid[1] > 65535:  # allow[R5]: the grid's y limit
        raise ValueError(f"Sq={Sq} needs more than 65,535 query tiles")
    with _build.on_device(dev):
        rc = _entry(body)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, Dh,
            *strides[0], *strides[1], *strides[2],
            float(scale), int(bool(causal)),
            0 if window is None else int(window),
            int(softcap is not None),
            0.0 if softcap is None else float(softcap),
            int(q_offset), plan.DP, plan.P, plan.RQ, *plan.grid,
            LOADERS.index(loader), *widths, _build.stream_of(dev))
    _build.check(rc, "flash_attention", f"flash_attention[{body}, {loader}]")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.body_launches[body] += 1
    flash_attention_cuda.loader_launches[loader] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.body_launches = dict.fromkeys(BODIES, 0)
flash_attention_cuda.loader_launches = dict.fromkeys(LOADERS, 0)
