"""Blockwise (flash) attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(line 34). The kernel is ``csrc/flash_attention.cu``; its header says what
bounds it on the H100 (memory at the embed path's S = 32, operations at
long S) and what its design does about that (one block per (batch x head,
32-row query tile), K/V tiles staged in shared memory, the online softmax
in f32, key tiles outside the causal or window band skipped). The plain
version is ``kernels/ref.py::attention`` (``plain`` here); the two differ
only on a row that sees no key, where the kernel gives 0 as the TPU kernel
does and the plain version the mean of V, as ``repro``'s reference does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["flash_attention_cuda", "plain", "MAX_HEAD_DIM"]

plain = _ref.attention
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BQ = 32           # query rows per block (csrc/flash_attention.cu kBQ)


@functools.cache
def _entry():
    f = _build.library("flash_attention").rt_flash_attention
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
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
    dense, in q's dtype. Launches the kernel or raises."""
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
    if -(-Sq // _BQ) > 65535:
        raise ValueError(f"Sq={Sq} needs more than 65,535 query tiles")
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    out = torch.empty((B, Hq, Sq, Dh), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, Dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)),
            0 if window is None else int(window),
            int(softcap is not None),
            0.0 if softcap is None else float(softcap),
            int(q_offset), _build.stream_of(dev))
    _build.check(rc, "flash_attention", "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
