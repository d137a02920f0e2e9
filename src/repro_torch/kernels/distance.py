"""All-pairs distance: the CUDA kernel's wrapper, and the half types' gate.

Replaces the TPU kernel ``repro/kernels/distance.py::_dist_kernel`` (line
26). The kernel is ``csrc/distance.cu``; its header says what bounds it on
the H100 and what its design does about that: persistent blocks over 64 x
128 output tiles on the tensor cores, a cp.async ring in the 128-byte
swizzle, the norms in the same K-loop, the output passed through shared
memory and written as whole 512-byte row segments. Two bodies, by input
type:

  * ``"tf32x3"``: f32 inputs, each value split into a tf32 part and an f32
    rest and three TF32 products summed in f32;
  * ``"wgmma"``: bf16 / f16 inputs, one 16-bit product (exact in f32)
    summed in f32, held to :func:`half_gate`.

``pairwise_dist_cuda.body_launches`` counts the launches of each body. The
plain version is ``kernels/ref.py::pairwise_dist`` (``plain`` here).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["pairwise_dist_cuda", "plain", "grid_of", "plan", "half_gate",
           "Plan", "TILE", "DIST_RTOL"]

plain = _ref.pairwise_dist
_METRICS = {"l2": 0, "ip": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BODY = {torch.float32: "tf32x3", torch.bfloat16: "wgmma",
         torch.float16: "wgmma"}
TILE = (64, 128)          # queries x rows of x per output tile
_MAX_TILES = 2 ** 31 - 1
DIST_RTOL = 1e-5          # relative to ‖q‖² + ‖x‖²
_U = 2.0 ** -24           # f32's unit roundoff
GATE_CHUNK = 1 << 16      # columns of the output a gate step holds in f64
# one ring stage of the kernel: the q and x tiles in 128-byte rows
_STAGE_BYTES = (TILE[0] + TILE[1]) * 128


class Plan(NamedTuple):
    body: str     # "tf32x3" (f32) or "wgmma" (bf16 / f16)
    tiles: int    # output tiles, walked by the persistent blocks
    vec: bool     # 16-byte cp.async copies, else element loads
    smem: int     # a block's dynamic shared memory, bytes


def grid_of(Bq: int, N: int) -> int:
    """Output tiles of the kernel (its blocks walk them)."""
    return -(-Bq // TILE[0]) * -(-N // TILE[1])


def plan(q: torch.Tensor, x: torch.Tensor) -> Plan:
    """The kernel's launch decisions for q [Bq, D] and x [N, D]: its body
    by dtype, its tiles, whether a 16-byte piece of a row can be copied
    whole (D a multiple of the values it holds and both data pointers
    16-byte aligned; else element loads), and a block's shared memory:
    1,024 bytes to align the ring to the swizzle atom, two ring stages
    (f32: a third buffer, the split's small parts) and the tile's row
    norms."""
    Bq, D = q.shape
    piece = 16 // q.element_size()
    vec = (D % piece == 0 and q.data_ptr() % 16 == 0
           and x.data_ptr() % 16 == 0)
    body = _BODY[q.dtype]
    stages = 3 if body == "tf32x3" else 2
    smem = 1024 + stages * _STAGE_BYTES + (TILE[0] + TILE[1]) * 4
    return Plan(body, grid_of(Bq, x.shape[0]), vec, smem)


def half_gate(got, q, x, *, metric="l2", plain=None) -> dict:
    """The gate of a bf16 / f16 pairwise distance ``got`` f32[Bq, N] over
    q [Bq, D] and x [N, D] (the 16-bit inputs). Each product of two 16-bit
    values is exact in f32, so any f32 sum of the D products is within the
    order-free bound of such a sum of the exact result; two parts:

      1. against ``plain`` (the plain version's output), where given:
         ``|got − plain| <= DIST_RTOL·(‖q‖² + ‖x‖²)``, the rule the f32
         inputs pass;
      2. against the exact result in f64, with S = |q|·|x|ᵀ: for ip
         ``|got − exact| <= 2·D·2⁻²⁴·S``; for l2 ``|got − exact| <=
         2·(D + 2)·2⁻²⁴·(‖q‖² + 2S + ‖x‖²)``. That is the order-free error
         bound of an f32 sum of D exact products (and, for l2, of the norms
         and the two adds), doubled for the tensor cores' truncation while
         they accumulate. Unlike a tolerance taken from one sum's output,
         it holds for every order, the plain version's included.

    Returns the outputs over each part and its worst margin (the largest
    error over its tolerance; <= 1 passes): ``{"over_plain",
    "margin_plain", "over_exact", "margin_exact"}`` (the ``_plain`` pair
    None without ``plain``). Works in column chunks of GATE_CHUNK on the
    tensors' device."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    Bq, D = q.shape
    qd = q.double()
    qq = (qd * qd).sum(1, keepdim=True)
    qa = qd.abs()
    out = {"over_plain": None, "margin_plain": None, "over_exact": 0,
           "margin_exact": 0.0}
    if plain is not None:
        out.update(over_plain=0, margin_plain=0.0)
    for s in range(0, x.shape[0], GATE_CHUNK):
        xd = x[s:s + GATE_CHUNK].double()
        xx = (xd * xd).sum(1)[None, :]
        dot = qd @ xd.T
        S = qa @ xd.abs().T
        g = got[:, s:s + GATE_CHUNK].double()
        if metric == "ip":
            exact, tol = -dot, 2.0 * D * _U * S
        else:
            exact = qq - 2.0 * dot + xx
            tol = 2.0 * (D + 2) * _U * (qq + 2.0 * S + xx)
        parts = [("exact", (g - exact).abs(), tol)]
        if plain is not None:
            parts.append(("plain",
                          (g - plain[:, s:s + GATE_CHUNK].double()).abs(),
                          DIST_RTOL * (qq + xx)))
        for name, err, t in parts:
            out[f"over_{name}"] += int((err > t).sum())
            ratio = torch.where(err > 0, err / t, torch.zeros_like(err))
            out[f"margin_{name}"] = max(out[f"margin_{name}"],
                                        float(ratio.max()))
        del xd, xx, dot, S, g, exact, tol, parts
    return out


@functools.cache
def _entry():
    f = _build.library("distance").rt_pairwise_dist
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
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
    p = plan(q, x)
    if p.tiles > _MAX_TILES:
        raise ValueError(f"pairwise_dist: Bq={Bq} x N={N} needs more than "
                         f"{_MAX_TILES} tiles")
    out = torch.empty((Bq, N), dtype=torch.float32, device=dev)
    if Bq == 0 or N == 0:
        return out
    if D == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        rc = _entry()(q.data_ptr(), x.data_ptr(), out.data_ptr(), Bq, N, D,
                      _DTYPES[q.dtype], _METRICS[metric], int(p.vec), p.smem,
                      _build.stream_of(dev))
    _build.check(rc, "distance", "pairwise_dist")
    pairwise_dist_cuda.launches += 1
    pairwise_dist_cuda.body_launches[p.body] += 1
    return out


pairwise_dist_cuda.launches = 0
pairwise_dist_cuda.body_launches = {"tf32x3": 0, "wgmma": 0}
