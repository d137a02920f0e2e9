"""Shared pieces of the port's benchmarks (``repro``'s
``benchmarks/common.py`` and ``hotpath.py::_elemental_table``).

Timing is by CUDA events on the card and by the host clock on the CPU;
every record names the device it ran on (:func:`device_info`).
"""
from __future__ import annotations

import pathlib
import subprocess
import time

import numpy as np
import torch

__all__ = [
    "emit", "artifacts_dir", "time_calls", "device_info", "card_line",
    "elemental_table", "prune_parity", "PRUNE_TIE_RTOL", "PRUNE_MAX_DIFF",
]

ROOT = pathlib.Path(__file__).resolve().parents[3]
PRUNE_TIE_RTOL = 1e-5     # prune: a keep decision within this of du
PRUNE_MAX_DIFF = 1e-3     # prune: share of rows allowed to differ


def emit(rows) -> None:
    """Print ``name,us_per_call,derived`` CSV rows."""
    for r in rows:
        print(",".join(str(x) for x in r))


def artifacts_dir() -> str:
    d = ROOT / "artifacts"
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def device_info(device: torch.device) -> dict:
    """What a record says of where it ran."""
    info = {"device_type": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        info.update(device=torch.cuda.get_device_name(device),
                    card=card_line(), cuda=torch.version.cuda)
    else:
        info["device"] = "cpu"
    return info


def time_calls(fn, device: torch.device, *, iters=20, warmup=3,
               reduce="mean") -> float:
    """Seconds per call of ``fn(i)`` (``i`` the call index, so a call
    that updates its inputs in place can take a fresh copy), after
    ``warmup`` calls: the mean over ``iters`` calls, or with
    ``reduce="min"`` the least single call. CUDA events on the card, the
    host clock on the CPU."""
    for i in range(warmup):
        fn(i)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    if reduce == "mean":
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(warmup + i)
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for i in range(iters):
            fn(warmup + i)
        return (time.perf_counter() - t0) / iters
    if reduce != "min":
        raise ValueError(f"unknown reduce {reduce!r}")
    best = float("inf")
    for i in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(warmup + i)
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(warmup + i)
            best = min(best, time.perf_counter() - t0)
    return best


def elemental_table(rng, n, m, logn):
    """Synthetic but structurally valid elemental-graph table: every edge
    stays inside its layer's segment, 15% of slots are -1 padding
    (``repro``'s ``benchmarks/hotpath.py::_elemental_table``; the same
    draws from the same generator give the same table)."""
    layers = logn + 1
    base = rng.integers(0, n, (n, layers, m)).astype(np.int32)
    u_ids = np.arange(n, dtype=np.int32)[:, None, None]
    shift = (logn - np.arange(layers, dtype=np.int32))[None, :, None]
    seg_lo = (u_ids >> shift) << shift
    seg_size = (1 << shift)
    nbrs = np.minimum(seg_lo + base % seg_size, n - 1).astype(np.int32)
    nbrs[rng.random(nbrs.shape) < 0.15] = -1
    return nbrs


def _near_tie(ids, du, vecs, m, alpha, fill) -> bool:
    """Replay the plain prune of one row in f64 and report whether any
    keep decision is a near tie, |alpha*cc - du| <= PRUNE_TIE_RTOL*du."""
    from repro_torch.kernels import ref

    ids, du, vecs = ids[None], du[None], vecs[None]
    C = ids.shape[1]
    v64 = vecs.double()
    xx = (v64 * v64).sum(-1)[0]
    kept = ref.prune_vecs(ids, du, vecs, m=m, alpha=alpha, fill=fill)[0]
    for kid in kept.tolist():
        if kid < 0:
            break
        p = int((ids[0] == kid).nonzero()[0, 0])
        cc = (xx - 2.0 * (v64[0] @ v64[0, p]) + xx[p]).clamp_min(0.0)
        d = du[0].double()
        live = torch.isfinite(d) & (ids[0] >= 0)
        gap = (alpha * cc - d).abs()
        if bool((live & (gap <= PRUNE_TIE_RTOL * d.abs())).any()):
            return True
    return C == 0


def prune_parity(got, want, cand, du, vecs, m, alpha=1.0,
                 fill=True) -> tuple[int, int, bool]:
    """The near-tie rule between two prunes of the same inputs (``vecs``
    the decoded candidate rows [B, C, d]): ``(rows differing, of them near
    ties, ok)``, ok when every differing row holds a near-tie keep
    decision and they are at most PRUNE_MAX_DIFF of the rows."""
    diff = (got != want).any(dim=1).nonzero()[:, 0].tolist()
    ties = sum(_near_tie(cand[r], du[r], vecs[r], m, alpha, fill)
               for r in diff)
    ok = ties == len(diff) and len(diff) <= PRUNE_MAX_DIFF * got.shape[0]
    return len(diff), ties, ok
