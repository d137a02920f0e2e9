"""Per-kernel roofline: bytes moved, operations, achieved fraction of the
device's measured peaks (``repro``'s ``benchmarks/roofline.py``, without
its TPU-mesh dry-run table, which has no H100 counterpart).

For each hot-path kernel this times the dispatch path (``kernels/ops.py``:
the CUDA kernels on the card, the plain versions on the CPU) at the
benchmark shape, pairs the time with ``repro``'s count of bytes moved and
arithmetic operations (integer for integer), and reports the achieved
fraction of the roofline bound

    t_bound = max(flops / peak_flops, bytes / peak_bw)

where both peaks are measured on the device right before the kernel rows
(:func:`measure_peaks`: an f32 matrix product with TF32 off, at k = 1,024
and 8,192 keeping the faster, and a 128 MiB elementwise stream). The
pairwise_dist row's kernel runs its product as 3xTF32 on the tensor cores
(three TF32 products per f32 one), so its operations term is 3 x flops
over a TF32 product peak measured the same way (``torch.mm`` with TF32
on, k = 8,192: a yardstick only, the port never calls it). A fraction
above 1 means the working set stayed in cache or a count is wrong. Times
are the least single call, by CUDA events on the card.

The hop updates its ``visited`` bitset in place (``ops.hop``), so every
warm-up and timed call gets its own zeroed bitset, made before timing:
with one bitset every call after the first would find its ids visited and
time no distance work.

Run: ``python -m repro_torch.bench.roofline [--smoke] [--strict]
[--device cpu] [--b 64] [--n 100000] [--d 128] [--m 16] [--iters 20]
[--out PATH]``. Writes ``artifacts/BENCH_torch_roofline.json``
(``..._smoke.json`` under ``--smoke``) or ``--out``. ``--strict`` exits 1
on an errored or non-finite row.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import bitset
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["measure_peaks", "make_problem", "kernel_rows", "run_kernels",
           "main"]

STREAM_FLOATS = 32 * 1024 * 1024      # 128 MiB of f32
TF32_K = 8192                         # the TF32 peak's product size


def _mm_flops(device, k, iters, tf32) -> float:
    """FLOP/s of a k x k x k f32 ``torch.mm``, TF32 on or off, the least
    single call of ``iters``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        a = torch.ones((k, k), dtype=torch.float32, device=device)
        b = torch.ones((k, k), dtype=torch.float32, device=device)
        c = torch.empty((k, k), dtype=torch.float32, device=device)
        t = common.time_calls(lambda i: torch.mm(a, b, out=c), device,
                              iters=iters, warmup=2, reduce="min")
        return 2.0 * k ** 3 / t
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def measure_peaks(device: torch.device, iters=10,
                  sizes=(1024, 8192)) -> dict:
    """Measured device peaks: f32 matrix-product FLOP/s (TF32 off, the
    fastest of ``sizes``), the TF32 product's FLOP/s (TF32 on, k =
    TF32_K or the largest of ``sizes`` if smaller; on the CPU, which has
    no TF32, an f32 product's) and the
    bytes/s of an out-of-cache elementwise stream (one read and one write
    of 128 MiB)."""
    by_size = {k: _mm_flops(device, k, iters, False) for k in sizes}
    peak_flops = max(by_size.values())
    tf32_k = min(TF32_K, max(sizes))
    peak_tf32 = _mm_flops(device, tf32_k, iters, True)
    x = torch.ones((STREAM_FLOATS,), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    t = common.time_calls(lambda i: torch.mul(x, 1.5, out=y), device,
                          iters=iters, warmup=2, reduce="min")
    peak_bw = 2.0 * x.numel() * x.element_size() / t
    return {
        "peak_gflops": peak_flops / 1e9,
        "peak_tf32_gflops": peak_tf32 / 1e9,
        "tf32_k": tf32_k,
        "peak_gbps": peak_bw / 1e9,
        "ridge_intensity_flop_per_byte": peak_flops / peak_bw,
        "matmul_gflops_by_k": {str(k): v / 1e9 for k, v in by_size.items()},
    }


def make_problem(B, n, d, M, device, seed=11) -> dict:
    """One shared problem at the benchmark shape: ``repro``'s
    ``_mk_problem``, the same numpy draws in the same order."""
    rng = np.random.default_rng(seed)
    W, m_out = 4, M
    logn = max(int(np.ceil(np.log2(max(n, 2)))), 1)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return {
        "B": B, "n": n, "d": d, "M": M, "W": W, "m_out": m_out,
        "logn": logn, "K": (logn + 1) * M, "device": device,
        "q": t(rng.standard_normal((B, d)), torch.float32),
        "table": t(rng.standard_normal((n, d)), torch.float32),
        "nbrs": t(common.elemental_table(rng, n, M, logn), torch.int32),
        "u": t(rng.integers(0, n, (B, W)).astype(np.int32), torch.int32),
        "L": t(rng.integers(0, n // 2, B * W).astype(np.int32), torch.int32),
        "gids": t(rng.integers(-1, n, (B, W * m_out)).astype(np.int32),
                  torch.int32),
        "cand_ids": t(rng.integers(0, n, (B, 4 * M)).astype(np.int32),
                      torch.int32),
        "cand_dists": t(rng.random((B, 4 * M)), torch.float32),
    }


def kernel_rows(p, iters, warmup=2):
    """(name, fn(i), flops, bytes) per hot-path kernel, with ``repro``'s
    counts: bytes as if every table access missed cache, multiply-adds as 2
    flops and, for the integer kernels, compare/select ops as 1 each."""
    B, n, d = p["B"], p["n"], p["d"]
    W, m_out, K, logn = p["W"], p["m_out"], p["K"], p["logn"]
    F, WM = B * W, W * m_out
    C = p["cand_ids"].shape[1]
    words = bitset.num_words(n)
    q, table, nbrs = p["q"], p["table"], p["nbrs"]
    u, L, gids = p["u"], p["L"], p["gids"]
    R = L + n // 2 - 1
    us = u.reshape(F)
    exp_ok = torch.ones((B, W), dtype=torch.bool, device=p["device"])
    # the hop sets bits in place: one zeroed bitset per call
    vis = [bitset.make(B, n, device=p["device"])
           for _ in range(warmup + iters)]

    scan_ops = 12 * F * K              # validity: bounds + layer-mask tests
    dedup_ops = 4 * F * K * m_out      # m_out masked-argmin + wipe sweeps

    return [
        ("pairwise_dist", lambda i: ops.pairwise_dist(q, table),
         2 * B * n * d + 3 * B * n,
         4 * (B * d + n * d + B * n)),
        ("gather_dist", lambda i: ops.gather_dist(q, table, gids),
         2 * B * WM * d + 3 * B * WM,
         4 * (B * d + B * WM * d + 2 * B * WM)),
        ("edge_select", lambda i: ops.select_edges(
            nbrs, us, L, R, logn=logn, m_out=m_out),
         scan_ops + dedup_ops,
         4 * (F * K + 3 * F + F * m_out)),
        ("hop", lambda i: ops.hop(
            q, table, nbrs, u, L, R, vis[i], exp_ok, logn=logn,
            m_out=m_out),
         scan_ops + dedup_ops + 2 * B * WM * d + 13 * B * WM,
         4 * (F * K + B * WM * d + 2 * B * words + B * d + 3 * B * WM)),
        ("prune", lambda i: ops.prune(
            p["cand_ids"], p["cand_dists"], table, m=p["M"]),
         B * (2 * p["M"] * C * d + 8 * p["M"] * C + 3 * C * C),
         4 * (B * C * d + 2 * B * C + B * p["M"])),
    ]


def run_kernels(p, peaks, iters, warmup=2) -> list[dict]:
    """One record per kernel row; a row whose call raises records the
    error (``--strict`` and ``chip_smoke.py`` fail on it)."""
    rows = []
    pb = peaks["peak_gbps"] * 1e9
    for name, fn, flops, nbytes in kernel_rows(p, iters, warmup):
        # ops over the peak of the units the kernel runs on: pairwise_dist
        # runs 3xTF32, three TF32 products for each f32 one of its count
        if name == "pairwise_dist":
            ops, pf = 3 * flops, peaks["peak_tf32_gflops"] * 1e9
        else:
            ops, pf = flops, peaks["peak_gflops"] * 1e9
        row = {"kernel": name, "flops": int(flops), "bytes": int(nbytes),
               "intensity_flop_per_byte": flops / nbytes}
        try:
            t = common.time_calls(fn, p["device"], iters=iters,
                                  warmup=warmup, reduce="min")
        except Exception as e:  # noqa: BLE001 - recorded, fails --strict
            row["error"] = f"{type(e).__name__}: {e}"
            rows.append(row)
            continue
        t_bound = max(ops / pf, nbytes / pb)
        row.update({
            "time_us": t * 1e6,
            "achieved_gflops": flops / t / 1e9,
            "achieved_gbps": nbytes / t / 1e9,
            "bound_us": t_bound * 1e6,
            "achieved_fraction": t_bound / t,
            "bottleneck": (
                "compute" if ops / pf >= nbytes / pb else "memory"),
        })
        rows.append(row)
    return rows


def failures_of(rows, peaks) -> list[str]:
    """What ``--strict`` fails on: errored rows, non-finite numbers."""
    out = []
    if not all(math.isfinite(peaks[k]) and peaks[k] > 0
               for k in ("peak_gflops", "peak_tf32_gflops", "peak_gbps")):
        out.append(f"non-finite device peaks: {peaks}")
    for r in rows:
        if "error" in r:
            out.append(f"kernel {r['kernel']} errored: {r['error']}")
        elif not all(math.isfinite(r[k]) for k in
                     ("time_us", "bound_us", "achieved_fraction")):
            out.append(f"kernel {r['kernel']} non-finite measurement")
    return out


def _csv_rows(rows):
    csv = []
    for r in rows:
        if "error" in r:
            csv.append(("roofline", r["kernel"], "error", r["error"][:60],
                        "", "", "", "", ""))
            continue
        csv.append((
            "roofline", r["kernel"], r["bottleneck"],
            f"{r['time_us']:.1f}us", f"{r['flops']:.3e}",
            f"{r['bytes']:.3e}", f"{r['intensity_flop_per_byte']:.2f}",
            f"{r['achieved_gbps']:.2f}GB/s",
            f"{r['achieved_fraction']:.3f}"))
    return csv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes, few iterations: a schema probe, not "
                         "a measurement")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on an errored or non-finite row")
    ap.add_argument("--out", default=None,
                    help="where to write the JSON record")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.b, args.n, args.d, args.m = 8, 4096, 32, 8
        args.iters = 3
    # a CPU cannot afford the k = 8,192 product
    sizes = (1024, 8192) if device.type == "cuda" and not args.smoke \
        else (1024,)

    peaks = measure_peaks(device, iters=max(3, args.iters // 2),
                          sizes=sizes)
    print(f"device peaks: {peaks['peak_gflops']:.1f} GFLOP/s  (TF32 "
          f"{peaks['peak_tf32_gflops']:.1f})  "
          f"{peaks['peak_gbps']:.1f} GB/s  (ridge "
          f"{peaks['ridge_intensity_flop_per_byte']:.1f} flop/B)")
    p = make_problem(args.b, args.n, args.d, args.m, device)
    rows = run_kernels(p, peaks, args.iters)
    common.emit(_csv_rows(rows))
    failures = failures_of(rows, peaks)

    payload = {
        "host": {**common.device_info(device), "smoke": args.smoke},
        "config": {"B": args.b, "n": args.n, "d": args.d, "M": args.m,
                   "iters": args.iters},
        "peaks": peaks,
        "kernels": rows,
    }
    out = args.out or os.path.join(
        common.artifacts_dir(), "BENCH_torch_roofline_smoke.json"
        if args.smoke else "BENCH_torch_roofline.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", out)
    if failures:
        for msg in failures:
            print(f"roofline: {msg}", file=sys.stderr)
        if args.strict:
            print(f"roofline: FAIL ({len(failures)} degraded rows, "
                  "--strict)", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
