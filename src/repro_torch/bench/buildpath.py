"""Build-path benchmark: the construction prune by backend (``repro``'s
``benchmarks/buildpath.py``).

Two measurements:

  * ``prune_step`` — one batched RNG prune per representative level shape
    (search levels C = m + ef_construction, brute levels C =
    brute_threshold, the reverse pass C = 3m), over chunk sizes and
    backends: ``legacy`` (the eager ``[C, C]`` matrix and C-step scan,
    ``core/rng.py``), ``torch`` (the lazy-column plain version,
    ``kernels/ref.py::prune``) and, on the card, ``cuda`` (the kernel).
    The calls are made as the build makes them, with the gathered
    candidate rows handed in (the kernel gathers its own).
  * ``build_levels`` — a whole ``build_neighbor_table`` per backend under
    the default ``chunk=None``, with seconds and nodes/s per level.

Parity, checked before any timing: legacy and torch keep identical ids
(their distances are the same operations in the same order,
``core/rng.py::pairwise_sq_dists``); cuda against torch differs only in
rows with a near-tie keep decision, in at most 0.1% of rows
(``common.prune_parity``). Whole builds: legacy and torch give the same
table; a cuda build gives the same table or, where a near tie changed a
level, tables whose per-layer edge overlap (mean Jaccard) is >= 0.95.

The record's ratios, as ``repro``'s: ``prune_speedup_best``, the best
over ``prune_step`` rows of the legacy backend's µs over the fused
backend's (``cuda`` on the card, ``torch`` on the CPU), and
``build_speedup``, the legacy build's ``total_s`` over the fused one's.
``bench/ci_gate.py`` compares a smoke run's ``prune_speedup_best`` with
the committed record's ``smoke_ref``.

Run: ``python -m repro_torch.bench.buildpath [--smoke] [--device cpu]
[--n 32768] [--d 64] [--m 16] [--efc 64] [--brute-threshold 128]
[--chunks 512,2048,4096] [--iters 8] [--e2e-n 8192] [--no-e2e]
[--out PATH] [--update-smoke-ref]``. Writes
``artifacts/BENCH_torch_build.json`` (``..._smoke.json`` under
``--smoke``) or ``--out``; a full run carries the committed record's
``smoke_ref`` forward and ``--smoke --update-smoke-ref`` rewrites it.
Exits 1 when parity fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import build as build_mod
from repro_torch.core import knobs as knobs_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["backends_for", "bench_prune_step", "bench_build_levels",
           "table_overlap", "main"]

MIN_LAYER_JACCARD = 0.95


def backends_for(device: torch.device) -> tuple[str, ...]:
    return ("legacy", "torch", "cuda") if device.type == "cuda" \
        else ("legacy", "torch")


def _prune_case(rng, table_np, chunk, C, d, device):
    """Synthetic but build-shaped candidate lists (``repro``'s draws):
    ~10% invalid slots, one duplicated slot per row, distances computed
    the way the build computes them."""
    n = table_np.shape[0]
    ids = rng.integers(0, n, (chunk, C)).astype(np.int32)
    ids[:, -1] = ids[:, 0]                       # duplicates exercise dedup
    ids = np.where(rng.random((chunk, C)) < 0.1, -1, ids).astype(np.int32)
    u = rng.standard_normal((chunk, d)).astype(np.float32)
    cvec = table_np[np.maximum(ids, 0)]
    du = ((cvec - u[:, None, :]) ** 2).sum(-1).astype(np.float32)
    du = np.where(ids < 0, np.inf, du).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (ids, du, cvec))


def bench_prune_step(n, d, m, efc, brute_threshold, chunks, iters, device,
                     backends):
    """Per level shape x chunk: every backend's time per call, and parity.
    Returns (rows, parity)."""
    rng = np.random.default_rng(0)
    table_np = rng.standard_normal((n, d)).astype(np.float32)
    table = torch.as_tensor(table_np, device=device)
    shapes = [("search", m + efc), ("brute", brute_threshold),
              ("reverse", 3 * m)]
    rows = []
    parity = True
    for kind, C in shapes:
        for chunk in chunks:
            ids, du, cvec = _prune_case(rng, table_np, chunk, C, d, device)

            def step(impl):
                return ops.prune(ids, du, table, m=m, alpha=1.0, fill=True,
                                 impl=impl, cand_vecs=cvec)

            got = {impl: step(impl) for impl in backends}
            exact = bool(torch.equal(got["legacy"], got["torch"]))
            row = {"kind": kind, "C": int(C), "m": int(m), "d": int(d),
                   "chunk": int(chunk), "legacy_torch_identical": exact}
            parity &= exact
            if "cuda" in got:
                differ, ties, ok = common.prune_parity(
                    got["cuda"], got["torch"], ids, du, cvec, m)
                row.update(cuda_rows_differ=differ, cuda_near_ties=ties)
                parity &= ok
            for impl in backends:
                s = common.time_calls(lambda i: step(impl), device,
                                      iters=iters, warmup=2)
                row[f"{impl}_us"] = s * 1e6
                row[f"{impl}_nodes_per_s"] = chunk / s
            for impl in backends[1:]:
                row[f"{impl}_speedup"] = row["legacy_us"] / row[f"{impl}_us"]
            rows.append(row)
    return rows, parity


def table_overlap(a, b) -> list[float]:
    """Per layer with edges, the mean per-node Jaccard overlap of two
    ``[n, layers, m]`` tables (each row's ids distinct)."""
    out = []
    for lay in range(a.shape[1] - 1):             # the leaves hold no edges
        x, y = a[:, lay], b[:, lay]
        lx, ly = x >= 0, y >= 0
        inter = ((x[:, :, None] == y[:, None, :]) & lx[:, :, None]).any(2)
        inter = inter.sum(1)
        union = lx.sum(1) + ly.sum(1) - inter
        jac = torch.where(union > 0, inter / union.clamp_min(1), 1.0)
        out.append(float(jac.double().mean()))
    return out


def bench_build_levels(n, d, m, efc, brute_threshold, device, backends):
    """A whole build per prune backend with per-level nodes/s. Returns
    (records, parity, tables agreement)."""
    rng = np.random.default_rng(1)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    out, tables = {}, {}
    for impl in backends:
        cfg = build_mod.BuildConfig(
            m=m, ef_construction=efc, brute_threshold=brute_threshold,
            prune_impl=impl)
        # load the kernels outside the timing
        build_mod.build_neighbor_table(vectors[:min(n, 512)], cfg,
                                       device=device)
        times: list = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        tables[impl] = build_mod.build_neighbor_table(
            vectors, cfg, device=device, level_times=times)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        total = time.perf_counter() - t0
        out[impl] = {
            "total_s": total, "nodes_per_s": n / total,
            "levels": [{**lt, "nodes_per_s": n / max(lt["seconds"], 1e-9)}
                       for lt in times],
        }
    agree = {"legacy_torch_identical": bool(
        torch.equal(tables["legacy"], tables["torch"]))}
    parity = agree["legacy_torch_identical"]
    if "cuda" in tables:
        same_rows = float((tables["cuda"] == tables["torch"]).all(2).all(1)
                          .double().mean())
        jac = table_overlap(tables["cuda"], tables["torch"])
        agree.update(cuda_identical_rows_share=same_rows,
                     cuda_min_layer_jaccard=min(jac))
        parity &= same_rows == 1.0 or min(jac) >= MIN_LAYER_JACCARD
    return out, parity, agree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32_768)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--efc", type=int, default=64)
    ap.add_argument("--brute-threshold", type=int, default=128)
    ap.add_argument("--chunks", type=str, default="512,2048,4096")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--e2e-n", type=int, default=8192)
    ap.add_argument("--no-e2e", action="store_true",
                    help="skip the whole-build measurement")
    ap.add_argument("--device", default=None,
                    help="cpu to run legacy and torch only (default: the "
                         "card, with cuda too)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes, few iterations: a probe of shapes "
                         "and parity, not a measurement")
    ap.add_argument("--update-smoke-ref", action="store_true",
                    help="with --smoke: record this run's ratio as the "
                         "committed record's smoke_ref")
    ap.add_argument("--out", default=None,
                    help="where to write the JSON record")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.n, args.d, args.m, args.efc = 2048, 32, 8, 24
        args.brute_threshold, args.chunks = 32, "256"
        args.iters, args.e2e_n = 2, 1024
    chunks = tuple(int(c) for c in args.chunks.split(","))
    backends = backends_for(device)
    fused = backends[-1]

    step_rows, step_parity = bench_prune_step(
        args.n, args.d, args.m, args.efc, args.brute_threshold, chunks,
        args.iters, device, backends)
    for r in step_rows:
        print(f"prune {r['kind']:7s} C={r['C']:3d} chunk={r['chunk']:5d}: "
              + "  ".join(f"{b} {r[f'{b}_us']:.0f}us" for b in backends))
    best = max(r[f"{fused}_speedup"] for r in step_rows)
    e2e, e2e_parity, agree, e2e_speedup = None, True, None, None
    if not args.no_e2e:
        e2e, e2e_parity, agree = bench_build_levels(
            args.e2e_n, args.d, args.m, args.efc, args.brute_threshold,
            device, backends)
        e2e_speedup = e2e["legacy"]["total_s"] / e2e[fused]["total_s"]
        print(f"e2e build n={args.e2e_n}: " + "  ".join(
            f"{b} {e2e[b]['total_s']:.2f}s" for b in backends)
              + f" ({e2e_speedup:.2f}x legacy/{fused}); "
              + json.dumps(agree))
    print(f"prune_speedup_best ({fused} over legacy): {best:.2f}x")
    payload = {
        "host": {**common.device_info(device), "smoke": args.smoke},
        "card_line": common.card_line() if device.type == "cuda" else None,
        "config": {"n": args.n, "d": args.d, "m": args.m, "efc": args.efc,
                   "brute_threshold": args.brute_threshold,
                   "chunks": list(chunks), "iters": args.iters,
                   "e2e_n": args.e2e_n, "backends": list(backends),
                   "fused_impl": fused},
        "auto_chunk": {
            "budget_mb": knobs_mod.get_int("RTORCH_CHUNK_BUDGET_MB"),
            "search": build_mod.resolve_chunk(
                build_mod.BuildConfig(), args.m + args.efc, args.d,
                floor=build_mod._SEARCH_CHUNK_FLOOR),
            "brute": build_mod.resolve_chunk(
                build_mod.BuildConfig(), args.brute_threshold, args.d),
            "reverse": build_mod.resolve_chunk(
                build_mod.BuildConfig(), 3 * args.m, args.d),
        },
        "parity": bool(step_parity and e2e_parity),
        "prune_step": step_rows,
        "prune_speedup_best": best,
        "build_levels": e2e,
        "build_speedup": e2e_speedup,
        "build_agreement": agree,
    }
    if not payload["parity"]:
        print("ERROR: prune backends diverged", flush=True)
    committed = os.path.join(common.artifacts_dir(),
                             "BENCH_torch_build.json")
    if args.smoke:
        out = args.out or os.path.join(common.artifacts_dir(),
                                       "BENCH_torch_build_smoke.json")
        if args.update_smoke_ref:
            if common.update_smoke_ref(committed,
                                       {"prune_speedup_best": best}):
                print("updated smoke_ref in", committed)
            else:
                print("no committed record to update:", committed)
    else:
        out = args.out or committed
        payload = common.carry_smoke_ref(payload, committed)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", out)
    return 0 if payload["parity"] else 1


if __name__ == "__main__":
    sys.exit(main())
