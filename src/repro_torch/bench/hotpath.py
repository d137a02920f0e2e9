"""Beam-search hot-path benchmark of the port (``repro``'s
``benchmarks/hotpath.py``): the seed formulation against the composed and
fused ones, step by step, with the same sections and keys.

  * ``expansion_step`` — one hop's visited test-and-set and neighbour
    distances for [B, M] ids (B 64, n 100,000, d 128, M 16 by default):
    the seed formulation (dense ``bool[B, n]`` visited, a torch gather of
    [B, M, d] rows, einsum) against the packed bitset and
    ``ops.gather_dist``;
  * ``edge_select_step`` — edge improvisation for the [B*4] frontier: the
    argsort formulation (``core/edge_select.py``) against
    ``ops.select_edges``, asserted identical first;
  * ``hop_fused`` — one whole hop three ways: the seed composition
    (argsort, dense visited, gather + einsum), ``ops.hop(impl=
    "composed")`` (three dispatched ops) and the fused ``ops.hop``;
    composed and fused outputs (ids, distances, mask, visited words) are
    asserted identical before anything is timed;
  * ``autotune`` — each kernel's launch-plan candidates at the main
    paths' shapes (``kernels/autotune.py::PROBES``, pinned: the same in
    ``--smoke`` and full runs), each held against the default plan's
    outputs and timed by device time with L2 cold; the picks are
    installed for the rest of the run, then cleared. On the CPU there is
    no kernel: the section lists the candidates, untimed;
  * ``search_sweep`` — end-to-end QPS and recall@10 over ``expand_width``
    1, 2, 4, 8 and ``edge_impl`` argsort against auto (wit-like);
  * ``storage_footprint`` — the same graph in f32/int32 against
    bf16/int16 (bytes and recall), the neighbour codecs' id identity, and
    the int8 and PQ legs (``footprint_ratio``, ``nav_footprint_ratio``,
    ``recall_delta`` against f32 at ef 64; int8 at ef 128, PQ at ef 128
    with rerank 128);
  * ``serve_latency`` — the executor's power-of-two batch buckets against
    always padding to ``max_batch``, and a mixed-workload probe that
    counts cache entries against the ``configs × batch_buckets ×
    k_buckets`` grid (``repro`` counts compiles).

The steps are timed with CUDA events over back-to-back calls on the card
(``bench/common.py::time_calls``), so a wrapper's host time enters where
it exceeds the card's; on the CPU (``--device cpu``: the plain versions)
by the host clock, and no number is a device number.

Usage: ``python -m repro_torch.bench.hotpath [--smoke] [--device cpu]
[--no-sweep] [--b 64] [--n 100000] [--d 128] [--m 16] [--iters 50]
[--out PATH] [--update-smoke-ref]``. The record goes to
``artifacts/BENCH_torch_hotpath.json`` (``..._smoke.json`` with
``--smoke``, whose shapes are tiny and numbers meaningless); a full run
carries the committed record's ``smoke_ref`` forward and ``--smoke
--update-smoke-ref`` rewrites it.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import bitset
from repro_torch.core import edge_select as argsort_mod
from repro_torch.core import storage as storage_mod
from repro_torch.core.config import SearchConfig
from repro_torch.core.search_ref import _pairdist
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune as autotune_mod
from repro_torch.kernels import ops

__all__ = ["bench_expansion_step", "bench_edge_select", "bench_hop_fused",
           "bench_autotune", "bench_search_sweep", "bench_storage_footprint",
           "bench_serve_latency", "main"]

L2_FLUSH_BYTES = 128 << 20  # written before a cold launch: > the 50 MB L2


def _logn(n: int) -> int:
    return max(int(np.ceil(np.log2(max(n, 2)))), 1)


def _t(a, dev, dtype=None):
    return torch.as_tensor(a, dtype=dtype, device=dev)


def _us(fn, dev, iters) -> float:
    return common.time_calls(lambda i: fn(), dev, iters=iters,
                             warmup=2) * 1e6


def _dense_mark(dense, ids, valid):
    """``dense[b, ids] |= valid`` (the seed's ``.at[].max``)."""
    return dense.scatter_reduce(1, ids.clamp_min(0).long(),
                                valid.to(torch.uint8), "amax")


def bench_expansion_step(B, n, d, M, iters, device):
    """One hop: visited test+mark and neighbour distances for [B, M] ids.
    Each call starts from the empty visited state (a copy, as the seed's
    functional update makes one)."""
    rng = np.random.default_rng(0)
    vectors = _t(rng.standard_normal((n, d)), device, torch.float32)
    q = _t(rng.standard_normal((B, d)), device, torch.float32)
    nbr = _t(rng.integers(0, n, (B, M)).astype(np.int32), device)
    rows = torch.arange(B, device=device)[:, None]
    dense0 = torch.zeros((B, n), dtype=torch.uint8, device=device)
    bits0 = bitset.make(B, n, device=device)

    def seed_step():
        nvalid = (nbr >= 0) & ~dense0[rows, nbr.clamp_min(0).long()].bool()
        dense = _dense_mark(dense0, nbr, nvalid)
        nx = vectors[nbr.clamp_min(0).long()]           # [B, M, d]
        return dense, torch.where(nvalid, _pairdist(q, nx, "l2"), torch.inf)

    def fused_step():
        bits, seen = bitset.test_and_set(bits0.clone(), nbr, nbr >= 0)
        nvalid = (nbr >= 0) & ~seen
        return bits, ops.gather_dist(q, vectors, torch.where(nvalid, nbr, -1))

    seed_us = _us(seed_step, device, iters)
    fused_us = _us(fused_step, device, iters)
    return {
        "seed_us": seed_us, "fused_us": fused_us,
        "speedup": seed_us / fused_us,
        "visited_state_bytes": {"dense": int(B * n),
                                "bitset": int(B * bitset.num_words(n) * 4)},
    }


def _edge_problem(rng, B, n, m, W, device):
    logn = _logn(n)
    nbrs = _t(common.elemental_table(rng, n, m, logn), device)
    F = B * W
    us = _t(rng.integers(0, n, F).astype(np.int32), device)
    L = rng.integers(0, n // 2, F).astype(np.int32)
    R = (L + n // 2 - 1).astype(np.int32)
    return nbrs, us, _t(L, device), _t(R, device), logn


def bench_edge_select(B, n, m, iters, device):
    """Edge improvisation for a [B*4] frontier: the argsort formulation
    against ``ops.select_edges`` (ids asserted identical first)."""
    rng = np.random.default_rng(1)
    nbrs, us, L, R, logn = _edge_problem(rng, B, n, m, 4, device)
    impl = ops.default_impl("edge", us)

    def argsort_step():
        return argsort_mod.select_edges_batch(nbrs, us, L, R, logn=logn,
                                              m_out=m)

    def sortfree_step():
        return ops.select_edges(nbrs, us, L, R, logn=logn, m_out=m)

    if not torch.equal(argsort_step(), sortfree_step()):
        raise AssertionError("edge-selection formulations diverged")
    argsort_us = _us(argsort_step, device, iters)
    sortfree_us = _us(sortfree_step, device, iters)
    return {
        "frontier": int(us.shape[0]), "K": int(nbrs.shape[1] * m),
        "logn": int(logn), "argsort_us": argsort_us,
        "sortfree_us": sortfree_us, "speedup": argsort_us / sortfree_us,
        "edge_impl": impl,
    }


def bench_hop_fused(B, n, d, M, iters, device):
    """One whole hop three ways (see the module docstring). Composed and
    fused outputs are asserted identical before anything is timed; the
    seed composition must improvise the same edges (its newly visited
    mask is not compared: the dense map marks an id that appears twice in
    a row visited twice, the exactly-once defect the bitset fixed)."""
    rng = np.random.default_rng(3)
    W, m_out = 4, M
    logn = _logn(n)
    nbrs = _t(common.elemental_table(rng, n, M, logn), device)
    table = _t(rng.standard_normal((n, d)), device, torch.float32)
    q = _t(rng.standard_normal((B, d)), device, torch.float32)
    u = _t(rng.integers(0, n, (B, W)).astype(np.int32), device)
    L = _t(rng.integers(0, n // 2, B * W).astype(np.int32), device)
    R = L + n // 2 - 1
    vis0 = bitset.make(B, n, device=device)
    dense0 = torch.zeros((B, n), dtype=torch.uint8, device=device)
    exp_ok = torch.ones((B, W), dtype=torch.bool, device=device)
    rows = torch.arange(B, device=device)[:, None]
    impl = ops.resolve_hop("auto", "auto", "auto", q)[0]

    def seed_hop():
        nbr = argsort_mod.select_edges_batch(
            nbrs, u.reshape(B * W), L, R, logn=logn, m_out=m_out
        ).reshape(B, W * m_out)
        pre = (nbr >= 0) & exp_ok.repeat_interleave(m_out, dim=1)
        nvalid = pre & ~dense0[rows, nbr.clamp_min(0).long()].bool()
        dense = _dense_mark(dense0, nbr, nvalid)
        nx = table[nbr.clamp_min(0).long()]             # [B, W*m_out, d]
        nd = torch.where(nvalid, _pairdist(q, nx, "l2"), torch.inf)
        return nbr, nd, nvalid, dense

    def hop(how):
        return ops.hop(q, table, nbrs, u, L, R, vis0.clone(), exp_ok,
                       logn=logn, m_out=m_out, impl=how)

    a, b, c = seed_hop(), hop("composed"), hop("auto")
    if not torch.equal(a[0], b[0]):
        raise AssertionError("seed vs composed edge ids diverged")
    for x, y, what in zip(b, c, ("nbr", "ndist", "nvalid", "visited")):
        if not torch.equal(x, y):
            raise AssertionError(f"composed vs fused hop diverged on {what}")
    seed_us = _us(seed_hop, device, iters)
    composed_us = _us(lambda: hop("composed"), device, iters)
    fused_us = _us(lambda: hop("auto"), device, iters)
    return {
        "W": W, "m_out": int(m_out), "K": int(nbrs.shape[1] * M),
        "logn": int(logn), "hop_impl": impl,
        "seed_us": seed_us, "composed_us": composed_us, "fused_us": fused_us,
        "speedup": seed_us / fused_us,
        "launch_fusion_speedup": composed_us / fused_us,
        "outputs_identical": True,
    }


# ---------------------------------------------------------------------------
# autotune: the kernels' launch plans at the main paths' shapes
# ---------------------------------------------------------------------------

def _hop_inputs(g, n, d, B, W, m, dev):
    """One beam step's hop inputs on a synthetic table of n rows (as
    ``prune_time.py::hop_problem`` draws them): edges inside their layer's
    segment, 15% -1; query ranges of 2^-i of the table (i in 0..10); W
    frontier nodes inside each range, 90% expandable; 32 in-range ids
    already visited."""
    logn = _logn(n)
    layers = logn + 1
    shift = (logn - torch.arange(layers, device=dev))[None, :, None]
    lo = (torch.arange(n, device=dev)[:, None, None] >> shift) << shift
    base = torch.randint(0, n, (n, layers, m), generator=g, device=dev)
    nbrs = (lo + base % (2 ** shift)).clamp_max(n - 1)
    drop = torch.rand((n, layers, m), generator=g, device=dev) < 0.15
    nbrs = torch.where(drop, -1, nbrs).to(torch.int32).contiguous()
    del base, drop, lo
    frac = torch.randint(0, 11, (B,), generator=g, device=dev)
    span = (n >> frac).clamp_min(1)
    L = (torch.rand((B,), generator=g, device=dev, dtype=torch.float64)
         * (n - span + 1)).long()

    def pick(k):
        r = torch.rand((B, k), generator=g, device=dev, dtype=torch.float64)
        return (L[:, None] + (r * span[:, None]).long()).to(torch.int32)

    u = pick(W).contiguous()
    exp_ok = torch.rand((B, W), generator=g, device=dev) < 0.9
    vis = bitset.make(B, n, device=dev)
    seen = pick(32)
    bitset.test_and_set(vis, seen, torch.ones_like(seen, dtype=torch.bool))
    q = torch.randn((B, d), generator=g, device=dev)
    Lw = L.to(torch.int32).repeat_interleave(W).contiguous()
    Rw = (L + span - 1).to(torch.int32).repeat_interleave(W).contiguous()
    return q, nbrs, u, Lw, Rw, vis, exp_ok, logn


def _int8_table(g, n, d, dev):
    codes = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand((n,), generator=g, device=dev) * 0.05
    return storage_mod.Int8Vectors(codes, scales)


def _gather_run(g, p, dev):
    n = 1 << 20 if p["d"] == 128 else 131072
    x = torch.randn((n, p["d"]), generator=g, device=dev)
    table = _int8_table(g, n, p["d"], dev) if p["layout"] == "int8" else x
    q = torch.randn((p["B"], p["d"]), generator=g, device=dev)
    r = torch.rand((p["B"], p["M"]), generator=g, device=dev,
                   dtype=torch.float64)
    ids = (r * n).long().clamp_max(n - 1)
    drop = torch.rand((p["B"], p["M"]), generator=g, device=dev) < 0.05
    ids = torch.where(drop, -1, ids).to(torch.int32).contiguous()
    kind = "gather_dist_codec" if p["layout"] == "int8" else "gather_dist"
    return kind, (lambda **o: ops.gather_dist(q, table, ids, impl="cuda",
                                              **o)), None, None


def _hop_run(g, p, dev):
    n = 1 << 20 if p["d"] == 128 else 131072
    q, nbrs, u, Lw, Rw, vis0, exp_ok, logn = _hop_inputs(
        g, n, p["d"], p["B"], p["W"], 16, dev)
    table = torch.randn((n, p["d"]), generator=g, device=dev)
    vis = vis0.clone()

    def run(**o):
        return ops.hop(q, table, nbrs, u, Lw, Rw, vis, exp_ok, logn=logn,
                       m_out=p["m_out"], impl="cuda", **o)

    return "hop", run, (lambda: vis.copy_(vis0)), None


def _prune_run(g, p, dev):
    n = 1 << 20 if p["d"] == 128 else 131072
    B, C, d = p["B"], p["C"], p["d"]
    x = torch.randn((n, d), generator=g, device=dev)
    node = (torch.rand((B,), generator=g, device=dev) * n).long()
    cand = ((node >> 12) << 12)[:, None] + (torch.rand(
        (B, C), generator=g, device=dev) * 4096).long()
    cand = torch.where((cand < n) & (cand != node[:, None]), cand, -1)
    cand = cand.to(torch.int32).contiguous()
    cvec = x[cand.clamp_min(0).long()]
    du = torch.where(cand >= 0, ((cvec - x[node][:, None, :]) ** 2).sum(-1),
                     torch.inf).contiguous()

    def same(got, want):
        return common.prune_parity(got, want, cand, du, cvec, 16)[2]

    return "prune", (lambda **o: ops.prune(cand, du, x, m=16, impl="cuda",
                                           **o)), None, same


def _edge_run(g, p, dev):
    q, nbrs, u, Lw, Rw, _, _, logn = _hop_inputs(g, 1 << 20, 8,
                                                 p["F"] // 4, 4, 16, dev)
    us = u.reshape(-1).contiguous()
    return "edge_select", (lambda **o: ops.select_edges(
        nbrs, us, Lw, Rw, logn=logn, m_out=16, impl="cuda")), None, None


_RUNS = {"gather_dist": _gather_run, "gather_dist_codec": _gather_run,
         "hop": _hop_run, "prune": _prune_run, "edge_select": _edge_run}


def bench_autotune(device, iters=20):
    """Every kind's candidates at each of its probe shapes
    (``autotune.PROBES``): on the card each is held against the default
    plan's outputs (distances and ids bit-identical; the prune's kept ids
    but for near ties, ``common.prune_parity``) and timed by device time
    with L2 cold; the best is installed for its shape. On the CPU the
    candidates are listed untimed. Returns the ``autotune`` section."""
    cuda = device.type == "cuda"
    records = {}
    probes = {}
    for kind, plist in autotune_mod.PROBES.items():
        probes[kind] = [dict(p) for p in plist]
        records[kind] = []
        for p in plist:
            cands = autotune_mod.CANDIDATES[kind](p)
            if not cuda:
                records[kind].append({
                    "kind": kind, "probe": p["name"], "best": cands[0],
                    "best_ms": None,
                    "candidates": [{"params": c, "ms": None} for c in cands],
                    "default": cands[0], "default_ms": None, "refused": [],
                    "tunable": len(cands) > 1})
                continue
            g = torch.Generator(device=device)
            g.manual_seed(7)
            _, run, reset, same = _RUNS[kind](g, p, device)
            flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)

            def cold(i, reset=reset, flush=flush):
                if reset is not None:
                    reset()
                flush.fill_(float(i))

            rec = autotune_mod.autotune(kind, run, iters=iters,
                                        candidates=cands, same=same,
                                        reset=cold, device=device)
            rec["probe"] = p["name"]
            if not rec["tunable"]:
                rec["why"] = ("the kernel takes no tile at run time: one "
                              "warp a frontier row, eight a CTA, the "
                              "scanned layers staged at once")
            records[kind].append(rec)
            at = {f: p[f] for f in autotune_mod.KEYS[kind]}
            autotune_mod.set_pick(kind, {**rec["best"], "at": at})
            del run, reset, same, flush
            torch.cuda.empty_cache()
    return {"probe": probes, "interpret": False, "timed": cuda,
            "iters": int(iters), "picks": autotune_mod.all_picks(),
            "records": records}


# ---------------------------------------------------------------------------
# end to end: the sweep, the storage footprint, the serving executor
# ---------------------------------------------------------------------------

def _measure(index, cfg, wl, gt_index=None):
    r = common.measure(common.make_searcher(index, config=cfg), wl,
                       gt_index or index, k=common.DEFAULT_K)
    return {k: float(v) for k, v in r.items()}


def bench_search_sweep(device, widths=(1, 2, 4, 8), edge_impls=("argsort",),
                       dataset="wit-like", n_queries=128):
    index = common.build_index(dataset, device=device)
    wl = common.make_workload(index, "mixed", n_queries=n_queries)
    auto_edge = ops.default_impl("edge", index.vectors)
    rows = []
    for w in widths:
        rows.append({"expand_width": w, "edge_impl": auto_edge,
                     **_measure(index, SearchConfig(ef=64, expand_width=w),
                                wl)})
    for impl in edge_impls:
        if impl == auto_edge:
            continue
        rows.append({"expand_width": 4, "edge_impl": impl,
                     **_measure(index, SearchConfig(ef=64, edge_impl=impl),
                                wl)})
    return rows


def bench_storage_footprint(device, dataset="wit-like", n_queries=64,
                            seed=0):
    """The same graph in f32/int32 against bf16/int16, int8 and PQ
    (``astype_storage``: only the tables' codecs change), recall@10
    against the f32 index's ground truth. ``seed``: the dataset's and
    the build's (``common.build_index``); the queries stay the same
    draw."""
    # the baseline pinned to f32 so an RTORCH_STORAGE leg still measures
    # the codecs against true f32/int32
    idx32 = common.build_index(dataset, storage=storage_mod.StorageConfig(),
                               seed=seed, device=device)
    idxc = idx32.astype_storage(storage_mod.StorageConfig.compact())
    nb = storage_mod.table_nbytes
    wl = common.make_workload(idx32, "mixed", n_queries=n_queries)
    out = {
        "dataset": dataset,
        "f32_bytes": int(idx32.nbytes), "compact_bytes": int(idxc.nbytes),
        "footprint_ratio": idxc.nbytes / idx32.nbytes,
        "vector_dtype": str(idxc.vectors.dtype).replace("torch.", ""),
        "neighbor_dtype": str(idxc.neighbors.dtype).replace("torch.", ""),
        "hop_tables_bytes": {
            "f32": int(nb(idx32.vectors) + nb(idx32.neighbors)),
            "compact": int(nb(idxc.vectors) + nb(idxc.neighbors))},
    }
    for tag, idx in (("f32", idx32), ("compact", idxc)):
        out[tag] = _measure(idx, SearchConfig(ef=64), wl, idx32)
    out["recall_delta"] = out["compact"]["recall"] - out["f32"]["recall"]
    nq = min(16, len(wl.queries))
    args = (wl.queries[:nq], wl.L[:nq], wl.R[:nq])
    a = idx32.search_ranks(*args, k=common.DEFAULT_K,
                           config=SearchConfig(ef=64))
    for codec in ("int16", "split"):
        idxn = idx32.astype_storage(
            storage_mod.StorageConfig(neighbor_dtype=codec))
        b = idxn.search_ranks(*args, k=common.DEFAULT_K,
                              config=SearchConfig(ef=64))
        out[f"neighbor_codec_ids_identical_{codec}"] = bool(
            torch.equal(a.ids, b.ids))
    out["neighbor_codec_ids_identical"] = \
        out["neighbor_codec_ids_identical_int16"]
    # the quantized legs buy recall back with a deeper beam (and PQ with
    # the int8 sidecar's rerank), as repro's do
    codec_cfg = {"int8": SearchConfig(ef=128),
                 "pq": SearchConfig(ef=128, rerank=128)}
    for tag, st in (("int8", storage_mod.StorageConfig.int8()),
                    ("pq", storage_mod.StorageConfig.pq())):
        qidx = idx32.astype_storage(st)
        nav = nb(qidx.vectors) + nb(qidx.neighbors) + qidx.attrs.nbytes
        leg = {"bytes": int(qidx.nbytes), "nav_bytes": int(nav),
               "rerank_bytes": int(nb(qidx.rerank)),
               "footprint_ratio": qidx.nbytes / idx32.nbytes,
               "nav_footprint_ratio": nav / idx32.nbytes}
        for mode, cfg in (("plain", SearchConfig(ef=64)),
                          ("rerank", codec_cfg[tag])):
            leg[mode] = _measure(qidx, cfg, wl, idx32)
        leg["recall_delta"] = leg["rerank"]["recall"] - out["f32"]["recall"]
        out[tag] = leg
    return out


def bench_serve_latency(device, dataset="ytaudio-like", max_batch=64,
                        small_batches=(1, 2, 4, 8), iters=20):
    """Bucketed flushes against always padding to ``max_batch`` on small
    batches (both executors warmed), and the mixed-workload probe: cache
    entries after warmup, within the declared grid."""
    from repro_torch.serve.executor import SearchExecutor

    index = common.build_index(dataset, device=device)
    k = common.DEFAULT_K
    cfg = SearchConfig(ef=64, k_bucket=k)
    bucketed = SearchExecutor(index, cfg, max_batch=max_batch, warmup=False)
    padmax = SearchExecutor(index, cfg, max_batch=max_batch,
                            batch_buckets=(max_batch,), warmup=False)
    small_bbs = sorted({bucketed.batch_bucket(b) for b in small_batches})
    bucketed.warmup(batch_buckets=small_bbs, k_buckets=(k,))
    padmax.warmup(batch_buckets=(max_batch,), k_buckets=(k,))
    wl = common.make_workload(index, "mixed", n_queries=max_batch)
    rows = []
    for B in small_batches:
        q, L, R = wl.queries[:B], wl.L[:B], wl.R[:B]
        tb = _us(lambda: bucketed.search_ranks(q, L, R, k=k), device, iters)
        tp = _us(lambda: padmax.search_ranks(q, L, R, k=k), device, iters)
        rows.append({"B": int(B), "bucket": int(bucketed.batch_bucket(B)),
                     "bucketed_us": tb, "padmax_us": tp,
                     "speedup": tp / tb})
    pcfg = SearchConfig(ef=32, k_bucket=k)
    pcfg2 = pcfg.replace(expand_width=2)
    probe = SearchExecutor(index, pcfg, max_batch=8, warmup=False)
    warm = probe.warmup(configs=(pcfg, pcfg2))
    rng = np.random.default_rng(5)
    for config in (pcfg, pcfg2):
        for _ in range(16):
            B = int(rng.integers(1, probe.max_batch + 1))
            kk = int(rng.integers(1, config.ef + 1))
            probe.search_ranks(wl.queries[:B], wl.L[:B], wl.R[:B], k=kk,
                               config=config)
    return {
        "dataset": dataset, "max_batch": int(max_batch),
        "batch_buckets": list(bucketed.batch_buckets),
        "k_buckets": list(cfg.k_buckets()),
        "rows": rows,
        "small_batch_speedup": rows[0]["speedup"],
        "warmup_compiles": int(warm),
        "post_warmup_compiles": int(probe.stats["compiles"]
                                    - probe.stats["warmup_compiles"]),
        "max_programs": int(probe.program_grid(configs=(pcfg, pcfg2))),
        "compiles": int(probe.stats["compiles"]),
    }


def _fmt(x) -> str:
    return "-" if x is None or not math.isfinite(x) else f"{x:.4f}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the end-to-end expand_width sweep")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes, few iterations: a probe of the hot "
                         "path's shapes, not a measurement (the autotune "
                         "probes stay pinned)")
    ap.add_argument("--update-smoke-ref", action="store_true",
                    help="with --smoke: record this run's ratios as the "
                         "committed record's smoke_ref")
    ap.add_argument("--out", default=None,
                    help="where to write the JSON record")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.b, args.n, args.d, args.m = 8, 4096, 32, 8
        args.iters = 3
    cuda = device.type == "cuda"
    unit = "device" if cuda else "host (plain versions, no device number)"
    impl = "cuda" if cuda else "torch"

    autotune_mod.clear_picks()
    try:
        at = bench_autotune(device, iters=5 if args.smoke else 20)
        for kind, recs in at["records"].items():
            for r in recs:
                print(f"autotune {kind}[{r['probe']}]: pick {r['best']} "
                      f"{_fmt(r['best_ms'])} ms, default {r['default']} "
                      f"{_fmt(r['default_ms'])} ms; "
                      f"{len(r['candidates'])} candidates, "
                      f"{len(r['refused'])} refused", flush=True)
        step = bench_expansion_step(args.b, args.n, args.d, args.m,
                                    args.iters, device)
        print(f"expansion step B={args.b} n={args.n} d={args.d} "
              f"M={args.m} ({unit}): seed {step['seed_us']:.1f} us, fused "
              f"{step['fused_us']:.1f} us ({step['speedup']:.2f}x)",
              flush=True)
        edge = bench_edge_select(args.b, args.n, args.m, args.iters, device)
        print(f"edge select F={edge['frontier']} K={edge['K']}: argsort "
              f"{edge['argsort_us']:.1f} us, {edge['edge_impl']} "
              f"{edge['sortfree_us']:.1f} us ({edge['speedup']:.2f}x)",
              flush=True)
        hop = bench_hop_fused(args.b, args.n, args.d, args.m, args.iters,
                              device)
        print(f"hop B={args.b} W={hop['W']} K={hop['K']}: seed "
              f"{hop['seed_us']:.1f} us, composed {hop['composed_us']:.1f} "
              f"us, fused[{hop['hop_impl']}] {hop['fused_us']:.1f} us "
              f"({hop['speedup']:.2f}x vs seed, "
              f"{hop['launch_fusion_speedup']:.2f}x launch fusion); "
              "composed == fused", flush=True)
        if args.smoke:
            storage = bench_storage_footprint(device, "ytaudio-like",
                                              n_queries=16)
            serve = bench_serve_latency(device, "ytaudio-like",
                                        max_batch=16, small_batches=(1, 4),
                                        iters=3)
        else:
            storage = bench_storage_footprint(device, "wit-like",
                                              n_queries=64)
            serve = bench_serve_latency(device, "ytaudio-like")
        for row in serve["rows"]:
            print(f"serve flush B={row['B']} (bucket {row['bucket']}): "
                  f"bucketed {row['bucketed_us']:.0f} us, pad-to-max "
                  f"{row['padmax_us']:.0f} us ({row['speedup']:.2f}x)",
                  flush=True)
        print(f"serve cache probe: {serve['compiles']} entries (grid max "
              f"{serve['max_programs']}, {serve['post_warmup_compiles']} "
              "after warmup)", flush=True)
        print(f"storage {storage['dataset']}: f32 {storage['f32_bytes']} B "
              f"-> compact {storage['compact_bytes']} B (ratio "
              f"{storage['footprint_ratio']:.3f}) recall "
              f"{storage['f32']['recall']:.4f} -> "
              f"{storage['compact']['recall']:.4f}", flush=True)
        for tag in ("int8", "pq"):
            leg = storage[tag]
            print(f"storage {tag}: ratio {leg['footprint_ratio']:.3f} (nav "
                  f"{leg['nav_footprint_ratio']:.3f}) recall "
                  f"{leg['plain']['recall']:.4f} -> "
                  f"{leg['rerank']['recall']:.4f} rerank (delta "
                  f"{leg['recall_delta']:+.4f})", flush=True)
        sweep = None
        if not args.no_sweep:
            if args.smoke:
                sweep = bench_search_sweep(device, widths=(1, 4),
                                           dataset="ytaudio-like",
                                           n_queries=16)
            else:
                sweep = bench_search_sweep(device)
            for row in sweep:
                print(f"expand_width={row['expand_width']} edge_impl="
                      f"{row['edge_impl']}: qps={row['qps']:.1f} "
                      f"recall={row['recall']:.4f} "
                      f"mean_dists={row['mean_dists']:.0f}", flush=True)
    finally:
        autotune_mod.clear_picks()

    payload = {
        "host": {"backend": device.type, **common.device_info(device),
                 "kernel_interpreted": False, "smoke": args.smoke,
                 "timing": unit},
        "card_line": common.card_line() if cuda else None,
        "config": {"B": args.b, "n": args.n, "d": args.d, "M": args.m,
                   "iters": args.iters, "dist_impl": impl,
                   "edge_impl": impl, "hop_impl": hop["hop_impl"]},
        "expansion_step": step,
        "edge_select_step": edge,
        "hop_fused": hop,
        "autotune": at,
        "storage_footprint": storage,
        "serve_latency": serve,
        "search_sweep": sweep,
    }
    committed = os.path.join(common.artifacts_dir(),
                             "BENCH_torch_hotpath.json")
    if args.smoke:
        out = args.out or os.path.join(common.artifacts_dir(),
                                       "BENCH_torch_hotpath_smoke.json")
        if args.update_smoke_ref:
            refs = {
                "expansion_step.speedup": step["speedup"],
                "edge_select_step.speedup": edge["speedup"],
                "hop_fused.speedup": hop["speedup"],
                "serve_latency.small_batch_speedup":
                    serve["small_batch_speedup"],
            }
            if common.update_smoke_ref(committed, refs):
                print("updated smoke_ref in", committed)
            else:
                print("no committed record to update:", committed)
    else:
        out = args.out or committed
        payload = common.carry_smoke_ref(payload, committed)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", out, flush=True)
    return payload


if __name__ == "__main__":
    main()
