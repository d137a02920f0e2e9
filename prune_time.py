#!/usr/bin/env python3
"""Time the prune, flash-attention, pairwise-distance, gather-distance and
hop kernels and edge_select of one source tree at the paths' shapes.

``python3 prune_time.py <src dir> [parts]`` imports ``repro_torch`` from
``<src dir>`` (a checkout's ``src``), builds its kernels, and times them
on the card; ``parts`` is a comma-separated subset of ``prune,
prune_designs,flash,pairwise,pairwise_exact,gather,hop,edge,search,
codecs`` (default: all but prune_designs, gather, hop, edge, search and
codecs).

  * prune: n = 1,000,000 random f32 rows of d = 128, B = 16,384 nodes, C =
    80 candidates drawn from a 4,096-row segment (a search level) and C =
    128 (a brute level's whole segment); and n = 131,072 rows of d = 1,024
    (qwen3-0.6b's width), B = 4,096 nodes: C = 144 candidates from a
    4,096-row segment (a search level's chunk) on the f32 table and on
    its int8 encoding, C = 128 (a brute level) and C = 48 (the reverse
    pass's width); m = 16. Reports whether the kept ids equal the plain
    version's, and the tree's plan for the shape (``smem_plan``).
  * prune_designs (this tree's prune only, a tree whose
    ``prune_cuda`` takes a plan ``override``): the prune's regimes
    against each other on the same inputs, each plan forced by
    ``prune.smem_plan``'s override: C = 80 at d = 128 (block, table); C = 144 at d =
    1,024 with random rows (table, partial: one CTA staging the rows that
    fit) and with du scaled by 0.93, so that more rows stay live a sweep,
    as in the lm build's chunk; and the partial regime where it is the
    plan, B = 1,024 nodes at C = 48, d = 4,096 and C = 144, d = 8,192,
    with the plain version's time; each also at 4 and 8 warps a CTA.
    Reports ms and whether the kept ids equal the plain version's.
  * flash: bf16, causal, Hq 16, Hkv 8, Dh 128, in the projections' layout
    ([B, S, H, Dh] viewed as [B, H, S, Dh]): the embed path's B = 256, S =
    32, and B = 1, S = 4,096. Reports the largest |difference| from the
    plain version.
  * pairwise: l2 at the roofline's shape (Bq = 64, N = 100,000, d = 128,
    f32) and at 1,000 x 1,000,000 (d = 128) in f32, bf16 and f16, with
    the library call beside each (``chip_smoke.py::pairwise_library``:
    SGEMM for f32, the 16-bit product with f32 output for the half
    types). Reports the largest |difference| from the plain version over
    ‖q‖² + ‖x‖² and a digest of the output.
  * pairwise_exact (not timed): ip of the 1,000 queries against the
    131,072 rows of ``vector_dataset`` (64 clusters, d = 128, seed 0) in
    f32, bf16 and f16; the kernel and the plain version each against the
    exact dot (f64): how many outputs of each fall outside one bf16 ulp
    plus 1e-5 of the exact dot, and of each other (the half types' old
    gate, a count), and, for bf16 and f16, ``kernels/distance.py::
    half_gate`` of each (outputs over and worst margins).

  * gather: gather_dist on seeded synthetic inputs at the shapes the main
    path launches it (``GATHER_SHAPES``): one step of the build's sibling
    search at its lowest and highest level, at n = 2^20, d = 128 (B =
    32,768) and n = 131,072, d = 1,024 (B = 4,096); the entries' M = 3 at
    B = 32,768 and 1,000; the search's frontier (B = 1,000, M = 64) in
    every stored layout; the server's batch (B = 64, d = 1,024).
  * hop: the fused hop at the search's frontier (B = 1,000, W = 4, m_out
    = 16, n = 2^20, d = 128; every layout) and the server's batch (B =
    64, n = 131,072, d = 1,024), on a synthetic neighbour table.
    For both: device ms per launch from torch.profiler with L2 cold
    (``chip_smoke.py::device_ms``; the build's highest level warm, its
    rows stay in L2 there), the wrapper's host µs per call, the bound, the
    largest |difference| from the plain version, and a digest of the
    outputs: equal digests on two trees, bit-identical outputs.
  * edge: edge_select at the search's frontier (F = 4,000 rows of K = 336
    edge ids, n = 2^20) and the server's (F = 256, n = 131,072), drawn as
    for the hop: device ms with L2 cold, host µs, the bound, the latency
    floor of two dependent round trips (``chip_smoke.py::
    edge_floor_ms``; None on a tree without the probe), whether the ids
    equal the plain version's, and a digest.
  * search (not a kernel): the search QPS of chip_smoke.py's 1M cell
    (``search_part``), the index built by the first run and loaded from
    ``build/`` by every run, so that two trees search one graph.

  * codecs (not timed): ``bench/hotpath.py::bench_storage_footprint``
    on wit-like with 64 queries, as the committed hot-path record, for
    the build seeds in CODEC_SEEDS: each codec leg's ``recall_delta``
    (compact, int8, PQ with rerank) against the same build in f32, and
    each leg's least and largest delta over the seeds, beside
    ``bench/ci_gate.py``'s cap of 0.01.

Prints one JSON line: ms per launch by CUDA events over 20 launches (5 at
the long shapes) after 3 warm-ups (gather and hop: by device time, as
above), and the checks above. To compare two trees, run it once per tree
in turns (a, b, b, a) in one call on one card.
"""
import hashlib
import json
import math
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402

PARTS = ("prune", "prune_designs", "flash", "pairwise", "pairwise_exact",
         "gather", "hop", "edge", "search", "codecs")
CODEC_SEEDS = (0, 1, 2, 3, 4)
LAYOUT_F32 = ("f32",)
LAYOUTS_ALL = ("f32", "bf16", "f16", "int8", "pq")
DEFAULT_PARTS = ("prune", "flash", "pairwise", "pairwise_exact")


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# name, n, d, B, C, candidates ("search": drawn from the node's 4,096-row
# segment; "brute": its whole 128-row segment), stored layout
PRUNE_SHAPES = (
    ("C80", 1_000_000, 128, 16384, 80, "search", "f32"),
    ("C128", 1_000_000, 128, 16384, 128, "brute", "f32"),
    ("d1024_C144", 131072, 1024, 4096, 144, "search", "f32"),
    ("d1024_C144_int8", 131072, 1024, 4096, 144, "search", "int8"),
    ("d1024_C128", 131072, 1024, 4096, 128, "brute", "f32"),
    ("d1024_C48", 131072, 1024, 4096, 48, "search", "f32"),
)


def prune_part(out, dev, g):
    from repro_torch.core import storage
    from repro_torch.kernels import prune

    m = 16
    tables = {}
    for name, n, d, B, C, kind, layout in PRUNE_SHAPES:
        if d not in tables:
            tables[d] = torch.randn((n, d), generator=g, device=dev)
        x = tables[d]
        table = x if layout == "f32" else storage.encode_vectors(
            x, storage.StorageConfig.int8())
        node = (torch.rand((B,), generator=g, device=dev) * n).long()
        if kind == "brute":
            cand = ((node >> 7) << 7)[:, None] + torch.arange(
                C, device=dev)[None, :]
        else:
            cand = ((node >> 12) << 12)[:, None] + (torch.rand(
                (B, C), generator=g, device=dev) * 4096).long()
        cand = torch.where((cand < n) & (cand != node[:, None]), cand, -1)
        cand = cand.to(torch.int32).contiguous()
        cvec = x[cand.clamp_min(0).long()]
        du = torch.where(cand >= 0, ((cvec - x[node][:, None, :]) ** 2)
                         .sum(-1), torch.inf).contiguous()
        del cvec
        same = torch.equal(prune.prune_cuda(cand, du, table, m=m),
                           ref.prune(cand, du, table, m=m))
        out[f"{name}_ms"] = time_ms(
            lambda: prune.prune_cuda(cand, du, table, m=m))
        out[f"{name}_same_as_plain"] = bool(same)
        out[f"{name}_plan"] = list(prune.smem_plan(C, d))


def prune_designs_part(out, dev, g):
    from repro_torch.kernels import prune

    def forced(C, d, regime, warps):
        """The plan override of one design (``prune.smem_plan``)."""
        o = {} if warps is None else {"warps": warps}
        if regime == "table":
            return {**o, "regime": "table"}
        if regime == "block":
            return {**o, "regime": "block", "staged": C}
        base = prune.smem_bytes(C, d, 0)
        staged = (prune.SMEM_LIMIT - base) // ((d + 3) // 4 * 16)
        return {**o, "regime": "block", "staged": staged}

    for name, n, d, B, C, scale, designs in (
            ("C80", 1_000_000, 128, 16384, 80, 1.0, ("block", "table")),
            ("d1024_C144", 131072, 1024, 4096, 144, 1.0,
             ("table", "partial")),
            ("d1024_C144_du093", 131072, 1024, 4096, 144, 0.93,
             ("table", "partial")),
            ("d4096_C48", 131072, 4096, 1024, 48, 1.0, ("partial",)),
            ("d8192_C144", 65536, 8192, 1024, 144, 1.0, ("partial",))):
        x = torch.randn((n, d), generator=g, device=dev)
        node = (torch.rand((B,), generator=g, device=dev) * n).long()
        cand = ((node >> 12) << 12)[:, None] + (torch.rand(
            (B, C), generator=g, device=dev) * 4096).long()
        cand = torch.where((cand < n) & (cand != node[:, None]), cand, -1)
        cand = cand.to(torch.int32).contiguous()
        cvec = x[cand.clamp_min(0).long()]
        du = (torch.where(cand >= 0, ((cvec - x[node][:, None, :]) ** 2)
                          .sum(-1), torch.inf) * scale).contiguous()
        del cvec
        want = ref.prune(cand, du, x, m=16)
        if d >= 4096:
            out[f"{name}_plain_ms"] = time_ms(
                lambda: ref.prune(cand, du, x, m=16), iters=3)
        for regime in designs:
            for warps in (None, 4, 8):
                o = forced(C, d, regime, warps)
                tag = f"{name}_{regime}" + (f"_w{warps}" if warps else "")
                got = prune.prune_cuda(cand, du, x, m=16, override=o)
                out[f"{tag}_same_as_plain"] = bool(torch.equal(got, want))
                out[f"{tag}_ms"] = time_ms(
                    lambda: prune.prune_cuda(cand, du, x, m=16, override=o))
                out[f"{tag}_plan"] = list(prune.smem_plan(C, d, o))
        del x, cand, du, want
        torch.cuda.empty_cache()


# gather_dist: name, table rows n, d, queries B, slots M, segment whose
# sibling half each query's ids come from (0: the whole table), share of
# -1 slots, layouts, L2 cold. build_*: one step of the build's sibling
# search at the lowest level (rows from device memory) and the highest
# (a chunk's rows stay in L2), at the -1 share of its launches (measured
# on the H100 over one chunk's search: 0.73 and 0.92 at n = 1M, 0.49 and
# 0.95 at the lm's n); entries_*: the entry points' M = 3; then the
# search's frontier (every layout) and the server's batch at d = 1,024
GATHER_SHAPES = (
    ("build_1M_low", 1 << 20, 128, 32768, 64, 1 << 20, 0.75, LAYOUT_F32,
     True),
    ("build_1M_high", 1 << 20, 128, 32768, 64, 256, 0.92, LAYOUT_F32,
     False),
    ("build_lm_low", 131072, 1024, 4096, 64, 131072, 0.5, LAYOUT_F32,
     True),
    ("build_lm_high", 131072, 1024, 4096, 64, 256, 0.95, LAYOUT_F32,
     False),
    ("entries_build", 1 << 20, 128, 32768, 3, 1 << 20, 0.0, LAYOUT_F32,
     True),
    ("entries_search", 1 << 20, 128, 1000, 3, 0, 0.0, LAYOUT_F32, True),
    ("frontier", 1 << 20, 128, 1000, 64, 0, 0.05, LAYOUTS_ALL, True),
    ("server", 131072, 1024, 64, 64, 0, 0.05, LAYOUT_F32, True),
)
# the hop: name, n, d, queries B, layouts (W = 4 frontier rows of m = 16
# edges a layer, m_out = 16; L2 cold)
HOP_SHAPES = (
    ("frontier", 1 << 20, 128, 1000, LAYOUTS_ALL),
    ("server", 131072, 1024, 64, LAYOUT_F32),
)
# edge_select: name, n, queries B (W = 4 frontier rows each, F = 4 B; m =
# m_out = 16; L2 cold), drawn as the hop's
EDGE_SHAPES = (
    ("frontier", 1 << 20, 1000),
    ("server", 131072, 64),
)


def digest(*ts) -> str:
    """A short hash of the tensors' bytes: equal digests, equal bits."""
    h = hashlib.sha1()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def tables_of(x, layouts, g):
    """The f32 rows ``x`` in each stored layout: bf16 and f16 casts, and
    int8 codes with scales and PQ codes with a codebook drawn at random
    (d / 4 subspaces of 4): the kernels read what is stored, whatever
    encoded it."""
    from repro_torch.core import storage

    n, d = x.shape
    dev = x.device
    out = {}
    for lay in layouts:
        if lay == "f32":
            out[lay] = x
        elif lay in ("bf16", "f16"):
            out[lay] = x.to(torch.bfloat16 if lay == "bf16"
                            else torch.float16)
        elif lay == "int8":
            codes = torch.randint(-127, 128, (n, d), generator=g,
                                  device=dev, dtype=torch.int8)
            scales = torch.rand((n,), generator=g, device=dev) * 0.05
            out[lay] = storage.Int8Vectors(codes, scales)
        else:
            sub = d // 4
            codes = torch.randint(0, 256, (n, sub), generator=g, device=dev,
                                  dtype=torch.uint8)
            book = torch.randn((sub, 256, 4), generator=g, device=dev)
            out[lay] = storage.PQVectors(codes, book)
    return out


def table_rows(dev, g, n, d, cache):
    if (n, d) not in cache:
        cache.clear()
        torch.cuda.empty_cache()
        cache[(n, d)] = torch.randn((n, d), generator=g, device=dev)
    return cache[(n, d)]


def gather_ids(dev, g, n, B, M, seg, minus1):
    """ids int32[B, M] for the queries of nodes s0 .. s0 + B - 1 (s0 the
    middle of the table): each from the sibling half of the node's
    segment of ``seg`` rows (``seg`` 0: the whole table), a share
    ``minus1`` of them -1."""
    node = n // 2 + torch.arange(B, device=dev)
    if seg:
        half = seg // 2
        lo = node // seg * seg
        base = torch.where(node - lo < half, lo + half, lo)
        span = half
    else:
        base, span = torch.zeros_like(node), n
    r = torch.rand((B, M), generator=g, device=dev, dtype=torch.float64)
    ids = (base[:, None] + (r * span).long()).clamp_max(n - 1)
    drop = torch.rand((B, M), generator=g, device=dev) < minus1
    return torch.where(drop, -1, ids).to(torch.int32).contiguous()


def gather_part(out, dev, g):
    import chip_smoke as smoke
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels.gather_distance import gather_dist_cuda

    cache = {}
    for name, n, d, B, M, seg, minus1, layouts, cold in GATHER_SHAPES:
        x = table_rows(dev, g, n, d, cache)
        q = torch.randn((B, d), generator=g, device=dev)
        ids = gather_ids(dev, g, n, B, M, seg, minus1)
        for lay, table in tables_of(x, layouts, g).items():
            tag = f"gather_{name}" + ("" if lay == "f32" else f"_{lay}")
            got = gather_dist_cuda(q, table, ids)
            want = ref.gather_dist(q, table, ids)
            fin = torch.isfinite(want)
            same_mask = torch.equal(torch.isfinite(got), fin)
            out[f"{tag}_max_abs_err"] = float(
                (got - want)[fin].abs().max()) if same_mask else math.inf
            out[f"{tag}_digest"] = digest(got)

            def call(i):
                return gather_dist_cuda(q, table, ids)

            out[f"{tag}_ms"], out[f"{tag}_timed_by"] = smoke.device_ms(
                torch, call, "gather_dist_kernel", cold=cold)
            out[f"{tag}_host_us"] = smoke.host_us(torch, call)
            row, once = smoke.stored_row_bytes(table)
            nd = int(torch.unique(ids[ids >= 0]).numel())
            out[f"{tag}_bound_ms"], _ = smoke.bound_ms(
                2 * B * M * 4 + B * d * 4 + nd * row + once,
                int((ids >= 0).sum()) * 4 * d)
            if hasattr(gd, "plan"):  # the tree's launch plan, where it has one
                t = gd.table_args(table, dev)
                out[f"{tag}_plan"] = gd.plan(B, M, t.layout, d,
                                             gd.rows_vec(t))._asdict()
        del q, ids


def hop_problem(dev, g, n, d, B):
    """One beam step's hop inputs, as chip_smoke.py::frontier draws them
    on a built index, on a synthetic table of n rows: the neighbour table
    ``bench/common.py::elemental_table`` draws (edges inside their layer's
    segment, 15% -1), query ranges of 2^-i of the table (i in 0..10), W =
    4 frontier nodes each inside its query's range, 90% of them
    expandable, 32 in-range ids already visited."""
    from repro_torch.core import bitset

    W, m = 4, 16
    logn = max(int(math.ceil(math.log2(n))), 1)
    layers = logn + 1
    shift = (logn - torch.arange(layers, device=dev))[None, :, None]
    u_ids = torch.arange(n, device=dev)[:, None, None]
    lo = (u_ids >> shift) << shift
    base = torch.randint(0, n, (n, layers, m), generator=g, device=dev)
    nbrs = (lo + base % (2 ** shift)).clamp_max(n - 1)
    drop = torch.rand((n, layers, m), generator=g, device=dev) < 0.15
    nbrs = torch.where(drop, -1, nbrs).to(torch.int32).contiguous()
    del base, drop, lo
    frac = torch.randint(0, 11, (B,), generator=g, device=dev)
    span = (n >> frac).clamp_min(1)
    L = (torch.rand((B,), generator=g, device=dev, dtype=torch.float64)
         * (n - span + 1)).long()
    R = L + span - 1
    pick = lambda k: (L[:, None] + (torch.rand(  # noqa: E731
        (B, k), generator=g, device=dev, dtype=torch.float64)
        * span[:, None]).long()).to(torch.int32)
    u = pick(W).contiguous()
    exp_ok = torch.rand((B, W), generator=g, device=dev) < 0.9
    vis = bitset.make(B, n, device=dev)
    seen = pick(32)
    bitset.test_and_set(vis, seen, torch.ones_like(seen, dtype=torch.bool))
    q = torch.randn((B, d), generator=g, device=dev)
    Lw = L.to(torch.int32).repeat_interleave(W).contiguous()
    Rw = R.to(torch.int32).repeat_interleave(W).contiguous()
    return q, nbrs, u, Lw, Rw, vis, exp_ok, logn, m


def hop_part(out, dev, g):
    import chip_smoke as smoke
    from repro_torch.kernels.hop import hop_cuda

    cache = {}
    for name, n, d, B, layouts in HOP_SHAPES:
        x = table_rows(dev, g, n, d, cache)
        q, nbrs, u, Lw, Rw, vis0, exp_ok, logn, m_out = hop_problem(
            dev, g, n, d, B)
        for lay, table in tables_of(x, layouts, g).items():
            tag = f"hop_{name}" + ("" if lay == "f32" else f"_{lay}")
            got = hop_cuda(q, table, nbrs, u, Lw, Rw, vis0.clone(), exp_ok,
                           logn=logn, m_out=m_out)
            want = ref.hop(q, table, nbrs, u, Lw, Rw, vis0.clone(), exp_ok,
                           logn=logn, m_out=m_out)
            out[f"{tag}_ints_same_as_plain"] = all(
                torch.equal(got[i], want[i]) for i in (0, 2, 3))
            fin = torch.isfinite(want[1])
            out[f"{tag}_max_abs_err"] = float(
                (got[1] - want[1])[fin].abs().max()) if bool(fin.any()) \
                else 0.0
            out[f"{tag}_digest"] = digest(*got)
            out[f"{tag}_new"] = int(want[2].sum())
            need = smoke.edge_positions_needed(
                torch, nbrs, u.reshape(-1), Lw, Rw, logn,
                want[0].reshape(-1, m_out))
            out[f"{tag}_bound_ms"], _, _ = smoke.hop_bound(
                torch, table, exp_ok, want, need, d, m_out)
            vis = [vis0.clone() for _ in range(12)]

            def call(i):
                return hop_cuda(q, table, nbrs, u, Lw, Rw, vis[i], exp_ok,
                                logn=logn, m_out=m_out)

            out[f"{tag}_ms"], out[f"{tag}_timed_by"] = smoke.device_ms(
                torch, call, "hop_kernel",
                reset=lambda i: vis[i].copy_(vis0))
            vis = [vis0.clone()] * 50
            out[f"{tag}_host_us"] = smoke.host_us(torch, call)
            del vis
        del q, nbrs, u, Lw, Rw, vis0, exp_ok


def edge_part(out, dev, g):
    import chip_smoke as smoke
    from repro_torch.kernels.edge_select import select_edges_cuda

    for name, n, B in EDGE_SHAPES:
        _, nbrs, u, Lw, Rw, _, _, logn, m_out = hop_problem(dev, g, n, 8, B)
        us = u.reshape(-1).contiguous()
        tag = f"edge_{name}"
        got = select_edges_cuda(nbrs, us, Lw, Rw, logn=logn, m_out=m_out)
        want = ref.select_edges(nbrs, us, Lw, Rw, logn=logn, m_out=m_out)
        out[f"{tag}_same_as_plain"] = torch.equal(got, want)
        out[f"{tag}_digest"] = digest(got)

        def call(i):
            return select_edges_cuda(nbrs, us, Lw, Rw, logn=logn,
                                     m_out=m_out)

        out[f"{tag}_ms"], out[f"{tag}_timed_by"] = smoke.device_ms(
            torch, call, "edge_select_kernel")
        out[f"{tag}_host_us"] = smoke.host_us(torch, call)
        out[f"{tag}_bound_ms"] = smoke.edge_bound(torch, nbrs, us, Lw, Rw,
                                                  logn, want)[0]
        out[f"{tag}_floor_ms"] = smoke.edge_floor_ms(torch, nbrs, us)
        out[f"{tag}_shape"] = (f"F={us.shape[0]} K="
                               f"{nbrs.shape[1] * nbrs.shape[2]} "
                               f"m_out={m_out}")
        del nbrs, u, Lw, Rw, us, got, want


SEARCH_REPEATS = 7
SEARCH_INDEX = "search_index_1M.pt"  # under build/ beside this script


def search_part(out, dev, g):
    """The search QPS of chip_smoke.py's 1M cell: 1,000 mixed queries in
    one batch, k = 10, ef = 64, W = 4, the fused hop. The first run builds
    the index (n = 1M, d = 128, ``vector_dataset`` seed 0, m = 16, efc =
    64, chunk 32,768, with its tree's kernels) and saves it under
    ``build/``; every run, that one too, loads it from there, so both trees
    search the same graph. QPS of each of SEARCH_REPEATS batches by the
    host clock, the card synchronised at both ends (as the smoke's
    ``timed_search``), and a digest of the ids."""
    import os
    import time

    import chip_smoke as smoke
    from repro_torch import BuildConfig, RangeGraphIndex, SearchConfig
    from repro_torch.data import make_workload, vector_dataset

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        SEARCH_INDEX)
    if not os.path.exists(path):
        vectors, attrs, _, _ = vector_dataset(
            1_000_000, 128, seed=0, n_clusters=64, attr_kind="uniform",
            queries=1000, labels=True)
        t0 = time.perf_counter()
        index = RangeGraphIndex.build(
            vectors, attrs[:, 0],
            BuildConfig(m=16, ef_construction=64, chunk=smoke.BUILD_CHUNK))
        torch.cuda.synchronize()
        out["search_index_build_s"] = time.perf_counter() - t0
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(index, path)
        del index, vectors, attrs
    index = torch.load(path, map_location=dev, weights_only=False)
    wl = make_workload(index, "mixed", n_queries=1000, seed=1)
    lo, hi = index.attrs[wl.L], index.attrs[wl.R]
    cfg = SearchConfig(ef=64, expand_width=4, hop_impl="cuda")
    index.search(wl.queries[:8], lo[:8], hi[:8], k=10, config=cfg)
    qps = []
    for _ in range(SEARCH_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = index.search(wl.queries, lo, hi, k=10, config=cfg)
        ids = res.ids.cpu()
        qps.append(len(wl.queries) / (time.perf_counter() - t0))
    out["search_qps"] = qps
    out["search_qps_median"] = sorted(qps)[len(qps) // 2]
    out["search_ids_digest"] = digest(ids)


def codecs_part(out, dev, g):
    """The codec legs' recall deltas over build seeds (see the module
    docstring)."""
    from repro_torch.bench import hotpath

    legs = {"compact": [], "int8": [], "pq": []}
    for seed in CODEC_SEEDS:
        sf = hotpath.bench_storage_footprint(dev, "wit-like", n_queries=64,
                                             seed=seed)
        legs["compact"].append(sf["recall_delta"])
        legs["int8"].append(sf["int8"]["recall_delta"])
        legs["pq"].append(sf["pq"]["recall_delta"])
        print(f"codecs[seed {seed}]: f32 recall "
              f"{sf['f32']['recall']:.4f}; recall_delta compact "
              f"{legs['compact'][-1]:+.4f} int8 {legs['int8'][-1]:+.4f} pq "
              f"{legs['pq'][-1]:+.4f}", flush=True)
    out["codecs"] = {
        "seeds": list(CODEC_SEEDS), "recall_delta": legs,
        "min": {k: min(v) for k, v in legs.items()},
        "max": {k: max(v) for k, v in legs.items()},
        "over_cap_0.01": {k: [s for s, x in zip(CODEC_SEEDS, v)
                              if abs(x) > 0.01] for k, v in legs.items()}}


def flash_part(out, dev, g):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    for name, B, S in (("flash_path", 256, 32), ("flash_S4096", 1, 4096)):
        q, k, v = (torch.randn((B, S, h, 128), generator=g, device=dev,
                               dtype=torch.bfloat16).transpose(1, 2)
                   for h in (16, 8, 8))
        err = (flash_attention_cuda(q, k, v).float()
               - ref.attention(q, k, v).float()).abs().max()
        out[f"{name}_ms"] = time_ms(lambda: flash_attention_cuda(q, k, v),
                                    iters=5 if S >= 4096 else 20)
        out[f"{name}_max_abs_err"] = float(err)
        del q, k, v


def pairwise_part(out, dev, g):
    import chip_smoke as smoke
    from repro_torch.kernels.distance import pairwise_dist_cuda

    for name, Bq, N, dt in (("dist_roofline_f32", 64, 100_000, "float32"),
                            ("dist_1M_f32", 1000, 1_000_000, "float32"),
                            ("dist_1M_bf16", 1000, 1_000_000, "bfloat16"),
                            ("dist_1M_f16", 1000, 1_000_000, "float16")):
        dtype = getattr(torch, dt)
        q = torch.randn((Bq, 128), generator=g, device=dev).to(dtype)
        x = torch.randn((N, 128), generator=g, device=dev).to(dtype)
        got = pairwise_dist_cuda(q, x)
        want = ref.pairwise_dist(q, x)
        qf, xf = q.float(), x.float()
        terms = (qf * qf).sum(1, keepdim=True) + (xf * xf).sum(1)[None]
        out[f"{name}_max_rel_err"] = float(((got - want).abs()
                                            / terms).max())
        out[f"{name}_digest"] = digest(got)
        del got, want, terms, qf, xf
        it = 5 if N >= 1_000_000 else 20
        out[f"{name}_ms"] = time_ms(lambda: pairwise_dist_cuda(q, x),
                                    iters=it)
        lib, what = smoke.pairwise_library(torch, q, x)
        out[f"{name}_library_ms"] = time_ms(lambda: lib(0), iters=it)
        out[f"{name}_library"] = what
        del q, x
        torch.cuda.empty_cache()


def bf16_tol(got, want):
    """One bf16 ulp at the larger magnitude, plus 1e-5: the half types'
    card gate before it was stated against the exact result (a count
    only)."""
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8) \
        + 1e-5


def pairwise_exact_part(out, dev, g):
    from repro_torch.data import vector_dataset
    from repro_torch.kernels import distance
    from repro_torch.kernels.distance import pairwise_dist_cuda

    half_gate = getattr(distance, "half_gate", None)  # None on a parent

    x, _, q, _ = vector_dataset(131072, 128, seed=0, n_clusters=64,
                                attr_kind="uniform", queries=1000,
                                labels=True)
    x0 = torch.as_tensor(x, device=dev)
    q0 = torch.as_tensor(q, device=dev)
    for dt in ("float32", "bfloat16", "float16"):
        qd, xd = q0.to(getattr(torch, dt)), x0.to(getattr(torch, dt))
        exact = qd.double() @ xd.double().T
        ex = exact.float()
        kern = -pairwise_dist_cuda(qd, xd, metric="ip")
        plain = -ref.pairwise_dist(qd, xd, metric="ip")
        tag = f"exact_ip_{dt}"
        out[f"{tag}_kernel_max_err"] = float((kern.double() - exact)
                                             .abs().max())
        out[f"{tag}_plain_max_err"] = float((plain.double() - exact)
                                            .abs().max())
        for name, got in (("kernel", kern), ("plain", plain)):
            out[f"{tag}_{name}_over_ulp"] = int(
                ((got - ex).abs() > bf16_tol(got, ex)).sum())
        out[f"{tag}_kernel_vs_plain_over_ulp"] = int(
            ((kern - plain).abs() > bf16_tol(kern, plain)).sum())
        del exact, ex
        if dt != "float32" and half_gate is not None:
            out[f"{tag}_kernel_half_gate"] = half_gate(
                -kern, qd, xd, metric="ip", plain=-plain)
            out[f"{tag}_plain_half_gate"] = half_gate(-plain, qd, xd,
                                                      metric="ip")
        del kern, plain
    out["exact_ip_max_abs_dot"] = float((q0.double() @ x0.double().T)
                                        .abs().max())


def main():
    if not torch.cuda.is_available():
        sys.exit("prune_time: needs a CUDA card")
    parts = sys.argv[2].split(",") if len(sys.argv) > 2 else DEFAULT_PARTS
    if set(parts) - set(PARTS):
        sys.exit(f"prune_time: parts are a subset of {','.join(PARTS)}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    out = {"src": sys.argv[1]}
    for part in parts:
        globals()[f"{part}_part"](out, dev, g)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
