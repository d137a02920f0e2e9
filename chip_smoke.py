#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments:
the full-size run, one card). It

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the port's six CUDA kernels from ``src/repro_torch/csrc`` with
     ``nvcc`` (one process per source, all at once; set-up time), and
     prints the registers and spills of each kernel function, the two
     tensor-core kernels' (flash_attention, distance) among them;
  3. drives the main path with every launch counter at 0: builds a
     ``RangeGraphIndex`` on the card over ``vector_dataset`` data (n = 1M,
     d = 128, 64 clusters, uniform attributes, seed 0; ``BuildConfig(m=16,
     ef_construction=64)``), then answers 1,000 ``make_workload("mixed")``
     queries through ``index.search`` (k=10, ef=64, W=4) with the fused hop
     kernel, with the composed hop, and with the fused hop at ef=256;
     reads the counts and fails if a kernel of the path never launched;
  4. checks the answers against an exact in-range top-10 (plain torch on
     the card): fused and composed ids identical; each fused search's
     recall@10 within 0.01 of the same search with every op pinned to
     plain torch; recall@10 >= 0.70 for the workload at ef=256 and for
     queries drawn around the data's own centres at ef=64 (see
     MIN_RECALL), and prints why wide ranges lose recall;
  4a. sets each dispatch and storage knob of ``core/knobs.py`` in this
     process in turn (``knobs_phase``; the smoke refuses to start when
     one is set in its environment) and searches the same 1,000 queries
     at ef = 64 with every impl "auto", counts at 0 before each leg:
     RTORCH_IMPL=torch launches nothing and gives the all-plain ids;
     RTORCH_IMPL=cuda and RTORCH_HOP_IMPL=composed launch select_edges and
     gather_dist, no hop, and give the fused ids; with
     RTORCH_EDGE_IMPL=argsort the composed hop launches no select_edges
     and the fused one ignores it; RTORCH_PRUNE_IMPL=legacy builds n =
     32,768 with no prune launch and the table of a build with the plain
     prune; RTORCH_STORAGE=compact builds bf16 / int16 tables; unset
     again, the fused path's counts and ids (``knobs[...]`` lines). Then
     the oracles (``oracles_phase``): the seed engine
     (``core/search_ref.py``) on 64 of the queries against
     ``beam_search(expand_width=1)``: ids and hops identical to the fused
     hop's, everything identical to the all-plain path's; Algorithm 1
     literally and the argsort formulation against the edge kernel at the
     frontier's shape (F = 4,000): ids identical (``oracles[...]``);
  4b. drives the paper's comparison methods on the same index and
     queries at ef = 64 (``baselines_phase``), each with every count at 0
     just before it and once more with every impl pinned to plain torch:
     post-, in- and super-post-filtering, BasicSearch, the Oracle (two
     ranges of 65,536 items, a cut: printed as ``CUT:``; the builds timed
     apart from the search) and the multi-attribute search in its post,
     in and adaptive modes (a second attribute drawn as Fig. 5 draws it);
     prints recall@10, QPS, mean hops and distances and launches per
     kernel of each; fails unless each method's recall is within 0.01 of
     its plain run, Pre-filtering's ids equal ``brute_force``'s, and
     gather_dist launched on every filtered search, edge_select on every
     multi-attribute search and the prune on the Oracle's builds; in each
     multi-attribute mode it also records every edge_select call of one
     more search, fails unless each call's ids equal the plain version's,
     and times the middle call by device time with L2 cold beside its
     bound and its two-round-trip floor (``multiattr_edges``);
  4c. drives the async serving loop under open-loop Poisson load
     (``serve_slo_phase``): ``bench/serve_slo.py``'s three legs (nominal
     at half the measured capacity, overload at 4x, chaos at 4x with
     latency spikes, flush errors and queue-full bursts), its ``run_leg``
     and defaults, through ``AsyncServingEngine`` on a
     ``SearchExecutor(ef=64, k_bucket=10, max_batch=32)`` warmed on the
     main thread, the 1,000 mixed queries as the request pool, every
     count at 0 before each leg; prints per leg capacity, offered, each
     outcome, p50/p99, how late the reaper delivered the timeouts of
     requests in flight (the GIL it shares with the flush thread), and
     the launches of gather_dist and the hop; fails on a lost request, a
     failed one outside the chaos leg, a cache entry after warmup, a leg
     without a hop launch, a flush thread on another stream or card, or
     the nominal leg's recall@10 more than 0.01 from the same requests
     served by a ``ServingEngine`` on that executor;
  4d. drives sharded serving (``sharded_phase``, ``core/distributed.py``)
     with every count at 0: ``build_sharded`` cuts the 1M cell into 4
     contiguous attribute-rank shards of 250,000 (the same build config,
     d = 128, no cut), then 4 gloo ranks sharing the card, spawned with
     the kernels already built, run ``rfann_serve_step`` in three legs: a)
     data 4 x model 1, the 1,000 mixed queries at ef 64 and 256 (ef 64
     also timed on rank 0); b) the same shards with bf16 vectors; c) a
     ragged int16 witness (n = 65,535 over 2 shards, bf16 + int16, and
     its decoded-f32 twin, 64 queries) at data 2 x model 2. Prints build
     seconds per shard against the single index's, stored bytes, each
     rank's device, layouts and start-up, each leg's recall@10, QPS and
     launches per rank (``sharded[...]`` lines). Gates: every rank's
     [B, k] identical to the mesh-free path in this process; leg a's
     recall at ef 64 within 0.01 of the mesh-free search all-plain, at ef
     256 at least the single index's minus 0.05; ids in range, no padded
     row; compact ids equal the decoded twin's; gather_dist and the hop
     launched on every rank and leg, the bf16 hop body on b and c;
  5. holds every kernel against its plain version on the card at the main
     path's shapes (integers equal; distances within 1e-5 of the magnitude
     of their terms, ``‖q‖² + ‖x‖²``, since both sum d products in another
     order; prune rows may differ only at near-tie keep decisions,
     ``|alpha*cc - du| <= 1e-5*du``, in under 0.1% of rows; the bound
     counts what the inputs need) and times kernel, plain version and
     bound (gather_dist, edge_select and the hop by device time with L2
     cold, ``device_ms``, edge_select also beside the latency floor of its
     two dependent round trips, ``edge_floor_ms``; the others with CUDA
     events);
  6. drives the codec path with every count at 0: re-encodes the 1M index
     with ``astype_storage`` to bf16, f16 (both with "auto" ids), int8 and
     PQ (both with split ids; PQ with its int8 rerank sidecar), printing
     the seconds and stored bytes of each against f32; answers the same
     1,000 queries on each at ef = 64 and 256 through the fused hop, the
     composed hop and the all-plain path (PQ also with rerank = 48);
     prints recall@10 against the f32 ground truth, its difference to the
     f32 index at the same ef, and QPS; fails if a codec layout of
     gather_dist or hop never launched. Gates: fused ids identical to
     composed ids; fused recall within 0.01 of the all-plain path's; PQ
     with rerank >= PQ without;
  7. holds each codec layout of gather_dist and hop against its plain
     version at the main path's shapes, as in step 5, with the bound
     counted at the stored row width (the int8 scale per row, the PQ
     codebook once); no single PyTorch call computes either, so
     library_ms is null;
  8. saves the int8 and the PQ index with the port's own msgpack packer
     (zlib where zstandard is missing), loads them back onto the card, and
     holds every array and the search ids equal;
  9. builds n = 131,072 twice, with the kernels and all-plain, and holds
     the tables and their search recall against each other;
  10. drives the embed -> build -> serve path of ``launch/serve.py`` with
     every count at 0, at qwen3-0.6b's full width (28 layers, d = 1024,
     params f32, compute bf16, seeded random weights): embeds n = 131,072
     items of 32 tokens (the launcher's draw, 256 items per call), builds
     an index over them (``BuildConfig(m=16, ef_construction=128,
     chunk=4096)``), warms a ``ServingEngine(ef=64, k_bucket=10,
     max_batch=64)`` and serves 1,000 requests; prints embed tokens/s,
     build s, QPS, p50/p99 latency, cache entries before and after warmup
     and after serving, recall@10 against ``brute_force``, the same
     requests served with every op on plain torch, the same requests once
     more through ``AsyncServingEngine`` on the engine's executor (deadline
     30 s, queue 1,024, "block"; QPS, p50/p99, id agreement), a 4,096-item
     subsample
     embedded with attention on plain torch, and peak device memory;
     fails if flash_attention, prune, gather_dist or hop never launched,
     unless every flash launch (28 layers x each embed call) went to its
     tensor-core body, if serving added a cache entry, if recall is not within 0.01 of the
     all-plain path's, if the async pass did not serve every request
     within 0.01 of the sync engine's recall or added a cache entry, or if a subsample row's cosine to the plain
     attention's is below 0.9999 or an element differs by more than 0.05;
     profiles one embed call;
  11. holds the flash-attention kernel against its plain version at the
     path's shape (bf16, f16 and f32), at S = 4,096 and over a variant grid
     (window, softcap, bidirectional, q_offset; q, k and v in the
     projections' transposed layout) and at the lm decode phase's prefill
     shapes (gemma2-9b's local and global layers, B 4, S 4,608, Dh 256,
     softcap 50; granite-20b's MQA, g = 48; seamless's cross-attention
     over contiguous K/V; every other attention of leg B at its config's
     heads and Dh, B 2, S 512: qwen3, phi3-mini's Dh 96, chameleon's
     g = 8, the MoEs, zamba2's shared block, seamless's bidirectional
     encoder and causal decoder) (f32 within 1e-5, bf16 and f16 within
     one bf16 ulp and the f32 tolerance, see ``bf16_tol``), and fails a
     shape whose launch went to another body than its dtype and head dim
     name (16-bit: the tensor-core body; f32: the CUDA-core one), with
     SDPA's time beside it where SDPA computes the same function; the prune kernel at d = 1,024 and C = 144 on one build
     chunk's own candidates (``prune_check_wide``), each prune record
     with its regime (staged rows, shared memory and warps a CTA);
     one search level of the lm build under torch.profiler
     (``profile[build level ...]``: device busy share, the prune's share
     of device time, the top 8 kernels); and gather_dist and
     the hop on the lm index at the served batch's shapes (B = 64, d =
     1,024), as in step 5;
  11b. runs ``bench/roofline.py`` at its default shape with every count
     at 0, then holds pairwise_dist against its plain version at the
     roofline's shape and at 1,000 x 1M in f32 (within DIST_RTOL of its
     terms), bf16 and f16 (``kernels/distance.py::half_gate``: against the
     plain version and against the exact result, the plain version held
     to the second part too; the old one-bf16-ulp gate printed as a
     count), with the library call's time beside each
     (``pairwise_library``); then the prune's codec bodies and
     ``bench/buildpath.py``;
  11c. runs ``bench/hotpath.py --smoke`` (``hotpath_phase``): the seed,
     composed and fused hop steps at smoke shapes (composed and fused
     outputs asserted identical), and the launch-plan autotune of
     gather_dist, the hop, the prune and edge_select at the main paths'
     full shapes (``kernels/autotune.py::PROBES``), every candidate held
     against its default plan's outputs (a refused one fails); prints
     each kind's pick, its time and the default plan's
     (``hotpath[...]``), then the three new phases' seconds;
  11c'. the benchmark gate and two contract checks (``gate_phase``,
     ``sync_phase``, ``smem_phase``; at most GATE_MAX_S together):
     ``bench/buildpath.py --smoke`` and ``bench/serve_slo.py --smoke``
     into ``build/`` beside 11c's hot-path smoke record, then
     ``bench/ci_gate.py --smoke-dir build`` against the committed
     ``artifacts/BENCH_torch_{hotpath,build,serve_slo}.json``: every
     ``ok:`` and ``::warning::`` line and the ``allow`` marker count
     printed (``gate: ...``), exit 1 fails; ``contracts[sync, fused]``
     and ``contracts[sync, composed]``: 64 of the 1M queries searched
     under ``torch.cuda.set_sync_debug_mode("warn")``, every sync located
     by file and line, which must be ``beam_search``'s loop checks (one
     per ITER_BLOCK and one at the end) and the named ones before the
     loop (SYNC_NAMED), none inside ``body``; ``contracts[smem]``: every
     launch plan's shared memory from the Python mirror against the C
     formula its library exports (``kernels/smem_budget.py``), all equal
     and within the block limit;
  11d. frees what the earlier phases held and serves every model family
     through ``train/step.py``'s prefill and greedy decode steps
     (``lm_decode_phase``), each config's counts at 0 before its served
     path. Leg A, ``lm decode[gemma2-9b]``: full width and depth (42
     layers, d 3,584, params f32, compute bf16, seeded weights), 4
     prompts of 4,608 tokens (the 4,096 window bites in the 21 local
     layers), the caches grown to 4,640 positions, 32 greedy steps;
     prints prefill s and tokens/s, decode ms a step and tokens/s, peak
     device memory and the flash launches by body. Gates: 42 flash
     launches on the path, all on the wgmma body (decode is plain torch);
     prompt 0's last-position logits against an all-plain prefill, and
     one teacher-forced decode step against the forward pass over its
     4,609 tokens, least row cosine >= DEC_MIN_COSINE, finite; every
     generated token in [0, vocab). Leg B, ``lm families[<arch>]``: the
     nine other configs at full width, depth cut to one repeating unit
     (``FAM_CUT``, printed as ``CUT:``), 2 prompts of 512 tokens (seamless:
     512 seeded frames): prefill, 8 greedy steps and ``Model.embed``;
     gates: kernel prefill vs all-plain, 8 teacher-forced steps vs the
     forward pass (MoE at capacity factor 8.0 for this gate only), flash
     launches as many as attention applications, all on the wgmma body,
     embeddings finite [2, d]; prints parameters, prefill ms, decode ms a
     step and flash launches (seamless: encoder, decoder self-attention
     and cross-attention apart). The phase fails past DEC_MAX_S;
  11e. trains (``train_phase``), counts at 0 before each leg. Leg A,
     ``lm train[qwen3-0.6b]``: full width and depth (28 layers, params
     f32, compute bf16, remat "full", attention plain torch under
     autograd, seeded weights), ``TokenPipeline(seed=0)`` at B 16 x S
     1,024, ``AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12)``, 12
     steps of ``runtime/trainer.py::run_train_loop`` on one batch with a
     checkpoint every 4 steps (level 0: stored zlib blocks, one pass);
     prints s a step (median of steps 2-12), tokens/s, the model-FLOP
     share (6·N·tokens over 989 TFLOP/s), peak memory, each step's loss
     and grad norm, the checkpoint and restore seconds, and one
     loss-and-gradient call under the profiler. Gates: losses finite, the
     12th below 0.9 x the first; no restart (a failing step raises);
     every gradient leaf of the first step finite and not None, grad
     norms > 0, and its flattened cosine to the same gradient at f32
     compute >= 0.99; the checkpoint of step 8 restored into fresh
     tensors bit-identical to the state saved, and steps 9-12 replayed
     from it within 1e-3 relative; a step at microbatches 2 within 1e-3
     relative of the loss at 1 on the same state; a compressed step
     finite; training launched no flash kernel; the trained weights embed
     256 items of 32 tokens with 28 flash launches, all wgmma, least row
     cosine to all-plain >= 0.9999; ``flash_attention_cuda`` refuses an
     input that requires grad under grad mode. Leg B, ``lm train
     families[<arch>]``: the nine other configs and gemma2-9b at full
     width and one repeating unit of depth (``TRAIN_FAM_CUT``), B 2 x S
     512 (seamless: 512 seeded frames), two steps each; gates: every
     gradient leaf finite and not None, losses finite, MoE aux > 0; prints
     ms a step and peak memory. The phase fails past TRAIN_MAX_S;
  12. prints one JSON line of kernel records (each codec layout as e.g.
     ``gather_dist[int8]``; flash_attention with its launches on the lm
     serve path, on each config of the lm decode phase and its records at
     every attention shape of that phase's prefills, each held against
     the plain version in step 11, and its launches in training (0) and
     in the trained weights' embed; gather_dist, gather_dist[int8],
     select_edges, the hop and the prune with their autotune pick and
     default plan's time at each probe) and, last, the device line.

It exits non-zero, printing no result, when there is no CUDA card, when
the repo's sources are not beside it, when a dispatch or storage knob
(``RTORCH_IMPL``, ``RTORCH_*_IMPL``, ``RTORCH_STORAGE``) is set in its
environment, or when any phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

BUILD_CHUNK = 32768       # nodes per build step on the card
DIST_RTOL = 1e-5          # distances: relative to ‖q‖² + ‖x‖²
L2_FLUSH_BYTES = 128 << 20  # written before a cold launch: > the 50 MB L2
SLEEP_CYCLES = 1e8        # a head start for the host: ~50 ms at 1.98 GHz
# what gather_dist's and the hop's records add to the kernels line: ms is
# their device time per launch with L2 cold; event_ms the CUDA events
# around back-to-back wrapper calls, which time the host where it enqueues
# more slowly than the card runs
SEARCH_KERNEL_KEYS = ("timed_by", "event_ms", "host_us", "distinct_rows",
                      "minus1_share", "composed_identical",
                      "edge_ids_needed", "edge_ids_in_blocks", "floor_ms",
                      "shape")
# the prune's near-tie rule (a keep decision within 1e-5 of du, in under
# 0.1% of rows) is repro_torch/bench/common.py::prune_parity
# The search quality gate: recall@10 >= MIN_RECALL. make_workload draws
# its queries around other centres than the data's, so their true top-10
# are tail points of two or three clusters and wide ranges are hard: at
# ef = 64 the workload reaches 0.585 at n = 1M on every path, kernel and
# plain alike. The gate reads the workload at ef = QUALITY_EF, and queries
# drawn around the data's own centres over the same ranges at ef = 64.
MIN_RECALL = 0.70
QUALITY_EF = 256
WITNESS_N = 131072        # the kernel-vs-plain build witness's size
MAIN_KERNELS = ("gather_dist", "select_edges", "hop", "prune")

# The baselines phase (core/baselines.py, core/multiattr.py) on the 1M
# index and the main path's 1,000 queries: each method once with the
# kernels and once all-plain, at ef = BASE_EF. The oracle builds two
# ranges of ORACLE_SPAN items (Fig. 4: one per range of n >> i, i < 6), with
# ORACLE_QUERIES queries each; multi-attribute queries draw their second
# attribute as Fig. 5 does (seed 5, value ranges 0.25 wide).
BASE_EF = 64
ORACLE_SPAN = 65536
ORACLE_QUERIES = 50
BASIC_QUERIES = 1000      # basic_search's queries (all of the main path's)
BASE_MAX_S = 120.0        # what the phase may add to the smoke
BASE_KERNELS = {          # method -> kernels that must launch on it
    "postfilter": ("gather_dist",),
    "infilter": ("gather_dist",),
    "super_postfilter": ("gather_dist",),
    "basic_search": ("gather_dist",),
    "oracle_search": ("gather_dist", "prune"),
    "multiattr[post]": ("gather_dist", "select_edges"),
    "multiattr[in]": ("gather_dist", "select_edges"),
    "multiattr[adaptive]": ("gather_dist", "select_edges"),
}

# The embed -> build -> serve path (launch/serve.py) at qwen3-0.6b's full
# width: params f32, compute bf16, seeded random weights (no checkpoint is
# in the repository).
SLO_GATE_LEGS = ("nominal", "overload")  # legs where no flush may fail
SHARDS = 4                # the sharded phase: shards of the 1M cell
SHARD_RANKS = 4           # gloo ranks sharing the card
SHARD_WITNESS_N = 65535   # ragged int16 witness: 32,768 + 32,767 rows
SHARD_WITNESS_QUERIES = 64
SHARD_EFS = (BASE_EF, QUALITY_EF)  # leg a; legs b and c at BASE_EF
SHARD_RANK_TIMEOUT_S = 240.0  # the ranks' start-up and all their legs
SHARD_MAX_S = 150.0       # what the phase may add to the smoke
KNOB_BUILD_N = 32768      # the knobs phase's builds (prune, storage legs)
ORACLE_QUERIES_REF = 64   # the seed engine's queries: a dense bool[B, n] map
NEW_PHASES_MAX_S = 150.0  # what the knobs, oracles and hotpath phases may add
LM_ASYNC_DEADLINE_S = 30.0  # the lm phase's async pass: every request served
LM_ASYNC_MAX_QUEUE = 1024
LM_ARCH = "qwen3-0.6b"
LM_N = 131072             # items embedded and indexed
LM_SEQ = 32               # tokens per item (the launcher's default)
LM_BATCH = 256            # items per embed call
LM_BUILD_CHUNK = 4096     # nodes per build step: [4096, 144, 1024] f32 is
                          # a 2.4 GB candidate block
LM_QUERIES = 1000
LM_EF, LM_K = 64, 10
LM_SUBSAMPLE = 4096       # items re-embedded with attention on plain torch
# kernel vs plain attention on the subsample: every row's cosine, and the
# largest |difference| of an embedding element (0.99998 and 0.022 measured
# on the H100: both paths round each layer's attention to bf16, and those
# ulps carry through 28 layers)
LM_MIN_COSINE = 0.9999
LM_MAX_ABS_DIFF = 0.05
LM_MAX_BATCH = 64         # the engine's batch: the served kernels' B
PEAK_BF16_FLOPS = 989e12  # dense tensor-core peak, bf16 and f16
PEAK_TF32_FLOPS = 495e12  # dense tensor-core peak, TF32
# the roofline phase fails a row above this fraction of its bound
ROOF_MAX_FRACTION = 1.05
# roofline row -> the kernel (ops.KERNELS name) it launches
ROOF_KERNEL = {"edge_select": "select_edges"}
DIST_TAG = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
FLASH_F32_TOL = 1e-5      # flash vs plain in f32: sums in other orders
PEAK_FLOPS = {"torch.float32": PEAK_F32_FLOPS,
              "torch.bfloat16": PEAK_BF16_FLOPS,
              "torch.float16": PEAK_BF16_FLOPS}
# flash attention: the path's shape, one long shape and the variant grid
# (B, Hq, Hkv, Sq, Skv, Dh, dtype name, keyword arguments)
FLASH_SHAPES = {
    "path": (LM_BATCH, 16, 8, LM_SEQ, LM_SEQ, 128, "bfloat16", {}),
    "long": (1, 16, 8, 4096, 4096, 128, "bfloat16", {}),
    "path f16": (LM_BATCH, 16, 8, LM_SEQ, LM_SEQ, 128, "float16", {}),
    "path f32": (LM_BATCH, 16, 8, LM_SEQ, LM_SEQ, 128, "float32", {}),
    "window": (4, 16, 8, 512, 512, 128, "bfloat16", {"window": 128}),
    "window f32": (4, 16, 8, 512, 512, 128, "float32", {"window": 128}),
    "softcap": (4, 16, 8, 256, 256, 256, "bfloat16", {"softcap": 50.0}),
    "softcap f32": (4, 16, 8, 256, 256, 256, "float32", {"softcap": 50.0}),
    "bidirectional": (4, 16, 16, 200, 200, 64, "bfloat16",
                      {"causal": False}),
    "bidirectional f32": (4, 16, 16, 200, 200, 64, "float32",
                          {"causal": False}),
    "q_offset": (4, 16, 8, 100, 256, 128, "bfloat16", {"q_offset": 156}),
    "q_offset f32": (4, 16, 8, 100, 256, 128, "float32", {"q_offset": 156}),
    # the lm decode phase's prefill shapes: gemma2-9b's local and global
    # layers, granite-20b's MQA (g = 48), seamless's cross-attention over
    # the contiguous K/V that models/attention.py::cross_kv makes
    "gemma2 local": (4, 16, 8, 4608, 4608, 256, "bfloat16",
                     {"window": 4096, "softcap": 50.0}),
    "gemma2 global": (4, 16, 8, 4608, 4608, 256, "bfloat16",
                      {"softcap": 50.0}),
    "granite": (2, 48, 1, 512, 512, 128, "bfloat16", {}),
    "seamless cross": (2, 16, 16, 512, 512, 64, "bfloat16",
                       {"causal": False}),
    # the rest of leg B's prefill shapes, each config's heads and Dh at
    # B 2, S 512 (xlstm-125m has no attention)
    "qwen3": (2, 16, 8, 512, 512, 128, "bfloat16", {}),
    "phi3-mini": (2, 32, 32, 512, 512, 96, "bfloat16", {}),
    "chameleon": (2, 64, 8, 512, 512, 128, "bfloat16", {}),
    "granite-moe": (2, 16, 8, 512, 512, 64, "bfloat16", {}),
    "phi3.5-moe": (2, 32, 8, 512, 512, 128, "bfloat16", {}),
    "zamba2 shared": (2, 32, 32, 512, 512, 64, "bfloat16", {}),
    "seamless encoder": (2, 16, 16, 512, 512, 64, "bfloat16",
                         {"causal": False}),
    "seamless decoder": (2, 16, 16, 512, 512, 64, "bfloat16", {}),
}
FLASH_PATH_SHAPES = ("gemma2 local", "gemma2 global", "granite",
                     "seamless cross", "qwen3", "phi3-mini", "chameleon",
                     "granite-moe", "phi3.5-moe", "zamba2 shared",
                     "seamless encoder", "seamless decoder")
FLASH_CONTIGUOUS_KV = ("seamless cross",)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call of ``fn(i)`` by CUDA events (``i`` = call index,
    so a call that updates its inputs in place can take a fresh copy):
    ``repro_torch/bench/common.py::time_calls``."""
    from repro_torch.bench.common import time_calls

    return time_calls(fn, torch.device("cuda", 0), iters=iters,
                      warmup=warmup) * 1e3


def dev_us(e) -> float:
    """Self device µs of one torch.profiler key_averages() row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(torch, fn, kernel, iters=12, cold=True, reset=None,
              windows=3) -> tuple[float, str]:
    """(device ms per launch, how it was timed) of the kernel whose symbol
    contains ``kernel``, over calls ``fn(0) .. fn(iters - 1)``, the first
    two dropped, so the wrapper's host time does not enter. ``reset(i)``,
    where given, runs before call ``i`` in every pass, outside what is
    timed: a call that updates its inputs in place (the hop's visited
    bitset) then does the same work in every pass. With ``cold``,
    L2_FLUSH_BYTES are written before each call, so the launch reads its
    rows from device memory, as a caller that walks a table larger than
    the L2 finds them.

    "profiler": the mean duration of the launches in torch.profiler's
    trace (it idles 50 ms at both ends of its window, near which it can
    miss launches). Late in a long process the profiler now and then
    returns a window without the launches; up to ``windows`` windows are
    tried. Only if all of them come back empty, "events": CUDA events
    around each call, recorded behind a 50 ms sleep kernel so that the
    host is ahead of the card and no host time falls between a pair, less
    the mean time of an empty pair recorded in the same queue (the event
    records' own cost, stated in the returned string)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold \
        else None

    def launches():
        for i in range(iters):
            if reset is not None:
                reset(i)
            if flush is not None:
                flush.fill_(float(i))
            yield i

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for i in launches():
                fn(i)
            torch.cuda.synchronize()
            time.sleep(0.05)
        runs = sorted((e for e in prof.events()
                       if kernel in e.name
                       and str(e.device_type).endswith("CUDA")),
                      key=lambda e: e.time_range.start)[2:]
        if runs:
            return (sum(e.time_range.elapsed_us() for e in runs)
                    / len(runs) / 1e3, "profiler")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    pairs = [(ev(), ev()) for _ in range(iters)]
    empty = [(ev(), ev()) for _ in range(iters)]
    torch.cuda._sleep(int(SLEEP_CYCLES))
    for i in launches():
        empty[i][0].record()
        empty[i][1].record()
        pairs[i][0].record()
        fn(i)
        pairs[i][1].record()
    torch.cuda.synchronize()
    pair = sum(a.elapsed_time(b) for a, b in empty[2:]) / (iters - 2)
    ms = sum(a.elapsed_time(b) for a, b in pairs[2:]) / (iters - 2)
    return ms - pair, f"events, less {pair * 1e3:.2f} us a pair"


def host_us(torch, fn, iters=50) -> float:
    """The host µs of one call of ``fn(i)``: the host clock around each
    call, with no synchronisation inside the loop (the card runs behind)."""
    torch.cuda.synchronize()
    spent = 0.0
    for i in range(iters):
        t0 = time.perf_counter()
        fn(i)
        spent += time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / iters * 1e6


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def dist_err(torch, got, want, qq, xx):
    """Max |got - want| over finite slots, and whether it is within
    DIST_RTOL of the expansion's term magnitude; +inf masks must agree."""
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        return math.inf, False
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0, True
    err = (got - want).abs()[fin]
    tol = DIST_RTOL * (qq.expand_as(want)[fin] + xx[fin])
    return float(err.max()), bool((err <= tol).all())


def edge_positions_needed(torch, nbrs, us, L, R, logn, out):
    """Per frontier row, how many of its K packed edge ids the selection
    must read: through the m_out-th emitted id when the row fills, else
    through the first fully covered layer; 0 for inactive rows."""
    from repro_torch.core import segment_tree
    from repro_torch.kernels import ref

    F = us.shape[0]
    n, layers, m = nbrs.shape
    K = layers * m
    flat = nbrs[us.clamp(0, n - 1)].reshape(F, K)
    lay = torch.div(torch.arange(K, device=us.device, dtype=torch.int32), m,
                    rounding_mode="floor")[None, :]
    valid = ref.edge_scan_valid(flat, us[:, None], L[:, None], R[:, None],
                                lay, logn=logn)
    last = out[:, -1]
    hit = valid & (flat == last[:, None])
    pos_last = hit.int().argmax(dim=1)
    u = us.clamp_min(0)[:, None]
    lays = torch.arange(layers, device=us.device, dtype=torch.int32)[None, :]
    lo, hi = segment_tree.seg_bounds(u, lays, logn)
    terminal = (lo >= L[:, None]) & (hi <= R[:, None])
    ft = torch.where(terminal.any(1), terminal.int().argmax(1), 0)
    needed = torch.where(last >= 0, pos_last + 1, (ft + 1) * m)
    return int(torch.where(us >= 0, needed, 0).sum())


def edge_bound(torch, nbrs, us, L, R, logn, want) -> tuple[float, str,
                                                          int]:
    """edge_select's bound on a frontier: each row's (u, L, R), the edge
    ids its selection must read (``edge_positions_needed``) and its m_out
    outputs, once each. Returns (ms, bound_by, ids needed)."""
    F, m_out = want.shape
    need = edge_positions_needed(torch, nbrs, us, L, R, logn, want)
    ms, by = bound_ms(3 * F * 4 + need * 4 + F * m_out * 4, 0.0)
    return ms, by, need


def edge_floor_ms(torch, nbrs, us):
    """Device ms (L2 cold, ``device_ms``) of edge_select's latency floor on
    a frontier: ``csrc/edge_select.cu``'s probe, the kernel's CTAs and its
    two dependent round trips (each row's u, then u's first 32 edge ids)
    with no selection. None where the tree's library has no probe."""
    import ctypes

    from repro_torch.kernels import _build

    f = getattr(_build.library("edge_select"), "rt_edge_floor", None)
    if f is None:
        return None
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    F, (n, layers, m) = us.shape[0], nbrs.shape
    dev = us.device
    sums = torch.empty((F,), dtype=torch.int32, device=dev)

    def call(i):
        _build.check(f(nbrs.data_ptr(), us.data_ptr(), sums.data_ptr(), F, n,
                       layers * m, _build.stream_of(dev)),
                     "edge_select", "edge_floor")

    return device_ms(torch, call, "edge_floor_kernel")[0]


def pairwise_library(torch, q, x):
    """(call(i), what it is) of the one PyTorch call timed as
    pairwise_dist's library_ms (the port never calls it): f32, cuBLAS
    SGEMM of q @ x.T (TF32 off); bf16 / f16, the same product with f32
    output, ``torch.mm(q, x.T, out_dtype=torch.float32)``, or, where this
    torch rejects ``out_dtype``, the 16-bit-output product. Either is the
    product alone, without the norms: a lower bound on any library
    version of the function."""
    xt = x.T
    if q.dtype == torch.float32:
        return (lambda i: torch.mm(q, xt)), "torch.mm f32 (SGEMM, TF32 off)"
    try:
        torch.mm(q[:1], xt[:, :1], out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return ((lambda i: torch.mm(q, xt)),
                "torch.mm 16-bit output (out_dtype rejected by this torch)")
    return ((lambda i: torch.mm(q, xt, out_dtype=torch.float32)),
            "torch.mm out_dtype=float32")


def cross_cluster_share(torch, index, lab) -> list:
    """Per layer, the share of its edges that join two clusters (``lab``:
    the cluster of each rank, on the index's device)."""
    nb = index.neighbors.long()
    out = []
    for lay in range(nb.shape[1] - 1):             # the leaves hold no edges
        e = nb[:, lay, :]
        live = e >= 0
        joins = live & (lab[e.clamp_min(0)] != lab[:, None])
        out.append(round(float(joins.sum()) / max(int(live.sum()), 1), 4))
    return out


def recall_by_entry(torch, index, lab_np, L, R, gt, ids, frac) -> dict:
    """Recall@10 by range fraction 2^-i, split by whether an entry point
    lies in the cluster of the query's true nearest neighbour ("hit") or
    not ("miss"), beside the mean number of clusters the true top-10 spans
    ("gt_clusters")."""
    from repro_torch import recall
    from repro_torch.core.search import range_entry_ids

    dev = index.device
    ent = range_entry_ids(torch.as_tensor(L, device=dev),
                          torch.as_tensor(R, device=dev), index.n).cpu()
    ent_lab = np.where(ent >= 0, lab_np[ent.clamp_min(0).numpy()], -1)
    hit = (ent_lab == lab_np[gt[:, 0]][:, None]).any(1)
    spans = np.array([len(set(lab_np[g[g >= 0]].tolist())) for g in gt])

    def rec(sel):
        return round(recall(ids[sel], gt[sel]), 4) if sel.any() else None

    return {int(i): {"queries": int((frac == i).sum()),
                     "hit": int((hit & (frac == i)).sum()),
                     "recall": rec(frac == i),
                     "recall_hit": rec(hit & (frac == i)),
                     "recall_miss": rec(~hit & (frac == i)),
                     "gt_clusters": round(float(spans[frac == i].mean()), 2)}
            for i in np.unique(frac)}


def witness_build(torch, n_cut) -> tuple[dict, bool]:
    """The build kernels at a size where recall on wide ranges is already
    low: build the same data twice on the card, once with the kernels and
    once with the prune and the sibling searches' distances pinned to plain
    torch, then compare the tables layer by layer and the recall of one
    search over each by range fraction."""
    from repro_torch import BuildConfig, RangeGraphIndex, SearchConfig, recall
    from repro_torch.bench.buildpath import table_overlap
    from repro_torch.data import make_workload, vector_dataset
    from repro_torch.kernels import ops

    vectors, attrs, _ = vector_dataset(n_cut, 128, seed=0, n_clusters=64,
                                       attr_kind="uniform")
    cfg = BuildConfig(m=16, ef_construction=64, chunk=BUILD_CHUNK)
    t0 = time.perf_counter()
    kidx = RangeGraphIndex.build(vectors, attrs[:, 0], cfg)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    before = ops.launch_counts()
    t0 = time.perf_counter()
    pidx = RangeGraphIndex.build(vectors, attrs[:, 0], cfg,
                                 prune_impl="torch", dist_impl="torch")
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    plain_launches = sum(ops.launch_counts().values()) - sum(before.values())
    jac = table_overlap(kidx.neighbors, pidx.neighbors)
    same_rows = float((kidx.neighbors == pidx.neighbors).all(2).all(1)
                      .double().mean())
    wl = make_workload(kidx, "mixed", n_queries=1000, seed=1)
    gt, _ = kidx.brute_force(wl.queries, wl.L, wl.R, k=10)
    c = SearchConfig(ef=64, expand_width=4, hop_impl="cuda")
    rk = kidx.search_ranks(wl.queries, wl.L, wl.R, k=10, config=c)
    rp = pidx.search_ranks(wl.queries, wl.L, wl.R, k=10, config=c)
    rk, rp = rk.ids.cpu().numpy(), rp.ids.cpu().numpy()
    frac = np.rint(np.log2(n_cut / (wl.R - wl.L + 1))).astype(int)
    by_frac = {int(i): [round(recall(rk[frac == i], gt[frac == i]), 4),
                        round(recall(rp[frac == i], gt[frac == i]), 4)]
               for i in np.unique(frac)}
    r_k, r_p = recall(rk, gt), recall(rp, gt)
    out = {"n": n_cut, "kernel_build_s": round(k_s, 2),
           "plain_build_s": round(p_s, 2),
           "plain_build_kernel_launches": plain_launches,
           "edge_jaccard_min": round(min(jac), 4),
           "edge_jaccard_min_layer": int(np.argmin(jac)),
           "identical_rows_share": round(same_rows, 4),
           "recall_kernel_build": round(r_k, 4),
           "recall_plain_build": round(r_p, 4),
           "recall_by_frac_kernel_plain": by_frac}
    good = (plain_launches == 0 and min(jac) >= 0.95
            and abs(r_k - r_p) <= 0.01)
    return out, good


# The codec slice: every stored layout of the vector table, re-encoded from
# the main 1M index (StorageConfig presets, as repro names them).
CODECS = (("bf16", "compact", ("bfloat16",)), ("f16", "compact", ("float16",)),
          ("int8", "int8", ()), ("pq", "pq", ()))
PQ_RERANK = 48            # SearchConfig.rerank for PQ, as tests/test_codecs
# TPU codec body each layout replaces (file:line of the decode branch)
CODEC_TPU = {
    "gather_dist": {"bf16": "gather_distance.py:111",
                    "f16": "gather_distance.py:111",
                    "int8": "gather_distance.py:98",
                    "pq": "gather_distance.py:101"},
    "hop": {"bf16": "hop.py:233", "f16": "hop.py:233", "int8": "hop.py:220",
            "pq": "hop.py:223"},
    "prune": "prune.py:95",   # the codec body, :95-105 (set-up :207-219)
}
# what pairwise_dist's library_ms times (the port never calls it;
# pairwise_library): each record names its call under "library"
PAIRWISE_LIBRARY = ("the product q @ x.T alone, without the norms: f32 "
                    "cuBLAS SGEMM (torch.mm, TF32 off); bf16/f16 torch.mm "
                    "with out_dtype=torch.float32 (16-bit in, f32 out), or "
                    "the 16-bit-output product where torch rejects "
                    "out_dtype; a lower bound on any library version")


def stored_row_bytes(table) -> tuple[int, int]:
    """(bytes of one stored row including its int8 scale, bytes read once
    per call: the PQ codebook) of a vector table."""
    from repro_torch.core import storage

    if isinstance(table, storage.Int8Vectors):
        return table.codes.shape[1] + 4, 0
    if isinstance(table, storage.PQVectors):
        return (table.codes.shape[1],
                table.codebook.numel() * table.codebook.element_size())
    return table.shape[1] * table.element_size(), 0


def encode_codecs(torch, index) -> dict:
    """Re-encode the index under every codec on the card; print the
    seconds and the stored bytes of each table against f32."""
    from repro_torch import StorageConfig
    from repro_torch.core import storage

    def parts(ix):
        return {"vectors": storage.table_nbytes(ix.vectors),
                "neighbors": storage.table_nbytes(ix.neighbors),
                "rerank": storage.table_nbytes(ix.rerank),
                "total": ix.nbytes}

    base = parts(index)
    print(f"encode[f32]: stored bytes {json.dumps(base)}", flush=True)
    out = {}
    for name, preset, args in CODECS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = index.astype_storage(getattr(StorageConfig, preset)(*args))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = parts(out[name])
        print(f"encode[{name}]: {secs:.2f} s; stored bytes "
              f"{json.dumps(got)}; vs f32: vectors "
              f"{got['vectors'] / base['vectors']:.4f}, neighbors "
              f"{got['neighbors'] / base['neighbors']:.4f}, total "
              f"{got['total'] / base['total']:.4f}", flush=True)
    return out


def codec_searches(torch, codec_idx, wl, lo_val, hi_val, gt, f32_recall,
                   efs) -> bool:
    """Each codec index answers the workload at each ef through the fused
    hop, the composed hop and the all-plain path (PQ also with rerank).
    Gates: fused ids == composed ids; fused recall within 0.01 of the
    all-plain path's; PQ with rerank >= PQ without, less 1e-9."""
    from repro_torch import SearchConfig, recall

    ok = True
    for name, idx in codec_idx.items():
        for ef in efs:
            base = SearchConfig(ef=ef, expand_width=4)
            variants = [0] + ([PQ_RERANK] if name == "pq" else [])
            rec = {}
            for rr in variants:
                c = base.replace(rerank=rr)
                paths = {"fused": c.replace(hop_impl="cuda"),
                         "composed": c.replace(hop_impl="composed"),
                         "plain": c.replace(hop_impl="torch",
                                            edge_impl="torch",
                                            dist_impl="torch")}
                got = {}
                for path, pc in paths.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = idx.search(wl.queries, lo_val, hi_val, k=10,
                                     config=pc)
                    ids = res.ids.cpu().numpy()
                    got[path] = (ids, time.perf_counter() - t0)
                tag = f"{name} ef={ef}" + (f" rerank={rr}" if rr else "")
                r = {p: recall(ids, gt) for p, (ids, _) in got.items()}
                rec[rr] = r["fused"]
                same = bool(np.array_equal(got["fused"][0],
                                           got["composed"][0]))
                print(f"codec search[{tag}]: recall@10 fused "
                      f"{r['fused']:.4f} (vs f32 "
                      f"{r['fused'] - f32_recall[ef]:+.4f}), composed "
                      f"{r['composed']:.4f}, plain {r['plain']:.4f}; QPS "
                      + ", ".join(f"{p} {len(ids) / secs:.1f}"
                                  for p, (ids, secs) in got.items())
                      + ("" if same else "; fused and composed ids DIFFER"),
                      flush=True)
                if not same:
                    ok = False
                if abs(r["fused"] - r["plain"]) > 0.01:
                    print(f"codec search[{tag}]: fused recall is not within "
                          "0.01 of the all-plain path's", flush=True)
                    ok = False
            if name == "pq" and rec[PQ_RERANK] < rec[0] - 1e-9:
                print(f"codec search[pq ef={ef}]: rerank recall "
                      f"{rec[PQ_RERANK]:.4f} below no-rerank {rec[0]:.4f}",
                      flush=True)
                ok = False
    return ok


def frontier(torch, index, queries, L, R, W, gen) -> dict:
    """One beam step's inputs on ``index`` for ``queries`` over rank
    ranges [L, R]: W frontier nodes per query drawn inside its range, 90%
    of them expandable, 32 in-range ids already visited; the edges the
    plain select_edges gives them (the gather's ids, [B, W * m]) and the
    hop's arguments."""
    from repro_torch.core import bitset
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    nbrs, logn, m_out = index.neighbors, index.logn, index.m
    B = len(queries)
    q = torch.as_tensor(queries, device=dev)
    Lt = torch.as_tensor(L, device=dev)
    Rt = torch.as_tensor(R, device=dev)
    span = (Rt - Lt + 1).to(torch.float64)
    u = (Lt[:, None] + (torch.rand((B, W), generator=gen, device=dev,
                                   dtype=torch.float64) * span[:, None])
         .floor().to(torch.int32)).contiguous()
    exp_ok = torch.rand((B, W), generator=gen, device=dev) < 0.9
    Lw = Lt.repeat_interleave(W).contiguous()
    Rw = Rt.repeat_interleave(W).contiguous()
    vis0 = bitset.make(B, index.n, device=dev)
    seen_ids = (Lt[:, None] + (torch.rand((B, 32), generator=gen, device=dev,
                                          dtype=torch.float64) * span[:, None])
                .floor().to(torch.int32))
    bitset.test_and_set(vis0, seen_ids, torch.ones_like(seen_ids,
                                                         dtype=torch.bool))
    us = u.reshape(-1).contiguous()
    edges = ref.select_edges(nbrs, us, Lw, Rw, logn=logn, m_out=m_out)

    def hop_need(nb, out):
        return edge_positions_needed(torch, nb, us, Lw, Rw, logn,
                                     out.reshape(B * W, m_out))

    return dict(q=q, us=us, Lw=Lw, Rw=Rw,
                ids=edges.reshape(B, W * m_out).contiguous(),
                hop_args=(u, Lw, Rw, vis0, exp_ok, logn, m_out),
                hop_need=hop_need)


def table_kernels(torch, name, table, nbrs, q, ids, hop_args,
                  hop_need) -> dict:
    """gather_dist and hop on one stored vector table against their plain
    versions on the card at the main path's shapes: distances within
    DIST_RTOL of their terms, the hop's integers identical, and the fused
    hop's four outputs identical to the composed hop's (edge_select ->
    bitset -> gather_dist), distances too. Times: each kernel's device ms
    per launch with L2 cold (``device_ms``), the wrapper's host µs per
    call (``host_us``), and by CUDA events around back-to-back wrapper
    calls (``event_ms``), plain ms; the bound at
    the stored row width counts each distinct row once (the int8 scale per
    row, the PQ codebook once). Returns {"gather_dist": record, "hop":
    record}."""
    from repro_torch.core import storage
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gather_distance import gather_dist_cuda
    from repro_torch.kernels.hop import hop_cuda

    u, Lw, Rw, vis0, exp_ok, logn, m_out = hop_args
    B, d = q.shape
    W = u.shape[1]
    tag = "" if name == "f32" else f" {name}"
    qq = (q * q).sum(-1, keepdim=True)
    dec = storage.decode_vectors(table)
    xx_all = (dec * dec).sum(-1)
    del dec
    row, once = stored_row_bytes(table)
    records = {}

    def gather(i):
        return gather_dist_cuda(q, table, ids)

    got = gather(0)
    want = ref.gather_dist(q, table, ids)
    xx = torch.where(ids >= 0, xx_all[ids.clamp_min(0).long()], 0.0)
    err, good = dist_err(torch, got, want, qq, xx)
    dms, how = device_ms(torch, gather, "gather_dist_kernel")
    hus = host_us(torch, gather)
    kms = time_ms(torch, gather)
    pms = time_ms(torch, lambda i: ref.gather_dist(q, table, ids))
    nv = int((ids >= 0).sum())
    nd = int(torch.unique(ids[ids >= 0]).numel())
    bms, by = bound_ms(ids.numel() * 8 + B * d * 4 + nd * row + once,
                       nv * 4 * d)
    records["gather_dist"] = dict(
        ok=good, max_abs_err=err, ms=dms, timed_by=how, event_ms=kms,
        host_us=hus, plain_ms=pms, bound_ms=bms, bound_by=by,
        distinct_rows=nd,
        minus1_share=1 - nv / ids.numel(),
        shape=f"B={B} M={ids.shape[1]} d={d}{tag}")

    vis_k = [vis0.clone() for _ in range(12)]
    vis_p = [vis0.clone() for _ in range(5 + 3)]
    gk = hop_cuda(q, table, nbrs, u, Lw, Rw, vis0.clone(), exp_ok,
                  logn=logn, m_out=m_out)
    gp = ref.hop(q, table, nbrs, u, Lw, Rw, vis0.clone(), exp_ok,
                 logn=logn, m_out=m_out)
    gc = ops.hop(q, table, nbrs, u, Lw, Rw, vis0.clone(), exp_ok,
                 logn=logn, m_out=m_out, impl="composed")
    int_ok = all(torch.equal(a, b) for a, b in
                 ((gk[0], gp[0]), (gk[2], gp[2]), (gk[3], gp[3])))
    composed_same = all(torch.equal(a, b) for a, b in zip(gk, gc))
    if not composed_same:
        print(f"hop[{name}]: the fused hop's outputs differ from the "
              "composed hop's", flush=True)
    xx = torch.where(gp[2], xx_all[gp[0].clamp_min(0).long()], 0.0)
    err, good = dist_err(torch, gk[1], gp[1], qq, xx)

    def hop(i):
        return hop_cuda(q, table, nbrs, u, Lw, Rw, vis_k[i], exp_ok,
                        logn=logn, m_out=m_out)

    # every timed call starts from the same visited rows: a call that found
    # its candidates already visited would load no rows
    dms, how = device_ms(torch, hop, "hop_kernel",
                         reset=lambda i: vis_k[i].copy_(vis0))
    vis_h = vis0.clone()
    hus = host_us(torch, lambda i: hop_cuda(
        q, table, nbrs, u, Lw, Rw, vis_h, exp_ok, logn=logn, m_out=m_out))
    del vis_h
    vis_k = [vis0.clone() for _ in range(20 + 3)]
    kms = time_ms(torch, hop)
    del vis_k
    pms = time_ms(torch, lambda i: ref.hop(
        q, table, nbrs, u, Lw, Rw, vis_p[i], exp_ok, logn=logn,
        m_out=m_out), iters=5)
    need = hop_need(nbrs, gp[0])
    bms, by, nd = hop_bound(torch, table, exp_ok, gp, need, d, m_out)
    K = nbrs.shape[1] * nbrs.shape[2]
    records["hop"] = dict(
        ok=int_ok and good and composed_same, max_abs_err=err, ms=dms,
        timed_by=how, event_ms=kms, host_us=hus, plain_ms=pms,
        bound_ms=bms, bound_by=by, composed_identical=composed_same,
        distinct_rows=nd,
        edge_ids_needed=need, edge_ids_in_blocks=int((u >= 0).sum()) * K,
        shape=f"B={B} W={W} m_out={m_out} n={storage.table_n(table)} "
              f"d={d}{tag}")
    return records


def hop_bound(torch, table, exp_ok, plain_out, need, d, m_out):
    """(bound ms, bound_by, distinct rows) of one hop launch: q, the
    frontier and its bounds, the ``need`` edge ids the selection reads,
    one visited word per pre-valid edge, the new ids' distances, each
    distinct new row once at its stored width and the outputs, over the
    card's memory rate; 4d operations per new row. ``plain_out`` is the
    plain hop's (nbr, ndist, nvalid, visited)."""
    nbr, _, nvalid, _ = plain_out
    B, W = exp_ok.shape
    row, once = stored_row_bytes(table)
    n_new = int(nvalid.sum())
    nd = int(torch.unique(nbr[nvalid]).numel())
    pre_valid = (nbr >= 0) & exp_ok.repeat_interleave(m_out, dim=1)
    nbytes = (B * d * 4 + B * W * 13 + need * 4 + int(pre_valid.sum()) * 4
              + n_new * 4 + nd * row + once + B * W * m_out * 9)
    bms, by = bound_ms(nbytes, n_new * 4 * d)
    return bms, by, nd


def codec_files(torch, codec_idx, wl, lo_val, hi_val, names) -> bool:
    """Save each named codec index with the port's packer (zlib where
    zstandard is missing) to a temporary directory, load it back on the
    card, and hold every array and the search ids equal."""
    import tempfile

    from repro_torch import RangeGraphIndex, SearchConfig

    c = SearchConfig(ef=64, expand_width=4, hop_impl="cuda")
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in names:
            idx = codec_idx[name]
            cr = c.replace(rerank=PQ_RERANK) if idx.rerank is not None else c
            path = os.path.join(tmp, f"{name}.bin")
            t0 = time.perf_counter()
            idx.save(path)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            back = RangeGraphIndex.load(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            os.remove(path)
            a, b = idx.to_numpy(), back.to_numpy()
            same = set(a) == set(b)
            for k in a:
                if isinstance(a[k], np.ndarray) or isinstance(a[k], tuple):
                    la = list(a[k]) if isinstance(a[k], tuple) else [a[k]]
                    lb = list(b[k]) if isinstance(b[k], tuple) else [b[k]]
                    same &= type(a[k]) is type(b[k]) and len(la) == len(lb)
                    same &= all(x.dtype == y.dtype and np.array_equal(x, y)
                                for x, y in zip(la, lb))
                else:
                    same &= a[k] == b[k]
            ids_a = idx.search(wl.queries, lo_val, hi_val, k=10,
                               config=cr).ids.cpu().numpy()
            ids_b = back.search(wl.queries, lo_val, hi_val, k=10,
                                config=cr).ids.cpu().numpy()
            same_ids = bool(np.array_equal(ids_a, ids_b))
            print(f"files[{name}, n={idx.n}]: saved {size / 2**20:.1f} MiB "
                  f"in {save_s:.1f} s, loaded on {back.device} in "
                  f"{load_s:.1f} s; arrays equal {same}; search ids equal "
                  f"{same_ids}", flush=True)
            ok &= bool(same) and same_ids and back.device.type == "cuda"
            del back
    return ok


def kernel_entry(name, rec, cu, tpu, launches, library_ms=None) -> dict:
    """Print one kernel's check and return its record of the kernels line.
    ``library_ms`` is the time of one PyTorch call computing the same
    function, where there is one (for pairwise_dist, cuBLAS SGEMM of the
    product alone: PAIRWISE_LIBRARY); else null."""
    timing = f"{rec['ms']:.4f} ms"
    if "event_ms" in rec:
        timing = (f"device {rec['ms']:.4f} ms (L2 cold, by "
                  f"{rec['timed_by']}), by events around back-to-back calls "
                  f"{rec['event_ms']:.4f} ms, host {rec['host_us']:.1f} us")
    print(f"kernel {name} [{rec['shape']}]: {timing}, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})"
          + ("" if library_ms is None else f", library {library_ms:.4f} ms")
          + ("" if rec.get("floor_ms") is None else
             f", two-round-trip floor {rec['floor_ms']:.4f} ms")
          + f", max_abs_err {rec['max_abs_err']:.3g}"
          + (f", rows differing {rec['rows_differ']} (near ties "
             f"{rec['near_ties']})" if "rows_differ" in rec else "")
          + (f"; {rec['regime']}" if "regime" in rec else "")
          + ("" if rec["ok"] else "  DISAGREES"), flush=True)
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{cu}",
             "replaces": f"src/repro/kernels/{tpu}",
             "launches": launches, "max_abs_err": rec["max_abs_err"],
             "ms": rec["ms"], "plain_ms": rec["plain_ms"],
             "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": library_ms}
    entry.update({k: rec[k] for k in SEARCH_KERNEL_KEYS if k in rec})
    return entry


def prune_regimes() -> dict:
    """The prune's launches per regime since the counters were zeroed."""
    from repro_torch.kernels.prune import prune_cuda

    return dict(prune_cuda.regime_launches)


def profile_search(torch, search, tag="search fused", share_of=None) -> None:
    """One call of ``search`` under torch.profiler (the card's activity
    only): device busy share of the wall time and the kernels that took
    the most device time; with ``share_of`` (a kernel name's substring, or
    a tuple of them), each kernel's device time, launches and share of the
    device time too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        time.sleep(0.05)  # the profiler can miss launches near its start
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(0.05)  # and near its end

    # device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    if not busy:
        print(f"profile[{tag}]: device time not measured (the "
              "profiler saw no device activity)", flush=True)
        return
    top = sorted(events, key=dev_us, reverse=True)[:8]
    share = ""
    for name in (share_of,) if isinstance(share_of, str) else share_of or ():
        mine = [e for e in events if name in e.key]
        spent = sum(dev_us(e) for e in mine)
        share += (f"; {name} {spent / 1e3:.2f} ms over "
                  f"{sum(e.count for e in mine)} launches, "
                  f"{100 * spent / busy:.1f}% of device time")
    print(f"profile[{tag}]: wall {wall_us / 1e3:.2f} ms under the "
          f"profiler, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / wall_us:.1f}%){share}; top device time: "
          + "; ".join(
              f"{e.key[:60]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
              for e in top), flush=True)


def bf16_tol(torch, got, want):
    """Per element: one bf16 ulp at the larger magnitude of the two, plus
    FLASH_F32_TOL. Kernel and plain version each round one f32 result to
    bf16 once, and those f32 results differ by their sum order, up to the
    f32 gate's 1e-5 absolute: near 0, where V's terms cancel, that is more
    than an ulp of the output."""
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8) \
        + FLASH_F32_TOL


def attention_pairs(Sq, Skv, causal, window, q_offset) -> int:
    """(query, key) pairs a causal / windowed attention must score."""
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return int(ok.sum())


def flash_checks(torch) -> dict:
    """The flash-attention kernel against its plain version on the card at
    the embed path's shape, one long shape and the variant grid: f32
    within 1e-5, bf16 within ``bf16_tol``; ms, plain ms, the bound (bytes
    at 3.35 TB/s or flops at the input type's peak) and, where SDPA
    computes the same function (causal or not, no window, softcap or
    offset), its ms as library_ms."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import body_of, \
        flash_attention_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = {}
    for name, (B, Hq, Hkv, Sq, S, Dh, dt, kw) in FLASH_SHAPES.items():
        dtype = getattr(torch, dt)
        # q, k and v in the path's layout: [B, S, H, Dh] viewed as
        # [B, H, S, Dh]
        q = torch.randn((B, Sq, Hq, Dh), generator=gen, device=dev,
                        dtype=dtype).transpose(1, 2)
        k = torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                        dtype=dtype).transpose(1, 2)
        v = torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                        dtype=dtype).transpose(1, 2)
        if name in FLASH_CONTIGUOUS_KV:
            k, v = k.contiguous(), v.contiguous()
        ops.reset_launch_counts()
        got = flash_attention_cuda(q, k, v, **kw)
        body = [b for b, c in flash_attention_cuda.body_launches.items()
                if c][0]
        want = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if body != body_of(dtype, Dh):
            print(f"flash_attention[{name}]: launched the {body} body, "
                  f"not {body_of(dtype, Dh)}", flush=True)
            good = False
        elif dtype == torch.float32:
            good = float(err.max()) <= FLASH_F32_TOL
        else:
            tol = bf16_tol(torch, got, want)
            good = bool((err <= tol).all())
            if not good:
                bad = (err - tol).argmax()
                print(f"flash_attention[{name}]: worst element got "
                      f"{float(got.flatten()[bad])}, plain "
                      f"{float(want.flatten()[bad])}", flush=True)
        iters = 5 if S >= 4096 else 20
        kms = time_ms(torch, lambda i: flash_attention_cuda(q, k, v, **kw),
                      iters=iters)
        pms = time_ms(torch, lambda i: ref.attention(q, k, v, **kw),
                      iters=3 if S >= 4096 else 10)
        lms = None
        if not ({"window", "softcap"} & set(kw)) and not kw.get("q_offset"):
            lms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                q, k, v, is_causal=kw.get("causal", True), enable_gqa=True),
                iters=iters)
        pairs = attention_pairs(Sq, S, kw.get("causal", True),
                                kw.get("window"), kw.get("q_offset", 0))
        esz = got.element_size()
        nbytes = (2 * B * Hq * Sq * Dh + 2 * B * Hkv * S * Dh) * esz
        flops = 4.0 * B * Hq * pairs * Dh
        bms, by = bound_ms(nbytes, flops, PEAK_FLOPS[str(dtype)])
        rec = dict(ok=good, max_abs_err=float(err.max()), ms=kms,
                   plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms,
                   body=body,
                   shape=f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={S} Dh={Dh} "
                         f"{dt}"
                         + (f" {json.dumps(kw)}" if kw else " causal")
                         + (" contiguous k/v" if name in FLASH_CONTIGUOUS_KV
                            else ""))
        out[name] = rec
        print(f"kernel flash_attention[{name}] [{rec['shape']}] ({body} "
              f"body): {kms:.4f} ms, plain {pms:.4f} ms, SDPA "
              + ("n/a" if lms is None else f"{lms:.4f} ms")
              + f", bound {bms:.4f} ms ({by}), max_abs_err "
              f"{rec['max_abs_err']:.3g}" + ("" if good else "  DISAGREES"),
              flush=True)
        del q, k, v, got, want, err
    return out


def prune_work(torch, cand, du, cvec, m, alpha=1.0,
               fill=True) -> tuple[int, int, int]:
    """What the prune of these inputs must do, as ``kernels/ref.py::
    prune_vecs`` decides it: (distinct valid ids over the whole batch, the
    table rows it must read once; valid candidates left after each node's
    dedup, summed; dot products the sweeps need: at each keep, one with
    every candidate it could still suppress, i.e. valid, not taken, not
    yet suppressed and not the keep itself). Each live candidate's norm
    is one dot more."""
    B, C = cand.shape
    dev = cand.device
    pos = torch.arange(C, device=dev)
    valid = (cand >= 0) & torch.isfinite(du)
    same = cand[:, :, None] == cand[:, None, :]
    earlier = (du[:, :, None] < du[:, None, :]) | (
        (du[:, :, None] == du[:, None, :]) & (pos[:, None] < pos[None, :]))
    valid &= ~(same & earlier & valid[:, :, None]
               & valid[:, None, :]).any(dim=1)
    del same, earlier
    union = int(torch.unique(cand[valid]).numel())
    live_rows = int(valid.sum())
    xx = (cvec * cvec).sum(-1)
    supp = torch.zeros_like(valid)
    taken = torch.zeros_like(valid)
    rows = torch.arange(B, device=dev)
    dots = 0
    for _ in range(m):
        avail = valid & ~taken
        fillable = avail & supp if fill else torch.zeros_like(avail)
        cls = torch.where(avail & ~supp, 0, torch.where(fillable, 1, 2))
        cmin = cls.amin(dim=1, keepdim=True)
        pick = (cls == cmin) & (cmin < 2)
        dmask = torch.where(pick, du, torch.inf)
        dmin = dmask.amin(dim=1, keepdim=True)
        p = torch.where(pick & (dmask == dmin), pos, C).amin(dim=1)
        keep = cmin[:, 0] == 0
        p_safe = torch.where(cmin[:, 0] < 2, p, 0)
        open_ = avail & ~supp & (pos[None, :] != p[:, None]) & keep[:, None]
        dots += int(open_.sum())
        xy = torch.einsum("bcd,bd->bc", cvec, cvec[rows, p_safe])
        cc = (xx - 2.0 * xy + xx[rows, p_safe][:, None]).clamp_min(0.0)
        supp |= keep[:, None] & (alpha * cc < du)
        taken |= pos[None, :] == p[:, None]
    return union, live_rows, dots


def prune_record(torch, table, cand, du, m, shape) -> dict:
    """The prune kernel against its plain version on one table in any
    stored layout: kept ids equal but for near ties (``prune_parity``), ms
    and plain ms by CUDA events, and the bound of what these inputs need
    (``prune_work``) at the stored row width: the distinct candidate rows
    read once (int8 with its scale, PQ codes with the codebook once)."""
    from repro_torch.bench.common import prune_parity
    from repro_torch.core import storage
    from repro_torch.kernels import ref
    from repro_torch.kernels.prune import prune_cuda, smem_plan

    B, C = cand.shape
    d = storage.table_dim(table)
    plan = smem_plan(C, d)
    regime = plan.regime
    before = prune_cuda.regime_launches[regime]
    got = prune_cuda(cand, du, table, m=m)
    counted = prune_cuda.regime_launches[regime] - before == 1
    want = ref.prune(cand, du, table, m=m)
    cvec = storage.decode_rows(table, cand.clamp_min(0).long())
    differ, ties, good = prune_parity(got, want, cand, du, cvec, m)
    kms = time_ms(torch, lambda i: prune_cuda(cand, du, table, m=m))
    pms = time_ms(torch, lambda i: ref.prune(cand, du, table, m=m), iters=3)
    union, live, dots = prune_work(torch, cand, du, cvec, m)
    del cvec
    row, once = stored_row_bytes(table)
    bms, by = bound_ms(B * C * 8 + union * row + once + B * m * 4,
                       (dots + live) * 2.0 * d)
    if not counted:
        print(f"prune [{shape}]: the launch was not counted in the "
              f"{regime} regime its plan names", flush=True)
    return dict(ok=good and counted,
                max_abs_err=float((got - want).abs().max()),
                ms=kms, plain_ms=pms, bound_ms=bms, bound_by=by,
                rows_differ=differ, near_ties=ties,
                staged_rows=plan.staged, smem_bytes=plan.bytes,
                warps=plan.warps,
                regime=f"{regime}: one CTA a node, {plan.staged} staged "
                       f"rows, {plan.bytes} B and {plan.warps} warps",
                rows_distinct=union, rows_live=live, dots=dots, shape=shape,
                kept=got)


def prune_check_wide(torch, index, efc) -> dict:
    """The prune kernel against its plain version at the lm index's width
    (d = 1024) on one build chunk's own inputs: the nodes of one
    LM_BUILD_CHUNK at a search level (segments of 4,096 at n = 131,072),
    their candidates formed as ``core/build.py::_build_search_level``
    forms them (own child's edges plus ``search_fixed_layer(k=efc)`` over
    the sibling half: C = m + efc = 144 distinct ids), the child level
    read from the built table, which the later levels never change; on the
    f32 table and on its int8 re-encoding (rows that do not fit in shared
    memory decoded in the sweeps). Rows may differ only at near ties.
    Returns {"f32": record, "int8": record}."""
    from repro_torch import SearchConfig, StorageConfig
    from repro_torch.core import storage
    from repro_torch.core.search import search_fixed_layer

    table = index.vectors
    nbrs = index.neighbors
    n, d = table.shape
    dev = table.device
    m, logn = index.m, index.logn
    C = m + efc
    lay = max(logn - 12, 0)
    size = 1 << (logn - lay)
    s = (n // 2 // LM_BUILD_CHUNK) * LM_BUILD_CHUNK
    e = min(n, s + LM_BUILD_CHUNK)
    Bp = e - s
    u = torch.arange(s, e, dtype=torch.int32, device=dev)
    res = search_fixed_layer(
        table, nbrs, table[s:e], *sibling_bounds(torch, index, lay, s, e),
        layer=lay + 1, k=efc, config=SearchConfig(ef=efc))
    cand = torch.cat([nbrs[s:e, lay + 1, :], res.ids], dim=1)
    valid = (cand >= 0) & (cand != u[:, None]) & (cand < n)
    cand = torch.where(valid, cand, -1).to(torch.int32).contiguous()
    cvec = table[cand.clamp_min(0).long()]
    du = torch.where(valid, ((cvec - table[s:e][:, None, :]) ** 2).sum(-1),
                     torch.inf).contiguous()
    del cvec
    out = {}
    for name, tbl in (("f32", table), ("int8", storage.encode_vectors(
            table, StorageConfig.int8()))):
        rec = prune_record(torch, tbl, cand, du, m,
                           f"B={Bp} C={C} d={d} m={m}"
                           + ("" if name == "f32" else f" {name}"))
        rec.pop("kept")
        rec.update(layer=lay, segment=size)
        print(f"kernel prune [{rec['shape']}, one build chunk at layer "
              f"{lay} (segments of {size}); {rec['regime']}; "
              f"{rec['rows_live']} live candidates, {rec['rows_distinct']} "
              f"distinct table rows, {rec['dots']} dots]: "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), rows "
              f"differing {rec['rows_differ']} (near ties "
              f"{rec['near_ties']})" + ("" if rec["ok"] else "  DISAGREES"),
              flush=True)
        out[name] = rec
    return out


def profile_build_level(torch, index, efc, chunk, lay) -> None:
    """torch.profiler over one search level of a build, as
    ``core/build.py::_build_search_level`` runs it (the child level read
    from the built table, which the later levels never change): the device
    busy share, the prune's and gather_dist's device time, launches and
    share of it, and the top 8 kernels, the candidate gather and
    ``_sq_dists`` glue among them."""
    from repro_torch.core import build

    table, nbrs = index.vectors, index.neighbors
    n = table.shape[0]
    logn = index.logn
    cfg = build.BuildConfig(m=index.m, ef_construction=efc, chunk=chunk)
    profile_search(
        torch, lambda: build._build_search_level(
            table, nbrs, n, lay, logn, 1 << (logn - lay), cfg, chunk,
            "auto"),
        f"build level {lay}, n={n} d={table.shape[1]}, segments of "
        f"{1 << (logn - lay)}, {-(-n // chunk)} chunks of {chunk}",
        share_of=("prune", "gather_dist"))


def sibling_bounds(torch, index, lay, s, e):
    """Nodes [s, e) of layer ``lay`` and the sibling half of each one's
    segment, as ``core/build.py::_build_search_level`` forms them."""
    logn = index.logn
    size = 1 << (logn - lay)
    u = torch.arange(s, e, dtype=torch.int32, device=index.device)
    lo = (u >> (logn - lay)) << (logn - lay)
    mid = lo + size // 2 - 1
    in_left = u <= mid
    return (torch.where(in_left, mid + 1, lo),
            torch.where(in_left, lo + size - 1, mid))


def gather_at_build(torch, index, efc, chunk, lay) -> dict:
    """gather_dist as the build's sibling search launches it: one chunk of
    layer ``lay`` (the middle chunk of nodes, their queries against the
    sibling half of their segment on the child layer), run once under
    torch.profiler for its launches' mean device time, and once with
    ``ops.gather_dist`` wrapped to record every call. The entries' call
    (M = 3) and the hop step in the middle of the search are timed again
    alone by device time, with L2 cold and warm, beside their bound: the
    ids, queries and outputs, and each distinct valid row once, and held
    against the plain version on their arguments. Returns {"entries":
    record, "step": record, "ok": both agree, ...}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import SearchConfig
    from repro_torch.core.search import search_fixed_layer
    from repro_torch.kernels import ops

    table, nbrs = index.vectors, index.neighbors
    n, d = table.shape
    s = (n // 2 // chunk) * chunk
    e = min(n, s + chunk)
    sib_lo, sib_hi = sibling_bounds(torch, index, lay, s, e)

    def search():
        return search_fixed_layer(table, nbrs, table[s:e], sib_lo, sib_hi,
                                  layer=lay + 1, k=efc,
                                  config=SearchConfig(ef=efc))

    search()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        search()
        torch.cuda.synchronize()
        time.sleep(0.05)
    rows = [r for r in prof.key_averages() if "gather_dist" in r.key
            and str(r.device_type).endswith("CUDA")]
    launches = sum(r.count for r in rows)
    in_search = sum(dev_us(r) for r in rows) / max(launches, 1) / 1e3

    calls = []
    real = ops.gather_dist

    def spy(q, tbl, ids, **kw):
        calls.append((q, ids.clone()))
        return real(q, tbl, ids, **kw)

    ops.gather_dist = spy
    try:
        search()
    finally:
        ops.gather_dist = real
    valid = torch.stack([(ids >= 0).sum() for _, ids in calls]).cpu()
    slots = torch.tensor([ids.numel() for _, ids in calls])
    share = 1 - valid.double() / slots
    quart = [share[min(len(calls) - 1, k * len(calls) // 4)].item()
             for k in range(5)]
    out = {"layer": lay, "segment": 1 << (index.logn - lay),
           "nodes": [s, e], "launches": len(calls),
           "device_ms_in_search": in_search,
           "profiled_launches": launches,
           "minus1_share_all_calls": 1 - float(valid.sum() / slots.sum()),
           "minus1_share_at_quarters": quart}
    for name, k in (("entries", 0), ("step", len(calls) // 2)):
        q, ids = calls[k]
        out[name] = gather_call_record(torch, table, q, ids)
        out[name]["call"] = k
    del calls
    out["ok"] = out["entries"]["ok"] and out["step"]["ok"]
    print(f"gather_dist at build[layer {lay}, n={n} d={d}, chunk {s}:{e}]: "
          + json.dumps(out), flush=True)
    return out


def gather_call_record(torch, table, q, ids) -> dict:
    """One gather_dist call (f32 table, ids int32[B, M]) held against its
    plain version on the same arguments (``ok``: +inf masks equal, the
    distances within DIST_RTOL of ``‖q‖² + ‖x‖²``) and timed alone: device
    ms per launch with L2 cold and warm, the wrapper's host µs per call,
    and the bound: the ids, queries and outputs, and each distinct valid
    row once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_distance import gather_dist_cuda

    B, M = ids.shape
    d = q.shape[1]
    valid = ids >= 0
    nv = int(valid.sum())
    nd = int(torch.unique(ids[valid]).numel())
    bms, by = bound_ms(2 * B * M * 4 + B * d * 4
                       + nd * table.shape[1] * table.element_size(),
                       nv * 4 * d)

    def call(i):
        return gather_dist_cuda(q, table, ids)

    rows = table[ids.clamp_min(0).long()]
    xx = torch.where(valid, (rows * rows).sum(-1), 0.0)
    del rows
    err, good = dist_err(torch, call(0), ref.gather_dist(q, table, ids),
                         (q * q).sum(-1, keepdim=True), xx)
    del xx
    rec = {"shape": f"B={B} M={M} d={d}", "ok": good, "max_abs_err": err,
           "minus1_share": 1 - nv / (B * M),
           "distinct_rows": nd, "bound_ms": bms, "bound_by": by}
    for tag, cold in (("cold", True), ("warm", False)):
        rec[f"ms_{tag}"], rec[f"timed_by_{tag}"] = device_ms(
            torch, call, "gather_dist_kernel", cold=cold)
    rec["host_us"] = host_us(torch, call)
    return rec


def lm_serve(torch, n_items) -> tuple[dict, bool]:
    """The embed -> build -> serve path of ``launch/serve.py`` at
    qwen3-0.6b's full width, every launch counter at 0 before it and read
    after it. Returns (summary with the counts, every gate passed); the
    index and the model stay for the kernel checks."""
    import dataclasses

    from repro_torch import BuildConfig, RangeGraphIndex, SearchConfig, recall
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import embed_corpus
    from repro_torch.models.api import Model
    from repro_torch.serve import Request, ServingEngine

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ok = True
    out = {"arch": cfg.name, "n": n_items, "seq": LM_SEQ,
           "embed_batch": LM_BATCH, "build_chunk": LM_BUILD_CHUNK}

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vectors = embed_corpus(model, params, n_items, LM_SEQ, cfg.vocab,
                           seed=0, batch=LM_BATCH)
    embed_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    attrs = rng.uniform(0, 1e6, n_items)
    t0 = time.perf_counter()
    index = RangeGraphIndex.build(
        vectors, attrs, BuildConfig(m=16, ef_construction=2 * LM_EF,
                                    chunk=LM_BUILD_CHUNK))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = ServingEngine(index, config=SearchConfig(ef=LM_EF,
                                                      k_bucket=LM_K),
                           max_batch=LM_MAX_BATCH)
    entries0 = engine.stats["compiles"]
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    entries1 = engine.stats["compiles"]
    t0 = time.perf_counter()
    qv = embed_corpus(model, params, LM_QUERIES, LM_SEQ, cfg.vocab, seed=2,
                      batch=LM_BATCH)
    qembed_s = time.perf_counter() - t0
    los = rng.uniform(0, 5e5, LM_QUERIES)
    his = los + rng.uniform(1e5, 5e5, LM_QUERIES)
    t0 = time.perf_counter()
    for i in range(LM_QUERIES):
        engine.submit(Request(qv[i], los[i], his[i], k=LM_K))
    results = engine.flush()
    serve_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    bodies = {k: v for k, v in ops.body_counts().items()
              if k.startswith("flash_attention")}
    regimes = prune_regimes()
    st = engine.stats
    entries2 = st["compiles"]
    peak = torch.cuda.max_memory_allocated(dev)

    failed = [r for r in results if isinstance(r, Exception)]
    if failed:
        print(f"lm serve: {len(failed)} requests failed: {failed[0]!r}",
              flush=True)
        ok = False
    got = np.stack([r.ids for r in results if not isinstance(r, Exception)])
    L, R = index.ranks_of(los, his)
    t0 = time.perf_counter()
    gt = index.original_ids(index.brute_force(qv, L, R, k=LM_K)[0])
    gt_s = time.perf_counter() - t0
    rec = recall(got, gt)
    out["async"], good = lm_async(torch, index, engine, qv, los, his, got, gt,
                                  rec)
    ok &= good
    plain = ServingEngine(index, config=SearchConfig(
        ef=LM_EF, k_bucket=LM_K, hop_impl="torch", edge_impl="torch",
        dist_impl="torch"), max_batch=LM_MAX_BATCH)
    for i in range(LM_QUERIES):
        plain.submit(Request(qv[i], los[i], his[i], k=LM_K))
    t0 = time.perf_counter()
    pres = plain.flush()
    plain_s = time.perf_counter() - t0
    rec_plain = recall(np.stack([r.ids for r in pres]), gt)
    plain.close()
    # how hard the data is: recall at a wider beam, and the distance to
    # the 10th neighbour over the mean distance to 256 random in-range
    # items (near 1: every item is about as far as the nearest)
    wide = index.search_ranks(qv, L, R, k=LM_K, config=SearchConfig(
        ef=4 * LM_EF)).ids.cpu().numpy()
    rec_wide = recall(index.original_ids(wide), gt)
    gtd = index.brute_force(qv, L, R, k=LM_K)[1][:, -1]
    pick = L[:, None] + (rng.random((LM_QUERIES, 256))
                         * (R - L + 1)[:, None]).astype(np.int64)
    x = index.vectors[torch.as_tensor(pick, device=dev)]
    qd = torch.as_tensor(qv, device=dev)[:, None, :]
    mean_d = ((x - qd) ** 2).sum(-1).mean(1).cpu().numpy()
    contrast = float(np.mean(gtd / mean_d))
    del x, qd

    # attention on plain torch for a subsample: the same tokens (the draw
    # is batch by batch), the same weights
    sub = min(LM_SUBSAMPLE, n_items)
    pmodel = Model(dataclasses.replace(cfg, attention_impl="torch"))
    before = ops.launch_counts()["flash_attention"]
    pvec = embed_corpus(pmodel, params, sub, LM_SEQ, cfg.vocab, seed=0,
                        batch=LM_BATCH)
    plain_flash = ops.launch_counts()["flash_attention"] - before
    a, b = vectors[:sub].astype(np.float64), pvec.astype(np.float64)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))

    tokens = n_items * LM_SEQ
    out.update({
        "embed_s": round(embed_s, 3),
        "embed_tokens_per_s": round(tokens / embed_s, 1),
        "build_s": round(build_s, 3),
        "warmup_s": round(warm_s, 3),
        "query_embed_s": round(qembed_s, 3),
        "serve_s": round(serve_s, 3),
        "qps": round(engine.qps, 1),
        "latency_p50_ms": round(st["latency_p50"] * 1e3, 3),
        "latency_p99_ms": round(st["latency_p99"] * 1e3, 3),
        "cache_entries": [entries0, entries1, entries2],
        "recall_at_10": round(rec, 4),
        "recall_at_10_all_plain": round(rec_plain, 4),
        f"recall_at_10_ef{4 * LM_EF}": round(rec_wide, 4),
        "dist10_over_mean_dist": round(contrast, 4),
        "all_plain_qps": round(LM_QUERIES / plain_s, 1),
        "ground_truth_s": round(gt_s, 2),
        "subsample_plain_attention": {
            "items": sub, "max_abs_diff": float(np.abs(a - b).max()),
            "min_row_cosine": float(cos.min()),
            "kernel_launches": plain_flash},
        "peak_device_memory_gib": round(peak / 2**30, 2),
        "index_bytes": int(index.nbytes),
        "launches": counts,
        "flash_bodies": bodies,
        "prune_regimes": regimes,
    })
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    never = [k for k in ("flash_attention", "prune", "gather_dist", "hop")
             if counts[k] == 0]
    if never:
        fail(f"kernels never launched on the lm serve path: {never}")
    # every layer of every embed call on the tensor-core body
    calls = -(-n_items // LM_BATCH) + -(-LM_QUERIES // LM_BATCH)
    want_flash = cfg.n_layers * calls
    if counts["flash_attention"] != want_flash or \
            bodies["flash_attention[wgmma]"] != want_flash:
        fail(f"lm serve: {counts['flash_attention']} flash launches, "
             f"{json.dumps(bodies)}; expected {want_flash} ({cfg.n_layers} "
             f"layers x {calls} embed calls), all on the wgmma body")
    if entries2 != entries1 or entries1 == entries0:
        print(f"lm serve: cache entries {entries0} -> {entries1} after "
              f"warmup -> {entries2} after serving", flush=True)
        ok = False
    if abs(rec - rec_plain) > 0.01:
        print(f"lm serve: recall {rec:.4f} is not within 0.01 of the "
              f"all-plain path's {rec_plain:.4f}", flush=True)
        ok = False
    max_diff = float(np.abs(a - b).max())
    if cos.min() < LM_MIN_COSINE or max_diff > LM_MAX_ABS_DIFF or \
            plain_flash != 0 or not np.isfinite(vectors).all() or \
            vectors.shape != (n_items, cfg.d_model):
        print("lm serve: the embeddings are not finite of shape "
              f"({n_items}, {cfg.d_model}) or differ from plain attention's "
              f"(least row cosine {cos.min():.6f}, max |diff| {max_diff:.4g},"
              f" plain-path kernel launches {plain_flash})", flush=True)
        ok = False
    engine.close()
    out["index"] = index
    out["queries"] = (qv, L, R)
    out["model"] = (model, params)
    return out, ok


def lm_async(torch, index, engine, qv, los, his, sync_ids, gt,
             sync_recall) -> tuple[dict, bool]:
    """The lm phase's requests a second time, through
    ``AsyncServingEngine`` on the sync engine's warmed executor (deadline
    30 s, queue 1,024, ``"block"``: every request is expected served).
    Prints QPS, p50/p99 and id agreement with the sync engine's results.
    Gates: every request served, recall@10 within 0.01 of the sync
    engine's, no new cache entry."""
    import asyncio

    from repro_torch import ServeConfig, recall
    from repro_torch.kernels import ops
    from repro_torch.serve import AsyncServingEngine, Request, Result

    entries = engine.stats["compiles"]
    before = ops.launch_counts()
    cfg = ServeConfig(deadline_s=LM_ASYNC_DEADLINE_S,
                      max_queue=LM_ASYNC_MAX_QUEUE, backpressure="block")

    async def go():
        async with AsyncServingEngine(index, executor=engine.executor,
                                      serve=cfg, faults=False) as eng:
            t0 = time.perf_counter()
            res = await asyncio.gather(*(
                eng.submit(Request(qv[i], los[i], his[i], k=LM_K))
                for i in range(len(qv))), return_exceptions=True)
            return res, time.perf_counter() - t0, eng.stats

    res, secs, st = asyncio.run(go())
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()
              if v - before[k]}
    served = [r for r in res if isinstance(r, Result)]
    rec = dict(served=len(served), requests=len(res), seconds=secs,
               qps=len(served) / secs, flushes=st["flushes"],
               latency_p50_ms=st["latency_p50"] * 1e3,
               latency_p99_ms=st["latency_p99"] * 1e3,
               new_cache_entries=engine.stats["compiles"] - entries,
               launches=counts)
    ok = len(served) == len(res)
    if ok:
        got = np.stack([r.ids for r in served])
        rec["recall_at_10"] = recall(got, gt)
        rec["ids_identical"], rec["id_overlap"] = id_agreement(got, sync_ids)
        ok = abs(rec["recall_at_10"] - sync_recall) <= 0.01
    ok &= rec["new_cache_entries"] == 0
    print(f"lm serve async[AsyncServingEngine on the engine's executor, "
          f"{json.dumps(vars(cfg))}]: {json.dumps(rec)}; sync "
          f"recall@10 {sync_recall:.4f}" + ("" if ok else "  FAILED"),
          flush=True)
    if not ok and len(served) < len(res):
        first = next(r for r in res if not isinstance(r, Result))
        print(f"lm serve async: {len(res) - len(served)} requests not "
              f"served: {first!r}", flush=True)
    return rec, ok


def roofline_phase(torch) -> tuple[list, dict, dict, bool]:
    """``bench/roofline.py`` at its default shape (B = 64, n = 100,000,
    d = 128, M = 16) on the card, every launch counter at 0 before its
    kernel rows and read after: the measured peaks beside the data sheet's,
    each row's time, bound and fraction. Fails a row that errored, is not
    finite, or reaches more than ROOF_MAX_FRACTION of its bound (a count
    or a peak would be wrong). Returns (rows, counts, problem, ok)."""
    from repro_torch.bench import roofline
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    peaks = roofline.measure_peaks(dev, iters=10)
    print(f"roofline peaks (measured, f32 matmul TF32 off, 128 MiB "
          f"stream): {peaks['peak_gflops'] / 1e3:.2f} TFLOP/s (by k: "
          + ", ".join(f"{k}: {v / 1e3:.2f}" for k, v in
                      peaks["matmul_gflops_by_k"].items())
          + f"); TF32 product {peaks['peak_tf32_gflops'] / 1e3:.2f} TFLOP/s "
          f"at k = {peaks['tf32_k']}; {peaks['peak_gbps'] / 1e3:.3f} TB/s; "
          f"data sheet {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32, "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TF32, "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)
    p = roofline.make_problem(64, 100_000, 128, 16, dev)
    ops.reset_launch_counts()
    rows = roofline.run_kernels(p, peaks, iters=20)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    failures = roofline.failures_of(rows, peaks)
    for r in rows:
        if "error" in r:
            continue
        line = (f"roofline[{r['kernel']}]: {r['time_us']:.2f} us, bound "
                f"{r['bound_us']:.2f} us ({r['bottleneck']}), fraction "
                f"{r['achieved_fraction']:.4f}, {r['achieved_gbps']:.1f} "
                f"GB/s, {r['achieved_gflops']:.1f} GFLOP/s; flops "
                f"{r['flops']}, bytes {r['bytes']}")
        if r["achieved_fraction"] > ROOF_MAX_FRACTION:
            failures.append(f"kernel {r['kernel']} at "
                            f"{r['achieved_fraction']:.3f} of its bound")
        print(line, flush=True)
    print(f"roofline path launches: {json.dumps(counts)}", flush=True)
    for msg in failures:
        print(f"roofline: {msg}", flush=True)
    never = [r["kernel"] for r in rows
             if counts.get(ROOF_KERNEL.get(r["kernel"], r["kernel"])) == 0]
    if never:
        fail(f"kernels never launched on the roofline path: {never}")
    return rows, counts, p, not failures


def pairwise_checks(torch, q_roof, x_roof, q_1m, x_1m) -> dict:
    """Kernel 5 against its plain version at the roofline's shape and at
    the 1M path's ground-truth shape (1,000 queries against the 1M index's
    f32 vectors: a 4 GB output), for f32, bf16 and f16 inputs, l2 and ip.
    f32 within DIST_RTOL of ``‖q‖² + ‖x‖²``. The half types by
    ``kernels/distance.py::half_gate``: within DIST_RTOL of the terms of
    the plain version, and within the order-free bound of an f32 sum of
    exact products of the exact result (f64), the kernel and the plain
    version alike, with 0 outputs over each part. The old half-type gate
    (one bf16 ulp plus 1e-5 of the plain version's output) holds only in
    the plain version's own sum order where a dot cancels to near 0, so it
    is printed as a count (``ulp_over``), not gated. ms, plain ms, the
    bound and the library call's ms (``pairwise_library``). The bound
    follows the kernel's units: f32 inputs run the product as 3xTF32, 3 x
    2*Bq*N*D at 495 TFLOP/s; bf16 and f16 inputs as one product, 2*Bq*N*D
    at 989; or the bytes (inputs read once, the f32 output written once),
    the larger."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.distance import half_gate, pairwise_dist_cuda

    out = {}
    for where, (q0, x0) in (("roofline", (q_roof, x_roof)),
                            ("1M", (q_1m, x_1m))):
        big = x0.shape[0] >= 1_000_000
        for dt in ("float32", "bfloat16", "float16"):
            dtype = getattr(torch, dt)
            q, x = q0.to(dtype).contiguous(), x0.to(dtype).contiguous()
            qf, xf = q.float(), x.float()
            qq = (qf * qf).sum(1, keepdim=True)
            xx = (xf * xf).sum(1)[None, :]
            del qf, xf
            for metric in ("l2", "ip"):
                name = f"{where} {DIST_TAG[dt]} {metric}"
                got = pairwise_dist_cuda(q, x, metric=metric)
                want = ref.pairwise_dist(q, x, metric=metric)
                err = (got - want).abs()
                rel_ok = bool((err <= DIST_RTOL * (qq + xx)).all())
                max_err = float(err.max())
                rec = dict(max_abs_err=max_err, within_f32_rule=rel_ok,
                           library_ms=None)
                if dtype == torch.float32:
                    good = rel_ok
                else:
                    rec["ulp_over"] = int((err > bf16_tol(torch, got, want))
                                          .sum())
                    rec["gate"] = half_gate(got, q, x, metric=metric,
                                            plain=want)
                    rec["plain_gate"] = half_gate(want, q, x, metric=metric)
                    good = (rec["gate"]["over_plain"] == 0
                            and rec["gate"]["over_exact"] == 0
                            and rec["plain_gate"]["over_exact"] == 0)
                rec["ok"] = good
                del got, want, err
                timed = metric == "l2" or not big
                if timed:
                    Bq, D = q.shape
                    N = x.shape[0]
                    it = 5 if big else 20
                    rec["ms"] = time_ms(torch, lambda i: pairwise_dist_cuda(
                        q, x, metric=metric), iters=it, warmup=2)
                    rec["plain_ms"] = time_ms(
                        torch, lambda i: ref.pairwise_dist(q, x,
                                                           metric=metric),
                        iters=3 if big else 10, warmup=1)
                    lib, rec["library"] = pairwise_library(torch, q, x)
                    rec["library_ms"] = time_ms(torch, lib, iters=it,
                                                warmup=2)
                    if dtype == torch.float32:
                        flops, peak = 3 * 2.0 * Bq * N * D, PEAK_TF32_FLOPS
                    else:
                        flops, peak = 2.0 * Bq * N * D, PEAK_BF16_FLOPS
                    nbytes = (Bq + N) * D * q.element_size() + Bq * N * 4
                    rec["bound_ms"], rec["bound_by"] = bound_ms(
                        nbytes, flops, peak)
                rec["shape"] = (f"Bq={q.shape[0]} N={x.shape[0]} "
                                f"d={q.shape[1]} {dt} {metric}")
                out[name] = rec
                gate = ""
                if "gate" in rec:
                    gk, gp = rec["gate"], rec["plain_gate"]
                    gate = (f", half_gate kernel: {gk['over_plain']} over "
                            f"vs plain (worst {gk['margin_plain']:.3g}), "
                            f"{gk['over_exact']} over vs exact (worst "
                            f"{gk['margin_exact']:.3g}); plain: "
                            f"{gp['over_exact']} over vs exact (worst "
                            f"{gp['margin_exact']:.3g}); outputs over one "
                            f"bf16 ulp + 1e-5 of plain {rec['ulp_over']} "
                            "(a count, no gate)")
                print(f"kernel pairwise_dist[{name}] [{rec['shape']}]: "
                      + (f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
                         f"ms, bound {rec['bound_ms']:.4f} ms "
                         f"({rec['bound_by']}), library "
                         f"{rec['library_ms']:.4f} ms ({rec['library']}), "
                         if timed else "")
                      + f"max_abs_err {max_err:.3g}, within 1e-5 of its "
                      f"terms {rel_ok}{gate}"
                      + ("" if good else "  DISAGREES"), flush=True)
            del q, x, qq, xx
            torch.cuda.empty_cache()
    return out


def buildpath_phase(torch) -> tuple[dict, dict, bool]:
    """``bench/buildpath.py`` at its defaults on the card, every launch
    counter at 0 before and read after: ``prune_step`` over the level
    shapes (C = 80, 128, 48) x chunks 512 / 2048 / 4096 at n = 32,768,
    d = 64, m = 16 with legacy, torch and cuda, and whole builds at n =
    8,192 with each. Gates: legacy and torch identical; cuda within the
    near-tie rule step by step, and the same table or per-layer edge
    overlap >= 0.95 for the builds. Returns (record, counts, ok)."""
    from repro_torch.bench import buildpath
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    backends = buildpath.backends_for(dev)
    ops.reset_launch_counts()
    rows, step_parity = buildpath.bench_prune_step(
        32_768, 64, 16, 64, 128, (512, 2048, 4096), 8, dev, backends)
    e2e, e2e_parity, agree = buildpath.bench_build_levels(
        8192, 64, 16, 64, 128, dev, backends)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for r in rows:
        print(f"buildpath prune_step[{r['kind']} C={r['C']} "
              f"chunk={r['chunk']}]: " + ", ".join(
                  f"{b} {r[f'{b}_us']:.1f} us" for b in backends)
              + f"; legacy == torch {r['legacy_torch_identical']}, cuda "
              f"rows differing {r['cuda_rows_differ']} (near ties "
              f"{r['cuda_near_ties']})", flush=True)
    print("buildpath build_levels[n=8192]: " + ", ".join(
        f"{b} {e2e[b]['total_s']:.3f} s ({e2e[b]['nodes_per_s']:.0f} "
        f"nodes/s)" for b in backends) + f"; {json.dumps(agree)}",
          flush=True)
    if counts["prune"] == 0:
        fail("the prune kernel never launched on the buildpath path")
    ok = step_parity and e2e_parity
    if not ok:
        print("buildpath: the prune backends diverged", flush=True)
    return {"prune_step": rows, "build_levels": e2e,
            "agreement": agree}, counts, ok


def multiattr_edges(torch, fn, cfg) -> dict:
    """edge_select as a multi-attribute search launches it: ``fn(cfg)``
    run once more with ``ops.select_edges`` wrapped to record every call;
    every call's ids held against the plain version on its arguments
    (``ok``: bit-identical), and the middle call timed alone by device time
    with L2 cold beside its bound and the two-round-trip floor."""
    from repro_torch.core import storage
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.edge_select import select_edges_cuda

    calls = []
    real = ops.select_edges

    def spy(nbrs, us, L, R, **kw):
        got = real(nbrs, us, L, R, **kw)
        calls.append((nbrs, us.clone(), L, R, kw, got))
        return got

    ops.select_edges = spy
    try:
        fn(cfg)
    finally:
        ops.select_edges = real
    same = 0
    for nb, us, L, R, kw, got in calls:
        want = ref.select_edges(storage.decode_neighbors(nb), us, L, R,
                                logn=kw["logn"], m_out=kw["m_out"],
                                skip_layers=kw.get("skip_layers", True))
        same += bool(torch.equal(got, want))
    nb, us, L, R, kw, got = calls[len(calls) // 2]
    nb = storage.decode_neighbors(nb)
    args = dict(logn=kw["logn"], m_out=kw["m_out"],
                skip_layers=kw.get("skip_layers", True))

    def call(i):
        return select_edges_cuda(nb, us, L, R, **args)

    ms, how = device_ms(torch, call, "edge_select_kernel")
    bms, _, need = edge_bound(torch, nb, us, L, R, kw["logn"], got)
    out = {"calls": len(calls), "calls_identical": same,
           "ok": same == len(calls) and len(calls) > 0, "ms": ms,
           "timed_by": how, "bound_ms": bms, "edge_ids_needed": need,
           "floor_ms": edge_floor_ms(torch, nb, us),
           "active_rows": int((us >= 0).sum()),
           "shape": f"F={us.shape[0]} K={nb.shape[1] * nb.shape[2]} "
                    f"m_out={kw['m_out']}"}
    del calls
    return out


def baselines_phase(torch, index, queries, L, R, gt) -> tuple[dict, bool]:
    """The paper's comparison methods and its multi-attribute search on the
    main path's index and queries (``queries``, rank ranges ``L``/``R``,
    ground truth ``gt``), at ef = BASE_EF. Each method runs with every
    count at 0 just before it and is read just after; then again with
    every impl pinned to plain torch. Prints one line per method (recall@10
    against its ground truth, QPS, mean hops and distances, launches per
    kernel). Gates: each method's recall within 0.01 of its plain run;
    ``prefilter`` ids equal to ``brute_force``'s; every kernel of
    BASE_KERNELS launched on its method. Returns ({method: record}, ok)."""
    from repro_torch import SearchConfig, recall
    from repro_torch.core import baselines, multiattr
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    dev = index.device
    n = index.n
    B = len(queries)
    cfg = SearchConfig(ef=BASE_EF, expand_width=4)
    plain = cfg.replace(hop_impl="torch", edge_impl="torch",
                        dist_impl="torch")
    ok = True
    out = {}

    # Fig. 5's second attribute and value ranges, and their ground truth
    rng = np.random.default_rng(5)
    attr2 = rng.uniform(0, 1.0, n).astype(np.float32)
    lo2 = rng.uniform(0, 0.5, B).astype(np.float32)
    hi2 = (lo2 + 0.25).astype(np.float32)
    t0 = time.perf_counter()
    gt2, _ = multiattr.brute_force_multiattr(index, attr2, queries, L, R,
                                             lo2, hi2, k=10)
    gt2_s = time.perf_counter() - t0
    # the oracle's two ranges (Fig. 4's seed), on the first queries
    span = min(ORACLE_SPAN, n // 4)
    print(f"CUT: baselines oracle on two ranges of {span:,} items, "
          f"{ORACLE_QUERIES} queries each (Fig. 4 builds one graph per "
          f"range of n >> i items, i < 6, n = {n:,})",
          flush=True)
    orng = np.random.default_rng(4)
    o_lo = [int(orng.integers(0, n - span)) for _ in range(2)]
    oL = np.repeat(np.asarray(o_lo, np.int32), ORACLE_QUERIES)
    oR = (oL + span - 1).astype(np.int32)
    oq = queries[:2 * ORACLE_QUERIES]
    t0 = time.perf_counter()
    o_gt, _ = index.brute_force(oq, oL, oR, k=10)
    gt_s = time.perf_counter() - t0
    nb = min(BASIC_QUERIES, B)
    if nb < B:
        print(f"CUT: baselines basic_search on the first {nb} of {B} "
              "queries", flush=True)
    cache: dict = {}
    methods = {  # name -> (search(config) -> SearchResult, ground truth)
        name: (lambda c, _f=getattr(baselines, name): _f(
            index, queries, L, R, k=10, config=c), gt)
        for name in ("postfilter", "infilter", "super_postfilter")}
    methods["basic_search"] = (lambda c: baselines.basic_search(
        index, queries[:nb], L[:nb], R[:nb], k=10, config=c), gt[:nb])
    methods["oracle_search"] = (lambda c: baselines.oracle_search(
        index, oq, oL, oR, k=10, config=c, cache=cache), o_gt)
    for mode in multiattr.MODES:
        methods[f"multiattr[{mode}]"] = (
            lambda c, _m=mode: multiattr.search_multiattr(
                index, attr2, queries, L, R, lo2, hi2, k=10, mode=_m,
                seed=0, config=c), gt2)

    def timed(fn, c):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn(c)
        ids = res.ids.cpu().numpy()
        return res, ids, time.perf_counter() - t0

    for name, (fn, want) in methods.items():
        ops.reset_launch_counts()
        build_s = None
        if name == "oracle_search":  # its builds, then its search alone
            t0 = time.perf_counter()
            fn(cfg)
            torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
        res, ids, secs = timed(fn, cfg)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        _, pids, psecs = timed(fn, plain)
        r, rp = recall(ids, want), recall(pids, want)
        nq = len(ids)
        rec = dict(queries=nq, seconds=secs, qps=nq / secs, recall=r,
                   plain_recall=rp, plain_qps=nq / psecs,
                   mean_hops=float(res.n_hops.float().mean()),
                   mean_dists=float(res.n_dists.float().mean()),
                   launches=counts)
        if build_s is not None:
            rec.update(build_s=build_s, ranges=2, span=span)
        out[name] = rec
        never = [k for k in BASE_KERNELS[name] if not counts.get(k)]
        good = abs(r - rp) <= 0.01 and not never
        if name.startswith("multiattr"):
            rec["recall_equals_plain"] = r == rp
            rec["edge_select"] = multiattr_edges(torch, fn, cfg)
            good &= rec["edge_select"]["ok"]
        print(f"baselines[{name} ef={BASE_EF}]: {nq} queries in "
              f"{secs:.3f} s = {nq / secs:.1f} QPS; recall@10 {r:.4f} "
              f"(all-plain {rp:.4f}, {nq / psecs:.1f} QPS); mean hops "
              f"{rec['mean_hops']:.1f}; mean distances "
              f"{rec['mean_dists']:.1f}; launches {json.dumps(counts)}"
              + ("" if build_s is None else
                 f"; builds {build_s:.1f} s for 2 ranges of {span:,}")
              + ("" if good else "  FAILED"), flush=True)
        if "edge_select" in rec:
            e = rec["edge_select"]
            print(f"baselines[{name}] edge_select [{e['shape']}, "
                  f"{e['active_rows']} rows active in the middle call]: "
                  f"{e['calls_identical']} of {e['calls']} calls' ids "
                  f"identical to the plain version's; middle call device "
                  f"{e['ms']:.4f} ms (L2 cold, by {e['timed_by']}), bound "
                  f"{e['bound_ms']:.4f} ms, two-round-trip floor "
                  f"{e['floor_ms']:.4f} ms; recall equal to all-plain: "
                  f"{rec['recall_equals_plain']}"
                  + ("" if e["ok"] else "  DISAGREES"), flush=True)
        if never:
            print(f"baselines[{name}]: kernels never launched: {never}",
                  flush=True)
        if abs(r - rp) > 0.01:
            print(f"baselines[{name}]: recall {r:.4f} is not within 0.01 "
                  f"of the all-plain run's {rp:.4f}", flush=True)
        ok &= good

    # Pre-filtering is the exact scan: its ids are brute_force's
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pre = baselines.prefilter(index, queries, L, R, k=10)
    pids = pre.ids.cpu().numpy()
    secs = time.perf_counter() - t0
    same = bool(np.array_equal(pids, gt))
    out["prefilter"] = dict(queries=B, seconds=secs, qps=B / secs,
                            recall=recall(pids, gt), equals_brute_force=same,
                            mean_dists=float(pre.n_dists.float().mean()))
    print(f"baselines[prefilter]: {B} queries in {secs:.3f} s = "
          f"{B / secs:.1f} QPS (plain torch, one query at a time); ids equal "
          f"brute_force's: {same}; mean distances "
          f"{out['prefilter']['mean_dists']:.1f}"
          + ("" if same else "  FAILED"), flush=True)
    ok &= same
    phase_s = time.perf_counter() - t_phase
    print(f"phase[baselines]: {phase_s:.1f} s (of at most {BASE_MAX_S:.0f}; "
          f"ground truth: multi-attribute {gt2_s:.1f} s, oracle ranges "
          f"{gt_s:.1f} s)", flush=True)
    if phase_s > BASE_MAX_S:
        print(f"phase[baselines]: over its {BASE_MAX_S:.0f} s", flush=True)
    out["phase_s"] = phase_s
    return out, ok


def id_agreement(a, b) -> tuple[float, float]:
    """(share of rows with identical ids, mean share of b's ids in a)."""
    a, b = np.asarray(a), np.asarray(b)
    same = float((a == b).all(axis=1).mean())
    over = [len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
            / max(int((y >= 0).sum()), 1) for x, y in zip(a, b)]
    return same, float(np.mean(over))


def serve_slo_phase(torch, index, wl, gt) -> bool:
    """``bench/serve_slo.py``'s three legs (its ``run_leg`` and defaults:
    ``max_batch`` 32, 4 s a leg, deadline 0.25 s) through
    ``AsyncServingEngine`` on a ``SearchExecutor(ef=64, k_bucket=10)``
    warmed on this thread, over the main path's index with its 1,000 mixed
    queries as the request pool (``gt``: their exact in-range top-10, rank
    ids). Every launch count is set to 0 before each leg and read after
    it. Prints per leg capacity, offered, each outcome, p50/p99, the
    lateness of the timeouts delivered while a flush ran, and the launches
    of gather_dist and the hop. Gates: lost 0 and resolved == offered in
    every leg; no failed request outside the chaos leg; no cache entry
    after warmup; the hop launched in every leg; the flush thread on this
    thread's stream and card; the nominal leg's recall@10 within 0.01 of
    the same requests served by a ``ServingEngine`` on that executor.
    Prints the legs' whole records as one JSON line; returns whether
    every gate passed."""
    import asyncio

    from repro_torch import SearchConfig, recall
    from repro_torch.bench import serve_slo
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, SearchExecutor, ServingEngine

    t_phase = time.perf_counter()
    dev = index.device
    k = 10
    ok = True
    ex = SearchExecutor(index, SearchConfig(ef=serve_slo.EF, k_bucket=k),
                        max_batch=serve_slo.MAX_BATCH)
    warmed = ex.warmup(k_buckets=(k,))
    cap = serve_slo.measure_capacity(ex, wl, k)
    cfg = serve_slo.serve_config(cap, max_batch=serve_slo.MAX_BATCH,
                                 deadline_s=serve_slo.DEADLINE_S)

    def where():
        return (torch.cuda.current_device(),
                torch.cuda.current_stream(dev).cuda_stream)

    worker = asyncio.run(asyncio.to_thread(where))
    same_stream = worker == where()
    print(f"serve_slo: executor max_batch={ex.max_batch} ef={serve_slo.EF}, "
          f"{warmed} entries warmed on the main thread; capacity "
          f"{cap:.1f} QPS (a full batch timed by CUDA events); "
          f"{json.dumps(vars(cfg))}; flush thread (card, "
          f"stream) {worker}, main {where()}"
          + ("" if same_stream else "  DIFFER"), flush=True)
    ok &= same_stream
    gt_orig = index.original_ids(gt)
    out = {"capacity_qps": cap, "serve": vars(cfg),
           "same_stream": same_stream}
    served: list = []
    for name, (factor, seed, inject) in serve_slo.LEGS.items():
        ops.reset_launch_counts()
        leg = asyncio.run(serve_slo.run_leg(
            index, ex, wl, qps=factor * cap,
            duration_s=serve_slo.DURATION_S, serve_cfg=cfg,
            faults=serve_slo.leg_faults(inject, serve_slo.DEADLINE_S),
            k=k, seed=seed, served=served if name == "nominal" else None))
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        leg["launches"] = {kk: v for kk, v in counts.items() if v}
        bad = []
        if leg["lost"] or leg["resolved"] != leg["offered"]:
            bad.append("lost requests")
        if leg["failed"] and name in SLO_GATE_LEGS:
            bad.append("failed requests")
        if not counts["hop"]:
            bad.append("the hop never launched")
        tl = leg["timeout_late_ms"]
        print(f"serve_slo[{name}]: capacity {cap:.1f} QPS, target "
              f"{leg['target_qps']:.1f}, offered {leg['offered']}, resolved "
              f"{leg['resolved']}, lost {leg['lost']}; ok {leg['ok']}, shed "
              f"{leg['shed']}, timeout {leg['timeout']}, rejected "
              f"{leg['rejected']}, failed {leg['failed']}, shutdown "
              f"{leg['shutdown']}; achieved {leg['achieved_qps']:.1f} QPS; "
              f"p50 {leg['p50_ms']} ms, p99 {leg['p99_ms']} ms; timeouts "
              f"delivered late by p50 {tl['p50']} ms, max {tl['max']} ms "
              f"(n {tl['n']}); generator late p50 "
              f"{leg['generator_late_ms']['p50']} ms, max "
              f"{leg['generator_late_ms']['max']} ms; search a flush mean "
              f"{leg['search_ms']['mean']} ms (n {leg['search_ms']['n']}); "
              f"launches gather_dist "
              f"{counts['gather_dist']}, hop {counts['hop']}"
              + (f"; injected {json.dumps(leg['injected'])}"
                 if "injected" in leg else "")
              + ("" if not bad else f"  FAILED: {bad}"), flush=True)
        ok &= not bad
        out[name] = leg

    # the nominal leg's served requests, again through the sync engine
    pool = [i for i, _ in served]
    got = np.stack([r.ids for _, r in served])
    lo, hi = index.attrs[wl.L], index.attrs[wl.R]
    timed = serve_slo.TimedExecutor(ex)
    sync = ServingEngine(index, executor=timed, faults=False)
    for i in pool:
        sync.submit(Request(wl.queries[i], lo[i], hi[i], k=k))
    want = np.stack([r.ids for r in sync.flush()])
    sync.close()
    # a flush's search three ways: the capacity run (the pool's first 32
    # queries, nothing else running), the sync engine on the served
    # requests (no event loop), and inside the loop (GIL shared with it)
    alone_ms = serve_slo.MAX_BATCH / cap * 1e3
    sync_ms = float(np.mean(timed.search_s)) * 1e3
    print(f"serve_slo search a flush: alone {alone_ms:.1f} ms (the "
          f"capacity run); ServingEngine on the nominal leg's served "
          f"requests {sync_ms:.1f} ms ({len(timed.search_s)} batches of up "
          f"to 32); in the loop, mean " + ", ".join(
              f"{name} {out[name]['search_ms']['mean']:.1f} ms "
              f"({out[name]['search_ms']['n']} flushes)"
              for name in serve_slo.LEGS), flush=True)
    out["search_ms_alone"] = alone_ms
    out["search_ms_sync"] = sync_ms
    r_async = recall(got, gt_orig[pool])
    r_sync = recall(want, gt_orig[pool])
    same, over = id_agreement(got, want)
    post = ex.stats["compiles"] - ex.stats["warmup_compiles"]
    good = abs(r_async - r_sync) <= 0.01 and post == 0
    print(f"serve_slo[nominal] recall@10 of the {len(pool)} served requests "
          f"{r_async:.4f}, the same requests through ServingEngine on that "
          f"executor {r_sync:.4f}; ids identical in {same:.4f} of rows, mean "
          f"overlap {over:.4f}; cache entries {ex.stats['compiles']}, "
          f"{post} after warmup" + ("" if good else "  FAILED"), flush=True)
    ok &= good
    out["nominal"].update(recall=r_async, sync_recall=r_sync,
                          ids_identical=same, id_overlap=over)
    out["post_warmup_entries"] = post
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve_slo record: {json.dumps(out)}", flush=True)
    print(f"phase[serve_slo]: {out['phase_s']:.1f} s", flush=True)
    ex.close()
    return ok


def sharded_rank(rank, world, root, meta, out) -> None:
    """One rank of the sharded phase, in a process of its own (spawned):
    one torch thread, the card shared with the other ranks, gloo over a
    ``FileStore`` in ``root``, every wait bounded by a 60 s timeout. Loads
    the kernels the parent built (fails if it had to compile one), its
    shards and the queries from ``root``, then runs the legs through
    ``rfann_serve_step``: a (data 4 x model 1, f32, ef 64 and 256, ef 64
    also timed: CUDA events between barriers, 3 times), b (the same
    layout, bf16 vectors, ef 64) and c (data 2 x model 2 on new groups,
    the witness's compact shards and their decoded-f32 twins, ef 64).
    Every launch count is set to 0 before each leg's step and read after
    it. Puts one dict on ``out``: per leg the [B, k] ids and distances and
    the counts, the rank's wall clock at entry and when ready, its
    layouts, or the traceback."""
    import traceback

    res = {"rank": rank, "entered": time.time()}
    try:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # no network
        import datetime

        import torch
        import torch.distributed as dist

        from repro_torch import SearchConfig, StorageConfig
        from repro_torch.core import storage
        from repro_torch.core.distributed import (ShardLayout,
                                                  rfann_serve_step)
        from repro_torch.kernels import _build, ops

        torch.set_num_threads(1)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        built = _build.build_all()
        if built != 0.0:
            raise RuntimeError(f"rank {rank} compiled kernels for "
                               f"{built:.1f} s: the parent's were missing")
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(root, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60))
        try:
            q = torch.load(os.path.join(root, "queries.pt"),
                           map_location=dev)
            legs = {}

            def leg(name, layout, shard, qq, L, R, logn, ef, timed=False):
                cfg = SearchConfig(ef=ef, expand_width=4)

                def step():
                    return rfann_serve_step(
                        *shard, qq, L, R, layout=layout, logn=logn,
                        m=meta["m"], k=meta["k"], config=cfg)

                ops.reset_launch_counts()
                ids, dists = step()
                torch.cuda.synchronize(dev)
                rec = {"ids": ids.cpu().numpy(), "dists": dists.cpu().numpy(),
                       "launches": {kk: v for kk, v in
                                    ops.launch_counts().items() if v},
                       "layouts": {kk: v for kk, v in
                                   ops.layout_counts().items() if v}}
                if timed:
                    rec["step_ms"] = []
                    for _ in range(3):
                        dist.barrier()
                        e0 = torch.cuda.Event(enable_timing=True)
                        e1 = torch.cuda.Event(enable_timing=True)
                        e0.record()
                        step()
                        e1.record()
                        torch.cuda.synchronize(dev)
                        rec["step_ms"].append(e0.elapsed_time(e1))
                legs[name] = rec

            lay = ShardLayout(world, 1, device=dev)
            a = torch.load(os.path.join(root, f"a{lay.data_rank}.pt"),
                           map_location=dev)
            res["ready"] = time.time()
            for ef in SHARD_EFS:
                leg(f"a ef={ef}", lay, (a["vec"], a["nbr"], a["bnd"]),
                    q["q"], q["L"], q["R"], meta["logn_a"], ef,
                    timed=ef == BASE_EF)
            # the same shard's vectors re-encoded here, as the parent did
            bf16 = storage.encode_vectors(a["vec"], StorageConfig.compact())
            leg(f"b bf16 ef={BASE_EF}", lay, (bf16, a["nbr"], a["bnd"]),
                q["q"], q["L"], q["R"], meta["logn_a"], BASE_EF)
            del a, bf16
            lay_c = ShardLayout(world // 2, 2, device=dev)
            c = torch.load(os.path.join(root, f"c{lay_c.data_rank}.pt"),
                           map_location=dev)
            for name, vk, nk in (("c compact", "vec", "nbr"),
                                 ("c decoded", "twin_vec", "twin_nbr")):
                leg(name, lay_c, (c[vk], c[nk], c["bnd"]), q["wq"], q["wL"],
                    q["wR"], meta["logn_c"], BASE_EF)
            res.update(legs=legs, layouts=[repr(lay), repr(lay_c)],
                       backend=lay.backend,
                       device=f"{dev} {torch.cuda.get_device_name(dev)}")
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the phase
        res["error"] = traceback.format_exc()
    out.put(res)


def sharded_phase(torch, index, vectors, attrs, wl, L, R, gt,
                  single) -> tuple[dict, bool]:
    """Sharded RFANN serving (``core/distributed.py``) on the 1M cell:
    ``build_sharded`` into SHARDS = 4 contiguous attribute-rank shards
    (``BuildConfig(m=16, ef_construction=64, chunk=BUILD_CHUNK)``, d =
    128, no cut) with every count at 0, then SHARD_RANKS = 4 gloo ranks
    sharing the card (``sharded_rank``) run three legs through
    ``rfann_serve_step``: a, data 4 x model 1, the cell's 1,000 mixed
    queries at ef 64 and 256; b, the same shards with bf16 vectors; c, a
    ragged int16 witness (``vector_dataset(65,535, 128)`` over 2 shards
    of 32,768 and 32,767 rows, ``StorageConfig.compact()`` and its
    decoded-f32 twin, 64 queries) at data 2 x model 2. ``single``: the
    single index's build seconds, fused recall@10 at ef 64 and 256 and
    fused QPS. Gates: every rank's [B, k] equals, bit for bit, the
    mesh-free path in this process (``shard_topk`` per shard, then
    ``merge_topk``); leg a's recall at ef 64 within 0.01 of the mesh-free
    search all-plain; at ef 256 at least the single index's minus 0.05;
    every id inside its query's range and the witness's padded row never
    returned; the compact ids equal the decoded twin's; the shards' rows
    equal the index's (same ranks); the build launched the prune and
    gather_dist, and every rank gather_dist and the hop on every leg, the
    bf16 body on legs b and c compact. Returns the phase's record and
    whether every gate passed."""
    import multiprocessing
    import queue
    import shutil

    from repro_torch import BuildConfig, SearchConfig, StorageConfig, recall
    from repro_torch.core import storage
    from repro_torch.core.distributed import (ShardedRangeIndex,
                                              build_sharded, merge_topk,
                                              shard_topk)
    from repro_torch.data import vector_dataset
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    dev = index.device
    k = 10
    ok = True
    cfg_b = BuildConfig(m=16, ef_construction=64, chunk=BUILD_CHUNK)
    ops.reset_launch_counts()
    per_shard = []
    t0 = time.perf_counter()
    sh = build_sharded(vectors, attrs, SHARDS, cfg_b, shard_seconds=per_shard)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    build_counts = ops.launch_counts()
    bounds = sh.bounds.tolist()
    same_rows = all(torch.equal(sh.vectors[s, :hi - lo + 1],
                                index.vectors[lo:hi + 1])
                    for s, (lo, hi) in enumerate(bounds))
    good = (same_rows and build_counts["prune"] > 0
            and build_counts["gather_dist"] > 0)
    shard_bytes = sh.nbytes // SHARDS
    print(f"sharded build: n={index.n} S={SHARDS} d={index.dim} m=16 efc=64 "
          f"chunk={BUILD_CHUNK}: {build_s:.1f} s (per shard "
          f"{', '.join(f'{x:.1f}' for x in per_shard)} s; the single index "
          f"{single['build_s']:.1f} s); bounds {bounds}; launches prune="
          f"{build_counts['prune']} gather_dist={build_counts['gather_dist']}"
          f"; nbytes {shard_bytes} a shard, {sh.nbytes} in all; the shards' "
          f"rows are the index's ranks: {same_rows}"
          + ("" if good else "  FAILED"), flush=True)
    ok &= good
    sh_b = ShardedRangeIndex(
        storage.encode_vectors(sh.vectors, StorageConfig.compact()),
        sh.neighbors, sh.bounds, sh.logn, sh.m)

    # the ragged int16 witness and its decoded-f32 twin
    wn = SHARD_WITNESS_N
    wv, wattrs, wq = vector_dataset(wn, index.dim, seed=0, n_clusters=64,
                                    queries=SHARD_WITNESS_QUERIES)
    wc = build_sharded(wv, wattrs[:, 0], 2, cfg_b, StorageConfig.compact())
    twin = ShardedRangeIndex(wc.vectors.float(),
                             storage.decode_neighbors(wc.neighbors),
                             wc.bounds, wc.logn, wc.m)
    rng = np.random.default_rng(2)
    wL = rng.integers(0, wn // 2, SHARD_WITNESS_QUERIES).astype(np.int32)
    wR = (wL + rng.integers(64, wn // 2, SHARD_WITNESS_QUERIES)).clip(
        max=wn - 1).astype(np.int32)
    wlo, whi = wc.bounds[1].tolist()
    per = -(-wn // 2)
    good = (wc.vectors.dtype == torch.bfloat16
            and wc.neighbors.dtype == torch.int16 and wc.bounds.tolist()
            == [[0, per - 1], [per, wn - 1]])
    print(f"sharded witness: n={wn} S=2 compact: vectors {wc.vectors.dtype},"
          f" neighbors {wc.neighbors.dtype}, bounds {wc.bounds.tolist()} "
          f"(shard 1 padded by {wc.vectors.shape[1] - (whi - wlo + 1)} row); "
          f"{SHARD_WITNESS_QUERIES} queries, of which "
          f"{int((wR < wlo).sum())} miss shard 1 (empty clip)"
          + ("" if good else "  FAILED"), flush=True)
    ok &= good

    # the mesh-free path on the card, in this process
    q = torch.as_tensor(wl.queries, device=dev, dtype=torch.float32)
    Lt = torch.as_tensor(L, device=dev, dtype=torch.int32)
    Rt = torch.as_tensor(R, device=dev, dtype=torch.int32)
    wqt = torch.as_tensor(wq, device=dev, dtype=torch.float32)
    wLt = torch.as_tensor(wL, device=dev)
    wRt = torch.as_tensor(wR, device=dev)

    def mesh_free(shd, qq, Lq, Rq, cfg):
        outs = [shard_topk(*shd.shard(s, dev), qq, Lq, Rq, logn=shd.logn,
                           m=shd.m, k=k, config=cfg)
                for s in range(shd.n_shards)]
        i, d = merge_topk(torch.stack([o[0] for o in outs]),
                          torch.stack([o[1] for o in outs]), k)
        return i.cpu().numpy(), d.cpu().numpy()

    cfg = SearchConfig(ef=BASE_EF, expand_width=4)
    want = {f"a ef={ef}": mesh_free(sh, q, Lt, Rt, cfg.replace(ef=ef))
            for ef in SHARD_EFS}
    want[f"b bf16 ef={BASE_EF}"] = mesh_free(sh_b, q, Lt, Rt, cfg)
    want["c compact"] = mesh_free(wc, wqt, wLt, wRt, cfg)
    want["c decoded"] = mesh_free(twin, wqt, wLt, wRt, cfg)
    plain_ids, _ = mesh_free(sh, q, Lt, Rt, cfg.replace(
        hop_impl="torch", edge_impl="torch", dist_impl="torch"))

    # the ranks' inputs, in the checkout's build directory
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "sharded")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.save({"q": q.cpu(), "L": Lt.cpu(), "R": Rt.cpu(), "wq": wqt.cpu(),
                "wL": wLt.cpu(), "wR": wRt.cpu()},
               os.path.join(root, "queries.pt"))
    for s in range(SHARDS):
        torch.save({"vec": sh.vectors[s].cpu(), "nbr": sh.neighbors[s].cpu(),
                    "bnd": sh.bounds[s].cpu()}, os.path.join(root, f"a{s}.pt"))
    for s in range(2):
        torch.save({"vec": wc.vectors[s].cpu(), "nbr": wc.neighbors[s].cpu(),
                    "twin_vec": twin.vectors[s].cpu(),
                    "twin_nbr": twin.neighbors[s].cpu(),
                    "bnd": wc.bounds[s].cpu()}, os.path.join(root, f"c{s}.pt"))
    meta = {"m": sh.m, "k": k, "logn_a": sh.logn, "logn_c": wc.logn}
    del sh_b, twin, wc
    save_s = time.perf_counter() - t0

    # the ranks: spawned (this process holds a CUDA context), the kernels
    # already built here
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    t_spawn = time.time()
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, SHARD_RANKS, root, meta, out))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    ranks = {}
    deadline = time.time() + SHARD_RANK_TIMEOUT_S
    try:
        for _ in procs:
            r = out.get(timeout=max(1.0, deadline - time.time()))
            ranks[r["rank"]] = r
    except queue.Empty:
        print(f"sharded: ranks {sorted(set(range(SHARD_RANKS)) - set(ranks))}"
              f" gave no answer within {SHARD_RANK_TIMEOUT_S:.0f} s  FAILED",
              flush=True)
        ok = False
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    shutil.rmtree(root, ignore_errors=True)
    for r, res in sorted(ranks.items()):
        if "error" in res:
            print(f"sharded rank {r} FAILED:\n{res['error']}", flush=True)
            ok = False
    ranks = {r: res for r, res in ranks.items() if "error" not in res}
    if len(ranks) != SHARD_RANKS:
        return {"ranks_answered": len(ranks)}, False
    r0 = ranks[0]
    print(f"sharded ranks: inputs written in {save_s:.1f} s; backend "
          f"{r0['backend']}, "
          + "; ".join(f"rank {r}: {res['device']}, {res['layouts']}, ready "
                      f"{res['ready'] - t_spawn:.1f} s after spawn (entered "
                      f"{res['entered'] - t_spawn:.1f} s)"
                      for r, res in sorted(ranks.items())), flush=True)

    # gates: each leg on every rank against the mesh-free path
    ranges = {"a": (L, R), "b": (L, R), "c": (wL, wR)}
    rec = {"build_s": build_s, "build_shard_s": per_shard,
           "single_build_s": single["build_s"],
           "build_launches": {kk: v for kk, v in build_counts.items() if v},
           "nbytes": sh.nbytes, "nbytes_shard": shard_bytes,
           "backend": r0["backend"], "layouts": r0["layouts"],
           "startup_s": [ranks[r]["ready"] - t_spawn for r in sorted(ranks)],
           "inputs_written_s": save_s,
           "legs": {}}
    for name, (wi, wd) in want.items():
        lo_r, hi_r = ranges[name[0]]
        same = all(np.array_equal(res["legs"][name]["ids"], wi)
                   and np.array_equal(res["legs"][name]["dists"], wd)
                   for res in ranks.values())
        in_range = all(((row[row >= 0] >= a) & (row[row >= 0] <= b)).all()
                       for row, a, b in zip(wi, lo_r, hi_r))
        body = "bf16" if name.startswith(("b", "c compact")) else "f32"
        counts = [res["legs"][name]["launches"] for _, res in
                  sorted(ranks.items())]
        layouts = [res["legs"][name]["layouts"] for _, res in
                   sorted(ranks.items())]
        launched = all(c.get("gather_dist", 0) > 0 and c.get("hop", 0) > 0
                       for c in counts)
        body_ok = all(lay.get(f"hop[{body}]", 0) > 0 for lay in layouts)
        leg = {"same_as_mesh_free": same, "in_range": in_range,
               "max_id": int(wi.max()), "launches": counts,
               "layouts": layouts}
        good = same and in_range and launched and body_ok
        if name.startswith("c"):
            good &= int(wi.max()) <= wn - 1
        else:
            leg["recall"] = recall(wi, gt)
        extra = ""
        if name == f"a ef={BASE_EF}":
            leg["plain_recall"] = recall(plain_ids, gt)
            ms = float(np.median(r0["legs"][name]["step_ms"]))
            leg.update(step_ms=r0["legs"][name]["step_ms"],
                       qps=len(wi) / ms * 1e3)
            good &= abs(leg["recall"] - leg["plain_recall"]) <= 0.01
            extra = (f"; all-plain mesh-free recall@10 "
                     f"{leg['plain_recall']:.4f}; the single index "
                     f"{single['recall'][BASE_EF]:.4f}; step median "
                     f"{ms:.2f} ms of {r0['legs'][name]['step_ms']} on rank "
                     f"0 = {leg['qps']:.1f} QPS (the single index's "
                     f"search[fused] {single['qps']:.1f} QPS)")
        if name == f"a ef={QUALITY_EF}":
            floor = single["recall"][QUALITY_EF] - 0.05
            good &= leg["recall"] >= floor
            extra = (f"; the single index {single['recall'][QUALITY_EF]:.4f}"
                     f" (floor {floor:.4f})")
        if name == "c compact":
            leg["equals_decoded"] = bool(np.array_equal(
                wi, want["c decoded"][0]))
            good &= leg["equals_decoded"]
            extra = f"; ids equal the decoded twin's: {leg['equals_decoded']}"
        print(f"sharded[{name}]: {len(wi)} queries, every rank's [B, k] "
              f"equals the mesh-free path: {same}; ids in range: {in_range}"
              f"; max id {leg['max_id']}"
              + (f"; recall@10 {leg['recall']:.4f}" if "recall" in leg
                 else "") + extra
              + f"; launches per rank (gather_dist, hop, hop[{body}]) "
              + ", ".join(f"({c.get('gather_dist', 0)}, {c.get('hop', 0)}, "
                          f"{lay.get(f'hop[{body}]', 0)})"
                          for c, lay in zip(counts, layouts))
              + ("" if good else "  FAILED"), flush=True)
        ok &= good
        rec["legs"][name] = leg
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"sharded record: {json.dumps(rec)}", flush=True)
    print(f"phase[sharded]: {rec['phase_s']:.1f} s (of at most "
          f"{SHARD_MAX_S:.0f})", flush=True)
    if rec["phase_s"] > SHARD_MAX_S:
        print(f"phase[sharded]: over its {SHARD_MAX_S:.0f} s", flush=True)
    return rec, ok


class knob_env:
    """Set RTORCH_* knobs in this process for a block, restoring them
    after (read through the registry, ``core/knobs.py``)."""

    def __init__(self, env: dict):
        self.env = env

    def __enter__(self):
        from repro_torch.core import knobs

        self.old = {k: knobs.raw(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# knobs[...] legs: (name, env, the ids they must equal, the launch check)
KNOB_LEGS = (
    ("RTORCH_IMPL=torch", {"RTORCH_IMPL": "torch"}, "plain",
     lambda c: not any(c.values())),
    ("RTORCH_IMPL=cuda", {"RTORCH_IMPL": "cuda"}, "fused",
     lambda c: c["hop"] == 0 and c["select_edges"] > 0
     and c["gather_dist"] > 0),
    ("RTORCH_HOP_IMPL=composed", {"RTORCH_HOP_IMPL": "composed"}, "fused",
     lambda c: c["hop"] == 0 and c["select_edges"] > 0
     and c["gather_dist"] > 0),
    # the edge knob moves the composed hop's edge selection; the fused
    # kernel has no per-op backend (as repro's megakernel)
    ("RTORCH_HOP_IMPL=composed RTORCH_EDGE_IMPL=argsort",
     {"RTORCH_HOP_IMPL": "composed", "RTORCH_EDGE_IMPL": "argsort"},
     "fused", lambda c: c["hop"] == 0 and c["select_edges"] == 0
     and c["gather_dist"] > 0),
    ("RTORCH_EDGE_IMPL=argsort", {"RTORCH_EDGE_IMPL": "argsort"}, "fused",
     lambda c: c["hop"] > 0 and c["select_edges"] == 0),
)


def knobs_phase(torch, index, wl, lo_val, hi_val, fused_ids,
                plain_ids) -> bool:
    """Each dispatch and storage knob set in this process in turn, on the
    1M index's 1,000 mixed queries at ef 64 with every impl "auto": the
    launch counts and ids each leg must show (KNOB_LEGS); the prune knob
    and the storage knob on builds of KNOB_BUILD_N; then, every knob unset
    again, the counts and ids of the fused path."""
    from repro_torch import BuildConfig, RangeGraphIndex, SearchConfig
    from repro_torch.data import vector_dataset
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    cfg = SearchConfig(ef=BASE_EF, expand_width=4)

    def search():
        ops.reset_launch_counts()
        res = index.search(wl.queries, lo_val, hi_val, k=10, config=cfg)
        ids = res.ids.cpu().numpy()
        return ids, ops.launch_counts()

    base_ids, base = search()
    ok = np.array_equal(base_ids, fused_ids)
    print(f"knobs[none set]: launches {json.dumps(base)}; ids "
          f"{'equal' if ok else 'DIFFER from'} the fused search's",
          flush=True)
    want = {"fused": fused_ids, "plain": plain_ids}
    for name, env, ref_name, check in KNOB_LEGS:
        with knob_env(env):
            ids, counts = search()
        same = np.array_equal(ids, want[ref_name])
        good = same and check(counts)
        print(f"knobs[{name}]: launches {json.dumps(counts)}; ids "
              f"{'equal' if same else 'DIFFER from'} the {ref_name} "
              "search's" + ("" if good else "  FAILED"), flush=True)
        ok &= good
    vectors, attrs, _ = vector_dataset(KNOB_BUILD_N, 128, seed=0,
                                       n_clusters=64, attr_kind="uniform")
    bcfg = BuildConfig(m=16, ef_construction=64, chunk=BUILD_CHUNK)
    ops.reset_launch_counts()
    plain_prune = RangeGraphIndex.build(vectors, attrs[:, 0], bcfg,
                                        prune_impl="torch")
    with knob_env({"RTORCH_PRUNE_IMPL": "legacy"}):
        ops.reset_launch_counts()
        legacy = RangeGraphIndex.build(vectors, attrs[:, 0], bcfg)
        counts = ops.launch_counts()
    same = torch.equal(legacy.neighbors, plain_prune.neighbors)
    good = same and counts["prune"] == 0 and counts["gather_dist"] > 0
    print(f"knobs[RTORCH_PRUNE_IMPL=legacy, build n={KNOB_BUILD_N}]: "
          f"launches {json.dumps(counts)}; table "
          f"{'equals' if same else 'DIFFERS from'} the build with the "
          "plain prune" + ("" if good else "  FAILED"), flush=True)
    ok &= good
    with knob_env({"RTORCH_STORAGE": "compact"}):
        compact = RangeGraphIndex.build(vectors, attrs[:, 0], bcfg)
    dtypes = (compact.vectors.dtype, compact.neighbors.dtype)
    good = dtypes == (torch.bfloat16, torch.int16)
    print(f"knobs[RTORCH_STORAGE=compact, build n={KNOB_BUILD_N}]: tables "
          f"{dtypes[0]} / {dtypes[1]}" + ("" if good else "  FAILED"),
          flush=True)
    ok &= good
    del plain_prune, legacy, compact
    ids, counts = search()
    good = np.array_equal(ids, fused_ids) and counts == base
    print(f"knobs[none set, after]: launches {json.dumps(counts)}; "
          f"{'the fused path' if good else 'NOT the fused path'}",
          flush=True)
    ok &= good
    print(f"phase[knobs]: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return bool(ok)


def oracles_phase(torch, index, wl, L, R) -> bool:
    """The seed engine (``core/search_ref.py``) on ORACLE_QUERIES_REF of the
    1M queries against ``beam_search(expand_width=1)`` on the card: ids
    identical to the fused hop's, everything identical to the all-plain
    path's; and Algorithm 1 literally (``select_edges_reference``) and the
    argsort formulation against the edge kernel on the frontier's
    shapes."""
    from repro_torch import SearchConfig
    from repro_torch.core import edge_select, search_ref
    from repro_torch.core.search import range_entry_ids
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_select import select_edges_cuda

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    B, n, m = ORACLE_QUERIES_REF, index.n, index.m
    q = torch.as_tensor(wl.queries[:B], device=dev)
    Lt = torch.as_tensor(L[:B], device=dev, dtype=torch.int32)
    Rt = torch.as_tensor(R[:B], device=dev, dtype=torch.int32)
    ent = range_entry_ids(Lt, Rt.clamp_max(n - 1), n)
    ent = torch.where((ent >= Lt[:, None]) & (ent <= Rt[:, None]), ent, -1)

    def nbr_fn(u):
        return edge_select.select_edges_batch(index.neighbors, u, Lt, Rt,
                                              logn=index.logn, m_out=m)

    t0 = time.perf_counter()
    want = search_ref.beam_search_reference(index.vectors, q, ent, nbr_fn,
                                            ef=BASE_EF, k=10)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    fused = index.search_ranks(q, Lt, Rt, k=10, config=SearchConfig(
        ef=BASE_EF, expand_width=1, hop_impl="cuda"))
    hops = ops.launch_counts()["hop"]
    plain = index.search_ranks(q, Lt, Rt, k=10, config=SearchConfig(
        ef=BASE_EF, expand_width=1, edge_impl="torch", dist_impl="torch"))
    fused_same = torch.equal(fused.ids, want.ids) and \
        torch.equal(fused.n_hops, want.n_hops)
    plain_same = all(torch.equal(a, b) for a, b in zip(plain, want))
    fin = torch.isfinite(want.dists)
    err = float((fused.dists - want.dists)[fin].abs().max()) \
        if bool(fin.any()) else 0.0
    good = fused_same and plain_same and hops > 0
    print(f"oracles[beam_search_reference, {B} queries, ef={BASE_EF}, "
          f"{ref_s:.1f} s]: W=1 fused hop ({hops} launches) ids and hops "
          f"{'identical' if fused_same else 'DIFFER'} (distances max |diff| "
          f"{err:.3g}); W=1 all-plain "
          f"{'identical, distances too' if plain_same else 'DIFFERS'}"
          + ("" if good else "  FAILED"), flush=True)
    ok = good
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    fr = frontier(torch, index, wl.queries, L, R, 4, gen)
    us, Lw, Rw = fr["us"], fr["Lw"], fr["Rw"]
    kernel = select_edges_cuda(index.neighbors, us, Lw, Rw, logn=index.logn,
                               m_out=m)
    argsort = edge_select.select_edges_batch(index.neighbors, us, Lw, Rw,
                                             logn=index.logn, m_out=m)
    rows = index.neighbors[us.long()].cpu()
    u_h, L_h, R_h, k_h = (t.cpu().tolist() for t in (us, Lw, Rw, kernel))
    literal = sum(
        edge_select.select_edges_reference(
            rows[f], u_h[f], L_h[f], R_h[f], logn=index.logn, m_out=m)
        != [x for x in k_h[f] if x >= 0] for f in range(len(u_h)))
    good = torch.equal(kernel, argsort) and literal == 0
    print(f"oracles[edge_select, F={len(u_h)}]: argsort "
          f"{'identical' if torch.equal(kernel, argsort) else 'DIFFERS'}; "
          f"Algorithm 1 differs on {literal} rows"
          + ("" if good else "  FAILED"), flush=True)
    ok &= good
    print(f"phase[oracles]: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return bool(ok)


# the kernels line's entries and the autotune records they take
AUTOTUNE_OF = {"gather_dist": "gather_dist", "gather_dist[int8]":
               "gather_dist_codec", "select_edges": "edge_select",
               "hop": "hop", "prune": "prune"}


def hotpath_phase(torch) -> tuple[dict, bool]:
    """``bench/hotpath.py --smoke`` on the card: the steps at smoke shapes
    (composed and fused hops asserted identical), and the autotune section
    at the full probe shapes (``kernels/autotune.py::PROBES``), every
    candidate held against its default plan's outputs: a refused one
    fails the phase. Returns the autotune records by kind."""
    from repro_torch.bench import hotpath

    t_phase = time.perf_counter()
    payload = hotpath.main(["--smoke", "--out", os.path.join(
        ROOT, "build", "BENCH_torch_hotpath_smoke.json")])
    records = payload["autotune"]["records"]
    ok = payload["hop_fused"]["outputs_identical"]
    for kind, recs in records.items():
        for r in recs:
            good = not r["refused"] and len(r["candidates"]) >= 1
            ok &= good
            print(f"hotpath[autotune {kind}, {r['probe']}]: pick "
                  f"{json.dumps(r['best'])} {r['best_ms']:.4f} ms; default "
                  f"{json.dumps(r['default'])} {r['default_ms']:.4f} ms; "
                  "candidates " + json.dumps(
                      [[c["params"], round(c["ms"], 4)]
                       for c in r["candidates"]])
                  + f"; refused {json.dumps(r['refused'])}"
                  + ("" if good else "  FAILED"), flush=True)
    for key in ("expansion_step", "edge_select_step", "hop_fused"):
        print(f"hotpath[{key}]: {json.dumps(payload[key])}", flush=True)
    print(f"phase[hotpath]: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return records, bool(ok)


# The benchmark gate and the port's contract checks on the card (R3, R4 of
# tests/test_torch_contracts.py; GATE_MAX_S for the three together)
GATE_MAX_S = 120.0
SYNC_QUERIES = 64
# syncs of a search outside beam_search's loop, by file and function: each
# a host-to-device copy of the caller's inputs before the loop starts
SYNC_NAMED = {
    ("core/index.py", "_on_device"): (3, "the queries, L and R to the card"),
    ("core/search.py", "range_entry_ids"): (1, "the entry fractions to the "
                                              "card"),
}


def gate_phase(torch) -> bool:
    """``bench/buildpath.py --smoke`` and ``bench/serve_slo.py --smoke``
    into ``build/``, beside ``hotpath_phase``'s smoke record, then
    ``bench/ci_gate.py`` on the three against the committed
    ``artifacts/BENCH_torch_*.json``; every line of the gate printed.
    Fails when a bench fails or the gate exits 1 (a shape or correctness
    error; timing drift only warns)."""
    import io

    from repro_torch.bench import buildpath, ci_gate, serve_slo

    out_dir = os.path.join(ROOT, "build")
    rc_build = buildpath.main(["--smoke", "--out", os.path.join(
        out_dir, "BENCH_torch_build_smoke.json")])
    rc_slo = serve_slo.main(["--smoke", "--out-dir", out_dir])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ci_gate.main(["--smoke-dir", out_dir])
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"gate: {line}", flush=True)
    warn = sum(line.startswith("::warning::") for line in lines)
    err = sum(line.startswith("::error::") for line in lines)
    print(f"gate: buildpath --smoke exit {rc_build}, serve_slo --smoke exit "
          f"{rc_slo}, ci_gate exit {rc}: {err} errors, {warn} timing "
          "warnings", flush=True)
    return rc == 0 and rc_build == 0 and rc_slo == 0


def _functions_of(path) -> list:
    """``(first line, last line, qualified name)`` of every function in
    ``path``, innermost last."""
    import ast

    out = []

    def walk(node, prefix):
        for n in ast.iter_child_nodes(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{n.name}"
                out.append((n.lineno, n.end_lineno, name))
                walk(n, name + ".")
            else:
                walk(n, prefix)

    with open(path) as f:
        walk(ast.parse(f.read()), "")
    return out


def sync_phase(torch, index, wl, lo_val, hi_val) -> bool:
    """R3 on the card: one fused and one composed ``index.search`` of
    SYNC_QUERIES of the 1M workload's queries under
    ``torch.cuda.set_sync_debug_mode("warn")``, every warning recorded
    with the line that made it. The count must be the loop's checks (the
    ``while`` test of ``beam_search``: one per ITER_BLOCK iterations run
    and one that ends the loop, unless ``max_iters`` ends it) plus
    SYNC_NAMED, each at its site; a sync inside ``body`` fails."""
    import ast
    import warnings

    from repro_torch import SearchConfig
    from repro_torch.core import search as search_mod
    from repro_torch.kernels import ops

    src = os.path.join(ROOT, "src", "repro_torch")
    spath = os.path.join(src, "core", "search.py")
    funcs = {}

    def where(path, line):
        rel = os.path.relpath(path, src).replace(os.sep, "/")
        if rel not in funcs:
            funcs[rel] = _functions_of(path) if os.path.exists(path) else []
        inner = [f for f in funcs[rel] if f[0] <= line <= f[1]]
        return rel, (inner[-1][2] if inner else "<module>")

    spans = {name: (a, b) for a, b, name in _functions_of(spath)}
    body = spans["beam_search.body"]
    with open(spath) as f:
        tree = ast.parse(f.read())
    loop = next(n.lineno for n in ast.walk(tree) if isinstance(n, ast.While)
                and spans["beam_search"][0] <= n.lineno
                <= spans["beam_search"][1])
    q, lo, hi = (wl.queries[:SYNC_QUERIES], lo_val[:SYNC_QUERIES],
                 hi_val[:SYNC_QUERIES])
    ok = True
    for name, kernel in (("fused", "hop"), ("composed", "select_edges")):
        cfg = SearchConfig(ef=64, expand_width=4, hop_impl=(
            "cuda" if name == "fused" else "composed"))
        index.search(q, lo, hi, k=10, config=cfg)  # warm
        torch.cuda.synchronize()
        before = ops.launch_counts()[kernel]
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                index.search(q, lo, hi, k=10, config=cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        iters = ops.launch_counts()[kernel] - before  # one a body call
        max_iters = 4 * cfg.ef + 32
        blocks = -(-iters // search_mod.ITER_BLOCK)
        want_loop = blocks + (1 if iters < max_iters else 0)
        sites: dict = {}
        for w in rec:
            if "synchronizing CUDA operation" not in str(w.message):
                continue
            key = (*where(w.filename, w.lineno), w.lineno)
            sites[key] = sites.get(key, 0) + 1
        in_body = sum(c for (rel, _, line), c in sites.items()
                      if rel == "core/search.py"
                      and body[0] <= line <= body[1])
        at_loop = sites.get(("core/search.py", "beam_search", loop), 0)
        named = {k: 0 for k in SYNC_NAMED}
        other = []
        for (rel, fn, line), c in sites.items():
            if (rel, fn) in named:
                named[rel, fn] += c
            elif not (rel == "core/search.py" and line == loop):
                other.append(f"{rel}:{line} ({fn}) x{c}")
        good = (in_body == 0 and at_loop == want_loop and not other
                and all(named[k] == SYNC_NAMED[k][0] for k in named))
        ok &= good
        total = sum(sites.values())
        print(f"contracts[sync, {name}]: {SYNC_QUERIES} queries, {iters} "
              f"iterations in {blocks} blocks of {search_mod.ITER_BLOCK}: "
              f"{total} syncs = {at_loop} loop checks at core/search.py:"
              f"{loop} (beam_search's while test; want {want_loop}) + "
              + " + ".join(
                  f"{named[k]} in {k[0]}::{k[1]} (want {n}: {why})"
                  for k, (n, why) in SYNC_NAMED.items())
              + f"; inside body (core/search.py:{body[0]}-{body[1]}) "
              f"{in_body}; unnamed {other}; sites "
              + json.dumps([f"{rel}:{line} {fn} x{c}" for (rel, fn, line), c
                            in sorted(sites.items())])
              + ("" if good else "  FAILED"), flush=True)
    return bool(ok)


def smem_phase() -> bool:
    """R4 on the card: every launch plan's shared memory from its Python
    mirror against the C formula its library exports
    (``kernels/smem_budget.py::c_mismatches``), over every autotune
    candidate at every probe and production shape and both flash bodies
    and pairwise_dist; and no plan over the card's block limit."""
    from repro_torch.kernels import smem_budget

    n, bad = smem_budget.c_mismatches()
    over = smem_budget.findings()
    kinds: dict = {}
    for e in smem_budget.entries():
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    largest = max(e["bytes"] for e in smem_budget.entries())
    print(f"contracts[smem]: {n} plans, C size function against the Python "
          f"mirror: {len(bad)} differ; by kind {json.dumps(kinds)}; largest "
          f"{largest} B of {smem_budget.LIMIT}; findings {json.dumps(over)}"
          + ("" if not bad else f"; differing {json.dumps(bad[:8])}")
          + ("" if not (bad or over) else "  FAILED"), flush=True)
    return not bad and not over


# The lm decode phase: prefill and greedy decode with KV and state caches
# (models/, train/step.py). Leg A serves gemma2-9b at full width and depth
# (params f32, compute bf16, seeded weights): DEC_B prompts of DEC_PROMPT
# tokens, so the 4,096 window bites in the local layers, then DEC_STEPS
# greedy steps. Leg B runs every other config at full width, its depth
# cut to one repeating unit (FAM_CUT), at FAM_B x FAM_PROMPT.
DEC_ARCH = "gemma2-9b"
DEC_B, DEC_PROMPT, DEC_STEPS = 4, 4608, 32
FAM_B, FAM_PROMPT, FAM_STEPS = 2, 512, 8
FAM_FRAMES = 512          # seamless: seeded random encoder frames
FAM_CUT = {               # config -> the fields its one-unit cut replaces
    "qwen3-0.6b": {"n_layers": 1},
    "phi3-mini-3.8b": {"n_layers": 1},
    "granite-20b": {"n_layers": 1},
    "chameleon-34b": {"n_layers": 1},
    "granite-moe-1b-a400m": {"n_layers": 1},
    "phi3.5-moe-42b-a6.6b": {"n_layers": 1},
    "xlstm-125m": {"n_layers": 4, "slstm_layers": (3,)},
    "zamba2-1.2b": {"n_layers": 7},  # one group of 6 + shared attn + tail
    "seamless-m4t-large-v2": {"n_layers": 1, "enc_layers": 1},
}
# kernel prefill vs all-plain prefill, decode vs the forward pass: least
# row cosine of the logits (both bf16 paths, rounded after other ops)
DEC_MIN_COSINE = 0.999
# MoE capacity for the decode-vs-forward gate only: at B = 2 a decode
# step's C is int(2k/e * 1.25) + 1 = 1 and drops tokens the forward keeps
DEC_GATE_CAPACITY = 8.0
DEC_MAX_S = 180.0         # what the phase may add to the smoke


def row_cosine(torch, a, b) -> float:
    """The least cosine between matching rows of two [R, V] logits."""
    return float(torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=-1).min())


@contextlib.contextmanager
def cross_launch_count(torch):
    """Counts, in the yielded one-element list, the flash launches made
    inside ``models/attention.py::attention`` calls given ``kv`` (the
    encoder-decoder's cross-attention), read off the kernel's own count
    before and after each call."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod

    inner, n = attn_mod.attention, [0]

    def attention(*args, kv=None, **kw):
        before = ops.launch_counts()["flash_attention"]
        out = inner(*args, kv=kv, **kw)
        if kv is not None:
            n[0] += ops.launch_counts()["flash_attention"] - before
        return out

    attn_mod.attention = attention
    try:
        yield n
    finally:
        attn_mod.attention = inner


def attention_applications(cfg) -> int:
    """Flash launches of one full-sequence pass of ``cfg``: its attention
    layers (zamba2: one per group; the encoder-decoder: encoder layers,
    and self plus cross attention per decoder layer)."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    if cfg.layer_pattern == "xlstm":
        return 0
    if cfg.layer_pattern == "hybrid_shared_attn":
        return cfg.n_layers // cfg.shared_attn_period
    return cfg.n_layers


def decode_leg_a(torch, dev, cfg) -> tuple[dict, bool]:
    """gemma2-9b served: all-plain prefill of prompt 0 (gate 2's
    reference), then with every count at 0 the kernel prefill of DEC_B
    prompts, the caches grown to DEC_PROMPT + DEC_STEPS, one
    teacher-forced step (gate 3) and DEC_STEPS greedy steps; then the
    forward pass over prompt 0's DEC_PROMPT + 1 tokens."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import Model, count_params
    from repro_torch.sharding.partitioning import leaves
    from repro_torch.train.step import build_decode_step, \
        build_prefill_step, greedy

    model = Model(cfg)
    plain = Model(dataclasses.replace(cfg, attention_impl="torch"))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.as_tensor(np.random.default_rng(23).integers(
        0, cfg.vocab, (DEC_B, DEC_PROMPT + 1)), device=dev)
    prefill = build_prefill_step(model)
    decode = build_decode_step(model)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ref_logits, _ = build_prefill_step(plain)(
        params, {"tokens": toks[:1, :DEC_PROMPT]})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_flash = ops.launch_counts()["flash_attention"]

    # the served path, every count at 0
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": toks[:, :DEC_PROMPT]})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_counts = ops.launch_counts()
    bodies = {k: v for k, v in ops.body_counts().items()
              if k.startswith("flash_attention")}
    cache = model.grow_cache(caches, DEC_PROMPT + DEC_STEPS)
    del caches
    tf_logits, _ = model.decode(params, toks[:, DEC_PROMPT:], cache,
                                DEC_PROMPT)
    tok = greedy(cfg, logits)
    out, step_ms = [tok], []
    for t in range(DEC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = decode(params, tok, cache, DEC_PROMPT + t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    # one more step at the last position (its row is rewritten) under the
    # profiler: where a step's device time goes
    profile_search(torch, lambda: decode(params, tok, cache,
                                         DEC_PROMPT + DEC_STEPS - 1),
                   f"decode step of {cfg.name}, B={DEC_B}")
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in leaves(cache))
    del cache
    generated = torch.cat(out, dim=1)

    # gate 3's reference: the forward pass over prompt 0's 4,609 tokens
    hidden, _, _ = transformer.forward_seq(params, cfg,
                                           toks[:1, :DEC_PROMPT + 1])
    fwd = transformer.compute_logits(params, cfg, hidden[:, -1])
    cos_plain = row_cosine(torch, logits[:1], ref_logits)
    cos_decode = row_cosine(torch, tf_logits[:1, 0], fwd)
    decode_s = sum(step_ms) / 1e3
    rec = {
        "B": DEC_B, "prompt": DEC_PROMPT, "steps": DEC_STEPS,
        "params": count_params(cfg),
        "init_s": round(init_s, 3),
        "prefill_s": round(prefill_s, 4),
        "prefill_tokens_per_s": round(DEC_B * DEC_PROMPT / prefill_s, 1),
        "plain_prefill_s_B1": round(plain_s, 4),
        "decode_ms_per_step": round(decode_s * 1e3 / DEC_STEPS, 3),
        "decode_ms_first_step": round(step_ms[0], 3),
        "decode_ms_median_step": round(float(np.median(step_ms)), 3),
        "decode_tokens_per_s": round(DEC_B * DEC_STEPS / decode_s, 1),
        # a step must read every f32 weight and the cache once
        "decode_bound_ms": round(bound_ms(
            4 * count_params(cfg) + cache_bytes, 0, PEAK_BF16_FLOPS)[0], 3),
        "peak_device_memory_gib": round(peak / 2**30, 2),
        "flash_launches_prefill": prefill_counts["flash_attention"],
        "flash_launches": counts["flash_attention"],
        "flash_bodies": bodies,
        "plain_prefill_flash_launches": plain_flash,
        "min_cosine_kernel_vs_plain_prefill": cos_plain,
        "min_cosine_decode_vs_forward": cos_decode,
        "logits_finite": bool(torch.isfinite(logits).all()
                              and torch.isfinite(tf_logits).all()),
        "tokens_in_range": bool(((generated >= 0)
                                 & (generated < cfg.vocab)).all()),
        "generated_prompt0": generated[0, :8].tolist(),
    }
    want = cfg.n_layers
    ok = True
    if counts["flash_attention"] != want or \
            bodies["flash_attention[wgmma]"] != want or plain_flash:
        print(f"lm decode[{cfg.name}]: flash launches {json.dumps(bodies)} "
              f"on the path ({counts['flash_attention']} in all), plain "
              f"prefill {plain_flash}; expected {want} (one per layer), "
              "all on the wgmma body, and 0 on the plain prefill",
              flush=True)
        ok = False
    if cos_plain < DEC_MIN_COSINE or cos_decode < DEC_MIN_COSINE or \
            not rec["logits_finite"] or not rec["tokens_in_range"]:
        print(f"lm decode[{cfg.name}]: cosine kernel vs plain prefill "
              f"{cos_plain:.6f}, decode vs forward {cos_decode:.6f} (gate "
              f"{DEC_MIN_COSINE}), finite {rec['logits_finite']}, tokens in "
              f"[0, vocab) {rec['tokens_in_range']}", flush=True)
        ok = False
    return rec, ok


def decode_leg_b(torch, dev, cfg) -> tuple[dict, bool]:
    """One config at full width, depth cut: with every count at 0 the
    kernel prefill of FAM_B prompts, FAM_STEPS greedy steps and
    ``Model.embed``; then the all-plain prefill, and FAM_STEPS
    teacher-forced steps against the forward pass's logits (MoE at
    DEC_GATE_CAPACITY)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, transformer
    from repro_torch.models.api import Model, count_params
    from repro_torch.train.step import build_decode_step, \
        build_prefill_step, greedy

    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    rng = np.random.default_rng(29)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab, (FAM_B, FAM_PROMPT + FAM_STEPS)), device=dev)
    inputs = {"tokens": toks[:, :FAM_PROMPT]}
    if model.is_encdec:
        inputs["frames"] = torch.as_tensor(rng.standard_normal(
            (FAM_B, FAM_FRAMES, cfg.d_model)), dtype=torch.float32,
            device=dev)
    decode = build_decode_step(model)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cross_launch_count(torch) as cross:
        logits, caches = build_prefill_step(model)(params, inputs)
        torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_flash = ops.launch_counts()["flash_attention"]
    cache = model.grow_cache(caches, FAM_PROMPT + FAM_STEPS)
    del caches
    tok = greedy(cfg, logits)
    out = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(FAM_STEPS):
        tok, cache = decode(params, tok, cache, FAM_PROMPT + t)
        out.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / FAM_STEPS
    del cache
    emb = None if model.is_encdec else model.embed(params,
                                                   inputs["tokens"])
    counts = ops.launch_counts()
    bodies = {k: v for k, v in ops.body_counts().items()
              if k.startswith("flash_attention")}
    generated = torch.cat(out, dim=1)
    enc_flash = None
    if model.is_encdec:
        ops.reset_launch_counts()
        encdec.encode(params, cfg, inputs["frames"])
        enc_flash = ops.launch_counts()["flash_attention"]

    plain = Model(dataclasses.replace(cfg, attention_impl="torch"))
    ref_logits, _ = plain.prefill(params, **inputs)
    gate = Model(dataclasses.replace(cfg, moe_capacity_factor=(
        DEC_GATE_CAPACITY if cfg.n_experts else cfg.moe_capacity_factor)))
    _, caches = gate.prefill(params, **inputs)
    cache = gate.grow_cache(caches, FAM_PROMPT + FAM_STEPS)
    del caches
    tf = [gate.decode(params, toks[:, FAM_PROMPT + t:FAM_PROMPT + t + 1],
                      cache, FAM_PROMPT + t)[0][:, 0]
          for t in range(FAM_STEPS)]
    del cache
    if model.is_encdec:
        enc = encdec.encode(params, gate.cfg, inputs["frames"])
        hidden, _ = encdec.decode_seq(params, gate.cfg, toks, enc)
    else:
        hidden, _, _ = transformer.forward_seq(params, gate.cfg, toks)
    fwd = transformer.compute_logits(params, cfg, hidden[:, FAM_PROMPT:])
    cos_plain = row_cosine(torch, logits, ref_logits)
    cos_decode = row_cosine(torch, torch.stack(tf, 1).flatten(0, 1),
                            fwd.flatten(0, 1))
    want = attention_applications(cfg) * (1 if model.is_encdec else 2)
    rec = {
        "params_cut": count_params(cfg),
        "params_full": count_params(get_arch(cfg.name)),
        "prefill_ms": round(prefill_ms, 3),
        "decode_ms_per_step": round(decode_ms, 3),
        "flash_launches": counts["flash_attention"],
        "flash_launches_prefill": prefill_flash,
        "flash_bodies": bodies,
        "min_cosine_kernel_vs_plain_prefill": cos_plain,
        "min_cosine_decode_vs_forward": cos_decode,
        "tokens_in_range": bool(((generated >= 0)
                                 & (generated < cfg.vocab)).all()),
    }
    if enc_flash is not None:
        rec["flash_launches_encoder"] = enc_flash
        rec["flash_launches_cross"] = cross[0]
        rec["flash_launches_decoder_self"] = prefill_flash - enc_flash \
            - cross[0]
    else:
        rec["embed_finite"] = bool(torch.isfinite(emb).all())
        rec["embed_shape"] = list(emb.shape)
    ok = True
    if counts["flash_attention"] != want or \
            bodies["flash_attention[wgmma]"] != want:
        print(f"lm families[{cfg.name}]: flash launches "
              f"{json.dumps(bodies)}, expected {want}, all on the wgmma "
              "body", flush=True)
        ok = False
    bad_embed = emb is not None and (not rec["embed_finite"] or
                                     tuple(emb.shape) != (FAM_B, cfg.d_model))
    if cos_plain < DEC_MIN_COSINE or cos_decode < DEC_MIN_COSINE or \
            not rec["tokens_in_range"] or bad_embed or \
            not bool(torch.isfinite(logits).all()):
        print(f"lm families[{cfg.name}]: cosine kernel vs plain prefill "
              f"{cos_plain:.6f}, decode vs forward {cos_decode:.6f} (gate "
              f"{DEC_MIN_COSINE}), tokens in range {rec['tokens_in_range']}"
              f", embeddings {rec.get('embed_shape')} finite "
              f"{rec.get('embed_finite')}", flush=True)
        ok = False
    return rec, ok


def lm_decode_phase(torch, dev) -> tuple[dict, bool]:
    """Legs A and B of the lm decode phase, each config's counts at 0
    before its served path. Frees the memory the other phases left
    first."""
    import dataclasses
    import gc

    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"lm decode: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          "held by the earlier phases", flush=True)
    out, ok = {}, True
    cfg = get_arch(DEC_ARCH)
    rec, good = decode_leg_a(torch, dev, cfg)
    print(f"lm decode[{cfg.name}, {cfg.n_layers} layers, d={cfg.d_model}, "
          f"params {cfg.param_dtype}, compute {cfg.compute_dtype}, "
          f"B={DEC_B}, prompt={DEC_PROMPT}, {DEC_STEPS} greedy steps]: "
          f"{json.dumps(rec)}" + ("" if good else "  FAILED"), flush=True)
    out[cfg.name] = rec
    ok &= good
    gc.collect()
    torch.cuda.empty_cache()
    for name, cut in FAM_CUT.items():
        cfg = dataclasses.replace(get_arch(name), **cut)
        print(f"CUT: lm families[{name}] depth {json.dumps(cut)} (full: "
              f"{get_arch(name).n_layers} layers"
              + (f", {get_arch(name).enc_layers} encoder layers"
                 if cfg.family == "encdec" else "") + ")", flush=True)
        rec, good = decode_leg_b(torch, dev, cfg)
        print(f"lm families[{name}, d={cfg.d_model}, B={FAM_B}, "
              f"prompt={FAM_PROMPT}, {FAM_STEPS} steps]: {json.dumps(rec)}"
              + ("" if good else "  FAILED"), flush=True)
        out[name] = rec
        ok &= good
        gc.collect()
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"phase[lm decode]: {phase_s:.1f} s (budget {DEC_MAX_S:.0f} s)",
          flush=True)
    if phase_s > DEC_MAX_S:
        print(f"phase[lm decode]: over its {DEC_MAX_S:.0f} s", flush=True)
        ok = False
    return out, ok


# -- the train phase: the training half of the LM stack --------------------
# Leg A trains qwen3-0.6b at full width and depth (28 layers, params f32,
# compute bf16, remat "full", attention plain torch with autograd, as
# repro trains with "xla": the flash kernel has no backward) through
# runtime/trainer.py, then serves the trained weights through the flash
# kernel. Leg B takes two steps of every other config, and of gemma2-9b,
# at full width and one repeating unit of depth (FAM_CUT).
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 16, 1024, 12
TRAIN_CKPT_EVERY, TRAIN_REPLAY_FROM = 4, 8
TRAIN_CKPT_LEVEL = 0      # zlib stored blocks in one pass: random f32
                          # weights hardly compress
TRAIN_MIN_GRAD_COSINE = 0.99  # first step's gradient, bf16 vs f32 compute
TRAIN_REPLAY_RTOL = 1e-3  # replayed losses: GPU atomics reorder sums
TRAIN_MB_RTOL = 1e-3      # loss at microbatches 2 vs 1, same state
TRAIN_EMBED_N, TRAIN_EMBED_SEQ = 256, 32
TRAIN_FAM_B, TRAIN_FAM_S, TRAIN_FAM_STEPS = 2, 512, 2
TRAIN_FAM_CUT = {**FAM_CUT, DEC_ARCH: {"n_layers": 2}}  # + one local/global
TRAIN_MAX_S = 150.0       # what the phase may add to the smoke


def _leaves_of(tree):
    from repro_torch.sharding.partitioning import leaves
    return list(leaves(tree))


def grad_report(torch, grads) -> dict:
    """Leaves whose gradient is None or has a non-finite value."""
    missing = ["/".join(p) for p, g in _leaves_of(grads) if g is None]
    bad = ["/".join(p) for p, g in _leaves_of(grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    return {"leaves": len(_leaves_of(grads)), "none": missing,
            "non_finite": bad}


def flat_cosine(torch, a, b) -> float:
    """Cosine of two gradient trees flattened into one vector each (f64
    sums leaf by leaf)."""
    dot = na = nb = 0.0
    for (_, x), (_, y) in zip(_leaves_of(a), _leaves_of(b)):
        x, y = x.double(), y.double()
        dot += float((x * y).sum())
        na += float((x * x).sum())
        nb += float((y * y).sum())
    return dot / math.sqrt(na * nb)


def train_leg_a(torch, dev) -> tuple[dict, bool]:
    """qwen3-0.6b trained at full width and depth: the first step's
    gradient gates, then with every count at 0 TRAIN_STEPS steps of
    ``run_train_loop`` on one batch with a checkpoint every
    TRAIN_CKPT_EVERY steps; the checkpoint of step TRAIN_REPLAY_FROM
    restored and replayed; one step at microbatches 2 and one with int8
    compression; then the trained weights embed through the flash
    kernel, counts at 0 again."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.api import Model, count_params
    from repro_torch.runtime.trainer import TrainLoopConfig, run_train_loop
    from repro_torch.train import compression
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import build_train_step, loss_and_grads

    served = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(served, attention_impl="torch")
    if (cfg.remat, cfg.param_dtype, cfg.compute_dtype) != (
            "full", "float32", "bfloat16"):
        fail(f"lm train: {cfg.name} is not remat full, f32 params, bf16 "
             "compute")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    batch = TokenPipeline(cfg.vocab, batch=TRAIN_B, seq=TRAIN_S,
                          seed=0).next_batch(device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    n_params = count_params(cfg)

    # the first step's gradient: every leaf, and bf16 against f32 compute
    t0 = time.perf_counter()
    _, _, grads = loss_and_grads(model, params, batch)
    report = grad_report(torch, grads)
    f32 = Model(dataclasses.replace(cfg, compute_dtype="float32"))
    _, _, grads32 = loss_and_grads(f32, params, batch)
    cosine = flat_cosine(torch, grads, grads32)
    del grads, grads32
    torch.cuda.synchronize()
    grad_gate_s = time.perf_counter() - t0

    # the main path, every count at 0: the fault-tolerant loop
    step = build_train_step(model, opt_cfg)
    snap, step_s, gnorms, logs = {}, [], [], []

    def step_fn(state, b):
        t0 = time.perf_counter()
        p, o, m = step(*state, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
        if int(o.step) == TRAIN_REPLAY_FROM:   # what its checkpoint holds
            snap["leaves"] = [t.detach().clone()
                              for t in ckpt.tree_flatten((p, o))]
        return (p, o), m

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    loop_cfg = TrainLoopConfig(
        total_steps=TRAIN_STEPS, ckpt_dir=tmp.name,
        ckpt_every=TRAIN_CKPT_EVERY, keep=2, max_restarts=0, log_every=1)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with knob_env({"RTORCH_COMPRESS_LEVEL": str(TRAIN_CKPT_LEVEL)}):
        (params, opt), hist = run_train_loop(
            step_fn, (params, init_opt_state(params)), lambda s: batch,
            loop_cfg, log=logs.append)
    loop_s = time.perf_counter() - t0
    train_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    ckpt_bytes = os.path.getsize(os.path.join(
        tmp.name, f"step_{TRAIN_STEPS}.ckpt"))

    # the checkpoint of step 8 into fresh tensors, then steps 9-12 again
    t0 = time.perf_counter()
    (rp, ro), at, _ = ckpt.restore(tmp.name, (params, opt),
                                   step=TRAIN_REPLAY_FROM)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored = ckpt.tree_flatten((rp, ro))
    bit_identical = at == TRAIN_REPLAY_FROM and len(restored) == len(
        snap["leaves"]) and all(
        a.dtype == b.dtype and torch.equal(a.detach(), b)
        for a, b in zip(restored, snap["leaves"]))
    fresh = all(a.data_ptr() != b.data_ptr() for a, b in zip(
        restored, ckpt.tree_flatten((params, opt))))
    del snap, restored, params, opt
    tmp.cleanup()
    replay = []
    for _ in range(TRAIN_STEPS - TRAIN_REPLAY_FROM):
        rp, ro, m = step(rp, ro, batch)
        replay.append(float(m["loss"]))
    replay_err = max(abs(a - b) / abs(b) for a, b in
                     zip(replay, hist["loss"][TRAIN_REPLAY_FROM:]))

    # one step at microbatches 2 against the loss at 1 on the same state
    with torch.no_grad():
        loss_mb1 = float(model.loss(rp, batch)[0])
    rp, ro, m = build_train_step(model, opt_cfg, microbatches=2)(
        rp, ro, batch)
    loss_mb2 = float(m["loss"])
    err = compression.init_error_state(rp)
    rp, ro, m, err = build_train_step(model, opt_cfg, compress=True)(
        rp, ro, batch, err)
    compressed = {k: float(v) for k, v in m.items()}
    del err
    # where a training step's device time goes (no update: loss + grads)
    gc_collect(torch)
    profile_search(torch, lambda: loss_and_grads(model, rp, batch),
                   f"train loss+grads of {cfg.name}, B={TRAIN_B}, "
                   f"S={TRAIN_S}", share_of=("gemm", "elementwise",
                                             "reduce", "softmax"))

    # the trained weights serve: embed through the flash kernel
    toks = np.random.default_rng(31).integers(
        0, cfg.vocab, (TRAIN_EMBED_N, TRAIN_EMBED_SEQ))
    ops.reset_launch_counts()
    emb = Model(served).embed(rp, toks)
    torch.cuda.synchronize()
    embed_counts = ops.launch_counts()
    bodies = {k: v for k, v in ops.body_counts().items()
              if k.startswith("flash_attention")}
    emb_plain = model.embed(rp, toks)
    emb_cos = row_cosine(torch, emb, emb_plain)

    # the kernel refuses a graph it cannot differentiate
    q = rp["embed"]["table"][:64].to(torch.bfloat16).reshape(1, 1, 64, -1)
    try:
        flash_attention_cuda(q[..., :128], q[..., :128], q[..., :128])
        guard = False
    except RuntimeError as e:
        guard = "no backward" in str(e)

    med = float(np.median(step_s[1:]))
    tokens = TRAIN_B * TRAIN_S
    rec = {
        "B": TRAIN_B, "S": TRAIN_S, "steps": TRAIN_STEPS,
        "params": n_params, "init_s": round(init_s, 3),
        "s_per_step_median_2_12": round(med, 4),
        "s_first_step": round(step_s[0], 4),
        "tokens_per_s": round(tokens / med, 1),
        "model_flop_share": round(6 * n_params * tokens / med
                                  / PEAK_BF16_FLOPS, 4),
        "peak_device_memory_gib": round(peak / 2**30, 2),
        "loss": [round(x, 5) for x in hist["loss"]],
        "grad_norm": [round(x, 5) for x in gnorms],
        "restarts": hist["restarts"],
        "straggler_events": hist["straggler_events"],
        "loop_s": round(loop_s, 2),
        "checkpoint_s_3_saves": round(loop_s - sum(step_s), 2),
        "checkpoint_bytes": ckpt_bytes,
        "restore_s": round(restore_s, 2),
        "restored_bit_identical": bit_identical,
        "restored_into_fresh_tensors": fresh,
        "replayed_loss_9_12": [round(x, 5) for x in replay],
        "replay_max_rel_err": replay_err,
        "grad_leaves": report["leaves"],
        "grad_none": report["none"], "grad_non_finite": report["non_finite"],
        "grad_cosine_bf16_vs_f32": cosine,
        "grad_gate_s": round(grad_gate_s, 2),
        "loss_microbatches_1": loss_mb1, "loss_microbatches_2": loss_mb2,
        "compressed_step": compressed,
        "flash_launches_training": train_counts["flash_attention"],
        "embed_flash_launches": embed_counts["flash_attention"],
        "embed_flash_bodies": bodies,
        "embed_min_cosine_vs_plain": emb_cos,
        "flash_refuses_autograd": guard,
    }
    checks = {
        "losses finite": all(math.isfinite(x) for x in hist["loss"]),
        f"loss at step {TRAIN_STEPS} < 0.9 x step 1":
            hist["loss"][-1] < 0.9 * hist["loss"][0],
        "no restart": hist["restarts"] == 0
            and len(hist["loss"]) == TRAIN_STEPS,
        "every gradient leaf finite, none None":
            not report["none"] and not report["non_finite"],
        "grad_norm > 0": min(gnorms) > 0,
        f"gradient cosine >= {TRAIN_MIN_GRAD_COSINE}":
            cosine >= TRAIN_MIN_GRAD_COSINE,
        "restored bit-identical into fresh tensors": bit_identical and fresh,
        f"replay within {TRAIN_REPLAY_RTOL} relative":
            replay_err <= TRAIN_REPLAY_RTOL,
        f"microbatches 2 within {TRAIN_MB_RTOL} relative":
            abs(loss_mb2 - loss_mb1) <= TRAIN_MB_RTOL * abs(loss_mb1),
        "compressed step finite": all(math.isfinite(v)
                                      for v in compressed.values()),
        "training launched no flash kernel":
            train_counts["flash_attention"] == 0,
        f"embed: {cfg.n_layers} flash launches, all wgmma":
            embed_counts["flash_attention"] == cfg.n_layers
            and bodies["flash_attention[wgmma]"] == cfg.n_layers,
        f"embed cosine >= {LM_MIN_COSINE}": emb_cos >= LM_MIN_COSINE
            and bool(torch.isfinite(emb).all()),
        "flash refuses autograd": guard,
    }
    failed = [k for k, good in checks.items() if not good]
    if failed:
        print(f"lm train[{cfg.name}]: failed {failed}", flush=True)
    for line in logs:
        print(f"lm train[{cfg.name}] {line}", flush=True)
    return rec, not failed


def gc_collect(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def train_leg_b(torch, dev, cfg) -> tuple[dict, bool]:
    """One config at full width, depth cut, trained: every gradient leaf
    of the first step, then TRAIN_FAM_STEPS steps timed."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.api import Model, count_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import build_train_step, loss_and_grads

    cfg = dataclasses.replace(cfg, attention_impl="torch")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    batch = TokenPipeline(cfg.vocab, batch=TRAIN_FAM_B, seq=TRAIN_FAM_S,
                          seed=0, encdec_dim=cfg.d_model
                          if model.is_encdec else 0).next_batch(device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    loss, metrics, grads = loss_and_grads(model, params, batch)
    report = grad_report(torch, grads)
    del grads
    step = build_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=1,
                                               total_steps=10))
    opt = init_opt_state(params)
    ms, losses = [], []
    for _ in range(TRAIN_FAM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    rec = {
        "params_cut": count_params(cfg),
        "params_full": count_params(get_arch(cfg.name)),
        "ms_per_step": [round(x, 3) for x in ms],
        "loss": losses, "aux": float(metrics["aux"]),
        "grad_norm": float(m["grad_norm"]),
        "peak_device_memory_gib": round(
            torch.cuda.max_memory_allocated(dev) / 2**30, 2),
        "grad_leaves": report["leaves"], "grad_none": report["none"],
        "grad_non_finite": report["non_finite"],
        "flash_launches": ops.launch_counts()["flash_attention"],
    }
    ok = (all(math.isfinite(x) for x in losses) and math.isfinite(
        float(loss)) and not report["none"] and not report["non_finite"]
        and rec["grad_norm"] > 0 and (rec["aux"] > 0 or not cfg.n_experts)
        and rec["flash_launches"] == 0)
    return rec, ok


def train_phase(torch, dev) -> tuple[dict, bool]:
    """Legs A and B of the train phase, each config's counts at 0 before
    its path. Frees what the earlier phases held first."""
    import dataclasses

    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    gc_collect(torch)
    print(f"lm train: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          "held by the earlier phases", flush=True)
    out = {}
    cfg = get_arch(TRAIN_ARCH)
    rec, ok = train_leg_a(torch, dev)
    print(f"lm train[{cfg.name}, {cfg.n_layers} layers, d={cfg.d_model}, "
          f"params {cfg.param_dtype}, compute {cfg.compute_dtype}, remat "
          f"{cfg.remat}, attention torch, B={TRAIN_B}, S={TRAIN_S}, "
          f"{TRAIN_STEPS} steps]: {json.dumps(rec)}"
          + ("" if ok else "  FAILED"), flush=True)
    out[cfg.name] = rec
    gc_collect(torch)
    for name, cut in TRAIN_FAM_CUT.items():
        cfg = dataclasses.replace(get_arch(name), **cut)
        print(f"CUT: lm train families[{name}] depth {json.dumps(cut)} "
              f"(full: {get_arch(name).n_layers} layers"
              + (f", {get_arch(name).enc_layers} encoder layers"
                 if cfg.family == "encdec" else "") + ")", flush=True)
        rec, good = train_leg_b(torch, dev, cfg)
        print(f"lm train families[{name}, d={cfg.d_model}, B={TRAIN_FAM_B}"
              f", S={TRAIN_FAM_S}, {TRAIN_FAM_STEPS} steps]: "
              f"{json.dumps(rec)}" + ("" if good else "  FAILED"),
              flush=True)
        out[f"families {name}"] = rec
        ok &= good
        gc_collect(torch)
    phase_s = time.perf_counter() - t_phase
    print(f"phase[lm train]: {phase_s:.1f} s (budget {TRAIN_MAX_S:.0f} s)",
          flush=True)
    if phase_s > TRAIN_MAX_S:
        print(f"phase[lm train]: over its {TRAIN_MAX_S:.0f} s", flush=True)
        ok = False
    return out, ok


def run(args):
    import torch

    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: run "
             "it from the root of a checkout")
    sys.path.insert(0, src)
    from repro_torch.core import knobs

    forced = {k.name: knobs.raw(k.name) for k in knobs.REGISTRY
              if k.section in ("dispatch", "storage")
              and knobs.raw(k.name) is not None}
    if forced:
        fail(f"dispatch or storage knobs are set in the environment "
             f"({forced}): the main path would not run what it names")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import BuildConfig, RangeGraphIndex, SearchConfig, recall
    from repro_torch.bench.common import card_line
    from repro_torch.core import storage
    from repro_torch.core.search import range_entry_ids
    from repro_torch.data import make_workload, vector_dataset
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.edge_select import select_edges_cuda

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.empty(1, device=dev)  # create the context before any query
    line = card_line()
    if line is None:
        fail("nvidia-smi gave no card name and power limit")
    print(line, flush=True)  # the card's name and power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- set-up: the kernels, built from the checkout's sources ------------
    t0 = time.perf_counter()
    build_s = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"setup: kernels built in {build_s:.1f} s "
          f"(loaded in {time.perf_counter() - t0:.1f} s)", flush=True)
    print(_build.ptxas_report(), flush=True)

    # -- data ---------------------------------------------------------------
    n, d = args.n, 128
    if n < 1_000_000:
        print(f"CUT: n = {n} (full size is 1,000,000)", flush=True)
    t0 = time.perf_counter()
    vectors, attrs, q_in, labels = vector_dataset(
        n, d, seed=0, n_clusters=64, attr_kind="uniform", queries=1000,
        labels=True)
    print(f"setup: data n={n} d={d} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- the main path, with every launch counter at 0 ----------------------
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    levels = []
    index = RangeGraphIndex.build(
        vectors, attrs[:, 0],
        BuildConfig(m=16, ef_construction=64, chunk=BUILD_CHUNK),
        level_times=levels)
    torch.cuda.synchronize(dev)
    build_seconds = time.perf_counter() - t0
    after_build = ops.launch_counts()
    print(f"build: n={n} layers={index.logn + 1} m=16 efc=64 "
          f"chunk={BUILD_CHUNK}: {build_seconds:.1f} s; launches "
          f"prune={after_build['prune']} (by regime "
          f"{json.dumps(prune_regimes())}) "
          f"gather_dist={after_build['gather_dist']}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    print("build levels (layer, kind, seconds): " + json.dumps(
        [[lv["layer"], lv["kind"], round(lv["seconds"], 3)]
         for lv in levels]), flush=True)

    wl = make_workload(index, "mixed", n_queries=1000, seed=1)
    lo_val, hi_val = index.attrs[wl.L], index.attrs[wl.R]
    L, R = index.ranks_of(lo_val, hi_val)
    cfg = SearchConfig(ef=64, expand_width=4)
    wide = cfg.replace(ef=QUALITY_EF)
    runs = {  # name -> config; "plain" pins every op to plain torch
        "fused": cfg.replace(hop_impl="cuda"),
        "composed": cfg.replace(hop_impl="composed"),
        f"fused ef={QUALITY_EF}": wide.replace(hop_impl="cuda"),
    }
    plain_runs = {
        "fused": cfg.replace(hop_impl="torch", edge_impl="torch",
                             dist_impl="torch"),
        f"fused ef={QUALITY_EF}": wide.replace(
            hop_impl="torch", edge_impl="torch", dist_impl="torch"),
    }

    def timed_search(c):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = index.search(wl.queries, lo_val, hi_val, k=10, config=c)
        ids = res.ids.cpu().numpy()
        return res, ids, time.perf_counter() - t0

    index.search(wl.queries[:8], lo_val[:8], hi_val[:8], k=10,
                 config=runs["fused"])  # warm-up
    before_search = ops.launch_counts()
    searches = {name: timed_search(c) for name, c in runs.items()}
    counts = ops.launch_counts()
    search_counts = {k: counts[k] - before_search[k] for k in counts}
    never = [k for k in MAIN_KERNELS if counts[k] == 0]
    if never:
        fail(f"kernels never launched on the main path: {never}")

    # -- are the answers right? --------------------------------------------
    t0 = time.perf_counter()
    gt, _ = index.brute_force(wl.queries, L, R, k=10)
    gt_s = time.perf_counter() - t0
    ok = True
    if not np.array_equal(searches["fused"][1], searches["composed"][1]):
        print("search: fused and composed ids DIFFER", flush=True)
        ok = False
    for name, (res, ids, secs) in searches.items():
        r = recall(ids, gt)
        print(f"search[{name}]: {len(ids)} queries in {secs:.3f} s = "
              f"{len(ids) / secs:.1f} QPS; recall@10 {r:.4f}; mean hops "
              f"{float(res.n_hops.float().mean()):.1f}; mean distances "
              f"{float(res.n_dists.float().mean()):.1f}", flush=True)
    plain_ids = {}
    for name, c in plain_runs.items():
        _, ids, secs = timed_search(c)
        plain_ids[name] = ids
        r_plain = recall(ids, gt)
        r = recall(searches[name][1], gt)
        print(f"search[{name}, plain torch on the card]: recall@10 "
              f"{r_plain:.4f}, {len(ids) / secs:.1f} QPS", flush=True)
        if abs(r - r_plain) > 0.01:
            print(f"search[{name}]: recall {r:.4f} is not within 0.01 of "
                  f"the plain search's {r_plain:.4f}", flush=True)
            ok = False
    r_wide = recall(searches[f"fused ef={QUALITY_EF}"][1], gt)
    if r_wide < MIN_RECALL:
        print(f"search: recall@10 {r_wide:.4f} at ef={QUALITY_EF} is below "
              f"{MIN_RECALL}", flush=True)
        ok = False
    print(f"search: ground truth (plain torch on the card) in {gt_s:.1f} s",
          flush=True)
    print(f"search launches: {json.dumps(search_counts)}; main path "
          f"launches: {json.dumps(counts)}", flush=True)
    # where the recall goes: by range fraction 2^-i
    frac = np.rint(np.log2(n / (R - L + 1))).astype(int)
    for name in ("fused", f"fused ef={QUALITY_EF}"):
        ids = searches[name][1]
        by_frac = {int(i): round(recall(ids[frac == i], gt[frac == i]), 4)
                   for i in np.unique(frac)}
        print(f"search[{name}] recall@10 by range fraction 2^-i: "
              f"{json.dumps(by_frac)}", flush=True)
    # why wide ranges lose recall: do edges join clusters, do entry points
    # decide it, and is it the workload's queries, which make_workload
    # draws around other centres than the data's?
    lab_np = labels[index.perm]                    # cluster of rank i
    lab = torch.as_tensor(lab_np, device=dev)
    print("diagnosis: cross-cluster edge share by layer "
          f"{json.dumps(cross_cluster_share(torch, index, lab))}", flush=True)
    print("diagnosis[fused, ef=64, workload queries]: " + json.dumps(
        recall_by_entry(torch, index, lab_np, L, R, gt, searches["fused"][1],
                        frac)), flush=True)
    ids_in = index.search_ranks(q_in, L, R, k=10,
                                config=runs["fused"]).ids.cpu().numpy()
    gt_in, _ = index.brute_force(q_in, L, R, k=10)
    r_in = recall(ids_in, gt_in)
    print(f"diagnosis[fused, ef=64, queries around the data's centres]: "
          f"recall@10 {r_in:.4f}; " + json.dumps(
              recall_by_entry(torch, index, lab_np, L, R, gt_in, ids_in,
                              frac)), flush=True)
    if r_in < MIN_RECALL:
        print(f"search: recall@10 {r_in:.4f} at ef=64 for queries around "
              f"the data's centres is below {MIN_RECALL}", flush=True)
        ok = False

    profile_search(torch, lambda: index.search(
        wl.queries, lo_val, hi_val, k=10, config=runs["fused"]))

    # -- the knob registry, each knob set in turn; then the oracles ----------
    t_new = time.perf_counter()
    ok &= knobs_phase(torch, index, wl, lo_val, hi_val,
                      searches["fused"][1], plain_ids["fused"])
    ok &= oracles_phase(torch, index, wl, L, R)
    new_phases_s = time.perf_counter() - t_new

    # -- the paper's baselines and the multi-attribute search ---------------
    base_recs, good = baselines_phase(torch, index, wl.queries, L, R, gt)
    ok &= good

    # -- the async serving loop under Poisson load: bench/serve_slo.py ------
    ok &= serve_slo_phase(torch, index, wl, gt)

    # -- sharded serving: core/distributed.py over 4 gloo ranks -------------
    shard_rec, good = sharded_phase(
        torch, index, vectors, attrs[:, 0], wl, L, R, gt, single={
            "build_s": build_seconds,
            "recall": {BASE_EF: recall(searches["fused"][1], gt),
                       QUALITY_EF: recall(
                           searches[f"fused ef={QUALITY_EF}"][1], gt)},
            "qps": len(wl.queries) / searches["fused"][2]})
    ok &= good

    # -- every kernel against its plain version, at main-path shapes --------
    records = {}
    table = index.vectors
    nbrs = index.neighbors
    logn = index.logn
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fr = frontier(torch, index, wl.queries, L, R, 4, gen)
    q, us, Lw, Rw, m_out = fr["q"], fr["us"], fr["Lw"], fr["Rw"], index.m

    # edge_select at F = B*W
    F = us.shape[0]
    got = select_edges_cuda(nbrs, us, Lw, Rw, logn=logn, m_out=m_out)
    want = ref.select_edges(nbrs, us, Lw, Rw, logn=logn, m_out=m_out)
    err = int((got - want).abs().max())
    def select(i):
        return select_edges_cuda(nbrs, us, Lw, Rw, logn=logn, m_out=m_out)

    dms, how = device_ms(torch, select, "edge_select_kernel")
    hus = host_us(torch, select)
    kms = time_ms(torch, select)
    pms = time_ms(torch, lambda i: ref.select_edges(
        nbrs, us, Lw, Rw, logn=logn, m_out=m_out), iters=5)
    bms, by, need = edge_bound(torch, nbrs, us, Lw, Rw, logn, want)
    records["select_edges"] = dict(
        ok=err == 0, max_abs_err=float(err), ms=dms, timed_by=how,
        event_ms=kms, host_us=hus, plain_ms=pms, bound_ms=bms, bound_by=by,
        floor_ms=edge_floor_ms(torch, nbrs, us), edge_ids_needed=need,
        shape=f"F={F} K={nbrs.shape[1] * nbrs.shape[2]} m_out={m_out}")

    # gather_dist at [B, W*m_out] ids (the hop's edges), and the fused hop
    # at B queries x W frontier rows
    ids, hop_args, hop_need = fr["ids"], fr["hop_args"], fr["hop_need"]
    records.update(table_kernels(torch, "f32", table, nbrs, q, ids,
                                 hop_args, hop_need))
    # gather_dist where the build launches it: one chunk of the lowest
    # search level (rows from device memory) and of the highest (rows in
    # L2), and at the search's entries (M = 3); then one whole low level
    # of the build under the profiler
    t_phase = time.perf_counter()
    high = logn - BuildConfig().brute_threshold.bit_length()
    at_build = {f"1M layer {lay}": gather_at_build(torch, index, 64,
                                                   BUILD_CHUNK, lay)
                for lay in (0, high)}
    Lt = torch.as_tensor(L, device=dev, dtype=torch.int32)
    Rt = torch.as_tensor(R, device=dev, dtype=torch.int32)
    ent = range_entry_ids(Lt, Rt.clamp_max(n - 1), n)
    ent = torch.where((ent >= Lt[:, None]) & (ent <= Rt[:, None]), ent, -1)
    at_build["1M search entries"] = gather_call_record(torch, table, q, ent)
    print("gather_dist at the search's entries: "
          + json.dumps(at_build["1M search entries"]), flush=True)
    for key, rec in at_build.items():
        if not rec["ok"]:
            print(f"gather_dist at build[{key}]: differs from the plain "
                  "version", flush=True)
        ok &= rec["ok"]
    profile_build_level(torch, index, 64, BUILD_CHUNK, 0)
    print(f"phase[gather_dist at build + profile of build level 0]: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # prune at the build's two candidate widths
    prune_inputs = {}
    for C in (80, 128):
        Bp = 16384
        node = (torch.rand((Bp,), generator=gen, device=dev) * n).long()
        if C == 128:  # a brute level: the node's 128-wide segment
            base = (node >> 7) << 7
            cand = base[:, None] + torch.arange(128, device=dev)[None, :]
            cand = torch.where((cand < n) & (cand != node[:, None]), cand, -1)
        else:  # a search level: own child's edges + 64 sibling ids
            lay = max(logn - 10, 0)
            own = nbrs[node, lay + 1, :].long()
            shift = logn - lay - 1
            sib = ((node >> shift) ^ 1) << shift
            pick = (torch.rand((Bp, 64), generator=gen, device=dev)
                    * (1 << shift)).long()
            cand = torch.cat([own, sib[:, None] + pick], dim=1)
            cand = torch.where((cand >= 0) & (cand < n)
                               & (cand != node[:, None]), cand, -1)
        cand = cand.to(torch.int32).contiguous()
        du = torch.where(cand >= 0, ((table[cand.clamp_min(0).long()]
                                      - table[node][:, None, :]) ** 2)
                         .sum(-1), torch.inf).contiguous()
        rec = prune_record(torch, table, cand, du, 16,
                           f"B={Bp} C={C} d={d} m=16")
        rec.pop("kept")
        records["prune" if C == 80 else "prune_C128"] = rec
        prune_inputs[C] = (cand, du)

    sources = {
        "gather_dist": ("gather_distance.cu", "gather_distance.py:48"),
        "select_edges": ("edge_select.cu", "edge_select.py:52"),
        "hop": ("hop.cu", "hop.py:61"),
        "prune": ("prune.cu", "prune.py:44"),
    }
    kernels = []
    for name, (cu, tpu) in sources.items():
        rec = records[name]
        ok &= rec["ok"]
        kernels.append(kernel_entry(name, rec, cu, tpu, counts[name]))
        kernels[-1]["baselines_launches"] = {
            meth: r["launches"].get(name, 0)
            for meth, r in base_recs.items()
            if isinstance(r, dict) and "launches" in r}
        if name in ("gather_dist", "hop"):
            kernels[-1]["sharded_launches"] = {
                "build": shard_rec.get("build_launches", {}).get(name, 0),
                "ranks": [sum(leg["launches"][r].get(name, 0)
                              for leg in shard_rec.get("legs", {}).values())
                          for r in range(SHARD_RANKS)]
                if shard_rec.get("legs") else None}
        if name == "select_edges":
            kernels[-1]["multiattr"] = {
                meth: r["edge_select"] for meth, r in base_recs.items()
                if isinstance(r, dict) and "edge_select" in r}
        if "rows_differ" in rec:
            kernels[-1].update(rows_differ=rec["rows_differ"],
                               near_ties=rec["near_ties"],
                               regime=rec["regime"])
    c128 = records["prune_C128"]
    print(f"kernel prune [{c128['shape']}]: {c128['ms']:.4f} ms, plain "
          f"{c128['plain_ms']:.4f} ms, bound {c128['bound_ms']:.4f} ms "
          f"({c128['bound_by']}), rows differing {c128['rows_differ']} "
          f"(near ties {c128['near_ties']}); {c128['regime']}"
          + ("" if c128["ok"] else "  DISAGREES"), flush=True)
    if not c128["ok"]:
        ok = False
    kernels[-1]["at_C128"] = {k: c128[k] for k in
                              ("ms", "plain_ms", "bound_ms", "max_abs_err",
                               "rows_differ", "near_ties", "regime")}

    # -- the codec path: every stored layout, on the same 1M index ----------
    # driven with every count at 0: the encodes, then each codec's searches
    ops.reset_launch_counts()
    codec_idx = encode_codecs(torch, index)
    f32_recall = {64: recall(searches["fused"][1], gt),
                  QUALITY_EF: recall(searches[f"fused ef={QUALITY_EF}"][1],
                                     gt)}
    if not codec_searches(torch, codec_idx, wl, lo_val, hi_val, gt,
                          f32_recall, (64, QUALITY_EF)):
        ok = False
    layout_counts = ops.layout_counts()
    print(f"codec path launches: {json.dumps(layout_counts)}", flush=True)
    never = [f"{k}[{name}]" for k in ("gather_dist", "hop")
             for name, _, _ in CODECS if layout_counts[f"{k}[{name}]"] == 0]
    if never:
        fail(f"codec layouts never launched on the codec path: {never}")

    # each codec layout of gather_dist and hop against its plain version
    crec = {}
    for name, cidx in codec_idx.items():
        for kname, rec in table_kernels(
                torch, name, cidx.vectors,
                storage.decode_neighbors(cidx.neighbors), q, ids, hop_args,
                hop_need).items():
            crec[f"{kname}[{name}]"] = rec
    for kname, cu in (("gather_dist", "gather_distance.cu"),
                      ("hop", "hop.cu")):
        for name, _, _ in CODECS:
            key = f"{kname}[{name}]"
            ok &= crec[key]["ok"]
            kernels.append(kernel_entry(key, crec[key], cu,
                                        CODEC_TPU[kname][name],
                                        layout_counts[key]))

    # index files on the card: the port's packer, zlib without zstandard
    if not codec_files(torch, codec_idx, wl, lo_val, hi_val,
                       ("int8", "pq")):
        print("files: a saved and loaded index differs", flush=True)
        ok = False
    # the stored vector tables stay for the prune's codec bodies
    codec_tables = {name: cidx.vectors for name, cidx in codec_idx.items()}
    del codec_idx

    # -- the build kernels against a plain build, at a cut size -------------
    t0 = time.perf_counter()
    wit, good = witness_build(torch, WITNESS_N)
    print(f"witness[build n={WITNESS_N}, kernels vs plain torch] in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(wit)}"
          + ("" if good else "  DISAGREES"), flush=True)
    if not good:
        ok = False

    # -- the embed -> build -> serve path at qwen3-0.6b's full width --------
    # driven with every count at 0; then its kernels against their plain
    # versions at its shapes
    if args.lm_n < LM_N:
        print(f"CUT: lm serve n = {args.lm_n} (full size is {LM_N})",
              flush=True)
    lm, good = lm_serve(torch, args.lm_n)
    lm_index = lm.pop("index")
    lm_q, lm_L, lm_R = lm.pop("queries")
    model, params = lm.pop("model")
    print(f"lm serve[{LM_ARCH}, params f32, compute bf16, n={args.lm_n}, "
          f"seq={LM_SEQ}, BuildConfig(m=16, ef_construction={2 * LM_EF}, "
          f"chunk={LM_BUILD_CHUNK}), ServingEngine(ef={LM_EF}, "
          f"k_bucket={LM_K}, max_batch={LM_MAX_BATCH}), {LM_QUERIES} "
          "requests]: "
          f"{json.dumps(lm)}" + ("" if good else "  FAILED"), flush=True)
    ok &= good
    toks = np.random.default_rng(3).integers(
        0, model.cfg.vocab, (LM_BATCH, LM_SEQ)).astype(np.int32)
    model.embed(params, toks)
    profile_search(torch, lambda: model.embed(params, toks),
                   f"embed batch of {LM_BATCH}")
    del model, params
    flash = flash_checks(torch)
    for rec in flash.values():
        ok &= rec["ok"]
    wide = prune_check_wide(torch, lm_index, 2 * LM_EF)
    ok &= wide["f32"]["ok"]
    profile_build_level(torch, lm_index, 2 * LM_EF, LM_BUILD_CHUNK,
                        max(lm_index.logn - 12, 0))
    lm_high = lm_index.logn - BuildConfig().brute_threshold.bit_length()
    for lay in (0, lm_high):
        rec = at_build[f"lm layer {lay}"] = gather_at_build(
            torch, lm_index, 2 * LM_EF, LM_BUILD_CHUNK, lay)
        if not rec["ok"]:
            print(f"gather_dist at build[lm layer {lay}]: differs from the "
                  "plain version", flush=True)
        ok &= rec["ok"]
    # gather_dist and hop at the served batch's shapes on the d = 1024
    # index: B = LM_MAX_BATCH queries, the engine's W frontier rows of m
    fr = frontier(torch, lm_index, lm_q[:LM_MAX_BATCH], lm_L[:LM_MAX_BATCH],
                  lm_R[:LM_MAX_BATCH], SearchConfig(ef=LM_EF).expand_width,
                  gen)
    lm_kernels = table_kernels(torch, "lm", lm_index.vectors,
                               lm_index.neighbors, fr["q"], fr["ids"],
                               fr["hop_args"], fr["hop_need"])
    del lm_index, fr
    for kname, rec in lm_kernels.items():
        ok &= rec["ok"]
        at = kernel_entry(kname, rec, *sources[kname],
                          lm["launches"][kname])
        entry = next(e for e in kernels if e["name"] == kname)
        entry["at_d1024"] = {k: at[k] for k in
                             ("launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by")}
        entry["at_d1024"]["shape"] = rec["shape"]
        entry["at_d1024"].update({k: rec[k] for k in SEARCH_KERNEL_KEYS
                                  if k in rec})
        if kname == "gather_dist":
            entry["at_build"] = at_build
    path = flash["path"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": lm["launches"]["flash_attention"],
        "max_abs_err": path["max_abs_err"],
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"], "shape": path["shape"],
        "max_abs_err_f32": flash["path f32"]["max_abs_err"],
        "max_abs_err_f16": flash["path f16"]["max_abs_err"],
        "lm_path_bodies": lm["flash_bodies"],
        "at_S4096": {k: flash["long"][k] for k in
                     ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms", "max_abs_err")}})
    wide_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                 "rows_differ", "near_ties", "regime", "staged_rows",
                 "smem_bytes", "layer", "rows_distinct", "rows_live", "dots")
    for entry in kernels:
        if entry["name"] == "prune":
            entry["at_d1024"] = {k: wide["f32"][k] for k in wide_keys}
            entry["lm_path_launches"] = lm["launches"]["prune"]

    # -- the roofline path: bench/roofline.py at its default shape ----------
    # driven with every count at 0; then kernel 5 against its plain version
    t_phase = time.perf_counter()
    roof, roof_counts, problem, good = roofline_phase(torch)
    ok &= good
    dist = pairwise_checks(torch, problem["q"], problem["table"],
                           torch.as_tensor(wl.queries, device=dev),
                           index.vectors)
    ok &= all(r["ok"] for r in dist.values())
    del problem
    main_dist = dist["roofline f32 l2"]
    kernels.append(kernel_entry(
        "pairwise_dist", main_dist, "distance.cu", "distance.py:26",
        roof_counts["pairwise_dist"], main_dist["library_ms"]))
    kernels[-1]["library"] = PAIRWISE_LIBRARY
    kernels[-1]["at_1M"] = {k: dist["1M f32 l2"][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "max_abs_err", "shape")}
    kernels[-1]["body"] = {"f32": "tf32x3", "bf16": "wgmma", "f16": "wgmma"}
    for tag in ("bf16", "f16"):
        kernels[-1][f"at_1M_{tag}"] = {
            k: dist[f"1M {tag} l2"][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library", "max_abs_err", "shape")}
    kernels[-1]["half_gate"] = {
        name: {"kernel": r["gate"], "plain": r["plain_gate"],
               "ulp_over": r["ulp_over"]}
        for name, r in dist.items() if "gate" in r}
    kernels[-1]["max_abs_err_by_case"] = {
        name: r["max_abs_err"] for name, r in dist.items()}
    print(f"phase[roofline + pairwise_dist]: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- the prune's codec bodies: ops.prune on the 1M index's tables -------
    t_phase = time.perf_counter()
    cand, du = prune_inputs[80]
    ops.reset_launch_counts()
    kept = {name: ops.prune(cand, du, tbl, m=16)
            for name, tbl in codec_tables.items()}
    torch.cuda.synchronize()
    prune_layouts = ops.layout_counts()
    print(f"codec prune path launches: {json.dumps(prune_layouts)}",
          flush=True)
    never = [f"prune[{name}]" for name in codec_tables
             if prune_layouts[f"prune[{name}]"] == 0]
    if never:
        fail(f"codec layouts never launched on the codec prune path: {never}")
    for name, tbl in codec_tables.items():
        rec = prune_record(torch, tbl, cand, du, 16,
                           f"B={cand.shape[0]} C={cand.shape[1]} d={d} m=16 "
                           f"{name}")
        same = torch.equal(rec.pop("kept"), kept[name])
        rec["ok"] &= same
        ok &= rec["ok"]
        key = f"prune[{name}]"
        kernels.append(kernel_entry(key, rec, "prune.cu", CODEC_TPU["prune"],
                                    prune_layouts[key]))
        kernels[-1].update(rows_differ=rec["rows_differ"],
                           near_ties=rec["near_ties"], regime=rec["regime"])
        if not same:
            print(f"kernel {key}: the path's kept ids differ from a second "
                  "launch on the same inputs", flush=True)
    ok &= wide["int8"]["ok"]
    entry = next(e for e in kernels if e["name"] == "prune[int8]")
    entry["at_d1024"] = {k: wide["int8"][k] for k in wide_keys}
    del codec_tables
    print(f"phase[prune codec bodies]: {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # -- the build-path benchmark: bench/buildpath.py at its defaults -------
    t_phase = time.perf_counter()
    bp, bp_counts, good = buildpath_phase(torch)
    ok &= good
    print(f"phase[buildpath]: {time.perf_counter() - t_phase:.1f} s; "
          f"launches {json.dumps(bp_counts)}", flush=True)
    for entry in kernels:
        if entry["name"] == "prune":
            entry["buildpath_launches"] = bp_counts["prune"]

    # -- bench/hotpath.py: the steps, and the launch plans' autotune --------
    t_new = time.perf_counter()
    tuned, good = hotpath_phase(torch)
    ok &= good
    new_phases_s += time.perf_counter() - t_new
    for entry in kernels:
        kind = AUTOTUNE_OF.get(entry["name"])
        if kind is not None:
            entry["autotune"] = {
                r["probe"]: {"pick": r["best"], "pick_ms": r["best_ms"],
                             "default": r["default"],
                             "default_ms": r["default_ms"],
                             "candidates": len(r["candidates"])}
                for r in tuned[kind]}
    print(f"phase[knobs + oracles + hotpath]: {new_phases_s:.1f} s "
          f"(budget {NEW_PHASES_MAX_S:.0f} s)", flush=True)

    # -- the benchmark gate; the contract checks R3 (host syncs) and R4
    # (shared memory) on the card ------------------------------------------
    t_phase = time.perf_counter()
    ok &= gate_phase(torch)
    ok &= sync_phase(torch, index, wl, lo_val, hi_val)
    ok &= smem_phase()
    phase_s = time.perf_counter() - t_phase
    print(f"phase[gate + contracts]: {phase_s:.1f} s (budget "
          f"{GATE_MAX_S:.0f} s)", flush=True)
    if phase_s > GATE_MAX_S:
        print(f"phase[gate + contracts]: over its {GATE_MAX_S:.0f} s",
              flush=True)
        ok = False

    # -- prefill and decode of every family: gemma2-9b served at full width,
    # the others at full width and one repeating unit of depth -------------
    del index
    decoded, good = lm_decode_phase(torch, dev)
    ok &= good

    # -- training: qwen3-0.6b at full width and depth, then every family --
    trained, good = train_phase(torch, dev)
    ok &= good
    flash_entry = next(e for e in kernels if e["name"] == "flash_attention")
    flash_entry["lm_decode_launches"] = {
        name: {k: rec[k] for k in ("flash_launches", "flash_bodies")}
        for name, rec in decoded.items()}
    a = trained[TRAIN_ARCH]
    flash_entry["lm_train_launches"] = {
        "training": a["flash_launches_training"],
        "embed_of_trained_weights": a["embed_flash_launches"],
        "embed_bodies": a["embed_flash_bodies"],
        "families_training": {name: rec["flash_launches"] for name, rec
                              in trained.items() if name != TRAIN_ARCH}}
    for name in FLASH_PATH_SHAPES:
        flash_entry[f"at_{name.replace(' ', '_')}"] = {
            k: flash[name][k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "max_abs_err", "body")}
    if not ok:
        fail("a check failed (see above)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="dataset size (default: the full 1,000,000)")
    ap.add_argument("--lm-n", type=int, default=LM_N,
                    help="items the lm serve path embeds and indexes "
                         f"(default: the full {LM_N:,})")
    run(ap.parse_args())


if __name__ == "__main__":
    main()
