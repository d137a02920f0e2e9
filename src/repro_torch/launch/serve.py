"""Serving launcher: build an iRangeGraph index over model embeddings and
serve batched RFANN queries (port of ``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch qwen3-0.6b --n 4096 --queries 256``
(on the card; ``--device cpu`` runs the plain torch versions)

The end-to-end path of the framework: backbone -> embeddings -> iRangeGraph
build -> batched range-filtered serving with a recall probe. Like
``repro``'s launcher it embeds with the architecture's ``.reduced()``
variant and seeded random weights, and ``--arch`` takes every decoder-only
family (dense, MoE, gemma2's local/global, zamba2, xLSTM; the
encoder-decoder has no embedding); unlike it, attention stays at
``attention_impl="auto"`` (``repro`` pins its plain version because Pallas
only interprets off a TPU), so on the card every layer runs the
flash-attention kernel.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.core import BuildConfig, RangeGraphIndex, SearchConfig, recall
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServingEngine

__all__ = ["embed_corpus", "main"]


@torch.no_grad()
def embed_corpus(model, params, n, seq, vocab, seed=0, batch=64):
    """Embed ``n`` items of ``seq`` token ids drawn uniformly from
    ``[0, vocab)`` by ``np.random.default_rng(seed)``, ``batch`` items per
    call (``repro``'s draw, batch for batch) -> f32 numpy [n, d_model]."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(0, n, batch):
        e = min(n, s + batch)
        toks = rng.integers(0, vocab, (e - s, seq)).astype(np.int32)
        out.append(model.embed(params, toks).cpu().numpy())
    return np.concatenate(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(
        name for name, cfg in ARCHS.items() if cfg.family != "encdec"))
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)

    print(f"[serve] embedding {args.n} items with {cfg.name} (reduced) "
          f"on {dev}")
    vectors = embed_corpus(model, params, args.n, args.seq, cfg.vocab,
                           args.seed)
    rng = np.random.default_rng(args.seed + 1)
    attrs = rng.uniform(0, 1e6, args.n)

    t0 = time.time()
    index = RangeGraphIndex.build(
        vectors, attrs, BuildConfig(m=args.m, ef_construction=2 * args.ef),
        device=dev,
    )
    print(f"[serve] index built in {time.time()-t0:.1f}s "
          f"({index.nbytes/1e6:.1f} MB)")

    engine = ServingEngine(
        index, config=SearchConfig(ef=args.ef, k_bucket=args.k), max_batch=64
    )
    engine.warmup(k_buckets=(args.k,))  # the first flush adds no entries
    qv = embed_corpus(model, params, args.queries, args.seq, cfg.vocab,
                      args.seed + 2)
    los = rng.uniform(0, 5e5, args.queries)
    his = los + rng.uniform(1e5, 5e5, args.queries)
    for i in range(args.queries):
        engine.submit(Request(qv[i], los[i], his[i], k=args.k))
    results = engine.flush()

    # recall probe on a subsample, in original ids
    L, R = index.ranks_of(los[:32], his[:32])
    gt, _ = index.brute_force(qv[:32], L, R, k=args.k)
    got = np.stack([r.ids for r in results[:32]])
    gt_orig = index.original_ids(gt)
    rec = recall(got, gt_orig)
    print(f"[serve] served {len(results)} queries at {engine.qps:.0f} qps, "
          f"recall@{args.k}={rec:.3f}")
    return engine.qps, rec


if __name__ == "__main__":
    main()
