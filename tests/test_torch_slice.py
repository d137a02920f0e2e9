"""The embed -> build -> serve slice of the port against ``repro``'s, on
the CPU: ``launch/serve.py``'s path at the reduced qwen3-0.6b.

Both packages embed a corpus and queries with the same weights (``repro``'s
seeded init carried into the port) and the launcher's token draw; the
embeddings agree within 1e-4 (f32; sums in other orders). Each side then
builds its own index over its own embeddings (``BuildConfig(m=16,
ef_construction=64)``, the launcher's at ef = 32) and serves the same
requests through its ``ServingEngine``: held on mean top-10 id agreement
(reported, >= 0.95) and recall@10 within 0.01 of ``repro``'s.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.launch.serve import embed_corpus as jembed_corpus
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import BuildConfig, RangeGraphIndex, SearchConfig, recall
from repro_torch.configs import get_arch
from repro_torch.launch.serve import embed_corpus
from repro_torch.models.api import Model, params_from_numpy
from repro_torch.serve import Request, ServingEngine


def _agreement(a, b):
    """Mean per-row share of b's ids that a also returned."""
    out = []
    for x, y in zip(np.asarray(a), np.asarray(b)):
        xs, ys = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(xs & ys) / len(ys) if ys else float(not xs))
    return float(np.mean(out))


def test_slice_embed_build_serve_against_repro():
    """The launcher's slice on both sides: embed a corpus and queries with
    the reduced qwen3-0.6b (carried weights, the launcher's token draw),
    build an index on each side, serve the same requests."""
    n, nq, seq = 512, 48, 16
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(),
                               attention_impl="xla")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_arch("qwen3-0.6b").reduced())
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    jvec = jembed_corpus(jm, jp, n, seq, jcfg.vocab, seed=0)
    tvec = embed_corpus(tm, tp, n, seq, jcfg.vocab, seed=0)
    np.testing.assert_allclose(tvec, jvec, rtol=0, atol=1e-4)
    jq = jembed_corpus(jm, jp, nq, seq, jcfg.vocab, seed=2)
    tq = embed_corpus(tm, tp, nq, seq, jcfg.vocab, seed=2)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-4)

    rng = np.random.default_rng(1)
    attrs = rng.uniform(0, 1e6, n)
    jidx = JIndex.build(jvec, attrs, JBuildConfig(m=16, ef_construction=64))
    tidx = RangeGraphIndex.build(tvec, attrs, BuildConfig(
        m=16, ef_construction=64), device="cpu")
    los = rng.uniform(0, 5e5, nq)
    his = los + rng.uniform(1e5, 5e5, nq)
    jeng = JServingEngine(jidx, config=JSearchConfig(ef=32, k_bucket=10),
                          max_batch=64, warmup=False)
    teng = ServingEngine(tidx, config=SearchConfig(ef=32, k_bucket=10),
                         max_batch=64)
    for i in range(nq):
        jeng.submit(JRequest(jq[i], los[i], his[i], k=10))
        teng.submit(Request(tq[i], los[i], his[i], k=10))
    want = np.stack([r.ids for r in jeng.flush()])
    got = np.stack([r.ids for r in teng.flush()])
    L, R = tidx.ranks_of(los, his)
    gt = tidx.original_ids(tidx.brute_force(tq, L, R, k=10)[0])
    agree = _agreement(got, want)
    print(f"slice id agreement with repro {agree:.4f}; recall@10 port "
          f"{recall(got, gt):.4f}, repro {recall(want, gt):.4f}")
    assert agree >= 0.95
    assert abs(recall(got, gt) - recall(want, gt)) <= 0.01
