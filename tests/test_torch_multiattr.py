"""The port's multi-attribute search against the JAX package's.

One ``repro`` index (n=512, d=16, m=8, ef_construction=32) carried into the
port through ``from_numpy``; a second attribute drawn as Fig. 5 draws it
(uniform on [0, 1), value ranges 0.25 wide) and 128 queries over range
fraction 2^-2. ``post`` and ``in`` draw no coin that matters, so they are
held like the filtered searches: mean top-10 id agreement >= 0.98 and
recall@10 within 0.01 of ``repro``'s. ``adaptive`` draws its coins from a
``torch.Generator``, whose stream cannot match ``jax.random``'s: it is held
on statistics only (recall within 0.02, mean distance count within 10%),
and to the same result for the same seed. ``brute_force_multiattr`` gives
``repro``'s ids exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.core import multiattr as jmulti
from repro.core import recall as jrecall
from repro_torch import RangeGraphIndex, SearchConfig, recall
from repro_torch.core import multiattr
from repro_torch.core import search as tsearch
from repro_torch.data import make_workload, vector_dataset

N, D, B = 512, 16, 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors and many operations: one intra-op thread, so that on
    a loaded host no operation waits at a thread-pool barrier for threads
    the other test workers hold (10x and more per operation)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    vectors, attrs, _ = vector_dataset(N, D, seed=0)
    jidx = JIndex.build(vectors, attrs[:, 0],
                        JBuildConfig(m=8, ef_construction=32))
    fields = dict(
        vectors=np.asarray(jidx.vectors), attrs=jidx.attrs, perm=jidx.perm,
        neighbors=np.asarray(jidx.neighbors), m=jidx.m, logn=jidx.logn,
        build_cfg=dataclasses.asdict(jidx.build_cfg),
        storage=dataclasses.asdict(jidx.storage),
    )
    tidx = RangeGraphIndex.from_numpy(fields, device="cpu")
    rng = np.random.default_rng(5)
    attr2 = rng.uniform(0, 1.0, N).astype(np.float32)
    wl = make_workload(tidx, "frac_2", n_queries=B, seed=1)
    lo2 = rng.uniform(0, 0.5, B).astype(np.float32)
    hi2 = (lo2 + 0.25).astype(np.float32)
    args = (attr2, wl.queries, wl.L, wl.R, lo2, hi2)
    gt, _ = jmulti.brute_force_multiattr(jidx, *args, k=10)
    return jidx, tidx, args, gt


def _agreement(a, b):
    a, b = np.asarray(a), np.asarray(b)
    out = []
    for x, y in zip(a, b):
        xs, ys = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(xs & ys) / len(ys) if ys else float(not xs))
    return float(np.mean(out))


def test_brute_force_ids_equal(case):
    jidx, tidx, args, gt = case
    ids, dists = multiattr.brute_force_multiattr(tidx, *args, k=10)
    np.testing.assert_array_equal(ids, gt)
    _, jd = jmulti.brute_force_multiattr(jidx, *args, k=10)
    np.testing.assert_allclose(dists, jd, rtol=1e-5)
    assert (ids >= 0).sum() > 0.9 * ids.size


@pytest.mark.parametrize("mode", ["post", "in"])
@pytest.mark.parametrize("W", [1, 4])
def test_deterministic_modes_match_repro(case, mode, W):
    jidx, tidx, args, gt = case
    want = jmulti.search_multiattr(jidx, *args, k=10, mode=mode,
                                   config=JSearchConfig(ef=48,
                                                        expand_width=W))
    got = multiattr.search_multiattr(tidx, *args, k=10, mode=mode,
                                     config=SearchConfig(ef=48,
                                                         expand_width=W))
    assert _agreement(got.ids, want.ids) >= 0.98
    r_j = jrecall(np.asarray(want.ids), gt)
    r_t = recall(got.ids, gt)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    attr2, _, L, R, lo2, hi2 = args
    ids = got.ids.numpy()
    a = attr2[np.maximum(ids, 0)]
    ok = (ids == -1) | ((ids >= L[:, None]) & (ids <= R[:, None])
                        & (a >= lo2[:, None]) & (a <= hi2[:, None]))
    assert ok.all()


def test_adaptive_matches_repro_in_statistics(case):
    jidx, tidx, args, gt = case
    cfg = dict(ef=48)
    want = jmulti.search_multiattr(jidx, *args, k=10, mode="adaptive",
                                   config=JSearchConfig(**cfg))
    got = multiattr.search_multiattr(tidx, *args, k=10, mode="adaptive",
                                     seed=0, config=SearchConfig(**cfg))
    r_j = jrecall(np.asarray(want.ids), gt)
    r_t = recall(got.ids, gt)
    assert abs(r_t - r_j) <= 0.02, (r_t, r_j)
    nd_j = float(np.asarray(want.n_dists).mean())
    nd_t = float(got.n_dists.float().mean())
    assert abs(nd_t - nd_j) <= 0.10 * nd_j, (nd_t, nd_j)
    again = multiattr.search_multiattr(tidx, *args, k=10, mode="adaptive",
                                       seed=0, config=SearchConfig(**cfg))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # the coin is live: adaptive visits fewer rows than post-filtering
    post = multiattr.search_multiattr(tidx, *args, k=10, mode="post",
                                      config=SearchConfig(**cfg))
    assert nd_t < float(post.n_dists.float().mean())


def test_adaptive_ignores_the_iteration_block(case, monkeypatch):
    _, tidx, args, _ = case
    runs = []
    for block in (1, 8, 64):
        monkeypatch.setattr(tsearch, "ITER_BLOCK", block)
        runs.append(multiattr.search_multiattr(tidx, *args, k=10, seed=3))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_unknown_mode_raises(case):
    _, tidx, args, _ = case
    with pytest.raises(ValueError, match="mode"):
        multiattr.search_multiattr(tidx, *args, mode="pre")
