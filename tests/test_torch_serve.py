"""The port's serving stack (executor, engine, faults) on a ``repro``-built
index, on the CPU (the whole embed -> build -> serve slice is
``tests/test_torch_slice.py``).

Counterparts of ``tests/test_executor.py`` and ``tests/test_serve.py``: one
index is built by ``repro`` (n=256, d=12, m=8) and loaded into the port
(``RangeGraphIndex.from_numpy``). Cache counts are exact: the port keeps
one entry per (config, batch bucket, k bucket), and a warmed executor adds
none. Padding parity and the executor's agreement with a direct search are
bit for bit. Between the packages (the same requests through ``repro``'s
engine and the port's) float sums run in other orders, so near ties may
swap: held on mean top-k id agreement (reported, >= 0.95) and recall@10
within 0.01 of ``repro``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import RangeGraphIndex, SearchConfig, recall
from repro_torch.core import config as config_mod
from repro_torch.serve import (
    FaultConfig,
    FaultInjector,
    InjectedFaultError,
    InvalidRequestError,
    Request,
    SearchExecutor,
    ServingEngine,
    ShutdownError,
)


def _carry(jidx):
    fields = dict(
        vectors=np.asarray(jidx.vectors), attrs=jidx.attrs, perm=jidx.perm,
        neighbors=np.asarray(jidx.neighbors), m=jidx.m, logn=jidx.logn,
        build_cfg=dataclasses.asdict(jidx.build_cfg),
        storage=dataclasses.asdict(jidx.storage),
    )
    return RangeGraphIndex.from_numpy(fields, device="cpu")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    n, d = 256, 12
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    attrs = rng.uniform(0, 100, n)
    jidx = JIndex.build(vectors, attrs, JBuildConfig(
        m=8, ef_construction=32, brute_threshold=32))
    return jidx, _carry(jidx)


@pytest.fixture
def idx(pair):
    return pair[1]


def _workload(rng, index, B):
    q = rng.standard_normal((B, index.dim)).astype(np.float32)
    L = rng.integers(0, index.n // 2, B).astype(np.int32)
    R = (L + rng.integers(8, index.n // 2, B)).astype(np.int32)
    return q, L, np.minimum(R, index.n - 1).astype(np.int32)


def _requests(rng, index, ks, cls=Request):
    reqs = []
    for k in ks:
        v = rng.standard_normal(index.dim).astype(np.float32)
        lo, hi = sorted(rng.uniform(0, 100, 2))
        reqs.append(cls(vector=v, lo=lo, hi=hi, k=k))
    return reqs


def _agreement(a, b):
    """Mean per-row share of b's ids that a also returned."""
    out = []
    for x, y in zip(np.asarray(a), np.asarray(b)):
        xs, ys = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(xs & ys) / len(ys) if ys else float(not xs))
    return float(np.mean(out))


# -- the executor ------------------------------------------------------------

def test_warmup_then_zero_new_entries(idx):
    rng = np.random.default_rng(0)
    ex = SearchExecutor(idx, SearchConfig(ef=32, k_bucket=10), max_batch=8)
    filled = ex.warmup()
    assert filled == ex.program_grid() == \
        len(ex.batch_buckets) * len(ex.config.k_buckets())
    assert ex.stats["warmup_compiles"] == filled
    for B in list(range(1, 9)) * 2:
        q, L, R = _workload(rng, idx, B)
        k = int(rng.integers(1, 33))
        res = ex.search_ranks(q, L, R, k=k)
        assert res.ids.shape == (B, k)
    assert ex.stats["compiles"] == filled
    assert ex.stats["cache_hits"] == ex.stats["batches"]


@pytest.mark.parametrize("hop_impl", ["auto", "composed"])
def test_same_as_direct_search(idx, hop_impl):
    rng = np.random.default_rng(1)
    cfg = SearchConfig(ef=32, k_bucket=10, hop_impl=hop_impl)
    ex = SearchExecutor(idx, cfg, max_batch=8)
    for B, k in [(1, 3), (5, 10), (8, 7)]:
        q, L, R = _workload(rng, idx, B)
        got = ex.search_ranks(q, L, R, k=k)
        want = idx.search_ranks(q, L, R, k=cfg.bucket_k(k), config=cfg)
        assert torch.equal(got.ids, want.ids[:, :k])
        assert torch.equal(got.dists, want.dists[:, :k])


def test_padding_parity_exact_bucket(idx):
    rng = np.random.default_rng(2)
    ex = SearchExecutor(idx, SearchConfig(ef=32), max_batch=8)
    q, L, R = _workload(rng, idx, 8)
    part = ex.search_ranks(q[:5], L[:5], R[:5], k=10)
    full = ex.search_ranks(q, L, R, k=10)
    assert torch.equal(part.ids, full.ids[:5])
    assert torch.equal(part.dists, full.dists[:5])


def test_oversize_batch_splits(idx):
    rng = np.random.default_rng(3)
    q, L, R = _workload(rng, idx, 11)
    small = SearchExecutor(idx, SearchConfig(ef=32), max_batch=4)
    big = SearchExecutor(idx, SearchConfig(ef=32), max_batch=16)
    a = small.search_ranks(q, L, R, k=5)
    b = big.search_ranks(q, L, R, k=5)
    assert a.ids.shape == (11, 5)
    assert torch.equal(a.ids, b.ids)
    assert small.stats["batches"] == 3 and small.stats["queries"] == 11


def test_pad_to_max_mode(idx):
    rng = np.random.default_rng(4)
    ex = SearchExecutor(idx, SearchConfig(ef=32), max_batch=8,
                        batch_buckets=(8,))
    for B in (1, 5, 8):
        ex.search_ranks(*_workload(rng, idx, B), k=10)
    assert ex.stats["compiles"] == 1
    with pytest.raises(ValueError, match="end at max_batch"):
        SearchExecutor(idx, max_batch=8, batch_buckets=(4,))


def test_per_call_config_is_own_cache_axis(idx):
    rng = np.random.default_rng(5)
    cfg_a = SearchConfig(ef=32, k_bucket=10)
    cfg_b = cfg_a.replace(expand_width=1)
    ex = SearchExecutor(idx, cfg_a, max_batch=4)
    q, L, R = _workload(rng, idx, 4)
    ex.search_ranks(q, L, R, k=10)
    ex.search_ranks(q, L, R, k=10, config=cfg_b)
    assert ex.stats["compiles"] == 2
    ex.search_ranks(q, L, R, k=10)
    ex.search_ranks(q, L, R, k=10, config=cfg_b)
    assert ex.stats["compiles"] == 2 and ex.stats["cache_hits"] == 2


def test_k_exceeding_ef_rejected(idx):
    ex = SearchExecutor(idx, SearchConfig(ef=16), max_batch=4)
    q, L, R = _workload(np.random.default_rng(6), idx, 2)
    with pytest.raises(ValueError, match="exceeds the config's ef"):
        ex.search_ranks(q, L, R, k=17)


def test_executor_close_semantics(idx):
    ex = SearchExecutor(idx, SearchConfig(ef=32, k_bucket=10), max_batch=4)
    q, L, R = _workload(np.random.default_rng(7), idx, 2)
    ex.search_ranks(q, L, R, k=5)
    served = ex.stats["compiles"]
    ex.close()
    assert ex.closed
    with pytest.raises(ShutdownError):
        ex.search_ranks(q, L, R, k=5)
    assert ex.stats["compiles"] == served
    ex.close()


def test_bucket_math_matches_repro():
    from repro.core import config as jconfig

    for mb in (1, 5, 8, 64, 100):
        assert config_mod.batch_buckets(mb) == jconfig.batch_buckets(mb)
        for b in range(1, mb + 1):
            assert config_mod.batch_bucket(b, mb) == \
                jconfig.batch_bucket(b, mb)
    for ef, kb in ((64, 10), (16, 10), (32, 5)):
        t, j = SearchConfig(ef=ef, k_bucket=kb), \
            JSearchConfig(ef=ef, k_bucket=kb)
        assert t.k_buckets() == j.k_buckets()
        assert [t.bucket_k(k) for k in range(1, ef + 1)] == \
            [j.bucket_k(k) for k in range(1, ef + 1)]
    with pytest.raises(ValueError, match="k_bucket"):
        SearchConfig(k_bucket=0)


# -- the engine --------------------------------------------------------------

def test_mixed_k_single_bucket(idx):
    rng = np.random.default_rng(8)
    eng = ServingEngine(idx, config=SearchConfig(ef=32, k_bucket=10),
                        max_batch=4)
    for r in _requests(rng, idx, [3, 7, 10, 1, 9, 10, 2, 5]):
        eng.submit(r)
    assert len(eng.flush()) == 8
    assert eng.stats["compiles"] == 1 and eng.stats["served"] == 8
    assert eng.executor.seen_k_buckets == {10}
    with pytest.raises(ValueError, match="exceeds the engine's ef"):
        eng.submit(Request(np.zeros(idx.dim, np.float32), 0.0, 1.0, k=33))
    with pytest.raises(ValueError, match="must be >= 1"):
        eng.submit(Request(np.zeros(idx.dim, np.float32), 0.0, 1.0, k=0))


def test_zero_new_entries_after_warmup(idx):
    rng = np.random.default_rng(9)
    ex = SearchExecutor(idx, SearchConfig(ef=32, k_bucket=10), max_batch=4)
    eng = ServingEngine(idx, executor=ex, warmup=True)
    warm = eng.stats["compiles"]
    assert warm == eng.stats["warmup_compiles"] == ex.program_grid()
    for r in _requests(rng, idx, [1, 9, 12, 32, 4, 20, 31]):
        eng.submit(r)
    assert len(eng.flush()) == 7
    assert eng.stats["compiles"] == warm


def test_engine_padding_parity(idx):
    rng = np.random.default_rng(10)
    reqs = _requests(rng, idx, [5] * 5)
    fillers = _requests(rng, idx, [5] * 3)
    cfg = SearchConfig(ef=32, k_bucket=5)
    eng_pad = ServingEngine(idx, config=cfg, max_batch=8)
    eng_full = ServingEngine(idx, config=cfg, max_batch=8)
    for r in reqs:
        eng_pad.submit(r)
        eng_full.submit(r)
    for r in fillers:
        eng_full.submit(r)
    for g, w in zip(eng_pad.flush(), eng_full.flush()[:5]):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists, w.dists)


def test_results_in_range_with_own_k_and_latency(idx):
    rng = np.random.default_rng(11)
    eng = ServingEngine(idx, config=SearchConfig(ef=16, k_bucket=10),
                        max_batch=4)
    ks = [3, 12, 7, 15, 11, 5]
    reqs = _requests(rng, idx, ks)
    for r in reqs:
        eng.submit(r)
    results = eng.flush()
    assert eng.executor.seen_k_buckets == {10, 16}
    attrs_orig = np.empty(idx.n)
    attrs_orig[idx.perm] = idx.attrs
    for req, res, k in zip(reqs, results, ks):
        assert res.ids.shape == (k,) and res.dists.shape == (k,)
        got = res.ids[res.ids >= 0]
        assert ((attrs_orig[got] >= req.lo)
                & (attrs_orig[got] <= req.hi)).all()
        assert res.latency_s > 0
    s = eng.stats
    assert 0.0 < s["latency_p50"] <= s["latency_p95"] <= s["latency_p99"]
    assert s["latency_p99"] <= max(r.latency_s for r in results) + 1e-9


def test_validation_typed_errors(idx):
    eng = ServingEngine(idx, config=SearchConfig(ef=32, k_bucket=10),
                        max_batch=4)
    v = np.zeros(idx.dim, np.float32)
    cases = [
        (Request(np.zeros(idx.dim + 2, np.float32), 0.0, 1.0, k=5),
         "does not match index dim"),
        (Request(np.zeros((2, idx.dim), np.float32), 0.0, 1.0, k=5),
         "does not match index dim"),
        (Request(np.full(idx.dim, np.inf, np.float32), 0.0, 1.0, k=5),
         "NaN/Inf"),
        (Request(v, 5.0, 1.0, k=5), "inverted range"),
        (Request(v, np.nan, 1.0, k=5), "must not be NaN"),
        (Request(v, 0.0, np.nan, k=5), "must not be NaN"),
    ]
    for req, match in cases:
        with pytest.raises(InvalidRequestError, match=match):
            eng.submit(req)
    assert isinstance(InvalidRequestError("x"), ValueError)
    eng.submit(Request(v, -np.inf, np.inf, k=5))
    assert len(eng.flush()) == 1


def test_flush_error_isolation(idx):
    rng = np.random.default_rng(12)
    inj = FaultInjector(FaultConfig(kinds=("flush_error",),
                                    flush_error_rate=1.0))
    eng = ServingEngine(idx, config=SearchConfig(ef=32, k_bucket=10),
                        max_batch=4, faults=inj)
    for r in _requests(rng, idx, [5, 5, 5]):
        eng.submit(r)
    out = eng.flush()
    assert len(out) == 3 and all(isinstance(o, InjectedFaultError)
                                 for o in out)
    assert eng.stats["failed"] == 3 and eng.stats["flush_failures"] == 1
    inj.armed = False
    for r in _requests(rng, idx, [5, 5]):
        eng.submit(r)
    assert all(o.latency_s > 0 for o in eng.flush())
    assert eng.stats["served"] == 2


def test_flush_error_isolated_per_batch(idx):
    rng = np.random.default_rng(13)
    inj = FaultInjector(FaultConfig(kinds=("flush_error",),
                                    flush_error_rate=1.0))
    eng = ServingEngine(idx, config=SearchConfig(ef=32, k_bucket=10),
                        max_batch=4, faults=inj)
    orig = inj.maybe_flush_error

    def one_shot():
        try:
            orig()
        finally:
            inj.armed = False

    inj.maybe_flush_error = one_shot
    for r in _requests(rng, idx, [5, 5, 15]):   # buckets 10 and 20
        eng.submit(r)
    out = eng.flush()
    assert sum(isinstance(o, InjectedFaultError) for o in out) == 2
    assert sum(not isinstance(o, Exception) for o in out) == 1
    assert eng.stats["flush_failures"] == 1


@pytest.mark.parametrize("drain", [True, False])
def test_close_drain_semantics(idx, drain):
    rng = np.random.default_rng(14)
    eng = ServingEngine(idx, config=SearchConfig(ef=32, k_bucket=10),
                        max_batch=4)
    for r in _requests(rng, idx, [5, 5, 5]):
        eng.submit(r)
    out = eng.close(drain=drain)
    assert len(out) == 3
    if drain:
        assert not any(isinstance(o, Exception) for o in out)
    else:
        assert all(isinstance(o, ShutdownError) for o in out)
        assert eng.stats["failed"] == 3 and eng.stats["served"] == 0
    with pytest.raises(ShutdownError):
        eng.submit(_requests(rng, idx, [5])[0])
    assert eng.close() == []
    assert eng.executor.closed


def test_close_leaves_shared_executor_open(idx):
    ex = SearchExecutor(idx, SearchConfig(ef=32, k_bucket=10), max_batch=4)
    ServingEngine(idx, executor=ex).close()
    assert not ex.closed


def test_engine_config_defaults(idx):
    rng = np.random.default_rng(15)
    eng = ServingEngine(idx, max_batch=4)
    assert eng.config == SearchConfig() and eng.max_batch == 4
    for r in _requests(rng, idx, [3, 7]):
        eng.submit(r)
    assert len(eng.flush()) == 2


def test_faults_from_env():
    assert FaultConfig.from_env({}) is None
    assert FaultConfig.from_env({"REPRO_FAULTS": "latency"}) is None
    cfg = FaultConfig.from_env({"RTORCH_FAULTS": "latency, flush_error",
                                "RTORCH_FAULT_LATENCY_S": "0.5",
                                "RTORCH_FAULT_SEED": "3"})
    assert cfg == FaultConfig(kinds=("latency", "flush_error"),
                              latency_s=0.5, seed=3)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultConfig.from_env({"RTORCH_FAULTS": "meteor"})


# -- against repro -----------------------------------------------------------

def test_engines_agree_with_repro(pair):
    """The same 64 requests through ``repro``'s engine and the port's."""
    jidx, idx = pair
    rng = np.random.default_rng(16)
    q = rng.standard_normal((64, idx.dim)).astype(np.float32)
    lo = rng.uniform(0, 60, 64)
    hi = lo + rng.uniform(10, 40, 64)
    jeng = JServingEngine(jidx, config=JSearchConfig(ef=32, k_bucket=10),
                          max_batch=16, warmup=False)
    teng = ServingEngine(idx, config=SearchConfig(ef=32, k_bucket=10),
                         max_batch=16)
    for i in range(64):
        jeng.submit(JRequest(q[i], lo[i], hi[i], k=10))
        teng.submit(Request(q[i], lo[i], hi[i], k=10))
    want = np.stack([r.ids for r in jeng.flush()])
    got = np.stack([r.ids for r in teng.flush()])
    L, R = idx.ranks_of(lo, hi)
    gt = idx.original_ids(idx.brute_force(q, L, R, k=10)[0])
    agree = _agreement(got, want)
    print(f"engine id agreement with repro {agree:.4f}; recall@10 port "
          f"{recall(got, gt):.4f}, repro {recall(want, gt):.4f}")
    assert agree >= 0.95
    assert abs(recall(got, gt) - recall(want, gt)) <= 0.01
