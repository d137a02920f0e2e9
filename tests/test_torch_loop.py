"""The port's AsyncServingEngine: deadlines, shedding, backpressure, drain
(counterparts of ``tests/test_loop.py``), its ``ServeConfig``, the
executor's lock, ``bench/serve_slo.py``'s leg, and the loop against
``repro``'s, on the CPU.

One index is built by ``repro`` (n=256, d=12, m=8) and loaded into the
port, as ``tests/test_torch_serve.py`` does. Each test drives the loop
inside its own ``asyncio.run``. Deterministic tests pass ``faults=False``
so an ``RTORCH_FAULTS`` environment cannot perturb them; the tests that
want a stalled flusher build their own injector with ``latency_rate=1.0``
(a deterministic spike). Every injected stall ends at least 0.25 s away
from the deadline it races, and every request expected to be served has
a deadline of 1 s or more, so a loaded host does not flip an outcome.

All engines share one module-scoped warmed executor; engines never close
a shared executor, and the module's final test asserts that the whole
file ran with zero post-warmup cache entries. Against ``repro`` (the same
requests through both loops) float sums run in other orders, so near ties
may swap: held on mean top-k id agreement (>= 0.95) and recall@10 within
0.01, the tolerance of ``tests/test_torch_serve.py``.
"""
import asyncio
import dataclasses
import sys
import threading

import numpy as np
import pytest

from repro.core import BuildConfig as JBuildConfig
from repro.core import RangeGraphIndex as JIndex
from repro.core import SearchConfig as JSearchConfig
from repro.core import ServeConfig as JServeConfig
from repro.serve import AsyncServingEngine as JAsyncServingEngine
from repro.serve import Request as JRequest
from repro.serve import SearchExecutor as JSearchExecutor
from repro_torch import RangeGraphIndex, SearchConfig, ServeConfig, recall
from repro_torch.bench import serve_slo
from repro_torch.data import make_workload
from repro_torch.serve import (
    AsyncServingEngine,
    DeadlineExceededError,
    FaultConfig,
    InvalidRequestError,
    OverloadedError,
    Request,
    Result,
    SearchExecutor,
    ServingEngine,
    ShedError,
    ShutdownError,
)

CFG = SearchConfig(ef=32, k_bucket=10)


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
    rng = np.random.default_rng(31)
    n, d = 256, 12
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    attrs = rng.uniform(0, 100, n)
    jidx = JIndex.build(vectors, attrs, JBuildConfig(
        m=8, ef_construction=32, brute_threshold=32))
    return jidx, _carry(jidx)


@pytest.fixture(scope="module")
def serving(pair):
    idx = pair[1]
    ex = SearchExecutor(idx, CFG, max_batch=4, warmup=True)
    return idx, ex, np.random.default_rng(32)


def _req(rng, idx, k=5):
    v = rng.standard_normal(idx.dim).astype(np.float32)
    lo, hi = sorted(rng.uniform(0, 100, 2))
    return Request(vector=v, lo=lo, hi=hi, k=k)


def _stall(latency_s):
    """An injector that stalls EVERY flush by latency_s (deterministic)."""
    return FaultConfig(kinds=("latency",), latency_s=latency_s,
                       latency_rate=1.0)


def _agreement(a, b):
    """Mean per-row share of b's ids that a also returned."""
    out = []
    for x, y in zip(np.asarray(a), np.asarray(b)):
        xs, ys = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        out.append(len(xs & ys) / len(ys) if ys else float(not xs))
    return float(np.mean(out))


# -- ServeConfig -------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    None,   # the defaults
    {"deadline_s": 0.0}, {"deadline_s": -1.0}, {"max_queue": 0},
    {"backpressure": "drop"}, {"max_wait_s": -0.1},
    {"deadline_margin_s": -0.01}, {"drain_timeout_s": 0.0},
], ids=lambda b: "defaults" if b is None else next(iter(b)))
def test_serve_config_matches_repro(bad):
    if bad is None:
        got, want = ServeConfig(), JServeConfig()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert got.replace(max_queue=7).max_queue == 7
        with pytest.raises(dataclasses.FrozenInstanceError):
            got.deadline_s = 1.0
        return
    with pytest.raises(ValueError) as jerr:
        JServeConfig(**bad)
    with pytest.raises(ValueError) as terr:
        ServeConfig(**bad)
    assert str(terr.value) == str(jerr.value)


# -- the executor's lock ------------------------------------------------------

def test_executor_threads_share_one_bucket(serving):
    """Two threads search one cache entry (bucket 4, k 10) with different
    queries at once: each result must equal its serial answer. Without
    the executor's lock, one thread's copy-in lands between the other's
    copy-in and search, and it searches the other's rows."""
    idx, ex, _ = serving
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        q = rng.standard_normal((4, idx.dim)).astype(np.float32)
        L = rng.integers(0, 100, 4).astype(np.int32)
        R = (L + rng.integers(20, 150, 4)).astype(np.int32)
        batches.append((q, L, R))
    want = [ex.search_ranks(q, L, R, k=10) for q, L, R in batches]
    rounds = 40
    bad = [0, 0]
    errors = []
    start = threading.Barrier(2)

    def worker(t):
        q, L, R = batches[t]
        try:
            start.wait(timeout=10)
            for _ in range(rounds):
                got = ex.search_ranks(q, L, R, k=10)
                if not (np.array_equal(got.ids.numpy(), want[t].ids.numpy())
                        and np.array_equal(got.dists.numpy(),
                                           want[t].dists.numpy())):
                    bad[t] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert bad == [0, 0], f"results differing from the serial answer: {bad}"


# -- the loop (counterparts of tests/test_loop.py) ----------------------------

def test_serves_and_matches_sync_engine(serving):
    idx, ex, rng = serving
    reqs = [_req(rng, idx) for _ in range(6)]

    async def go():
        async with AsyncServingEngine(idx, executor=ex,
                                      faults=False) as eng:
            return await asyncio.gather(*(eng.submit(r) for r in reqs))

    got = asyncio.run(go())
    sync = ServingEngine(idx, executor=ex, faults=False)
    for r in reqs:
        sync.submit(r)
    want = sync.flush()
    for g, w, r in zip(got, want, reqs):
        assert isinstance(g, Result)
        assert g.ids.shape == (r.k,)
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists, w.dists)


def test_validation_rejects_before_queueing(serving):
    idx, ex, rng = serving

    async def go():
        async with AsyncServingEngine(idx, executor=ex,
                                      faults=False) as eng:
            bad = [
                Request(np.zeros(idx.dim, np.float32), 0.0, 1.0, k=0),
                Request(np.zeros(idx.dim, np.float32), 0.0, 1.0, k=64),
                Request(np.zeros(idx.dim + 1, np.float32), 0.0, 1.0, k=5),
                Request(np.full(idx.dim, np.nan, np.float32), 0.0, 1.0,
                        k=5),
                Request(np.zeros(idx.dim, np.float32), 5.0, 1.0, k=5),
                Request(np.zeros(idx.dim, np.float32), np.nan, 1.0, k=5),
            ]
            for r in bad:
                with pytest.raises(InvalidRequestError):
                    await eng.submit(r)
            assert eng.stats["submitted"] == 0
            # the engine still serves clean traffic afterwards
            res = await eng.submit(_req(rng, idx))
            assert isinstance(res, Result)

    asyncio.run(go())


def test_expired_queued_requests_shed_before_compute(serving):
    """While a latency spike burns inside one flush (worker thread), a
    short-deadline queued request expires: the reaper sheds it and it
    never reaches the executor (dispatched stays at the first batch)."""
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=_stall(1.0),
            serve=ServeConfig(deadline_s=5.0, max_wait_s=0.0,
                              deadline_margin_s=0.0),
        )
        first = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.2)     # flusher is now asleep in the spike
        with pytest.raises(ShedError):
            await eng.submit(_req(rng, idx), deadline_s=0.1)
        assert eng.stats["shed"] == 1
        assert eng.stats["dispatched"] == 1   # the shed one never ran
        assert isinstance(await first, Result)
        await eng.aclose()
        return eng.stats

    stats = asyncio.run(go())
    assert stats["served"] == 1


def test_shed_expired_false_times_out_instead(serving):
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=_stall(1.0),
            serve=ServeConfig(deadline_s=5.0, max_wait_s=0.0,
                              deadline_margin_s=0.0, shed_expired=False),
        )
        first = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.2)
        with pytest.raises(DeadlineExceededError):
            await eng.submit(_req(rng, idx), deadline_s=0.1)
        assert eng.stats["shed"] == 0
        await first
        await eng.aclose()

    asyncio.run(go())


def test_inflight_deadline_fires_during_latency_spike(serving):
    """The reaper delivers DeadlineExceededError while the flush is still
    running in its worker thread — an executor stall cannot freeze timeout
    delivery. The late result is counted, not double-delivered."""
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=_stall(0.6),
            serve=ServeConfig(deadline_s=0.2, max_wait_s=0.0,
                              deadline_margin_s=0.0),
        )
        with pytest.raises(DeadlineExceededError):
            await eng.submit(_req(rng, idx))
        assert eng.stats["timeouts"] == 1
        # let the spiking flush finish: its result must be counted late,
        # not delivered into the already-failed future
        await asyncio.sleep(0.8)
        assert eng.stats["late_results"] == 1
        assert eng.stats["served"] == 0
        await eng.aclose()

    asyncio.run(go())


def test_backpressure_reject(serving):
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=_stall(0.8),
            serve=ServeConfig(deadline_s=5.0, max_queue=1, max_wait_s=0.0,
                              deadline_margin_s=0.0, backpressure="reject"),
        )
        # 1st occupies the flusher (spike), 2nd fills the queue, 3rd must
        # be rejected at admission without ever queueing
        t1 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.2)
        t2 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.05)
        with pytest.raises(OverloadedError):
            await eng.submit(_req(rng, idx))
        assert eng.stats["rejected"] == 1
        assert isinstance(await t1, Result)
        assert isinstance(await t2, Result)
        await eng.aclose()

    asyncio.run(go())


def test_backpressure_block_waits_for_space(serving):
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=_stall(0.4),
            serve=ServeConfig(deadline_s=5.0, max_queue=1, max_wait_s=0.0,
                              deadline_margin_s=0.0, backpressure="block"),
        )
        t1 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.1)
        t2 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.05)
        # blocks while the queue is full, then admits once it drains
        t3 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        out = await asyncio.gather(t1, t2, t3)
        assert all(isinstance(r, Result) for r in out)
        assert eng.stats["rejected"] == 0
        await eng.aclose()

    asyncio.run(go())


def test_backpressure_block_respects_deadline(serving):
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=_stall(1.0),
            serve=ServeConfig(deadline_s=5.0, max_queue=1, max_wait_s=0.0,
                              deadline_margin_s=0.0, backpressure="block"),
        )
        t1 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.2)
        t2 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.05)
        with pytest.raises(DeadlineExceededError):
            await eng.submit(_req(rng, idx), deadline_s=0.1)
        await asyncio.gather(t1, t2)
        await eng.aclose()

    asyncio.run(go())


def test_aclose_drains_pending(serving):
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=False,
            serve=ServeConfig(deadline_s=5.0, max_wait_s=5.0),
        )
        # long max_wait: these would linger, but aclose must flush them
        tasks = [asyncio.ensure_future(eng.submit(_req(rng, idx)))
                 for _ in range(3)]
        await asyncio.sleep(0.05)
        await eng.aclose(drain=True)
        out = await asyncio.gather(*tasks)
        assert all(isinstance(r, Result) for r in out)
        assert eng.stats["shutdown"] == 0
        with pytest.raises(ShutdownError):
            await eng.submit(_req(rng, idx))

    asyncio.run(go())


def test_aclose_no_drain_fails_fast(serving):
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=_stall(1.0),
            serve=ServeConfig(deadline_s=5.0, max_wait_s=0.0,
                              deadline_margin_s=0.0),
        )
        t1 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.2)   # t1 in flight (spiking), t2 queued
        t2 = asyncio.ensure_future(eng.submit(_req(rng, idx)))
        await asyncio.sleep(0.05)
        await eng.aclose(drain=False)
        with pytest.raises(ShutdownError):
            await t2
        # the in-flight request fails fast too: exactly one outcome each
        with pytest.raises(ShutdownError):
            await t1
        assert eng.stats["shutdown"] == 2

    asyncio.run(go())


def test_deadline_margin_flushes_early(serving):
    """With a huge max_wait the loop would linger for 30 s; the deadline
    margin forces the flush in time to serve the request."""
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=False,
            serve=ServeConfig(deadline_s=1.0, max_wait_s=30.0,
                              deadline_margin_s=0.8),
        )
        res = await eng.submit(_req(rng, idx))
        assert isinstance(res, Result)
        await eng.aclose()

    asyncio.run(go())


def test_full_batch_flushes_immediately(serving):
    idx, ex, rng = serving

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=False,
            serve=ServeConfig(deadline_s=30.0, max_wait_s=30.0,
                              deadline_margin_s=0.1),
        )
        # max_batch (4) submissions: the loop must not wait out max_wait_s
        out = await asyncio.wait_for(
            asyncio.gather(*(eng.submit(_req(rng, idx))
                             for _ in range(ex.max_batch))),
            timeout=10.0,
        )
        assert all(isinstance(r, Result) for r in out)
        assert eng.stats["flushes"] >= 1
        await eng.aclose()

    asyncio.run(go())


# -- against repro ------------------------------------------------------------

def test_loop_agrees_with_repro(pair, serving):
    """The same 32 requests through ``repro``'s loop and the port's."""
    jidx, idx = pair
    _, ex, _ = serving
    rng = np.random.default_rng(17)
    q = rng.standard_normal((32, idx.dim)).astype(np.float32)
    lo = rng.uniform(0, 60, 32)
    hi = lo + rng.uniform(10, 40, 32)
    serve = dict(deadline_s=60.0, max_queue=64)
    jex = JSearchExecutor(jidx, JSearchConfig(ef=32, k_bucket=10),
                          max_batch=4, warmup=False)

    async def go(eng, cls):
        async with eng:
            return await asyncio.gather(*(
                eng.submit(cls(q[i], lo[i], hi[i], k=10))
                for i in range(32)))

    want = asyncio.run(go(JAsyncServingEngine(
        jidx, executor=jex, faults=False, serve=JServeConfig(**serve)),
        JRequest))
    got = asyncio.run(go(AsyncServingEngine(
        idx, executor=ex, faults=False, serve=ServeConfig(**serve)),
        Request))
    want = np.stack([r.ids for r in want])
    got = np.stack([r.ids for r in got])
    L, R = idx.ranks_of(lo, hi)
    gt = idx.original_ids(idx.brute_force(q, L, R, k=10)[0])
    agree = _agreement(got, want)
    print(f"loop id agreement with repro {agree:.4f}; recall@10 port "
          f"{recall(got, gt):.4f}, repro {recall(want, gt):.4f}")
    assert agree >= 0.95
    assert abs(recall(got, gt) - recall(want, gt)) <= 0.01


def test_serve_slo_leg_accounts_for_every_request(serving):
    """``bench/serve_slo.py``'s leg on the CPU: every offered request
    resolves exactly once, the outcomes reconcile with the engine's
    counts, and the flushes' searches were timed."""
    idx, ex, _ = serving
    wl = make_workload(idx, "mixed", n_queries=16, seed=3)
    cfg = serve_slo.serve_config(100.0, max_batch=ex.max_batch,
                                 deadline_s=1.0)
    served = []
    leg = asyncio.run(serve_slo.run_leg(
        idx, ex, wl, qps=100.0, duration_s=0.5, serve_cfg=cfg, faults=False,
        k=10, seed=1, served=served))
    assert leg["lost"] == 0 and leg["resolved"] == leg["offered"] > 0
    assert sum(leg[kind] for kind in serve_slo.OUTCOMES) == leg["offered"]
    assert leg["ok"] == len(served) == leg["engine"]["served"]
    # a flush still running when the leg's last request resolved is not
    # timed: the leg closes without waiting for its worker thread
    assert 0 < leg["search_ms"]["n"] <= leg["engine"]["flushes"]
    assert all(isinstance(r, Result) and 0 <= i < 16 for i, r in served)


def test_zero_post_warmup_entries_across_module(serving):
    """Runs last (file order): every flush in this file — partial batches,
    mixed arrival patterns, spikes, drains, two threads — stayed on the
    warmed grid."""
    idx, ex, rng = serving
    assert ex.stats["compiles"] == ex.stats["warmup_compiles"] > 0
