"""Chaos soak of the port's async serving loop (counterparts of
``tests/test_chaos.py``), on the CPU.

Under injected latency spikes, flush exceptions and queue-full bursts at
overload QPS, (1) every request resolves with exactly one typed terminal
outcome, (2) expired requests are shed before they reach compute, (3) the
executor adds no cache entry after warmup, whatever the arrival pattern
the faults produce.

The index is the port's own CPU build (n=256, d=12, m=8; the loop's
parity with ``repro`` is ``tests/test_torch_loop.py``). ``repro``'s soak
races 0.1 s spikes against a 0.12 s deadline and depends on the host's
timing; here every injected latency ends at least 0.1 s away from the
deadline it races, and every request expected to be served has a
deadline of 1 s or more. The injector is seeded; the soak offers its
120 requests and goes on (up to 2,000) until every fault kind has fired,
since how many flushes the faults get depends on the host's speed.
"""
import asyncio

import numpy as np
import pytest

from repro_torch import BuildConfig, RangeGraphIndex, SearchConfig, \
    ServeConfig
from repro_torch.serve import (
    AsyncServingEngine,
    DeadlineExceededError,
    FaultConfig,
    FaultInjector,
    InjectedFaultError,
    OverloadedError,
    Request,
    Result,
    SearchExecutor,
    ServingEngine,
    ShedError,
    ShutdownError,
)

CFG = SearchConfig(ef=32, k_bucket=10)


@pytest.fixture(scope="module")
def serving():
    rng = np.random.default_rng(47)
    n, d = 256, 12
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    attrs = rng.uniform(0, 100, n)
    idx = RangeGraphIndex.build(
        vectors, attrs, BuildConfig(m=8, ef_construction=32,
                                    brute_threshold=32), device="cpu")
    ex = SearchExecutor(idx, CFG, max_batch=4, warmup=True)
    return idx, ex, rng


def _req(rng, idx, k=5):
    v = rng.standard_normal(idx.dim).astype(np.float32)
    lo, hi = sorted(rng.uniform(0, 100, 2))
    return Request(vector=v, lo=lo, hi=hi, k=k)


def test_chaos_soak_exactly_once(serving):
    idx, ex, rng = serving
    faults = FaultInjector(FaultConfig(
        kinds=("latency", "flush_error", "queue_full"),
        latency_s=0.1, latency_rate=0.3,
        flush_error_rate=0.2, queue_full_rate=0.2, seed=11,
    ))
    N, N_MAX = 120, 2000
    deadline = 0.3   # 0.2 s past a spike

    async def fire(eng, r):
        try:
            res = await eng.submit(r, deadline_s=deadline)
            assert isinstance(res, Result)
            return "ok"
        except OverloadedError:
            return "rejected"
        except ShedError:
            return "shed"
        except DeadlineExceededError:
            return "timeout"
        except ShutdownError:
            return "shutdown"
        except InjectedFaultError:
            return "failed"
        # anything else propagates and fails the test: outcomes are typed

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=faults,
            serve=ServeConfig(deadline_s=deadline, max_queue=32,
                              max_wait_s=0.005, deadline_margin_s=0.02,
                              backpressure="reject"),
        )
        tasks = []
        # ~500 qps offered (overload) for N requests, and on until every
        # fault kind has fired: a slow host makes fewer flushes a second
        while len(tasks) < N or (len(tasks) < N_MAX and not (
                min(faults.counts.values()) > 0
                and eng.stats["flush_failures"] > 0)):
            tasks.append(asyncio.ensure_future(fire(eng, _req(rng, idx))))
            await asyncio.sleep(0.002)
        outcomes = await asyncio.gather(*tasks)
        await eng.aclose(drain=True)
        return outcomes, eng.stats

    outcomes, stats = asyncio.run(go())

    # exactly-once: every submit produced one typed outcome
    assert N <= len(outcomes) < N_MAX
    counts = {o: outcomes.count(o) for o in set(outcomes)}
    assert sum(counts.values()) == len(outcomes) == stats["submitted"] \
        + stats["rejected"]
    # caller-observed outcomes reconcile with the engine's own accounting
    assert counts.get("ok", 0) == stats["served"]
    assert counts.get("shed", 0) == stats["shed"]
    assert counts.get("rejected", 0) == stats["rejected"]
    assert counts.get("failed", 0) == stats["failed"]
    assert counts.get("timeout", 0) == stats["timeouts"]
    assert counts.get("shutdown", 0) == stats["shutdown"]
    # shed before compute: a shed request was never part of a dispatch
    assert stats["shed"] + stats["dispatched"] <= stats["submitted"]
    # the chaos actually happened (seeded)
    assert faults.counts["latency"] > 0
    assert faults.counts["flush_error"] > 0
    assert faults.counts["queue_full"] > 0
    assert stats["flush_failures"] > 0
    # and through all of it, batch formation stayed on the warmed grid
    assert ex.stats["compiles"] == ex.stats["warmup_compiles"]


def test_flush_error_isolation_async(serving):
    """An injected flush failure fails only its own flush's requests; the
    next submit on the same engine serves normally."""
    idx, ex, rng = serving
    faults = FaultInjector(FaultConfig(kinds=("flush_error",),
                                       flush_error_rate=1.0))

    async def go():
        eng = AsyncServingEngine(
            idx, executor=ex, faults=faults,
            serve=ServeConfig(deadline_s=5.0, max_wait_s=0.0,
                              deadline_margin_s=0.0),
        )
        with pytest.raises(InjectedFaultError):
            await eng.submit(_req(rng, idx))
        assert eng.stats["flush_failures"] == 1
        faults.armed = False
        res = await eng.submit(_req(rng, idx))   # regression: still alive
        assert isinstance(res, Result)
        await eng.aclose()
        assert eng.stats["served"] == 1
        assert eng.stats["failed"] == 1

    asyncio.run(go())


def test_env_faults_reach_only_the_async_loop(serving, monkeypatch):
    """RTORCH_FAULTS arms the async loop by default but never the sync
    engine/executor — deterministic suites stay deterministic."""
    idx, ex, rng = serving
    monkeypatch.setenv("RTORCH_FAULTS", "flush_error")
    monkeypatch.setenv("RTORCH_FAULT_FLUSH_ERROR_RATE", "1.0")

    async def go():
        eng = AsyncServingEngine(idx, executor=ex)   # faults=None: env
        with pytest.raises(InjectedFaultError):
            await eng.submit(_req(rng, idx))
        await eng.aclose()

    asyncio.run(go())
    sync = ServingEngine(idx, executor=ex)           # env must NOT attach
    assert sync.faults is None
    sync.submit(_req(rng, idx))
    assert isinstance(sync.flush()[0], Result)
