"""Deadline-aware async serving loop: the overload-safe front-end (port of
``repro/serve/loop.py``).

``ServingEngine`` (serve/engine.py) is a synchronous, caller-driven queue —
fine when the caller owns the clock, wrong for open traffic: one slow flush
stalls everything behind it, nothing bounds the queue, and a request has no
deadline. :class:`AsyncServingEngine` is the JetStream-style loop on top of
the same warmed ``SearchExecutor``:

  * **One terminal outcome per request.** ``await submit(req)`` resolves
    with exactly one of {``Result``, ``InvalidRequestError``,
    ``OverloadedError``, ``ShedError``, ``DeadlineExceededError``,
    ``ShutdownError``, the flush's own exception} — futures are the source
    of truth and every resolution path checks ``fut.done()`` first, so a
    request can never be lost or resolved twice (the chaos suite pins
    this under injected faults at overload).
  * **Admission control + backpressure.** A bounded queue
    (``ServeConfig.max_queue``); when full, ``"reject"`` fails the submit
    with ``OverloadedError`` immediately and ``"block"`` awaits space up
    to the request's deadline.
  * **Deadline-aware batch formation.** The background flush task lingers
    up to ``max_wait_s`` growing the batch toward the executor's bucket /
    ``max_batch`` under load, but flushes early when the oldest request is
    within ``deadline_margin_s`` of its deadline — and immediately when
    the batch is full.
  * **Load shedding before compute.** Requests whose deadline expired
    while still queued are shed (``ShedError``) at formation/reap time and
    never reach the executor; in-flight requests whose deadline passes
    resolve with ``DeadlineExceededError`` from the reaper task while the
    flush keeps running in a worker thread (``asyncio.to_thread``), so an
    executor latency spike cannot freeze timeout delivery.
  * **Graceful drain.** ``aclose(drain=True)`` serves what it can within
    ``drain_timeout_s`` and fails the rest fast with ``ShutdownError``;
    ``drain=False`` fails everything pending immediately. Nothing is ever
    silently dropped.

Batch formation (``plan_flush``) and the batch runner
(``run_search_batch``, which hosts the fault-injection hooks of
``serve/faults.py``) are shared with the sync engine. ``faults=None``
(default) resolves the ``RTORCH_FAULTS`` env.

The loop adds no device logic: the index's device decides where the
search runs, and the worker thread launches on that device's default
stream, as the caller's thread does (nothing here sets another stream, so
a flush's copies and kernels stay in one order). Two things differ from
``repro``, whose flush is one compiled call:

  * the flush thread runs the port's host-side beam loop, Python that
    holds the GIL between torch calls, so the reaper and the submitters
    wait for it: a timeout is delivered late by up to a switch interval
    or a torch call (``chip_smoke.py`` prints that lateness);
  * the port's kernels build at their first launch, so warm the executor
    (``warmup``) on the caller's thread before the loop serves: then no
    flush builds a kernel or adds a cache entry.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.config import SearchConfig, ServeConfig
from repro_torch.serve import faults as faults_mod
from repro_torch.serve.engine import Request, Result, plan_flush, \
    run_search_batch, validate_request
from repro_torch.serve.errors import DeadlineExceededError, \
    OverloadedError, ShedError, ShutdownError
from repro_torch.serve.executor import SearchExecutor

__all__ = ["AsyncServingEngine"]


@dataclasses.dataclass(eq=False)   # identity semantics: lives in a set
class _Pending:
    req: Request
    fut: asyncio.Future
    t_submit: float     # monotonic
    deadline: float     # monotonic


class AsyncServingEngine:
    def __init__(
        self, index, *, config: SearchConfig | None = None,
        serve: ServeConfig | None = None, max_batch: int = 64,
        executor: SearchExecutor | None = None, warmup: bool | None = None,
        faults=None,
    ):
        """config: the query-pipeline ``SearchConfig`` (forwarded to a new
        executor). serve: the loop's ``ServeConfig`` policy (deadlines,
        queue bound, backpressure, linger). executor: share a prebuilt
        warmed ``SearchExecutor`` (its config/max_batch win; it is left
        open on close). faults: see ``serve/faults.py::resolve`` — None
        picks up ``RTORCH_FAULTS``, False disables injection."""
        self.index = index
        self.serve = serve or ServeConfig()
        self._owns_executor = executor is None
        if executor is None:
            executor = SearchExecutor(
                index, config or SearchConfig(), max_batch=max_batch,
                warmup=warmup,
            )
        elif warmup:
            executor.warmup()
        self.executor = executor
        self.config = executor.config
        self.faults = faults_mod.resolve(faults)
        self.closed = False
        self._pending: deque[_Pending] = deque()
        self._inflight: set[_Pending] = set()
        self._flusher: asyncio.Task | None = None
        self._reaper: asyncio.Task | None = None
        self._wake = asyncio.Event()        # flusher: new work arrived
        self._reap_wake = asyncio.Event()   # reaper: deadlines changed
        self._space = asyncio.Event()       # blocked submitters: queue shrank
        self._idle = asyncio.Event()        # drain: nothing pending/in flight
        self._latencies: deque[float] = deque(maxlen=8192)
        self._counts = {
            "submitted": 0, "served": 0, "rejected": 0, "shed": 0,
            "timeouts": 0, "failed": 0, "shutdown": 0, "dispatched": 0,
            "flushes": 0, "flush_failures": 0, "late_results": 0,
        }

    # -- lifecycle -----------------------------------------------------------
    def _ensure_started(self):
        if self._flusher is None or self._flusher.done():
            loop = asyncio.get_running_loop()
            self._flusher = loop.create_task(self._flush_loop())
            self._reaper = loop.create_task(self._reap_loop())

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.aclose()

    async def aclose(self, *, drain: bool = True):
        """Stop accepting requests; resolve every pending one.

        drain=True keeps flushing (and shedding/timing out per deadline)
        for up to ``serve.drain_timeout_s``; whatever is still unresolved
        then — and everything, immediately, under drain=False — fails fast
        with ``ShutdownError``. Exactly one outcome per request holds
        through shutdown."""
        if self.closed:
            return
        self.closed = True
        if self._flusher is not None:
            self._wake.set()
            self._space.set()   # blocked submitters observe closed
            self._maybe_idle()
            if drain:
                try:
                    await asyncio.wait_for(
                        self._idle.wait(), self.serve.drain_timeout_s
                    )
                except asyncio.TimeoutError:
                    pass
            for p in list(self._pending) + list(self._inflight):
                if not p.fut.done():
                    self._counts["shutdown"] += 1
                    p.fut.set_exception(
                        ShutdownError("engine closed before serving request")
                    )
            self._pending.clear()
            for t in (self._flusher, self._reaper):
                t.cancel()
            await asyncio.gather(
                self._flusher, self._reaper, return_exceptions=True
            )
        if self._owns_executor:
            self.executor.close()

    # -- submission ----------------------------------------------------------
    async def submit(self, req: Request, *, deadline_s: float | None = None):
        """Admit, enqueue and await one request's terminal outcome.

        Validation failures, admission rejections and backpressure
        timeouts raise here (the request never queues); everything else
        resolves through the request's future."""
        if self.closed:
            raise ShutdownError("AsyncServingEngine is closed")
        validate_request(req, dim=self.index.dim, ef=self.config.ef)
        self._ensure_started()
        now = time.monotonic()
        budget = self.serve.deadline_s if deadline_s is None \
            else float(deadline_s)
        if not budget > 0.0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        deadline = now + budget
        await self._admit(deadline)
        p = _Pending(
            req, asyncio.get_running_loop().create_future(),
            time.monotonic(), deadline,
        )
        self._pending.append(p)
        self._counts["submitted"] += 1
        self._wake.set()
        self._reap_wake.set()
        return await p.fut

    async def _admit(self, deadline: float):
        """Admission control: bounded queue + the backpressure policy.
        ``queue_full`` faults force the full path for one check (a burst)."""
        while True:
            if self.closed:
                raise ShutdownError("AsyncServingEngine is closed")
            full = len(self._pending) >= self.serve.max_queue
            burst = (not full and self.faults is not None
                     and self.faults.queue_full())
            if not full and not burst:
                return
            if self.serve.backpressure == "reject":
                self._counts["rejected"] += 1
                raise OverloadedError(
                    f"queue full ({len(self._pending)}/"
                    f"{self.serve.max_queue})"
                )
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._counts["timeouts"] += 1
                raise DeadlineExceededError(
                    "deadline expired while blocked on backpressure"
                )
            # a fault burst is transient: recheck quickly instead of
            # waiting for real queue space that may never be signalled
            self._space.clear()
            try:
                await asyncio.wait_for(
                    self._space.wait(),
                    min(remaining, 0.005) if burst else remaining,
                )
            except asyncio.TimeoutError:
                pass

    # -- background tasks ----------------------------------------------------
    async def _flush_loop(self):
        while True:
            now = time.monotonic()
            self._compact_queue(now)
            if not self._pending:
                self._maybe_idle()
                if self.closed:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            oldest = self._pending[0]
            due = min(
                oldest.t_submit + self.serve.max_wait_s,
                oldest.deadline - self.serve.deadline_margin_s,
            )
            if (len(self._pending) >= self.executor.max_batch
                    or now >= due or self.closed):
                await self._flush_once()
            else:
                # linger: grow the batch toward the bucket under load, but
                # wake on new arrivals (they may fill the batch early)
                self._wake.clear()
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), max(due - now, 0.0)
                    )
                except asyncio.TimeoutError:
                    pass

    async def _flush_once(self):
        take: list[_Pending] = []
        while self._pending and len(take) < self.executor.max_batch:
            p = self._pending.popleft()
            if not p.fut.done():   # shed/timed-out entries never dispatch
                take.append(p)
        self._space.set()
        if not take:
            return
        plans = plan_flush(
            [p.req for p in take], self.config, self.executor.max_batch
        )
        self._inflight.update(take)
        for kb, idxs in plans:
            batch = [take[i] for i in idxs]
            self._counts["flushes"] += 1
            self._counts["dispatched"] += len(batch)
            try:
                orig, dists = await asyncio.to_thread(
                    run_search_batch, self.index, self.executor,
                    [p.req for p in batch], kb, faults=self.faults,
                )
            except Exception as e:  # noqa: BLE001 — isolate to this batch
                self._counts["flush_failures"] += 1
                for p in batch:
                    self._inflight.discard(p)
                    if not p.fut.done():
                        self._counts["failed"] += 1
                        p.fut.set_exception(e)
                continue
            t1 = time.monotonic()
            for row, p in enumerate(batch):
                self._inflight.discard(p)
                if p.fut.done():   # timed out while the flush ran
                    self._counts["late_results"] += 1
                    continue
                lat = t1 - p.t_submit
                self._latencies.append(lat)
                self._counts["served"] += 1
                p.fut.set_result(Result(
                    orig[row, : p.req.k], dists[row, : p.req.k], lat
                ))
        self._maybe_idle()

    async def _reap_loop(self):
        """Deadline watcher: sheds expired queued requests and times out
        expired in-flight ones — independent of the flusher, so a latency
        spike inside a flush cannot delay timeout delivery."""
        while True:
            now = time.monotonic()
            nxt = self._compact_queue(now)
            for p in self._inflight:
                if p.fut.done():
                    continue
                if p.deadline <= now:
                    self._counts["timeouts"] += 1
                    p.fut.set_exception(DeadlineExceededError(
                        "deadline exceeded while request was in flight"
                    ))
                elif nxt is None or p.deadline < nxt:
                    nxt = p.deadline
            self._maybe_idle()
            self._reap_wake.clear()
            try:
                if nxt is None:
                    await self._reap_wake.wait()
                else:
                    await asyncio.wait_for(
                        self._reap_wake.wait(), max(nxt - now, 1e-3)
                    )
            except asyncio.TimeoutError:
                pass

    def _compact_queue(self, now: float):
        """Resolve expired queued entries (shed before compute) and drop
        resolved ones; returns the earliest remaining queued deadline."""
        nxt = None
        keep: deque[_Pending] = deque()
        shrank = False
        while self._pending:
            p = self._pending.popleft()
            if p.fut.done():
                shrank = True
                continue
            if p.deadline <= now:
                shrank = True
                if self.serve.shed_expired:
                    self._counts["shed"] += 1
                    p.fut.set_exception(ShedError(
                        "deadline expired while queued; shed before compute"
                    ))
                else:
                    self._counts["timeouts"] += 1
                    p.fut.set_exception(DeadlineExceededError(
                        "deadline expired while queued"
                    ))
                continue
            keep.append(p)
            if nxt is None or p.deadline < nxt:
                nxt = p.deadline
        self._pending = keep
        if shrank:
            self._space.set()
        return nxt

    def _maybe_idle(self):
        if self.closed and not self._pending and not any(
            not p.fut.done() for p in self._inflight
        ):
            self._idle.set()

    # -- stats ---------------------------------------------------------------
    @property
    def stats(self) -> dict:
        ex = self.executor.stats
        lat = np.fromiter(self._latencies, float) if self._latencies else None
        pct = {
            f"latency_p{p}": float(np.percentile(lat, p)) if lat is not None
            else 0.0
            for p in (50, 95, 99)
        }
        return {
            **self._counts,
            "queue_depth": len(self._pending),
            "compiles": ex["compiles"],
            "warmup_compiles": ex["warmup_compiles"],
            "cache_hits": ex["cache_hits"],
            "index_bytes": ex["index_bytes"],
            **pct,
        }
