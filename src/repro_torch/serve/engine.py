"""RFANN serving engine: request batching over a SearchExecutor (port of
``repro/serve/engine.py``; the async loop, ``serve/loop.py``, shares its
:func:`plan_flush` and :func:`run_search_batch`).

Mirrors a production vector-search frontend: requests (vector + value range
+ k) accumulate in a queue; ``flush`` groups them by k bucket (so one
``k=ef`` straggler stops inflating everyone's top-k), cuts each group into
``max_batch``-sized batches, and hands them to the executor — which pads to
power-of-two batch buckets and serves each (config, batch_bucket, k_bucket)
from its cache (``serve/executor.py``). The engine itself is only
queueing + per-request stats:

  * ``Result.latency_s`` is the request's OWN queue+batch time (submit ->
    result), not the whole-batch wall time;
  * ``stats`` exposes latency percentiles (p50/p95/p99 over the last 8192
    requests — a bounded window, so long-running engines stay O(1) memory
    and the numbers track *recent* traffic), the executor's cache counts,
    qps, and the served index's real footprint
    (``index_bytes``) — a compact-storage index (``core/storage.py``)
    serves unchanged, decoding at the search edge.

Robustness contract (DESIGN.md §8):

  * ``submit`` validates at the edge — NaN/Inf vectors, wrong
    dimensionality, ``k <= 0``, ``k > ef``, inverted ranges all raise
    ``InvalidRequestError`` (a ``ValueError``) BEFORE queueing, so one bad
    request can never poison a batch;
  * ``flush`` isolates batch failures: an exception while running one
    batch fails only that batch's requests (their slots in the returned
    list hold the exception instance) and the engine stays serviceable;
  * ``close(drain=...)`` never silently drops pending requests — they are
    served (drain) or failed fast with ``ShutdownError``.

The flush-formation logic (:func:`plan_flush`) and the batch runner
(:func:`run_search_batch`, with the fault-injection hooks of
``serve/faults.py``) are module functions, as in ``repro``: the async
serving loop (``serve/loop.py``) shares them, and runs the batch runner in
a worker thread.

Engine knobs arrive as ONE ``SearchConfig``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.config import SearchConfig
from repro_torch.core.index import RangeGraphIndex
from repro_torch.serve import faults as faults_mod
from repro_torch.serve.errors import InvalidRequestError, ShutdownError
from repro_torch.serve.executor import SearchExecutor

__all__ = [
    "Request",
    "Result",
    "ServingEngine",
    "plan_flush",
    "run_search_batch",
    "validate_request",
]


@dataclasses.dataclass
class Request:
    vector: np.ndarray
    lo: float
    hi: float
    k: int = 10


@dataclasses.dataclass
class Result:
    ids: np.ndarray         # original object ids
    dists: np.ndarray
    latency_s: float        # this request's queue + batch time


def validate_request(req: Request, *, dim: int, ef: int):
    """Edge validation (shared by the sync engine and the async loop).

    Raises :class:`InvalidRequestError` (a ``ValueError``) so a malformed
    request fails its own submit instead of poisoning a whole batch. Open
    ranges (``lo=-inf`` / ``hi=+inf``) are legal; NaN bounds and inverted
    ranges are not.
    """
    k = int(req.k)
    if k < 1:
        raise InvalidRequestError(f"requested k={req.k} must be >= 1")
    if k > ef:
        raise InvalidRequestError(
            f"requested k={req.k} exceeds the engine's ef={ef}; "
            f"raise ef or lower k"
        )
    v = np.asarray(req.vector)
    if v.ndim != 1 or v.shape[0] != dim:
        raise InvalidRequestError(
            f"query vector shape {v.shape} does not match index dim ({dim},)"
        )
    if not np.isfinite(v).all():
        raise InvalidRequestError("query vector contains NaN/Inf")
    lo, hi = float(req.lo), float(req.hi)
    if np.isnan(lo) or np.isnan(hi):
        raise InvalidRequestError("range bounds must not be NaN")
    if lo > hi:
        raise InvalidRequestError(f"inverted range: lo={lo} > hi={hi}")


def plan_flush(
    reqs, config: SearchConfig, max_batch: int
) -> list[tuple[int, list[int]]]:
    """Form batches from queued requests: group indices by k bucket, cut
    each group into ``max_batch`` chunks. Returns ``[(k_bucket, indices)]``
    covering every input index exactly once — the ONE batch-formation rule
    shared by ``ServingEngine.flush`` and the async loop."""
    groups: dict[int, list[int]] = {}
    for i, req in enumerate(reqs):
        groups.setdefault(config.bucket_k(req.k), []).append(i)
    out = []
    for kb, idxs in groups.items():
        for s in range(0, len(idxs), max_batch):
            out.append((kb, idxs[s : s + max_batch]))
    return out


def run_search_batch(index, executor, reqs, kb, *, config=None, faults=None):
    """Run one formed batch through the executor: value->rank mapping,
    bucketed cached search, original-id mapping. Returns
    ``(orig_ids [B, kb], dists [B, kb])``.

    The fault-injection hooks fire here — ``latency`` right before the
    executor call (an executor latency spike), ``flush_error`` before any
    compute is spent — so both front-ends inject at the same point."""
    if faults is not None:
        faults.maybe_latency()
        faults.maybe_flush_error()
    q = np.stack([np.asarray(r.vector, np.float32) for r in reqs])
    lo = np.array([r.lo for r in reqs])
    hi = np.array([r.hi for r in reqs])
    L, R = index.ranks_of(lo, hi)
    res = executor.search_ranks(q, L, R, k=kb, config=config)
    # outside the executor's lock: the result tensors are fresh, never a
    # cache entry's buffers, so another thread's next search cannot write
    # them; and every thread launches on the device's default stream
    # (none sets another), so these copies wait for this search's kernels
    ids = res.ids.cpu().numpy()
    dists = res.dists.cpu().numpy()
    return index.original_ids(ids), dists


class ServingEngine:
    def __init__(
        self, index: RangeGraphIndex, *, config: SearchConfig | None = None,
        max_batch: int = 64, executor: SearchExecutor | None = None,
        warmup: bool = False, faults=False,
    ):
        """config: the engine's ``SearchConfig`` (defaults when None).
        executor: share a prebuilt ``SearchExecutor``
        (its config/max_batch win). warmup: fill the executor's grid now —
        forwarded to a newly built executor and, when True, also applied
        to a prebuilt one. faults: a ``FaultConfig``/``FaultInjector`` to
        inject failures into flushes; the sync engine never picks faults
        up from the env (see ``serve/faults.py``)."""
        config = config or SearchConfig()
        self.index = index
        self._owns_executor = executor is None
        if executor is None:
            executor = SearchExecutor(
                index, config, max_batch=max_batch, warmup=warmup
            )
        elif warmup:
            executor.warmup()
        self.executor = executor
        self.config = self.executor.config
        self.faults = faults_mod.resolve(faults) if faults else None
        self.closed = False
        self._queue: list[tuple[Request, float]] = []
        # bounded window: percentiles track recent traffic at O(1) memory
        self._latencies: deque[float] = deque(maxlen=8192)
        self._counts = {
            "served": 0, "batches": 0, "wall_s": 0.0,
            "failed": 0, "flush_failures": 0,
        }

    @property
    def max_batch(self) -> int:
        return self.executor.max_batch

    def warmup(self, **kw) -> int:
        """Fill the executor's cache grid (see ``SearchExecutor.warmup``);
        afterwards any mixed workload inside the grid serves with zero new
        cache entries."""
        return self.executor.warmup(**kw)

    def submit(self, req: Request):
        """Validate at the request boundary — once a request is queued,
        flush must be able to serve (or individually fail) the whole
        queue. Raises ``InvalidRequestError`` on a malformed request and
        ``ShutdownError`` after ``close()``."""
        if self.closed:
            raise ShutdownError("ServingEngine is closed")
        validate_request(req, dim=self.index.dim, ef=self.config.ef)
        self._queue.append((req, time.perf_counter()))

    def flush(self) -> list:
        """Serve the queue: group by k bucket, batch up to ``max_batch``,
        pad to the executor's batch buckets. Returns one entry per queued
        request in submission order — a ``Result``, or (error isolation)
        the exception that failed its batch: a failing flush takes down
        only its own batch's requests and the engine stays serviceable."""
        queue, self._queue = self._queue, []
        out: list = [None] * len(queue)
        for kb, idxs in plan_flush(
            [req for req, _ in queue], self.config, self.max_batch
        ):
            try:
                self._run_batch(queue, idxs, kb, out)
            except Exception as e:  # noqa: BLE001 — isolate to this batch
                self._counts["flush_failures"] += 1
                self._counts["failed"] += len(idxs)
                for i in idxs:
                    out[i] = e
        return out  # fully populated: every queue index was in one batch

    def _run_batch(self, queue, idxs, kb, out):
        t0 = time.perf_counter()
        reqs = [queue[i][0] for i in idxs]
        orig, dists = run_search_batch(
            self.index, self.executor, reqs, kb, faults=self.faults
        )
        t1 = time.perf_counter()
        self._counts["served"] += len(reqs)
        self._counts["batches"] += 1
        self._counts["wall_s"] += t1 - t0
        for row, i in enumerate(idxs):
            req, t_submit = queue[i]
            lat = t1 - t_submit
            self._latencies.append(lat)
            out[i] = Result(orig[row, : req.k], dists[row, : req.k], lat)

    def close(self, *, drain: bool = True) -> list:
        """Stop accepting requests; never silently drop pending ones.

        drain=True serves the pending queue (one last ``flush``) and
        returns its results; drain=False fails each pending request fast —
        the returned list holds one ``ShutdownError`` per dropped request.
        Idempotent; a shared (caller-provided) executor is left open."""
        if self.closed:
            return []
        self.closed = True
        if drain:
            out = self.flush()
        else:
            pending, self._queue = self._queue, []
            out = [
                ShutdownError("ServingEngine closed before serving request")
                for _ in pending
            ]
            self._counts["failed"] += len(pending)
        if self._owns_executor:
            self.executor.close()
        return out

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
            "compiles": ex["compiles"],
            "warmup_compiles": ex["warmup_compiles"],
            "cache_hits": ex["cache_hits"],
            "index_bytes": ex["index_bytes"],
            **pct,
        }

    @property
    def qps(self) -> float:
        return self._counts["served"] / max(self._counts["wall_s"], 1e-9)
