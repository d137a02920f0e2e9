"""One frozen config for the query pipeline (the port's ``SearchConfig``)
and the serving layer's bucket math.

Mirrors ``repro/core/config.py:48-240, 247-280``: ``SearchConfig`` is
frozen and hashable (a key of ``serve/executor.py``'s cache), with ``k``
per call, rounded up to a ``k_bucket`` multiple (:meth:`SearchConfig.
bucket_k`); :func:`batch_buckets` / :func:`pick_bucket` /
:func:`batch_bucket` give the power-of-two padded batch shapes. The
async serving loop's policy is :class:`ServeConfig` (fields, defaults and
messages as ``repro``'s). The backend tokens are the port's own:

  * ``dist_impl`` / ``edge_impl``: ``"auto" | "cuda" | "torch"``, and
    for ``edge_impl`` also ``"argsort"`` (the argsort formulation of
    ``core/edge_select.py``, an oracle);
  * ``hop_impl``: the same plus ``"composed"`` (the three dispatched ops
    chained, the fused hop's bit-identical oracle).

``"auto"`` resolves by the ``RTORCH_*_IMPL`` knobs, then by where the
tensors live: the hand-written kernel on a CUDA tensor, the plain torch
version on a CPU tensor (``kernels/ops.py::default_impl``).
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "SearchConfig", "ServeConfig", "batch_bucket", "batch_buckets",
    "pick_bucket",
]

_METRICS = ("l2", "ip")
_DIST_IMPLS = ("auto", "cuda", "torch")
_EDGE_IMPLS = ("auto", "cuda", "torch", "argsort")
_HOP_IMPLS = ("auto", "cuda", "torch", "composed")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Frozen query-pipeline knobs.

    ef:           dynamic candidate-list size (beam width).
    k_bucket:     requested k rounds up to the next multiple (clamped to
                  ``ef``) before it reaches the search, so mixed-k traffic
                  hits a bounded set of cache keys.
    expand_width: nodes expanded per query per beam iteration (the engine
                  clamps it to ``ef``).
    dist_impl:    gather-distance backend ("auto" | "cuda" | "torch").
    edge_impl:    edge-selection backend (same set, and "argsort").
    hop_impl:     whole-hop backend ("auto" | "cuda" | "torch" |
                  "composed"); an explicit ``dist_impl``/``edge_impl`` pin
                  routes the hop through "composed".
    metric:       "l2" | "ip".
    skip_layers:  Algorithm 1's skip-layer rule (improvised search only).
    max_iters:    beam iteration cap; None = the engine's ``4*ef + 32``.
    rerank:       top-``r`` exact refinement of the improvised search
                  (``max(k, min(rerank, ef))`` candidates re-scored against
                  the navigation vectors and re-cut to ``k``); 0 disables.
    """

    ef: int = 64
    k_bucket: int = 10
    expand_width: int = 4
    dist_impl: str = "auto"
    edge_impl: str = "auto"
    hop_impl: str = "auto"
    metric: str = "l2"
    skip_layers: bool = True
    max_iters: int | None = None
    rerank: int = 0

    def __post_init__(self):
        if int(self.ef) < 1:
            raise ValueError(f"ef must be >= 1, got {self.ef}")
        if int(self.k_bucket) < 1:
            raise ValueError(f"k_bucket must be >= 1, got {self.k_bucket}")
        if int(self.expand_width) < 1:
            raise ValueError(
                f"expand_width must be >= 1, got {self.expand_width}"
            )
        if self.metric not in _METRICS:
            raise ValueError(f"metric {self.metric!r} not in {_METRICS}")
        if self.dist_impl not in _DIST_IMPLS:
            raise ValueError(
                f"dist_impl {self.dist_impl!r} not in {_DIST_IMPLS}"
            )
        if self.edge_impl not in _EDGE_IMPLS:
            raise ValueError(
                f"edge_impl {self.edge_impl!r} not in {_EDGE_IMPLS}"
            )
        if self.hop_impl not in _HOP_IMPLS:
            raise ValueError(
                f"hop_impl {self.hop_impl!r} not in {_HOP_IMPLS}"
            )
        if self.max_iters is not None and int(self.max_iters) < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        if int(self.rerank) < 0:
            raise ValueError(f"rerank must be >= 0, got {self.rerank}")

    def replace(self, **kw) -> "SearchConfig":
        return dataclasses.replace(self, **kw)

    # -- k bucketing ---------------------------------------------------------
    def bucket_k(self, k_req: int) -> int:
        """Round a requested k up to the next ``k_bucket`` multiple,
        clamped to ``ef`` (the result list only holds ef candidates)."""
        k_req = int(k_req)
        if k_req < 1:
            raise ValueError(f"k must be >= 1, got {k_req}")
        return min(self.ef, self.k_bucket * -(-k_req // self.k_bucket))

    def k_buckets(self) -> tuple[int, ...]:
        """Every k :meth:`bucket_k` can emit: ``k_bucket`` multiples below
        ``ef``, plus the ``ef`` clamp bucket."""
        out = list(range(self.k_bucket, self.ef, self.k_bucket))
        out.append(self.ef)
        return tuple(out)


# ---------------------------------------------------------------------------
# Serving-loop policy
# ---------------------------------------------------------------------------

_BACKPRESSURE = ("reject", "block")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen policy knobs of the async serving loop (``serve/loop.py``).

    Deadlines and overload semantics are a *deployment* property, distinct
    from the query-pipeline knobs in :class:`SearchConfig` — one index can
    serve interactive traffic (tight deadline, reject) and batch traffic
    (loose deadline, block) with two loops sharing one warmed executor
    (``SearchExecutor`` serialises their searches under its lock).

    deadline_s:        default per-request deadline budget (submit ->
                       terminal outcome); ``submit(deadline_s=...)``
                       overrides per request.
    max_queue:         admission bound on *queued* (not yet in-flight)
                       requests — the backpressure trigger.
    backpressure:      full-queue policy: ``"reject"`` fails the submit
                       with ``OverloadedError`` immediately; ``"block"``
                       awaits queue space (up to the request's deadline,
                       then ``DeadlineExceededError``).
    max_wait_s:        batch-formation linger cap: a non-full batch flushes
                       once its oldest request has waited this long (under
                       load the batch grows toward the bucket/``max_batch``
                       within the linger window).
    deadline_margin_s: flush early when the oldest queued request is within
                       this margin of its deadline — the headroom reserved
                       for the flush itself.
    shed_expired:      shed already-expired queued requests with
                       ``ShedError`` before they waste a flush (False keeps
                       the per-request timeout — they resolve with
                       ``DeadlineExceededError`` instead — but never sends
                       an expired request to compute either way).
    drain_timeout_s:   ``aclose(drain=True)`` serves pending requests for
                       at most this long before failing the remainder fast
                       with ``ShutdownError``.
    """

    deadline_s: float = 0.5
    max_queue: int = 256
    backpressure: str = "reject"
    max_wait_s: float = 0.01
    deadline_margin_s: float = 0.05
    shed_expired: bool = True
    drain_timeout_s: float = 5.0

    def __post_init__(self):
        if not float(self.deadline_s) > 0.0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if int(self.max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.backpressure not in _BACKPRESSURE:
            raise ValueError(
                f"backpressure {self.backpressure!r} not in {_BACKPRESSURE}"
            )
        if float(self.max_wait_s) < 0.0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s}"
            )
        if float(self.deadline_margin_s) < 0.0:
            raise ValueError(
                f"deadline_margin_s must be >= 0, got {self.deadline_margin_s}"
            )
        if not float(self.drain_timeout_s) > 0.0:
            raise ValueError(
                f"drain_timeout_s must be > 0, got {self.drain_timeout_s}"
            )

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Batch-shape buckets
# ---------------------------------------------------------------------------

def batch_buckets(max_batch: int) -> tuple[int, ...]:
    """The padded batch shapes of a ``max_batch``-sized executor: powers of
    two below ``max_batch``, then ``max_batch`` itself."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    p = 1
    while p < max_batch:
        out.append(p)
        p <<= 1
    out.append(max_batch)
    return tuple(out)


def pick_bucket(b: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket of an ascending ladder holding ``b`` rows."""
    b = int(b)
    if b < 1:
        raise ValueError(f"batch size must be >= 1, got {b}")
    for bb in buckets:
        if bb >= b:
            return bb
    raise ValueError(f"batch size {b} exceeds max_batch {buckets[-1]}")


def batch_bucket(b: int, max_batch: int) -> int:
    """:func:`pick_bucket` over the default :func:`batch_buckets` ladder."""
    return pick_bucket(b, batch_buckets(max_batch))
