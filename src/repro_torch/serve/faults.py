"""Fault injection for the serving stack (the chaos harness; port of
``repro/serve/faults.py``).

Three fault kinds, each a hook the serving layers call at the exact point
the real failure would occur:

  * ``latency``      — ``maybe_latency()`` sleeps ``latency_s`` with
    probability ``latency_rate`` right before the executor call, modeling
    an executor latency spike (GC pause, host contention, a straggler
    device). With the async loop's compute running in a worker thread, the
    event loop keeps admitting, shedding and timing out requests while the
    spike burns — which is the property the chaos tests pin.
  * ``flush_error``  — ``maybe_flush_error()`` raises
    :class:`~repro_torch.serve.errors.InjectedFaultError` with probability
    ``flush_error_rate``, modeling a poisoned batch / transient executor
    failure. Error isolation must fail only that flush's requests.
  * ``queue_full``   — ``queue_full()`` returns True with probability
    ``queue_full_rate``, forcing the admission-control full-queue path
    (a burst arriving faster than the queue drains).

Injection is DETERMINISTIC given ``FaultConfig.seed`` (one
``random.Random`` stream, lock-protected — hooks fire from both the event
loop and the flush worker thread), and every fired fault is counted in
``FaultInjector.counts`` so tests and the SLO benchmark can report what
actually happened.

Env-driven activation, under the port's own prefix: ``RTORCH_FAULTS=
latency,flush_error`` enables those kinds for every component that
resolves its ``faults`` parameter through :func:`resolve` with the default
``None``; the synchronous ``ServingEngine`` and ``SearchExecutor`` only
inject when handed an injector explicitly, so deterministic runs stay
deterministic. Knobs (defaults as ``repro``'s): ``RTORCH_FAULT_LATENCY_S``
(0.02), ``RTORCH_FAULT_LATENCY_RATE`` (0.25),
``RTORCH_FAULT_FLUSH_ERROR_RATE`` (0.25), ``RTORCH_FAULT_QUEUE_FULL_RATE``
(0.25), ``RTORCH_FAULT_SEED`` (0).
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time

from repro_torch.serve.errors import InjectedFaultError

__all__ = ["FAULT_KINDS", "FaultConfig", "FaultInjector", "resolve"]

FAULT_KINDS = ("latency", "flush_error", "queue_full")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Which faults fire, how often, and how hard (frozen + hashable)."""

    kinds: tuple[str, ...] = ()
    latency_s: float = 0.02
    latency_rate: float = 0.25
    flush_error_rate: float = 0.25
    queue_full_rate: float = 0.25
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "kinds", tuple(self.kinds))
        for k in self.kinds:
            if k not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {k!r}; valid kinds: {FAULT_KINDS}"
                )
        for name in ("latency_rate", "flush_error_rate", "queue_full_rate"):
            v = getattr(self, name)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if float(self.latency_s) < 0.0:
            raise ValueError(f"latency_s must be >= 0, got {self.latency_s}")

    @classmethod
    def from_env(cls, env=None) -> "FaultConfig | None":
        """``RTORCH_FAULTS`` comma list -> a config, or None when unset or
        empty. ``env`` overrides the mapping read (default ``os.environ``);
        an unset or empty knob takes the field's default."""
        env = os.environ if env is None else env
        kinds = tuple(t.strip() for t in env.get("RTORCH_FAULTS", "")
                      .split(",") if t.strip())
        if not kinds:
            return None
        kw = {}
        for field, name, conv in _ENV_KNOBS:
            v = env.get(name, "").strip()
            if v:
                kw[field] = conv(v)
        return cls(kinds=kinds, **kw)


_ENV_KNOBS = (
    ("latency_s", "RTORCH_FAULT_LATENCY_S", float),
    ("latency_rate", "RTORCH_FAULT_LATENCY_RATE", float),
    ("flush_error_rate", "RTORCH_FAULT_FLUSH_ERROR_RATE", float),
    ("queue_full_rate", "RTORCH_FAULT_QUEUE_FULL_RATE", float),
    ("seed", "RTORCH_FAULT_SEED", int),
)


class FaultInjector:
    """Stateful, deterministic, thread-safe fault source.

    ``armed`` can be flipped off (e.g. a chaos test's clean final probe)
    without rebuilding the injector; counts keep accumulating while armed.
    """

    def __init__(self, config: FaultConfig):
        self.config = config
        self.armed = True
        self.counts = {k: 0 for k in FAULT_KINDS}
        self._rng = random.Random(config.seed)
        self._lock = threading.Lock()

    def _fire(self, kind: str, rate: float) -> bool:
        if not self.armed or kind not in self.config.kinds:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.counts[kind] += 1
        return hit

    def maybe_latency(self):
        """Executor latency spike: sleep in the calling (worker) thread."""
        if self._fire("latency", self.config.latency_rate):
            time.sleep(self.config.latency_s)

    def maybe_flush_error(self):
        """Poisoned flush: raise before the executor sees the batch."""
        if self._fire("flush_error", self.config.flush_error_rate):
            raise InjectedFaultError(
                "flush_error", "injected flush failure (serve/faults.py)"
            )

    def queue_full(self) -> bool:
        """Admission burst: report the queue as full this one check."""
        return self._fire("queue_full", self.config.queue_full_rate)


def resolve(faults) -> FaultInjector | None:
    """The one ``faults=`` parameter convention:

    ``None``  -> the ``RTORCH_FAULTS`` env (an injector, or no injection);
    ``False`` -> injection disabled regardless of env (deterministic tests);
    a ``FaultConfig`` -> a fresh injector for it;
    a ``FaultInjector`` -> used as-is (shared counts).
    """
    if faults is None:
        cfg = FaultConfig.from_env()
        return FaultInjector(cfg) if cfg is not None else None
    if faults is False:
        return None
    if isinstance(faults, FaultConfig):
        return FaultInjector(faults)
    if isinstance(faults, FaultInjector):
        return faults
    raise TypeError(
        f"faults must be None, False, FaultConfig or FaultInjector; "
        f"got {type(faults).__name__}"
    )
