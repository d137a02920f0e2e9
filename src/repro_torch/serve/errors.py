"""Typed terminal outcomes of the serving stack (port of
``repro/serve/errors.py``, class for class).

Every request submitted to the serving layer resolves with EXACTLY ONE of:

  * a ``Result`` (served);
  * :class:`InvalidRequestError` — rejected at the edge before queueing
    (NaN/Inf vector, wrong dimensionality, ``k <= 0``, ``k > ef``,
    inverted range), so one malformed request can never poison a batch;
  * :class:`OverloadedError`, :class:`ShedError`,
    :class:`DeadlineExceededError` — the async loop's admission, shedding
    and deadline outcomes (``serve/loop.py``);
  * :class:`ShutdownError` — the engine closed before it could be served
    (pending requests are failed fast, never silently dropped);
  * any other exception the flush raised — failing only that flush's
    requests (error isolation; the engine stays serviceable).

``InvalidRequestError`` subclasses ``ValueError`` so historical
``except ValueError`` call sites keep catching edge rejections.
:class:`InjectedFaultError` is what ``serve/faults.py`` raises when a
``flush_error`` fault fires — a regular flush failure as far as the
isolation machinery is concerned.
"""
from __future__ import annotations

__all__ = [
    "ServeError",
    "InvalidRequestError",
    "OverloadedError",
    "RejectedError",
    "ShedError",
    "DeadlineExceededError",
    "ShutdownError",
    "InjectedFaultError",
]


class ServeError(Exception):
    """Base of every typed serving outcome."""


class InvalidRequestError(ServeError, ValueError):
    """Request rejected at the serving edge (validation)."""


class OverloadedError(ServeError):
    """Admission control rejected the request: the bounded queue is full
    under the ``"reject"`` backpressure policy."""


RejectedError = OverloadedError  # the issue-tracker name for the same thing


class ShedError(ServeError):
    """The request's deadline expired while it was still queued; the loop
    shed it before it reached the executor (no compute was spent)."""


class DeadlineExceededError(ServeError, TimeoutError):
    """The request's per-request timeout fired after it left the queue
    (in flight, or blocked on backpressure)."""


class ShutdownError(ServeError):
    """The engine closed; the request was failed fast instead of being
    silently dropped."""


class InjectedFaultError(ServeError, RuntimeError):
    """A fault-injection hook fired (``serve/faults.py``)."""

    def __init__(self, kind: str, message: str | None = None):
        super().__init__(message or f"injected fault: {kind}")
        self.kind = kind
