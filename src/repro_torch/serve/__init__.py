"""Serving stack of the port: executor (per-shape state) -> engine (sync
queue) -> async loop (deadlines, admission, shedding). Port of
``repro/serve``; the loop's policy is ``core/config.py::ServeConfig``.

``SearchExecutor`` owns the per-shape cache; ``ServingEngine`` is the
synchronous caller-driven queue; ``AsyncServingEngine`` (``serve/loop.py``)
the deadline-aware loop over the same executor; ``serve/faults.py``
injects failures into both; ``serve/errors.py`` names every terminal
outcome.
"""
from repro_torch.serve.engine import Request, Result, ServingEngine
from repro_torch.serve.errors import (
    DeadlineExceededError,
    InjectedFaultError,
    InvalidRequestError,
    OverloadedError,
    RejectedError,
    ServeError,
    ShedError,
    ShutdownError,
)
from repro_torch.serve.executor import SearchExecutor
from repro_torch.serve.faults import FaultConfig, FaultInjector
from repro_torch.serve.loop import AsyncServingEngine

__all__ = [
    "AsyncServingEngine",
    "DeadlineExceededError",
    "FaultConfig",
    "FaultInjector",
    "InjectedFaultError",
    "InvalidRequestError",
    "OverloadedError",
    "RejectedError",
    "Request",
    "Result",
    "SearchExecutor",
    "ServeError",
    "ServingEngine",
    "ShedError",
    "ShutdownError",
]
