"""Serving stack of the port: executor (per-shape state) -> engine (sync
queue). Port of ``repro/serve`` without ``AsyncServingEngine`` and its
``ServeConfig`` (ROADMAP queue 1, item 8).

``SearchExecutor`` owns the per-shape cache; ``ServingEngine`` is the
synchronous caller-driven queue; ``serve/faults.py`` injects failures into
it; ``serve/errors.py`` names every terminal outcome.
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

__all__ = [
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
