"""One frozen config for the query pipeline (the port's ``SearchConfig``).

Mirrors ``repro/core/config.py::SearchConfig``: frozen and hashable, with
``k`` per call. The backend tokens are the port's own:

  * ``dist_impl`` / ``edge_impl``: ``"auto" | "cuda" | "torch"``;
  * ``hop_impl``: the same plus ``"composed"`` (the three dispatched ops
    chained, the fused hop's bit-identical oracle).

``"auto"`` resolves by where the tensors live: the hand-written kernel on a
CUDA tensor, the plain torch version on a CPU tensor (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses

__all__ = ["SearchConfig"]

_METRICS = ("l2", "ip")
_DIST_IMPLS = ("auto", "cuda", "torch")
_EDGE_IMPLS = ("auto", "cuda", "torch")
_HOP_IMPLS = ("auto", "cuda", "torch", "composed")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Frozen query-pipeline knobs.

    ef:           dynamic candidate-list size (beam width).
    expand_width: nodes expanded per query per beam iteration (the engine
                  clamps it to ``ef``).
    dist_impl:    gather-distance backend ("auto" | "cuda" | "torch").
    edge_impl:    edge-selection backend (same set).
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
