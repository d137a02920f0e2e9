"""iRangeGraph on PyTorch and CUDA: the port of ``repro`` (JAX + Pallas).

The paper's flow on one NVIDIA H100: build the segment tree of elemental
graphs (``core/build.py``), then improvise a dedicated graph per query
range inside beam search (``core/search.py``). The hot loops run in
hand-written CUDA kernels for Hopper (``csrc/``, dispatched by
``kernels/ops.py``); each has a plain torch version (``kernels/ref.py``)
that the CPU runs and the card is checked against.

Entry points run on the card unless the caller passes ``device="cpu"``.
Importing this package imports torch and numpy only: no JAX, nothing of
``repro``, and neither ``msgpack`` nor ``zstandard`` (loaded where an index
is saved or loaded).
"""
from repro_torch.core import (
    BuildConfig,
    IndexCorruptionError,
    RangeGraphIndex,
    SearchConfig,
    SearchResult,
    StorageConfig,
    recall,
)

__all__ = [
    "BuildConfig",
    "IndexCorruptionError",
    "RangeGraphIndex",
    "SearchConfig",
    "SearchResult",
    "StorageConfig",
    "recall",
]
