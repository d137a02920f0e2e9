"""iRangeGraph on PyTorch and CUDA: the port of ``repro`` (JAX + Pallas).

The paper's flow on one NVIDIA H100: build the segment tree of elemental
graphs (``core/build.py``), then improvise a dedicated graph per query
range inside beam search (``core/search.py``). The hot loops run in
hand-written CUDA kernels for Hopper (``csrc/``, dispatched by
``kernels/ops.py``); each has a plain torch version (``kernels/ref.py``)
that the CPU runs and the card is checked against.

Tables may be stored in any of ``repro``'s codecs (``core/storage.py``:
bf16/f16, int8, PQ with an int8 rerank sidecar, split neighbor ids); the
search kernels and the prune decode the stored rows in registers.
``repro_torch.core.baselines`` and ``repro_torch.core.multiattr`` hold the
paper's comparison methods and its multi-attribute search;
``repro_torch.core.distributed`` the index cut into contiguous attribute-
rank shards (``build_sharded``) and its serve step over the ranks of a
``torch.distributed`` process group (``ShardLayout``,
``rfann_serve_step``);
``repro_torch.bench`` the roofline and build-path benchmarks and the
paper's figure and table scripts.

Entry points run on the card unless the caller passes ``device="cpu"``.
Importing this package imports torch and numpy only: no JAX, nothing of
``repro``, no ``msgpack`` or ``ml_dtypes`` (index files go through the
port's own ``core/msgpack_lite.py``), and ``zstandard`` only where an
index is compressed, when it is installed.
"""
from repro_torch.core import (
    BuildConfig,
    IndexCorruptionError,
    RangeGraphIndex,
    SearchConfig,
    SearchResult,
    ServeConfig,
    ShardedRangeIndex,
    ShardLayout,
    StorageConfig,
    build_sharded,
    make_serve_step,
    merge_topk,
    rfann_serve_step,
    shard_topk,
    recall,
)

__all__ = [
    "BuildConfig",
    "IndexCorruptionError",
    "RangeGraphIndex",
    "SearchConfig",
    "SearchResult",
    "ServeConfig",
    "ShardLayout",
    "ShardedRangeIndex",
    "StorageConfig",
    "build_sharded",
    "make_serve_step",
    "merge_topk",
    "recall",
    "rfann_serve_step",
    "shard_topk",
]
