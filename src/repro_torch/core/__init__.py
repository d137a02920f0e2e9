"""iRangeGraph core of the port: config, storage, segment tree, bitset,
search, build, the index API, and the sharded index with its serve step
over ``torch.distributed`` (``core/distributed.py``); the paper's
comparison methods (``core/baselines.py``) and its multi-attribute search
(``core/multiattr.py``) import as submodules, as in ``repro``."""
from repro_torch.core.build import (
    BuildConfig,
    build_flat_graph,
    build_neighbor_table,
)
from repro_torch.core.config import SearchConfig, ServeConfig
from repro_torch.core.distributed import (
    ShardedRangeIndex,
    ShardLayout,
    build_sharded,
    make_serve_step,
    merge_topk,
    rfann_serve_step,
    shard_topk,
)
from repro_torch.core.index import IndexCorruptionError, RangeGraphIndex, recall
from repro_torch.core.search import SearchResult, search_improvised
from repro_torch.core.storage import StorageConfig

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
    "build_flat_graph",
    "build_neighbor_table",
    "build_sharded",
    "make_serve_step",
    "merge_topk",
    "recall",
    "rfann_serve_step",
    "search_improvised",
    "shard_topk",
]
