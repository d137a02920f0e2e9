"""iRangeGraph core of the port: config, storage, segment tree, bitset,
search, build and the index API; the paper's comparison methods
(``core/baselines.py``) and its multi-attribute search
(``core/multiattr.py``) import as submodules, as in ``repro``."""
from repro_torch.core.build import (
    BuildConfig,
    build_flat_graph,
    build_neighbor_table,
)
from repro_torch.core.config import SearchConfig, ServeConfig
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
    "StorageConfig",
    "build_flat_graph",
    "build_neighbor_table",
    "recall",
    "search_improvised",
]
