from .hnsw import HNSWIndex
from .semantic_cache import (
    CacheEntry,
    CacheStats,
    InMemorySemanticCache,
    build_cache,
)

__all__ = [
    "CacheEntry",
    "CacheStats",
    "HNSWIndex",
    "InMemorySemanticCache",
    "build_cache",
]
