from .sqlite_store import SQLiteMemoryStore
from .store import (
    InMemoryMemoryStore,
    MemoryExtractor,
    MemoryItem,
    MemoryStore,
    extract_memories_heuristic,
    keyword_score,
    sanitize_pii,
)

__all__ = ["InMemoryMemoryStore", "MemoryExtractor", "MemoryItem",
           "MemoryStore", "SQLiteMemoryStore", "extract_memories_heuristic",
           "keyword_score", "sanitize_pii"]
