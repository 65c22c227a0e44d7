"""Vector stores and the RAG retrieval layer (the port's copy of
``semantic_router_tpu.vectorstore``): in-memory, SQLite, ANN-backed,
plane-shared, Qdrant and Milvus stores behind one manager."""

from .store import (
    Chunk,
    Document,
    InMemoryVectorStore,
    SearchHit,
    VectorStore,
    VectorStoreManager,
    chunk_text,
    format_rag_context,
)

__all__ = ["Chunk", "Document", "InMemoryVectorStore", "SearchHit",
           "VectorStore", "VectorStoreManager", "chunk_text",
           "format_rag_context"]
