"""Vector stores and the RAG retrieval layer (the port's copy of
``semantic_router_tpu.vectorstore``): in-memory, SQLite, ANN-backed,
plane-shared, Qdrant, Milvus and Llama-Stack stores behind one manager,
with the Postgres metadata registry (``pg_registry``) that re-attaches
them at boot."""

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
