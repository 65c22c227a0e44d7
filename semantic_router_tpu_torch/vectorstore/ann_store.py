"""RAG retrieval through the on-device ANN plane.

The port's copy of ``semantic_router_tpu.vectorstore.ann_store``.

``AnnVectorStore`` keeps the in-memory store's chunking, document
bookkeeping, and hybrid (vector + keyword) scoring, but moves the
vector leg onto an ``ann.AnnIndex``: chunk embeddings land in the
index at ingest (host tier first, promoted to the device bank by the
maintenance cycle), and search pulls candidates with one batched
top-k matmul instead of a per-chunk Python loop.  Keyword rescoring
then runs over the candidate set only — the hybrid contract survives,
the O(chunks) embedding scan does not.

Vector scores are cosine (the bank L2-normalizes rows and queries),
where the in-memory store uses raw dot products — identical when the
embedder normalizes, and the hybrid weight applies unchanged either
way.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from .store import InMemoryVectorStore, SearchHit

_WORD = re.compile(r"\w+", re.UNICODE)

# candidate over-fetch: keyword rescoring can promote a chunk the pure
# vector ranking put below top_k, so pull a deeper device top-k first
CANDIDATE_FACTOR = 4


class AnnVectorStore(InMemoryVectorStore):
    """InMemoryVectorStore with the vector leg on an ANN index."""

    def __init__(self, index, embed_fn=None, **kwargs) -> None:
        super().__init__(embed_fn, **kwargs)
        self.index = index

    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None):
        doc = super().ingest(name, text, metadata=metadata)
        with self._lock:
            pending = [(cid, self.chunks[cid].embedding)
                       for cid in doc.chunk_ids if cid in self.chunks]
        for cid, emb in pending:
            if emb is not None:
                self.index.add(cid, emb)
        return doc

    def search(self, query: str, top_k: int = 5, threshold: float = 0.0,
               hybrid: bool = True) -> List[SearchHit]:
        if self.embed_fn is None:
            # keyword-only posture: nothing for the bank to score
            return super().search(query, top_k=top_k,
                                  threshold=threshold, hybrid=hybrid)
        q = np.asarray(self.embed_fn(query), np.float32)
        cand_ids, cand_scores = self.index.lookup(
            q, k=max(top_k * CANDIDATE_FACTOR, top_k))
        with self._lock:
            cands = [(self.chunks[cid], s)
                     for cid, s in zip(cand_ids, cand_scores)
                     if cid in self.chunks]
        if not cands:
            return []
        k_scores = np.zeros(len(cands))
        if hybrid:
            q_words = set(w.lower() for w in _WORD.findall(query))
            if q_words:
                for i, (chunk, _) in enumerate(cands):
                    words = set(w.lower()
                                for w in _WORD.findall(chunk.text))
                    if words:
                        k_scores[i] = len(q_words & words) / len(q_words)
        w = self.hybrid_weight if hybrid else 0.0
        v_scores = np.asarray([s for _, s in cands])
        final = (1 - w) * v_scores + w * k_scores
        order = np.argsort(-final)
        out: List[SearchHit] = []
        for i in order[:top_k]:
            if final[i] < threshold:
                break
            out.append(SearchHit(cands[i][0], float(final[i]),
                                 float(v_scores[i]), float(k_scores[i])))
        return out

    def delete_document(self, document_id: str) -> bool:
        with self._lock:
            doc = self.documents.get(document_id)
            chunk_ids = list(doc.chunk_ids) if doc is not None else []
        removed = super().delete_document(document_id)
        if removed:
            for cid in chunk_ids:
                self.index.delete(cid)
        return removed
