"""Long-term user memory: durable facts extracted from conversations
(an LLM-backed extractor with a deterministic heuristic fallback), PII
scrubbed before storage, embedding-indexed with dedup / consolidation,
retrieved by hybrid (vector + keyword) search, and summarized by
reflection.  The port's copy of the JAX package's ``memory/store.py``:
the in-process store; ``sqlite_store.py`` mirrors it to a file.
"""

from __future__ import annotations

import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np


@dataclass
class MemoryItem:
    id: str
    user_id: str
    text: str
    kind: str = "fact"  # fact | preference | event | reflection
    embedding: Optional[np.ndarray] = None
    created_t: float = field(default_factory=time.time)
    last_access_t: float = field(default_factory=time.time)
    access_count: int = 0
    metadata: Dict[str, str] = field(default_factory=dict)


class MemoryStore(Protocol):
    def add(self, item: MemoryItem) -> None: ...

    def search(self, user_id: str, query: str, limit: int = 5,
               threshold: float = 0.0) -> List[MemoryItem]: ...

    def list(self, user_id: str) -> List[MemoryItem]: ...

    def delete(self, user_id: str, memory_id: str) -> bool: ...


_PII_PATTERNS = [
    (re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.]+\b"), "<EMAIL>"),
    (re.compile(r"\b(?:\+?\d[\s-]?){7,15}\b"), "<PHONE>"),
    (re.compile(r"\b\d{3}-\d{2}-\d{4}\b"), "<SSN>"),
    (re.compile(r"\b(?:\d[ -]*?){13,19}\b"), "<CARD>"),
]


def sanitize_pii(text: str) -> str:
    """Deterministic PII scrub before storage."""
    for pat, repl in _PII_PATTERNS:
        text = pat.sub(repl, text)
    return text


_FACT_MARKERS = [
    (re.compile(r"\bmy name is ([^.,\n]{2,40})", re.I), "name: {0}"),
    (re.compile(r"\bi (?:work|am employed) (?:at|for) ([^.,\n]{2,40})", re.I),
     "works at {0}"),
    (re.compile(r"\bi live in ([^.,\n]{2,40})", re.I), "lives in {0}"),
    (re.compile(r"\bi (?:prefer|like|love) ([^.\n]{2,60})", re.I),
     "prefers {0}"),
    (re.compile(r"\bi (?:hate|dislike|can't stand) ([^.\n]{2,60})", re.I),
     "dislikes {0}"),
    (re.compile(r"\bi am allergic to ([^.,\n]{2,40})", re.I),
     "allergic to {0}"),
    (re.compile(r"\bi(?:'m| am) a ([^.,\n]{2,40})", re.I), "is a {0}"),
    (re.compile(r"\bcall me ([^.,\n]{2,30})", re.I), "goes by {0}"),
]


def extract_memories_heuristic(messages: Sequence[dict]) -> List[str]:
    """Deterministic extraction (no LLM): first-person durable facts and
    preferences from user turns."""
    out: List[str] = []
    for m in messages:
        if m.get("role") != "user":
            continue
        content = m.get("content", "")
        if not isinstance(content, str):
            continue
        for pat, template in _FACT_MARKERS:
            for match in pat.finditer(content):
                fact = template.format(match.group(1).strip())
                if fact not in out:
                    out.append(fact)
    return out


class MemoryExtractor:
    """LLM-backed extraction with heuristic fallback."""

    PROMPT = ("Extract durable user facts/preferences from this "
              "conversation as a JSON list of short strings. Only include "
              "things worth remembering long-term. Conversation:\n{convo}")

    def __init__(self, llm_complete: Optional[Callable[[str], str]] = None
                 ) -> None:
        self.llm_complete = llm_complete

    def extract(self, messages: Sequence[dict]) -> List[str]:
        if self.llm_complete is not None:
            try:
                convo = "\n".join(
                    f"{m.get('role')}: {m.get('content', '')}"
                    for m in messages if isinstance(m.get("content"), str))
                raw = self.llm_complete(self.PROMPT.format(convo=convo[:6000]))
                import json

                facts = json.loads(raw[raw.index("["):raw.rindex("]") + 1])
                return [str(f) for f in facts if isinstance(f, str)][:16]
            except Exception:
                pass  # fall back to heuristics
        return extract_memories_heuristic(messages)


_WORD = re.compile(r"\w+", re.UNICODE)


def keyword_score(query: str, text: str) -> float:
    """Hybrid search's keyword leg: 0.3 + 0.7 * Jaccard over word tokens
    when any overlap exists, else 0."""
    q = set(w.lower() for w in _WORD.findall(query))
    t = set(w.lower() for w in _WORD.findall(text))
    if not q or not t:
        return 0.0
    overlap = len(q & t) / len(q | t)
    return 0.3 + 0.7 * overlap if overlap > 0 else 0.0


class InMemoryMemoryStore:
    """Embedding + keyword hybrid store."""

    def __init__(self, embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 max_per_user: int = 512,
                 dedup_threshold: float = 0.92) -> None:
        self.embed_fn = embed_fn
        self.max_per_user = max_per_user
        self.dedup_threshold = dedup_threshold
        self._items: Dict[str, List[MemoryItem]] = {}
        self._lock = threading.RLock()

    # -- MemoryStore -------------------------------------------------------

    def add(self, item: MemoryItem) -> None:
        item.text = sanitize_pii(item.text)
        if item.embedding is None and self.embed_fn is not None:
            item.embedding = np.asarray(self.embed_fn(item.text), np.float32)
        with self._lock:
            items = self._items.setdefault(item.user_id, [])
            # consolidation: near-duplicates refresh instead of duplicating
            if item.embedding is not None:
                for existing in items:
                    if existing.embedding is not None:
                        sim = float(existing.embedding @ item.embedding)
                        if sim >= self.dedup_threshold:
                            existing.last_access_t = time.time()
                            existing.access_count += 1
                            return
            elif any(e.text == item.text for e in items):
                return
            items.append(item)
            if len(items) > self.max_per_user:
                items.sort(key=lambda i: (i.access_count, i.last_access_t))
                del items[0]

    def remember(self, user_id: str, text: str, kind: str = "fact",
                 **metadata: str) -> MemoryItem:
        item = MemoryItem(id=uuid.uuid4().hex[:12], user_id=user_id,
                          text=text, kind=kind, metadata=dict(metadata))
        self.add(item)
        return item

    def search(self, user_id: str, query: str, limit: int = 5,
               threshold: float = 0.0,
               hybrid: bool = True) -> List[MemoryItem]:
        with self._lock:
            items = list(self._items.get(user_id, ()))
        if not items:
            return []
        scores = np.zeros(len(items))
        if self.embed_fn is not None:
            q = np.asarray(self.embed_fn(query), np.float32)
            for i, item in enumerate(items):
                if item.embedding is not None:
                    scores[i] = float(item.embedding @ q)
        if hybrid or self.embed_fn is None:
            for i, item in enumerate(items):
                scores[i] = max(scores[i],
                                keyword_score(query, item.text))
        order = np.argsort(-scores)
        out = []
        for i in order[:limit]:
            if scores[i] < threshold:
                break
            items[i].last_access_t = time.time()
            items[i].access_count += 1
            out.append(items[i])
        return out

    def list(self, user_id: str) -> List[MemoryItem]:
        with self._lock:
            return list(self._items.get(user_id, ()))

    def list_all(self, limit: int = 5000) -> List[MemoryItem]:
        """Every user's items, at most ``limit``."""
        out: List[MemoryItem] = []
        with self._lock:
            for items in self._items.values():
                out.extend(items)
                if len(out) >= limit:
                    break
        return out[:limit]

    def delete(self, user_id: str, memory_id: str) -> bool:
        with self._lock:
            items = self._items.get(user_id, [])
            for i, item in enumerate(items):
                if item.id == memory_id:
                    del items[i]
                    return True
        return False

    def find_by_id(self, memory_id: str) -> Optional[MemoryItem]:
        """Cross-user lookup by id (``GET /v1/memory/{id}``)."""
        with self._lock:
            for items in self._items.values():
                for item in items:
                    if item.id == memory_id:
                        return item
        return None

    # -- pipeline integration ---------------------------------------------

    def auto_store(self, user_id: str, messages: Sequence[dict],
                   extractor: Optional[MemoryExtractor] = None) -> int:
        """Extract + store facts from a finished conversation turn (the
        router's response path calls it)."""
        extractor = extractor or MemoryExtractor()
        facts = extractor.extract(messages)
        for fact in facts:
            self.remember(user_id, fact)
        return len(facts)

    def reflect(self, user_id: str,
                llm_complete: Optional[Callable[[str], str]] = None
                ) -> Optional[MemoryItem]:
        """Periodic reflection: summarize accumulated facts into one
        higher-level memory."""
        items = self.list(user_id)
        if len(items) < 4:
            return None
        facts = "; ".join(i.text for i in items[-16:])
        if llm_complete is not None:
            try:
                summary = llm_complete(
                    f"Summarize into one sentence what we know about this "
                    f"user: {facts}")
            except Exception:
                summary = f"profile: {facts[:300]}"
        else:
            summary = f"profile: {facts[:300]}"
        return self.remember(user_id, summary, kind="reflection")
