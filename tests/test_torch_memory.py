"""The port's memory stores against the JAX package's, on the CPU: PII
sanitizing, heuristic extraction, dedup / consolidation, hybrid search
order and auto-store give the same results with the same ``embed_fn``,
in memory and in SQLite (a file one package writes, the other reads)."""

import hashlib

import numpy as np
import pytest

from semantic_router_tpu import memory as jmem
from semantic_router_tpu.memory.sqlite_store import \
    SQLiteMemoryStore as JSQLite
from semantic_router_tpu_torch import memory as tmem

D = 32


def embed(text: str) -> np.ndarray:
    """A deterministic unit embedding of the text's words (word vectors
    seeded by the word's digest, summed): texts sharing words are close."""
    v = np.zeros(D, np.float32)
    for w in text.lower().split():
        seed = int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4)
                              .digest(), "little")
        v += np.random.default_rng(seed).standard_normal(D)
    n = np.linalg.norm(v)
    return (v / n if n else v).astype(np.float32)


TEXTS = [
    "mail me at jane.doe@example.com or call +1 415 555 0199",
    "my ssn is 123-45-6789 and card 4111 1111 1111 1111",
    "nothing private here",
]

CONVO = [
    {"role": "system", "content": "Known about this user: old facts"},
    {"role": "user", "content": "Hi, my name is Ada Lovelace. I live in "
                                "London. I prefer concise answers and I "
                                "am allergic to peanuts."},
    {"role": "assistant", "content": "Noted."},
    {"role": "user", "content": "I work at Babbage Engines, I'm a "
                                "mathematician; call me Countess. I hate "
                                "long meetings"},
    {"role": "user", "content": ["not", "a", "string"]},
]

FACTS = ["likes tea in the morning", "likes tea in the morning",
         "works on analytical engines", "lives in London",
         "prefers short replies", "allergic to peanuts", "plays the harp",
         "name: Ada"]
QUERIES = ["what does the user like to drink in the morning",
           "where does she live", "engines", "harp music", "no overlap at all"]


@pytest.mark.parametrize("text", TEXTS)
def test_sanitize_pii(text):
    assert tmem.sanitize_pii(text) == jmem.sanitize_pii(text)


def test_heuristic_extraction():
    got = tmem.extract_memories_heuristic(CONVO)
    assert got == jmem.extract_memories_heuristic(CONVO)
    assert "name: Ada Lovelace" in got and "allergic to peanuts" in got
    assert tmem.MemoryExtractor().extract(CONVO) == got
    # a failing LLM falls back to the heuristics
    assert tmem.MemoryExtractor(lambda p: "no json").extract(CONVO) == got
    assert tmem.MemoryExtractor(lambda p: '["a", 2, "b"]').extract(CONVO) \
        == jmem.MemoryExtractor(lambda p: '["a", 2, "b"]').extract(CONVO) \
        == ["a", "b"]


def _fill(store, pkg):
    for i, fact in enumerate(FACTS):
        store.add(pkg.MemoryItem(id=f"m{i}", user_id="u1", text=fact,
                                 created_t=100.0 + i, last_access_t=100.0 + i))
    store.add(pkg.MemoryItem(id="x", user_id="u2", text="likes coffee",
                             created_t=1.0, last_access_t=1.0))


def _state(store, user):
    return [(i.id, i.text, i.kind, i.access_count) for i in store.list(user)]


def _search(store, **kw):
    return [[(i.id, i.text) for i in store.search("u1", q, **kw)]
            for q in QUERIES]


@pytest.mark.parametrize("use_embed", [True, False],
                         ids=["hybrid", "keyword_only"])
def test_dedup_and_hybrid_search_order(use_embed):
    fn = embed if use_embed else None
    jstore = jmem.InMemoryMemoryStore(fn, dedup_threshold=0.9)
    tstore = tmem.InMemoryMemoryStore(fn, dedup_threshold=0.9)
    _fill(jstore, jmem)
    _fill(tstore, tmem)
    assert _state(tstore, "u1") == _state(jstore, "u1")
    assert len(tstore.list("u1")) == len(FACTS) - 1  # one duplicate folded
    for kw in ({}, {"limit": 2}, {"threshold": 0.5}, {"hybrid": False}):
        assert _search(tstore, **kw) == _search(jstore, **kw), kw
    assert _state(tstore, "u1") == _state(jstore, "u1")  # access counts
    assert tstore.search("nobody", "tea") == []
    assert tstore.delete("u1", "m2") and not tstore.delete("u1", "m2")
    assert jstore.delete("u1", "m2")
    assert _state(tstore, "u1") == _state(jstore, "u1")


def test_eviction_keeps_max_per_user():
    jstore = jmem.InMemoryMemoryStore(embed, max_per_user=4)
    tstore = tmem.InMemoryMemoryStore(embed, max_per_user=4)
    _fill(jstore, jmem)
    _fill(tstore, tmem)
    assert [i.id for i in tstore.list("u1")] == \
        [i.id for i in jstore.list("u1")]
    assert len(tstore.list("u1")) == 4


def test_auto_store_and_reflection():
    jstore = jmem.InMemoryMemoryStore(embed)
    tstore = tmem.InMemoryMemoryStore(embed)
    assert tstore.auto_store("u1", CONVO) == jstore.auto_store("u1", CONVO)
    assert [i.text for i in tstore.list("u1")] == \
        [i.text for i in jstore.list("u1")]
    got, want = tstore.reflect("u1"), jstore.reflect("u1")
    assert got.text == want.text and got.kind == "reflection"
    assert tmem.InMemoryMemoryStore(embed).reflect("u9") is None


def test_sqlite_store_round_trips_between_packages(tmp_path):
    path = str(tmp_path / "memory.db")
    tstore = tmem.SQLiteMemoryStore(path, embed)
    _fill(tstore, tmem)
    tstore.auto_store("u3", CONVO)
    tstore.delete("u1", "m3")
    want = {u: _state(tstore, u) for u in ("u1", "u2", "u3")}
    tstore.close()
    reopened = tmem.SQLiteMemoryStore(path, embed)
    jstore = JSQLite(path, embed)
    for u, rows in want.items():
        assert sorted(_state(reopened, u)) == sorted(rows)
        assert sorted(_state(jstore, u)) == sorted(rows)
    assert _search(reopened) == _search(jstore)
    emb = {i.id: i.embedding for i in reopened.list("u1")}
    for i in jstore.list("u1"):
        np.testing.assert_array_equal(emb[i.id], i.embedding)
    reopened.close()
    jstore.close()
