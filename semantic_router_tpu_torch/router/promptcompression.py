"""Extractive prompt compression, on the host.

The port's copy of ``semantic_router_tpu.router.promptcompression``:
sentences scored by TextRank centrality, TF-IDF salience, a position prior
and a novelty penalty, weighted by a profile (default, coding, medical,
security, multi_turn); the first and last sentences a profile preserves
are kept, and the best-scored sentences up to the target ratio.  The
router compresses a prompt of ``prompt_compression.min_tokens`` or more
before the signals see it.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

# CJK sentence punctuation needs no trailing whitespace to split
_SENT_SPLIT = re.compile(r"(?<=[.!?\n])\s+|(?<=[。！？])\s*")
_WORD = re.compile(r"\w+", re.UNICODE)


@dataclass
class CompressionProfile:
    name: str = "default"
    textrank_weight: float = 0.35
    tfidf_weight: float = 0.3
    position_weight: float = 0.2
    novelty_weight: float = 0.15
    preserve_first: int = 1
    preserve_last: int = 1
    # profile-specific salience boosts (term → multiplier)
    boost_terms: Dict[str, float] = field(default_factory=dict)


PROFILES: Dict[str, CompressionProfile] = {
    "default": CompressionProfile(),
    "coding": CompressionProfile(
        name="coding", position_weight=0.1, tfidf_weight=0.4,
        boost_terms={"error": 1.5, "function": 1.3, "code": 1.3,
                     "exception": 1.5, "traceback": 1.6}),
    "medical": CompressionProfile(
        name="medical", novelty_weight=0.25,
        boost_terms={"dose": 1.5, "mg": 1.4, "symptom": 1.5,
                     "diagnosis": 1.5, "allergy": 1.6}),
    "security": CompressionProfile(
        name="security", preserve_first=2,
        boost_terms={"password": 1.6, "token": 1.4, "credential": 1.6,
                     "vulnerability": 1.5, "exploit": 1.5}),
    "multi_turn": CompressionProfile(
        name="multi_turn", preserve_last=3, position_weight=0.3),
}


def split_sentences(text: str) -> List[str]:
    parts = [s.strip() for s in _SENT_SPLIT.split(text)]
    return [s for s in parts if s]


def _tokenize(sent: str) -> List[str]:
    return [w.lower() for w in _WORD.findall(sent)]


def _tfidf_scores(sentences: Sequence[List[str]],
                  boost: Dict[str, float]) -> np.ndarray:
    n = len(sentences)
    df: Dict[str, int] = {}
    for toks in sentences:
        for w in set(toks):
            df[w] = df.get(w, 0) + 1
    scores = np.zeros(n)
    for i, toks in enumerate(sentences):
        if not toks:
            continue
        tf: Dict[str, int] = {}
        for w in toks:
            tf[w] = tf.get(w, 0) + 1
        s = 0.0
        for w, f in tf.items():
            idf = math.log((n + 1) / (df[w] + 0.5))
            s += (f / len(toks)) * idf * boost.get(w, 1.0)
        scores[i] = s
    return _norm01(scores)


def _similarity_matrix(sentences: Sequence[List[str]]) -> np.ndarray:
    n = len(sentences)
    sets = [set(t) for t in sentences]
    sim = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            if not sets[i] or not sets[j]:
                continue
            inter = len(sets[i] & sets[j])
            if inter:
                denom = math.log(len(sets[i]) + 1) + math.log(len(sets[j]) + 1)
                sim[i, j] = sim[j, i] = inter / max(denom, 1e-9)
    return sim


def _textrank(sim: np.ndarray, damping: float = 0.85,
              iters: int = 30) -> np.ndarray:
    n = sim.shape[0]
    if n == 0:
        return np.zeros(0)
    out_sum = sim.sum(axis=1, keepdims=True)
    trans = np.divide(sim, out_sum, out=np.zeros_like(sim),
                      where=out_sum > 0)
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        rank = (1 - damping) / n + damping * (trans.T @ rank)
    return _norm01(rank)


def _position_prior(n: int) -> np.ndarray:
    """First and last sentences matter most (U-shaped prior)."""
    if n <= 1:
        return np.ones(n)
    idx = np.arange(n) / (n - 1)
    return _norm01(0.5 * (np.abs(idx - 0.5) * 2) + 0.5)


def _novelty(sentences: Sequence[List[str]]) -> np.ndarray:
    """Penalize sentences redundant with earlier ones."""
    seen: set = set()
    scores = np.zeros(len(sentences))
    for i, toks in enumerate(sentences):
        if not toks:
            continue
        new = sum(1 for w in toks if w not in seen)
        scores[i] = new / len(toks)
        seen.update(toks)
    return scores


def _norm01(x: np.ndarray) -> np.ndarray:
    if x.size == 0:
        return x
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.ones_like(x)
    return (x - lo) / (hi - lo)


@dataclass
class CompressionResult:
    text: str
    original_sentences: int
    kept_sentences: int
    ratio: float


class PromptCompressor:
    def __init__(self, profile: str | CompressionProfile = "default",
                 target_ratio: float = 0.5,
                 min_sentences: int = 3) -> None:
        self.profile = (PROFILES.get(profile, PROFILES["default"])
                        if isinstance(profile, str) else profile)
        self.target_ratio = target_ratio
        self.min_sentences = min_sentences

    def compress(self, text: str,
                 target_ratio: float | None = None) -> CompressionResult:
        ratio = target_ratio if target_ratio is not None else self.target_ratio
        sents = split_sentences(text)
        n = len(sents)
        if n <= self.min_sentences:
            return CompressionResult(text, n, n, 1.0)
        toks = [_tokenize(s) for s in sents]
        p = self.profile
        score = (p.textrank_weight * _textrank(_similarity_matrix(toks))
                 + p.tfidf_weight * _tfidf_scores(toks, p.boost_terms)
                 + p.position_weight * _position_prior(n)
                 + p.novelty_weight * _novelty(toks))

        keep_n = max(self.min_sentences, int(math.ceil(n * ratio)))
        keep = set(np.argsort(-score)[:keep_n])
        keep.update(range(min(p.preserve_first, n)))
        keep.update(range(max(0, n - p.preserve_last), n))
        kept = [sents[i] for i in sorted(keep)]
        return CompressionResult(
            " ".join(kept), n, len(kept), len(kept) / n)
