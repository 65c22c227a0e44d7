"""Tokenization seam (the port's own copy of ``semantic_router_tpu``'s).

- ``HFTokenizer`` wraps a ``tokenizers`` JSON file (imported lazily: only a
  deployment that reads ``tokenizer.json`` needs the package).
- ``HashTokenizer`` is the deterministic model-free stand-in for tests and
  the smoke run: one token per whitespace word, exact char offsets.
- ``EncodingCache`` is the request-scoped tokenize-once cache.
- ``encode_windows`` splits a long input into overlapping stride windows,
  each a valid CLS/SEP-framed input.

Both tokenizers emit ``Encoding`` with char offsets so token-classification
span decoding is tokenizer-exact.
"""

from __future__ import annotations

import hashlib
import re
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Tuple


@dataclass
class Encoding:
    ids: List[int]
    attention_mask: List[int]
    offsets: List[Tuple[int, int]]  # char [start, end) per token; (0,0) for specials
    # truncated=True whenever max_length clipped tokens; total_tokens holds
    # the full pre-truncation count (0 = not truncated)
    truncated: bool = False
    total_tokens: int = 0

    def __len__(self) -> int:
        return len(self.ids)


class Tokenizer(Protocol):
    def encode(self, text: str, max_length: int = 0) -> Encoding: ...

    def decode(self, ids: List[int]) -> str: ...

    @property
    def vocab_size(self) -> int: ...


_WORD_RE = re.compile(r"\S+")


class HashTokenizer:
    """Deterministic test tokenizer: one token per whitespace word, id =
    stable hash into the vocab, [CLS]/[SEP] specials at 1/2, pad 0."""

    CLS, SEP, PAD = 1, 2, 0

    def __init__(self, vocab_size: int = 1024) -> None:
        self._vocab_size = vocab_size

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.lower().encode()).digest()[:4],
                           "little")
        return 3 + h % (self._vocab_size - 3)

    def encode(self, text: str, max_length: int = 0) -> Encoding:
        ids = [self.CLS]
        offsets: List[Tuple[int, int]] = [(0, 0)]
        truncated = False
        n_words = 0
        for m in _WORD_RE.finditer(text):
            n_words += 1
            if max_length and len(ids) >= max_length - 1:
                truncated = True
                continue  # keep counting words for total_tokens
            ids.append(self._word_id(m.group(0)))
            offsets.append((m.start(), m.end()))
        ids.append(self.SEP)
        offsets.append((0, 0))
        return Encoding(ids=ids, attention_mask=[1] * len(ids),
                        offsets=offsets, truncated=truncated,
                        total_tokens=(n_words + 2) if truncated else 0)

    def decode(self, ids: List[int]) -> str:
        """Hashing is lossy: stable ``tok<id>`` placeholders, specials
        dropped."""
        return " ".join(f"tok{int(i)}" for i in ids
                        if int(i) not in (self.CLS, self.SEP, self.PAD))


class HFTokenizer:
    """Wraps a ``tokenizers`` fast tokenizer loaded from tokenizer.json."""

    def __init__(self, path: str) -> None:
        from tokenizers import Tokenizer as _Tok

        self.tok = _Tok.from_file(path)
        # the source path is the tokenizer's content identity for
        # trunk-group fingerprinting: two loads of one file share a group
        self.path = path
        self._vocab_size = self.tok.get_vocab_size()

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "HFTokenizer":
        import os

        return cls(os.path.join(model_dir, "tokenizer.json"))

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def encode(self, text: str, max_length: int = 0) -> Encoding:
        # truncate post hoc: enable_truncation mutates the shared
        # tokenizer's state, which is racy across threads
        enc = self.tok.encode(text)
        ids = list(enc.ids)
        mask = list(enc.attention_mask)
        offsets = [tuple(o) for o in enc.offsets]
        total = len(ids)
        truncated = bool(max_length) and total > max_length
        if truncated:
            ids, mask, offsets = (ids[:max_length], mask[:max_length],
                                  offsets[:max_length])
        return Encoding(ids=ids, attention_mask=mask, offsets=offsets,
                        truncated=truncated,
                        total_tokens=total if truncated else 0)

    def decode(self, ids: List[int]) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=True)


class EncodingCache:
    """Request-scoped tokenize-once cache.

    A request fanning out to K learned signals on one shared trunk encodes
    its prompt once per (tokenizer, max_length).  Per-key reservation, not
    a global lock: racing threads on the SAME key wait on the winner's
    Future, distinct keys encode in parallel."""

    def __init__(self) -> None:
        self._entries: dict = {}  # key -> Future[Encoding]
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_encode(self, tokenizer: Tokenizer, text: str,
                      max_length: int,
                      on_miss: Optional[Callable[[], None]] = None
                      ) -> Encoding:
        key = (id(tokenizer), max_length, text)
        with self._lock:
            fut = self._entries.get(key)
            mine = fut is None
            if mine:
                fut = self._entries[key] = Future()
                self.misses += 1
            else:
                self.hits += 1
        if not mine:
            return fut.result()
        try:
            enc = tokenizer.encode(text, max_length=max_length)
        except BaseException as exc:
            # drop the reservation so a later call can retry; current
            # waiters see the error
            with self._lock:
                self._entries.pop(key, None)
            fut.set_exception(exc)
            raise
        fut.set_result(enc)
        if on_miss is not None:
            on_miss()
        return enc


def encode_windows(tokenizer: "Tokenizer", text: str, max_length: int,
                   stride: int = 0) -> List[Encoding]:
    """The whole text as overlapping windows of at most ``max_length``
    tokens: encode once (absolute char offsets kept), then slice the
    content into windows where consecutive windows share ``stride``
    tokens.  The special-token frame of the full encode (leading and
    trailing tokens with (0, 0) offsets, [CLS]/[SEP]) is re-attached to
    every window, so a CLS-pooled classifier reads a real [CLS] on each.
    Windows are not marked truncated (nothing was dropped) and carry
    ``total_tokens`` = the full encode's count.  A text that fits comes
    back as its one full encode."""
    if max_length <= 0:
        return [tokenizer.encode(text)]
    full = tokenizer.encode(text)
    n = len(full)
    if n <= max_length:
        return [full]
    pre = 1 if full.offsets and full.offsets[0] == (0, 0) else 0
    post = 1 if n > pre and full.offsets[-1] == (0, 0) else 0
    budget = max_length - pre - post  # content tokens per window
    if stride < 0 or stride >= budget:
        raise ValueError(f"stride must be in [0, {budget}) "
                         f"(max_length minus the special-token frame); "
                         f"got {stride}")
    head = slice(0, pre)
    tail = slice(n - post, n)
    body_ids = full.ids[pre:n - post]
    body_mask = full.attention_mask[pre:n - post]
    body_offs = full.offsets[pre:n - post]
    step = budget - stride
    windows: List[Encoding] = []
    start = 0
    while start < len(body_ids):
        end = min(start + budget, len(body_ids))
        windows.append(Encoding(
            ids=full.ids[head] + body_ids[start:end] + full.ids[tail],
            attention_mask=(full.attention_mask[head] + body_mask[start:end]
                            + full.attention_mask[tail]),
            offsets=(full.offsets[head] + body_offs[start:end]
                     + full.offsets[tail]),
            truncated=False,
            total_tokens=n,
        ))
        if end == len(body_ids):
            break
        start += step
    return windows


def decode_entity_spans(text: str, offsets: List[Tuple[int, int]],
                        labels: List[str], scores: List[float],
                        threshold: float = 0.5,
                        ignore_label: str = "O") -> List[dict]:
    """BIO/plain token labels + char offsets → entity spans: adjacent tokens
    of one entity type merge, "B-"/"I-" prefixes are honoured, tokens below
    the threshold break spans.  Returns [{type, start, end, text, score}]."""
    spans: List[dict] = []
    current: Optional[dict] = None

    def flush() -> None:
        nonlocal current
        if current is not None:
            current["text"] = text[current["start"]:current["end"]]
            spans.append(current)
            current = None

    for (start, end), label, score in zip(offsets, labels, scores):
        if start == end:  # special token
            flush()
            continue
        is_begin = label.startswith("B-")
        etype = label[2:] if label[:2] in ("B-", "I-") else label
        if etype == ignore_label or score < threshold:
            flush()
            continue
        if current is not None and current["type"] == etype and not is_begin:
            current["end"] = end
            current["score"] = min(current["score"], score)
        else:
            flush()
            current = {"type": etype, "start": start, "end": end,
                       "score": score}
    flush()
    return spans
