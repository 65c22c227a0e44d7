"""The routing-benchmark runner: every candidate model answers every
query over OpenAI-compatible HTTP (the looper's ``HTTPLLMClient``), each
answer is scored, and the (query, category, model, quality, latency)
records are written as the JSONL ``training.selection_train.
load_routing_jsonl`` reads.

The default scorer (``keyword_scorer``) is deterministic: keyword recall
against a query's ``expected`` answer, or, without one, the answer's
overlap with the query floored at 0.2 for any non-empty answer.  A model
that fails scores 0 with its error kept: failures are data.

``python -m semantic_router_tpu_torch.modelselection.benchmark --endpoint
URL --models a,b --out corpus.jsonl`` runs it over the synthetic query
set (``--queries FILE`` for a JSONL one; ``--endpoint`` may be
``model=url`` pairs).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..looper.looper import HTTPLLMClient

_WORD = re.compile(r"[a-z0-9]{2,}")


@dataclass
class BenchmarkQuery:
    query: str
    category: str = "other"
    expected: str = ""          # reference answer text ('' = none)


@dataclass
class BenchmarkResult:
    query: str
    category: str
    model: str
    quality: float
    latency_ms: float
    answer: str = ""
    error: str = ""


def keyword_scorer(answer: str, query: BenchmarkQuery) -> float:
    """A recall-style score in [0, 1]."""
    a_words = set(_WORD.findall(answer.lower()))
    if not a_words:
        return 0.0
    target = query.expected or query.query
    t_words = set(_WORD.findall(target.lower()))
    if not t_words:
        return 0.5
    recall = len(a_words & t_words) / len(t_words)
    if query.expected:
        return round(recall, 4)
    return round(0.2 + 0.8 * min(recall, 1.0), 4)


class BenchmarkRunner:
    """Drives queries × candidates on ``concurrency`` threads; ``resolve``
    maps a model to its base URL."""

    def __init__(self, resolve: Callable[[str], str],
                 scorer: Callable[[str, BenchmarkQuery], float]
                 = keyword_scorer,
                 timeout_s: float = 60.0, concurrency: int = 4) -> None:
        self.client = HTTPLLMClient(resolve, timeout_s=timeout_s)
        self.scorer = scorer
        self.concurrency = max(1, concurrency)

    def run_one(self, q: BenchmarkQuery, model: str) -> BenchmarkResult:
        body = {"messages": [{"role": "user", "content": q.query}]}
        t0 = time.perf_counter()
        try:
            resp = self.client.complete(body, model)
            latency = (time.perf_counter() - t0) * 1e3
            answer = ""
            choices = resp.get("choices") or []
            if choices:
                answer = str((choices[0].get("message") or {})
                             .get("content", ""))
            return BenchmarkResult(
                query=q.query, category=q.category, model=model,
                quality=self.scorer(answer, q),
                latency_ms=round(latency, 3), answer=answer[:500])
        except Exception as exc:
            return BenchmarkResult(
                query=q.query, category=q.category, model=model,
                quality=0.0,
                latency_ms=round((time.perf_counter() - t0) * 1e3, 3),
                error=f"{type(exc).__name__}: {exc}"[:200])

    def run(self, queries: Sequence[BenchmarkQuery],
            models: Sequence[str],
            progress: Optional[Callable[[int, int], None]] = None
            ) -> List[BenchmarkResult]:
        """Every (query, model) pair's result, in query-major order."""
        jobs = [(q, m) for q in queries for m in models]
        results: List[Optional[BenchmarkResult]] = [None] * len(jobs)
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.concurrency) as pool:
            futs = {pool.submit(self.run_one, q, m): i
                    for i, (q, m) in enumerate(jobs)}
            done = 0
            for fut in concurrent.futures.as_completed(futs):
                results[futs[fut]] = fut.result()
                done += 1
                if progress:
                    progress(done, len(jobs))
        return [r for r in results if r is not None]

    @staticmethod
    def write_jsonl(results: Sequence[BenchmarkResult], path: str) -> int:
        """The results as routing records (query, category, model,
        quality, latency_ms); the lines written."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n = 0
        with open(path, "w") as f:
            for r in results:
                f.write(json.dumps({
                    "query": r.query, "category": r.category,
                    "model": r.model, "quality": r.quality,
                    "latency_ms": r.latency_ms,
                }) + "\n")
                n += 1
        return n


def load_queries(path: str) -> List[BenchmarkQuery]:
    """JSONL: {"query": ..., "category": ..., "expected": ...}."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            out.append(BenchmarkQuery(
                query=d["query"], category=d.get("category", "other"),
                expected=d.get("expected", "")))
    return out


def synthetic_queries(n: int = 40) -> List[BenchmarkQuery]:
    cats = {
        "computer science": "explain how a {} hash table resolves "
                            "collisions",
        "math": "compute the derivative of x**{} + 3x",
        "health": "what are early symptoms of {} deficiency",
        "business": "draft a {}-quarter revenue summary outline",
    }
    out = []
    keys = list(cats)
    for i in range(n):
        cat = keys[i % len(keys)]
        out.append(BenchmarkQuery(query=cats[cat].format(i), category=cat))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="semantic_router_tpu_torch.modelselection.benchmark")
    ap.add_argument("--endpoint", required=True,
                    help="OpenAI-compatible base URL all candidates "
                         "share, or model=url pairs (comma-separated)")
    ap.add_argument("--models", required=True,
                    help="comma-separated candidate model names")
    ap.add_argument("--queries", default="",
                    help="JSONL query file (default: synthetic corpus)")
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--out", required=True,
                    help="output routing-record JSONL")
    ap.add_argument("--concurrency", type=int, default=4)
    args = ap.parse_args(argv)

    # a model=url table only when every part maps a bare name (no URL,
    # no query string on the key side) to a URL
    parts = args.endpoint.split(",")
    is_table = all(
        "=" in p
        and "://" in p.split("=", 1)[1]
        and "://" not in p.split("=", 1)[0]
        and "?" not in p.split("=", 1)[0]
        for p in parts)
    if is_table:
        table = dict(pair.split("=", 1) for pair in parts)
        resolve = lambda m: table.get(m, "")  # noqa: E731
    else:
        resolve = lambda m: args.endpoint  # noqa: E731
    models = [m for m in args.models.split(",") if m]
    queries = load_queries(args.queries) if args.queries else \
        synthetic_queries(args.n)
    runner = BenchmarkRunner(resolve, concurrency=args.concurrency)
    results = runner.run(
        queries, models,
        progress=lambda d, t: sys.stderr.write(f"\r{d}/{t}"))
    sys.stderr.write("\n")
    n = runner.write_jsonl(results, args.out)
    errs = sum(1 for r in results if r.error)
    print(json.dumps({"records": n, "errors": errs, "out": args.out,
                      "models": models}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
