"""Offline training of selector artifacts from a routing-benchmark corpus.

A corpus is a list of ``RoutingRecord``s — (query, category, model,
quality, latency) — as JSONL (``load_routing_jsonl``; the
``modelselection`` benchmark runner writes them).  ``featurize`` groups
them per query: the features are the query's embedding followed by a
scaled category one-hot, the label the best model (quality first, ties
within 0.02 to the faster one).  ``train_selector`` fits knn, kmeans,
svm, mlp or gmtrouter and returns the selector's JSON with its feature
recipe (``features``); ``load_selector`` loads an artifact back into its
serving selector, wrapped in ``CategoryFeatureSelector`` so the serving
pipeline's raw query embedding gains the one-hot the weights were
trained on.  An artifact whose recipe is the built-in crc32 feature hash
(``hash_embed``, the trainer's default embedding) is served in that
space; one trained on a model's embeddings (``embed_fn``) is served on
the router's embedding task.  Artifacts are the reference package's
JSON: either package loads the other's.

The torch selectors (kmeans, mlp, gmtrouter) fit on ``device`` (``cuda``
unless given).  A ``cost_bandit`` artifact — the routing flywheel's
policy — loads into ``flywheel.policy.CostAwareBanditSelector``, as the
reference's does.  ``python -m semantic_router_tpu_torch.training.
selection_train --device cpu`` trains every algorithm on the synthetic
corpus and prints each artifact's routing accuracy.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

CATEGORIES = ["business", "law", "psychology", "biology", "chemistry",
              "history", "other", "health", "economics", "math",
              "physics", "computer science", "philosophy", "engineering"]


@dataclasses.dataclass
class RoutingRecord:
    """One benchmark observation: how ``model`` did on ``query``."""

    query: str
    category: str
    model: str
    quality: float            # [0, 1]
    latency_ms: float


def load_routing_jsonl(path: str) -> List[RoutingRecord]:
    rows = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            rows.append(RoutingRecord(
                query=r["query"], category=r.get("category", "other"),
                model=r["model"], quality=float(r.get("quality", 0.0)),
                latency_ms=float(r.get("latency_ms", 0.0))))
    return rows


_QUERY_TEMPLATES = {
    "computer science": ["implement {x} in python", "debug the {x} module",
                         "optimize {x} complexity"],
    "math": ["prove the {x} theorem", "solve the {x} equation",
             "integrate {x} by parts"],
    "law": ["is {x} enforceable under contract law",
            "summarize the {x} statute"],
    "health": ["what are symptoms of {x}", "treatment options for {x}"],
    "business": ["draft a {x} business plan", "analyze the {x} market"],
    "other": ["tell me about {x}", "write a short note on {x}"],
}
_FILLERS = ["alpha", "beta", "gamma", "delta", "omega", "sigma",
            "lambda", "kappa"]


def synthetic_routing_dataset(n_queries: int = 120, seed: int = 0,
                              models: Sequence[str] = (
                                  "code-7b", "general-7b", "premium-70b"),
                              ) -> List[RoutingRecord]:
    """A seeded corpus with structure to learn: code-7b wins computer
    science and math, premium-70b law and health (slower), general-7b
    the rest."""
    rng = np.random.default_rng(seed)
    cats = list(_QUERY_TEMPLATES)
    rows: List[RoutingRecord] = []
    for i in range(n_queries):
        cat = cats[i % len(cats)]
        tpl = _QUERY_TEMPLATES[cat][i % len(_QUERY_TEMPLATES[cat])]
        q = tpl.format(x=_FILLERS[i % len(_FILLERS)]) + f" case {i}"
        for m in models:
            if m == "code-7b":
                base = 0.9 if cat in ("computer science", "math") else 0.45
                lat = 800
            elif m == "premium-70b":
                base = 0.9 if cat in ("law", "health") else 0.75
                lat = 3000
            else:
                base = 0.8 if cat in ("business", "other") else 0.55
                lat = 900
            rows.append(RoutingRecord(
                q, cat, m,
                float(np.clip(base + rng.normal(0, 0.05), 0, 1)),
                lat * float(rng.uniform(0.8, 1.2))))
    return rows


# -- features --------------------------------------------------------------


def hash_embed(texts: Sequence[str], dim: int = 64,
               seed: int = 0) -> np.ndarray:
    """A signed feature hash of token uni- and bigrams, L2-normalized:
    the trainer's embedding when no model is given.  crc32, so an
    artifact means the same thing in every process."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        toks = t.lower().split()
        for g in toks + [" ".join(p) for p in zip(toks, toks[1:])]:
            h = zlib.crc32(g.encode("utf-8")) ^ seed
            out[i, h % dim] += 1.0 if (h >> 1) % 2 else -1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-9)


# the one-hot's scale: distance across categories outweighs the spread
# of embeddings within one
CATEGORY_SCALE = 2.0


def category_onehot(cat: str) -> np.ndarray:
    v = np.zeros((len(CATEGORIES),), np.float32)
    try:
        v[CATEGORIES.index(cat)] = CATEGORY_SCALE
    except ValueError:
        v[CATEGORIES.index("other")] = CATEGORY_SCALE
    return v


def group_best(records: Sequence[RoutingRecord]
               ) -> Tuple[List[str], List[str], List[str]]:
    """(queries in first-seen order, their best models, their
    categories): the highest quality, ties within 0.02 to the lower
    latency."""
    by_q: Dict[str, List[RoutingRecord]] = {}
    for r in records:
        by_q.setdefault(r.query, []).append(r)
    queries = list(by_q)
    labels, cats = [], []
    for q in queries:
        rs = by_q[q]
        best = max(rs, key=lambda r: (round(r.quality / 0.02),
                                      -r.latency_ms))
        labels.append(best.model)
        cats.append(rs[0].category)
    return queries, labels, cats


def featurize(records: Sequence[RoutingRecord],
              embed_fn: Optional[Callable[[Sequence[str]], np.ndarray]]
              = None) -> Tuple[np.ndarray, List[str], Dict[str, int]]:
    """(features [N, d + 14], best-model labels, label counts), one
    embedding pass over the unique queries (``embed_fn``, else
    ``hash_embed``)."""
    queries, labels, cats = group_best(records)
    embed_fn = embed_fn or hash_embed
    embs = np.asarray(embed_fn(queries), np.float32)
    feats = [np.concatenate([embs[qi], category_onehot(c)])
             for qi, c in enumerate(cats)]
    counts: Dict[str, int] = {}
    for l in labels:
        counts[l] = counts.get(l, 0) + 1
    return np.stack(feats), labels, counts


class CategoryFeatureSelector:
    """A trained selector served on embedding ⊕ one-hot features: the
    query embedding the pipeline gives (or the feature hash, for a
    hash-trained artifact) gains the scaled one-hot of ``ctx.category``
    (``fb.category`` for feedback) before the inner selector sees it.
    An embedding of another width than the trained one raises (and logs
    ``artifact_dim_mismatch`` once)."""

    def __init__(self, inner, embedding_dim: int = 0,
                 hash_fallback: bool = False) -> None:
        self.inner = inner
        self.name = getattr(inner, "name", "trained")
        self.embedding_dim = embedding_dim
        self.hash_fallback = hash_fallback
        self._dim_warned = False

    def _check_dim(self, e: np.ndarray) -> None:
        if self.embedding_dim and e.shape[-1] != self.embedding_dim:
            if not self._dim_warned:
                self._dim_warned = True
                from ..observability.logging import component_event

                component_event("selection", "artifact_dim_mismatch",
                                expected=self.embedding_dim,
                                got=int(e.shape[-1]), level="warning")
            raise ValueError(f"embedding dim {e.shape[-1]} != artifact's "
                             f"trained dim {self.embedding_dim}")

    def _augment_ctx(self, ctx):
        base_fn = ctx.embed_fn
        if self.hash_fallback and self.embedding_dim:
            dim = self.embedding_dim
            base_fn = lambda q: hash_embed([q], dim=dim)[0]  # noqa: E731
        elif base_fn is None:
            return ctx
        cat = ctx.category

        def embed_fn(q, base_fn=base_fn):
            e = np.asarray(base_fn(q), np.float32)
            self._check_dim(e)
            return np.concatenate([e, category_onehot(cat)])

        return dataclasses.replace(ctx, embed_fn=embed_fn, _embedding=None)

    def select(self, candidates, ctx):
        return self.inner.select(candidates, self._augment_ctx(ctx))

    def update(self, fb) -> None:
        if fb.query_embedding is not None:
            fb = dataclasses.replace(fb, query_embedding=np.concatenate(
                [np.asarray(fb.query_embedding, np.float32),
                 category_onehot(fb.category)]))
        self.inner.update(fb)


# -- trainers --------------------------------------------------------------


def _tag_features(blob: str, feats: np.ndarray,
                  embed_kind: str = "crc32-hash-v1") -> str:
    """The artifact with its feature recipe: the one-hot and its scale,
    the embedding (``crc32-hash-v1``, self-contained, or ``external``)
    and the embedding's width."""
    data = json.loads(blob)
    data["features"] = {"category_onehot": True,
                        "category_scale": CATEGORY_SCALE,
                        "embed": embed_kind,
                        "embedding_dim": int(feats.shape[1])
                        - len(CATEGORIES)}
    return json.dumps(data)


def train_selector(algorithm: str, feats: np.ndarray,
                   labels: Sequence[str],
                   records: Optional[Sequence[RoutingRecord]] = None,
                   embed_fn=None, embed_kind: Optional[str] = None,
                   **kwargs) -> str:
    """Fit one algorithm on (features, labels); its JSON artifact.
    ``embed_kind`` names the embedding the features were built with: the
    crc32 hash unless an ``embed_fn`` was used (then ``external``: the
    serving side must not rebuild the space from the hash).  ``kwargs``
    go to the selector (``device``, ``gate`` included); gmtrouter replays
    every record of ``records``."""
    if embed_kind is None:
        embed_kind = "crc32-hash-v1" if embed_fn is None else "external"
    from ..selection.ml import (
        GMTRouterSelector,
        KMeansSelector,
        KNNSelector,
        MLPSelector,
        SVMSelector,
    )

    if algorithm in ("mlp", "svm"):
        sel = (MLPSelector if algorithm == "mlp" else SVMSelector)(**kwargs)
        sel.fit(feats, labels)
        return _tag_features(sel.to_json(), feats, embed_kind)
    if algorithm == "knn":
        sel = KNNSelector(**kwargs)
        for f, l in zip(feats, labels):
            sel.memory.add(f, l, 1.0)
        return _tag_features(sel.to_json(), feats, embed_kind)
    if algorithm == "kmeans":
        sel = KMeansSelector(n_clusters=kwargs.pop("n_clusters", 8),
                             **kwargs)
        for f, l in zip(feats, labels):
            sel.memory.add(f, l, 1.0)
        sel._maybe_fit()
        # frozen: a restored artifact has centroids and an empty memory,
        # which an online refit would orphan from its cluster labels
        sel.refit_every = 1 << 30
        return _tag_features(sel.to_json(), feats, embed_kind)
    if algorithm == "gmtrouter":
        from ..selection.base import Feedback

        sel = GMTRouterSelector(n_nodes=kwargs.pop("n_nodes", 8), **kwargs)
        if records is None:
            raise ValueError(
                "gmtrouter pre-training requires the full records (it "
                "replays every outcome, not just per-query winners)")
        queries = sorted({r.query for r in records})
        embs = np.asarray((embed_fn or hash_embed)(queries), np.float32)
        emb_by_q = {q: embs[i] for i, q in enumerate(queries)}
        cat_by_q = {r.query: r.category for r in records}
        # the node clusters, fitted on every query and frozen
        for f, l in zip(feats, labels):
            sel.kmeans.memory.add(np.asarray(f, np.float32), l, 1.0)
        sel.kmeans._maybe_fit()
        sel.kmeans.refit_every = 1 << 30
        # every outcome replayed onto the frozen graph, its reward the
        # advantage over the query's mean quality
        mean_q: Dict[str, List[float]] = {}
        for r in records:
            mean_q.setdefault(r.query, []).append(r.quality)
        for r in records:
            adv = r.quality - float(np.mean(mean_q[r.query]))
            feat = np.concatenate([emb_by_q[r.query],
                                   category_onehot(cat_by_q[r.query])])
            sel.update(Feedback(model=r.model, success=adv > 0,
                                quality=float(np.clip(0.5 + 2 * adv, 0, 1)),
                                latency_ms=r.latency_ms,
                                query_embedding=feat))
        return _tag_features(sel.to_json(), feats, embed_kind)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def load_selector(path: str, **kwargs):
    """The serving selector of the artifact at ``path`` (``kwargs`` —
    ``device``, ``gate`` — go to it), wrapped in
    ``CategoryFeatureSelector`` when it was trained on the one-hot
    features.  A ``cost_bandit`` artifact is the flywheel's bandit, whose
    signal-hash features need no wrapping (host numpy)."""
    from ..selection.ml import (
        GMTRouterSelector,
        KMeansSelector,
        KNNSelector,
        MLPSelector,
        SVMSelector,
    )

    with open(path) as f:
        blob = f.read()
    data = json.loads(blob)
    algo = data["algorithm"]
    if algo == "cost_bandit":
        # flywheel-trained contextual bandit: self-contained feature
        # recipe (signal-hash), no category wrapping needed
        from ..flywheel.policy import CostAwareBanditSelector

        return CostAwareBanditSelector.from_json(blob)
    cls = {"knn": KNNSelector, "kmeans": KMeansSelector,
           "svm": SVMSelector, "mlp": MLPSelector,
           "gmtrouter": GMTRouterSelector}[algo]
    sel = cls.from_json(blob, **kwargs)
    feats = data.get("features", {})
    if feats.get("category_onehot"):
        return CategoryFeatureSelector(
            sel, embedding_dim=int(feats.get("embedding_dim", 0)),
            hash_fallback=feats.get("embed") == "crc32-hash-v1")
    return sel


def evaluate_artifact(path: str, records: Sequence[RoutingRecord],
                      embed_fn=None,
                      embeddings: Optional[np.ndarray] = None,
                      **kwargs) -> float:
    """The fraction of the corpus's queries on which the artifact's
    serving selector picks the best model, driven as the pipeline drives
    it (the raw query embedding through ``ctx.embed_fn``, the category in
    ``ctx.category``).  ``embeddings`` (in ``group_best``'s query order)
    reuse an embedding pass."""
    from ..config.schema import ModelRef
    from ..selection.base import SelectionContext

    sel = load_selector(path, **kwargs)
    queries, labels, cats = group_best(records)
    embs = (np.asarray(embeddings, np.float32) if embeddings is not None
            else np.asarray((embed_fn or hash_embed)(queries), np.float32))
    models = sorted({r.model for r in records})
    cands = [ModelRef(model=m) for m in models]
    hits = 0
    for qi, (q, gold, cat) in enumerate(zip(queries, labels, cats)):
        ctx = SelectionContext(query=q, category=cat,
                               embed_fn=lambda _q, e=embs[qi]: e)
        hits += int(sel.select(cands, ctx).ref.model == gold)
    return hits / max(len(labels), 1)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="selector artifact training")
    ap.add_argument("--data-file", default="",
                    help="routing-benchmark JSONL (default: synthetic)")
    ap.add_argument("--output-dir", default="models/selection")
    ap.add_argument("--algorithms", default="knn,kmeans,svm,mlp,gmtrouter")
    ap.add_argument("--device", default=None,
                    help="where kmeans / mlp / gmtrouter fit (cuda)")
    args = ap.parse_args(argv)

    records = (load_routing_jsonl(args.data_file) if args.data_file
               else synthetic_routing_dataset())
    feats, labels, counts = featurize(records)
    embs = feats[:, :feats.shape[1] - len(CATEGORIES)]
    os.makedirs(args.output_dir, exist_ok=True)
    report = {"queries": len(labels), "label_counts": counts}
    for algo in args.algorithms.split(","):
        algo = algo.strip()
        blob = train_selector(algo, feats, labels, records=records,
                              device=args.device)
        path = os.path.join(args.output_dir, f"{algo}.json")
        with open(path, "w") as f:
            f.write(blob)
        report[algo] = {"artifact": path,
                        "accuracy": round(evaluate_artifact(
                            path, records, embeddings=embs,
                            device=args.device), 4)}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
