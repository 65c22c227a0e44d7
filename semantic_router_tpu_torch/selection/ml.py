"""Selectors over query embeddings: KNN, KMeans, SVM, an MLP, router_dc
(per-model prototypes) and gmtrouter (graph score propagation).

All read ``ctx.embedding()``.  The port's copy of the JAX package's
``selection/ml.py``, with the same JSON formats (a selector saved by one
package loads into the other).  Where the JAX package runs on its device
(KMeans's Lloyd iterations, the MLP's forward and its Adam fit), the port
runs torch on the selector's ``device`` (``cuda`` unless the caller names
one), inside its ``gate``: the router passes its engine's device and the
engine's capture gate, held shared, so a fit on a server thread never
launches while an engine step is being captured.  KNN, SVM, router_dc
and the rest stay host numpy, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import threading
from typing import Callable, ContextManager, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ModelRef
from ..utils.device import DeviceLike, resolve_device
from .base import (
    Feedback,
    SelectionContext,
    SelectionResult,
    registry,
)


class DeviceWork:
    """Where a selector's torch work runs: ``device`` (``cuda`` when None)
    and ``gate``, a zero-argument callable whose context the work runs in.
    Built from a selector's keyword arguments, which it leaves in place for
    the selector's fallback."""

    def __init__(self, device: DeviceLike = None,
                 gate: Optional[Callable[[], ContextManager]] = None,
                 **_) -> None:
        self.device = device
        self.gate = gate

    @contextlib.contextmanager
    def __call__(self):
        dev = resolve_device(self.device)
        with self.gate() if self.gate is not None \
                else contextlib.nullcontext():
            yield dev


def _reward(fb: Feedback) -> float:
    return fb.quality if fb.quality else (1.0 if fb.success else 0.0)


class _EmbeddingMemory:
    """Shared (embedding, model, reward) memory for instance-based
    selectors."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self.embeddings: List[np.ndarray] = []
        self.models: List[str] = []
        self.rewards: List[float] = []
        self._lock = threading.Lock()

    def add(self, emb: np.ndarray, model: str, reward: float) -> None:
        with self._lock:
            self.embeddings.append(np.asarray(emb, np.float32))
            self.models.append(model)
            self.rewards.append(reward)
            if len(self.embeddings) > self.capacity:
                drop = len(self.embeddings) - self.capacity
                del self.embeddings[:drop]
                del self.models[:drop]
                del self.rewards[:drop]

    def matrix(self):
        with self._lock:
            if not self.embeddings:
                return None, [], []
            return (np.stack(self.embeddings), list(self.models),
                    list(self.rewards))


class KNNSelector:
    """k-nearest-neighbor vote over past (query, model, reward)
    outcomes."""

    name = "knn"

    def __init__(self, k: int = 8, fallback: str = "static", **kwargs):
        self.k = k
        self.memory = _EmbeddingMemory()
        self._fallback = registry.create(fallback, **kwargs)

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        emb = ctx.embedding()
        mat, models, rewards = self.memory.matrix()
        if emb is None or mat is None or len(models) < self.k:
            return self._fallback.select(candidates, ctx)
        sims = mat @ emb / (
            np.linalg.norm(mat, axis=1) * max(np.linalg.norm(emb), 1e-9))
        top = np.argsort(-sims)[:self.k]
        cand_names = {c.model for c in candidates}
        votes: Dict[str, float] = {}
        for i in top:
            if models[i] in cand_names:
                votes[models[i]] = votes.get(models[i], 0.0) \
                    + float(sims[i]) * rewards[i]
        if not votes:
            return self._fallback.select(candidates, ctx)
        best_name = max(votes, key=votes.get)
        best = next(c for c in candidates if c.model == best_name)
        return SelectionResult(best, votes[best_name], f"knn k={self.k}")

    def update(self, fb: Feedback) -> None:
        if fb.query_embedding is not None:
            self.memory.add(fb.query_embedding, fb.model, _reward(fb))
        self._fallback.update(fb)

    def to_json(self) -> str:
        mat, models, rewards = self.memory.matrix()
        return json.dumps({
            "algorithm": "knn", "k": self.k,
            "embeddings": mat.tolist() if mat is not None else [],
            "models": models, "rewards": rewards})

    @classmethod
    def from_json(cls, blob: str, **kwargs) -> "KNNSelector":
        data = json.loads(blob)
        sel = cls(k=data.get("k", 8), **kwargs)
        embs = np.asarray(data.get("embeddings", []), np.float32)
        for i, (m, r) in enumerate(zip(data.get("models", []),
                                       data.get("rewards", []))):
            sel.memory.add(embs[i], m, float(r))
        return sel


def lloyd(x: np.ndarray, init: np.ndarray, iters: int,
          work: DeviceWork) -> np.ndarray:
    """Lloyd's iterations from centroids ``init`` [k, d] over ``x`` [N, d]
    on ``work``'s device: assign by argmin of squared distance, then each
    centroid to the mean of its rows (``index_add_``); a centroid with no
    rows stays."""
    with work() as dev, torch.no_grad():
        xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
        cents = torch.as_tensor(init, dtype=torch.float32).to(dev)
        k = cents.shape[0]
        ones = torch.ones(xt.shape[0], dtype=torch.float32, device=dev)
        for _ in range(iters):
            assign = ((xt[:, None, :] - cents[None, :, :]) ** 2) \
                .sum(-1).argmin(1)
            sums = torch.zeros_like(cents).index_add_(0, assign, xt)
            counts = torch.zeros(k, dtype=torch.float32, device=dev) \
                .index_add_(0, assign, ones)[:, None]
            cents = torch.where(counts > 0, sums / counts.clamp_min(1),
                                cents)
        return cents.cpu().numpy()


class KMeansSelector:
    """Cluster query embeddings; route each cluster to its best-performing
    model.  The Lloyd iterations run on the selector's device."""

    name = "kmeans"

    def __init__(self, n_clusters: int = 8, refit_every: int = 64,
                 fallback: str = "static", **kwargs):
        self.n_clusters = n_clusters
        self.refit_every = refit_every
        self.memory = _EmbeddingMemory()
        self.centroids: Optional[np.ndarray] = None
        self.cluster_best: Dict[int, str] = {}
        self._since_fit = 0
        self.work = DeviceWork(**kwargs)
        self._fallback = registry.create(fallback, **kwargs)
        self._lock = threading.Lock()

    def fit_kmeans(self, x: np.ndarray, k: int, iters: int = 25,
                   seed: int = 0) -> np.ndarray:
        """[N, d] → [k, d] centroids, from k distinct rows drawn as the JAX
        package draws them."""
        n = x.shape[0]
        k = min(k, n)
        rng = np.random.default_rng(seed)
        init = x[rng.choice(n, size=k, replace=False)]
        return lloyd(x, init, iters, self.work)

    def _maybe_fit(self) -> None:
        mat, models, rewards = self.memory.matrix()
        if mat is None or len(models) < self.n_clusters:
            return
        self.centroids = self.fit_kmeans(mat, self.n_clusters)
        d = ((mat[:, None, :] - self.centroids[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1)
        best: Dict[int, Dict[str, float]] = {}
        for a, m, r in zip(assign, models, rewards):
            best.setdefault(int(a), {}).setdefault(m, 0.0)
            best[int(a)][m] += r
        self.cluster_best = {a: max(ms, key=ms.get)
                             for a, ms in best.items()}

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        emb = ctx.embedding()
        with self._lock:
            cents = self.centroids
            mapping = dict(self.cluster_best)
        if emb is None or cents is None:
            return self._fallback.select(candidates, ctx)
        cluster = int(((cents - emb) ** 2).sum(1).argmin())
        model = mapping.get(cluster)
        for c in candidates:
            if c.model == model:
                return SelectionResult(c, 1.0, f"kmeans cluster {cluster}")
        return self._fallback.select(candidates, ctx)

    def update(self, fb: Feedback) -> None:
        if fb.query_embedding is not None:
            self.memory.add(fb.query_embedding, fb.model, _reward(fb))
            with self._lock:
                self._since_fit += 1
                if self._since_fit >= self.refit_every:
                    self._since_fit = 0
                    self._maybe_fit()
        self._fallback.update(fb)

    def to_json(self) -> str:
        with self._lock:
            return json.dumps({
                "algorithm": "kmeans", "n_clusters": self.n_clusters,
                "refit_every": self.refit_every,
                "centroids": self.centroids.tolist()
                if self.centroids is not None else [],
                "cluster_best": {str(k): v
                                 for k, v in self.cluster_best.items()}})

    @classmethod
    def from_json(cls, blob: str, **kwargs) -> "KMeansSelector":
        data = json.loads(blob)
        sel = cls(n_clusters=data.get("n_clusters", 8), **kwargs)
        # frozen clusters (a huge refit_every) stay frozen after a restore
        sel.refit_every = int(data.get("refit_every", sel.refit_every))
        cents = data.get("centroids", [])
        if cents:
            sel.centroids = np.asarray(cents, np.float32)
            sel.cluster_best = {int(k): v
                                for k, v in data["cluster_best"].items()}
        return sel


class SVMSelector:
    """Linear one-vs-rest SVM over query embeddings: hinge-loss SGD refit
    from the outcome memory (host numpy)."""

    name = "svm"

    def __init__(self, refit_every: int = 64, lr: float = 0.1,
                 reg: float = 1e-3, epochs: int = 10,
                 fallback: str = "static", **kwargs):
        self.refit_every = refit_every
        self.lr, self.reg, self.epochs = lr, reg, epochs
        self.memory = _EmbeddingMemory()
        self.weights: Optional[np.ndarray] = None  # [n_classes, d+1]
        self.classes: List[str] = []
        self._since_fit = 0
        self._fallback = registry.create(fallback, **kwargs)
        self._lock = threading.Lock()

    def fit(self, feats: np.ndarray, labels: Sequence[str]) -> None:
        """One-vs-rest hinge SGD over already-selected samples."""
        classes = sorted(set(labels))
        if len(classes) < 2:
            return
        x = np.concatenate([np.asarray(feats, np.float32),
                            np.ones((len(feats), 1), np.float32)], axis=1)
        y = np.asarray([[1.0 if l == c else -1.0 for c in classes]
                        for l in labels], np.float32)
        w = np.zeros((len(classes), x.shape[1]), np.float32)
        rng = np.random.default_rng(0)
        for _ in range(self.epochs):
            for i in rng.permutation(len(x)):
                margins = y[i] * (w @ x[i])
                mask = margins < 1.0
                w = (1 - self.lr * self.reg) * w
                w[mask] += self.lr * y[i][mask, None] * x[i][None, :]
        with self._lock:
            self.weights, self.classes = w, classes

    def _fit(self) -> None:
        mat, models, rewards = self.memory.matrix()
        if mat is None:
            return
        good = [i for i, r in enumerate(rewards) if r > 0.5]
        if len(good) < 8:
            return
        self.fit(mat[good], [models[i] for i in good])

    def to_json(self) -> str:
        with self._lock:
            return json.dumps({
                "algorithm": "svm", "classes": self.classes,
                "weights": self.weights.tolist()
                if self.weights is not None else []})

    @classmethod
    def from_json(cls, blob: str, **kwargs) -> "SVMSelector":
        data = json.loads(blob)
        sel = cls(**kwargs)
        if data.get("weights"):
            sel.weights = np.asarray(data["weights"], np.float32)
            sel.classes = list(data["classes"])
        return sel

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        emb = ctx.embedding()
        with self._lock:
            w, classes = self.weights, list(self.classes)
        if emb is None or w is None:
            return self._fallback.select(candidates, ctx)
        x = np.concatenate([emb, [1.0]]).astype(np.float32)
        scores = w @ x
        order = np.argsort(-scores)
        cand = {c.model: c for c in candidates}
        for i in order:
            if classes[i] in cand:
                return SelectionResult(cand[classes[i]], float(scores[i]),
                                       "svm margin")
        return self._fallback.select(candidates, ctx)

    def update(self, fb: Feedback) -> None:
        if fb.query_embedding is not None:
            self.memory.add(fb.query_embedding, fb.model, _reward(fb))
            self._since_fit += 1
            if self._since_fit >= self.refit_every:
                self._since_fit = 0
                self._fit()
        self._fallback.update(fb)


class _MLP(nn.Module):
    """tanh(x @ w1 + b1) @ w2 + b2, with the JAX package's parameter names
    and shapes (w1 [d, hidden], w2 [hidden, classes])."""

    def __init__(self, d: int, hidden: int, n_classes: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        self.w1 = nn.Parameter(torch.randn(d, hidden, generator=generator)
                               * (1 / np.sqrt(d)))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(torch.randn(hidden, n_classes,
                                           generator=generator)
                               * (1 / np.sqrt(hidden)))
        self.b2 = nn.Parameter(torch.zeros(n_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(dict(self.named_parameters()), x)


def mlp_forward(params: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"] \
        + params["b2"]


class MLPSelector:
    """Two-layer MLP scoring (embedding → model logits), trained from the
    outcome memory with Adam on the selector's device; JSON round trip.
    The initial weights come from ``torch.Generator`` seed 0 (the JAX
    package draws them from ``PRNGKey(0)``): the same parameters score
    alike in both packages, a fit from the same data lands on different
    ones."""

    name = "mlp"

    def __init__(self, hidden: int = 64, refit_every: int = 64,
                 lr: float = 1e-2, epochs: int = 30,
                 fallback: str = "static", **kwargs):
        self.hidden = hidden
        self.refit_every = refit_every
        self.lr, self.epochs = lr, epochs
        self.memory = _EmbeddingMemory()
        self.params: Optional[dict] = None
        self.classes: List[str] = []
        self._since_fit = 0
        self.work = DeviceWork(**kwargs)
        self._fallback = registry.create(fallback, **kwargs)
        self._lock = threading.Lock()
        self._on_device: tuple = (None, None)  # (params, device copies)

    def fit(self, x: np.ndarray, labels: Sequence[str]) -> None:
        classes = sorted(set(labels))
        if len(classes) < 2:
            return
        y = np.asarray([classes.index(l) for l in labels])
        with self.work() as dev, torch.inference_mode(False), \
                torch.enable_grad():
            mlp = _MLP(x.shape[1], self.hidden, len(classes),
                       torch.Generator().manual_seed(0)).to(dev)
            opt = torch.optim.Adam(mlp.parameters(), lr=self.lr)
            xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
            yt = torch.as_tensor(y).to(dev)
            for _ in range(self.epochs):
                opt.zero_grad()
                F.cross_entropy(mlp(xt), yt).backward()
                opt.step()
            params = {k: v.detach().cpu().numpy()
                      for k, v in mlp.named_parameters()}
        with self._lock:
            self.params = params
            self.classes = classes

    def _refit_from_memory(self) -> None:
        mat, models, rewards = self.memory.matrix()
        if mat is None:
            return
        good = [i for i, r in enumerate(rewards) if r > 0.5]
        if len(good) >= 8:
            self.fit(mat[good], [models[i] for i in good])

    def scores(self, emb: np.ndarray) -> np.ndarray:
        """The logits of one embedding, on the selector's device (the
        parameters are copied there once per fit or load)."""
        with self._lock:
            params = self.params
            held, copies = self._on_device
        with self.work() as dev, torch.no_grad():
            if held is not params:
                copies = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                          for k, v in params.items()}
                with self._lock:
                    self._on_device = (params, copies)
            x = torch.as_tensor(np.asarray(emb, np.float32)[None, :]).to(dev)
            return mlp_forward(copies, x)[0].cpu().numpy()

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        emb = ctx.embedding()
        with self._lock:
            params, classes = self.params, list(self.classes)
        if emb is None or params is None:
            return self._fallback.select(candidates, ctx)
        logits = self.scores(emb)
        order = np.argsort(-logits)
        cand = {c.model: c for c in candidates}
        for i in order:
            if classes[i] in cand:
                return SelectionResult(cand[classes[i]], float(logits[i]),
                                       "mlp")
        return self._fallback.select(candidates, ctx)

    def update(self, fb: Feedback) -> None:
        if fb.query_embedding is not None:
            self.memory.add(fb.query_embedding, fb.model, _reward(fb))
            self._since_fit += 1
            if self._since_fit >= self.refit_every:
                self._since_fit = 0
                self._refit_from_memory()
        self._fallback.update(fb)

    def to_json(self) -> str:
        with self._lock:
            return json.dumps({
                "algorithm": "mlp",
                "hidden": self.hidden,
                "classes": self.classes,
                "params": {k: v.tolist()
                           for k, v in (self.params or {}).items()},
            })

    @classmethod
    def from_json(cls, blob: str, **kwargs) -> "MLPSelector":
        data = json.loads(blob)
        sel = cls(hidden=data["hidden"], **kwargs)
        if data["params"]:
            sel.params = {k: np.asarray(v, np.float32)
                          for k, v in data["params"].items()}
            sel.classes = list(data["classes"])
        return sel


class RouterDCSelector:
    """Dual-contrastive routing: per-model prototype embeddings learned
    from positively-rated queries; select by the highest prototype
    similarity."""

    name = "router_dc"

    def __init__(self, momentum: float = 0.9, fallback: str = "static",
                 **kwargs):
        self.momentum = momentum
        self.prototypes: Dict[str, np.ndarray] = {}
        self._fallback = registry.create(fallback, **kwargs)
        self._lock = threading.Lock()

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        emb = ctx.embedding()
        with self._lock:
            protos = dict(self.prototypes)
        if emb is None or not protos:
            return self._fallback.select(candidates, ctx)
        n = max(np.linalg.norm(emb), 1e-9)
        scores = {}
        for c in candidates:
            p = protos.get(c.model)
            if p is not None:
                scores[c.model] = float(
                    emb @ p / (n * max(np.linalg.norm(p), 1e-9)))
        if not scores:
            return self._fallback.select(candidates, ctx)
        best_name = max(scores, key=scores.get)
        best = next(c for c in candidates if c.model == best_name)
        return SelectionResult(best, scores[best_name], "router_dc prototype")

    def update(self, fb: Feedback) -> None:
        if fb.query_embedding is not None and fb.success:
            with self._lock:
                p = self.prototypes.get(fb.model)
                e = np.asarray(fb.query_embedding, np.float32)
                self.prototypes[fb.model] = e if p is None else \
                    self.momentum * p + (1 - self.momentum) * e
        self._fallback.update(fb)


class GMTRouterSelector:
    """Graph-based routing: a bipartite query-cluster ↔ model graph whose
    edge weights come from rewards and propagate one hop, so sparsely
    observed clusters inherit neighboring evidence."""

    name = "gmtrouter"

    def __init__(self, n_nodes: int = 16, fallback: str = "static", **kwargs):
        self.kmeans = KMeansSelector(n_clusters=n_nodes, fallback=fallback,
                                     **kwargs)
        self._edge: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        emb = ctx.embedding()
        cents = self.kmeans.centroids
        if emb is None or cents is None:
            return self.kmeans.select(candidates, ctx)
        d = ((cents - emb) ** 2).sum(1)
        order = np.argsort(d)
        with self._lock:
            scores: Dict[str, float] = {}
            for rank, node in enumerate(order[:3]):  # one-hop propagation
                w = 1.0 / (1 + rank)
                for c in candidates:
                    e = self._edge.get((int(node), c.model))
                    if e is not None:
                        scores[c.model] = scores.get(c.model, 0.0) + w * e
        if not scores:
            return self.kmeans.select(candidates, ctx)
        best_name = max(scores, key=scores.get)
        best = next(c for c in candidates if c.model == best_name)
        return SelectionResult(best, scores[best_name], "gmtrouter graph")

    def update(self, fb: Feedback) -> None:
        self.kmeans.update(fb)
        if fb.query_embedding is not None and self.kmeans.centroids is not None:
            node = int(((self.kmeans.centroids - fb.query_embedding) ** 2)
                       .sum(1).argmin())
            with self._lock:
                key = (node, fb.model)
                self._edge[key] = 0.8 * self._edge.get(key, 0.5) \
                    + 0.2 * _reward(fb)

    def to_json(self) -> str:
        with self._lock:
            edges = [[n, m, w] for (n, m), w in self._edge.items()]
        return json.dumps({
            "algorithm": "gmtrouter",
            "kmeans": json.loads(self.kmeans.to_json()),
            "edges": edges})

    @classmethod
    def from_json(cls, blob: str, **kwargs) -> "GMTRouterSelector":
        data = json.loads(blob)
        km = data.get("kmeans", {})
        sel = cls(n_nodes=km.get("n_clusters", 16), **kwargs)
        sel.kmeans = KMeansSelector.from_json(json.dumps(km), **kwargs)
        for n, m, w in data.get("edges", []):
            sel._edge[(int(n), m)] = float(w)
        return sel


for _cls in (KNNSelector, KMeansSelector, SVMSelector, MLPSelector,
             RouterDCSelector, GMTRouterSelector):
    registry.register(_cls.name, _cls)
