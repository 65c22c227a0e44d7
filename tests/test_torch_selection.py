"""The port's selection registry against the JAX package's, on the CPU:
every algorithm fed the same feedback sequence and queried on the same
contexts chooses the same model for the same reason, with equal scores
(within 1e-5 for kmeans, whose Lloyd iterations run in torch); the JSON
formats round-trip between the packages; an unknown algorithm raises.

The MLP selector's initial weights come from each package's own random
source, so its training is held to the same choices on separable data, and
its scores through the JSON round trip (the same parameters score alike)."""

import numpy as np
import pytest
import torch

from semantic_router_tpu.config import ModelCard as JCard
from semantic_router_tpu.config import ModelRef as JRef
from semantic_router_tpu.decision import SignalMatches as JMatches
from semantic_router_tpu.observability.inflight import \
    default_tracker as jinflight
from semantic_router_tpu import selection as jsel
from semantic_router_tpu_torch import selection as tsel
from semantic_router_tpu_torch.config import ModelCard as TCard
from semantic_router_tpu_torch.config import ModelRef as TRef
from semantic_router_tpu_torch.decision.engine import SignalMatches as TMatches
from semantic_router_tpu_torch.observability.inflight import \
    default_tracker as tinflight

SCORE_TOL = 1e-5  # kmeans: Lloyd in torch against jax.jit
D = 16
MODELS = ["small-7b", "mid-32b", "large-70b"]
REFS = [dict(model="small-7b", weight=0.5), dict(model="mid-32b", weight=0.3),
        dict(model="large-70b", weight=0.2)]
CARDS = [dict(name="small-7b", param_size="7B", context_window_size=32768,
              quality_score=0.7, pricing={"prompt": 0.2, "completion": 0.4}),
         dict(name="mid-32b", param_size="32B", context_window_size=65536,
              quality_score=0.85, pricing={"prompt": 0.5, "completion": 1.5}),
         dict(name="large-70b", param_size="70B", context_window_size=131072,
              quality_score=0.95, pricing={"prompt": 1.0, "completion": 3.0})]

_rng = np.random.default_rng(20261017)
CENTERS = _rng.standard_normal((3, D)).astype(np.float32) * 2.0
N_FEEDBACK = 72
N_QUERIES = 12


def _emb(cluster: int) -> np.ndarray:
    return (CENTERS[cluster]
            + 0.2 * _rng.standard_normal(D)).astype(np.float32)


# query text → embedding (the selectors' embed_fn)
EMBS = {}
FEEDBACK = []
for _i in range(N_FEEDBACK):
    _c = _i % 3
    EMBS[f"q{_i}"] = _emb(_c)
    FEEDBACK.append(dict(
        model=MODELS[_c], success=_i % 7 != 3,
        quality=0.0 if _i % 5 else 0.9, latency_ms=100.0 * (1 + _c)
        + _i, ttft_ms=10.0 * (1 + _c), category=("math", "code")[_i % 2],
        session_id=f"s{_i % 4}", query=f"q{_i}",
        winner=MODELS[(_i + 1) % 3] if _i % 4 == 0 else "",
        loser=MODELS[_i % 3] if _i % 4 == 0 else ""))
QUERIES = []
for _i in range(N_QUERIES):
    # every third query repeats a feedback's (a lookup-table hit)
    _q = f"q{_i * 5}" if _i % 3 == 0 else f"x{_i}"
    EMBS.setdefault(_q, _emb(_i % 3))
    QUERIES.append(dict(query=_q, category=("math", "code")[_i % 2],
                        session_id=f"s{_i % 5}", token_count=40000 * (_i % 3),
                        complexity=("hard", "easy", "medium")[_i % 3]))
# mid-stream selections see the feedback so far
MID_EVERY = 6

# (algorithm, keyword arguments); seeds make the numpy draws the same
ALGORITHMS = [
    ("static", dict(seed=0)),
    ("elo", dict(seed=0, exploration=0.2)),
    ("latency_aware", dict(percentile=75.0)),
    ("multi_factor", dict(weights={"load": 0.3})),
    ("automix", dict(cost_quality_tradeoff=0.4)),
    ("rl_driven", dict(seed=0, epsilon=0.3)),
    ("session_aware", dict(fallback="elo", seed=0)),
    ("hybrid", dict(seed=0, exploration=0.0)),
    ("lookup_table", dict(seed=0)),
    ("knn", dict(k=5, seed=0)),
    ("kmeans", dict(n_clusters=3, refit_every=16, seed=0)),
    ("svm", dict(refit_every=16, seed=0)),
    ("mlp", dict(hidden=16, refit_every=24, lr=0.05, epochs=60, seed=0)),
    ("router_dc", dict(seed=0)),
    ("gmtrouter", dict(n_nodes=3, refit_every=16, seed=0)),
]
TORCH_ALGOS = {"kmeans", "mlp", "gmtrouter"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Pkg:
    """One package's selection surface."""

    def __init__(self, sel, card, ref, matches, inflight, extra):
        self.sel, self.card, self.ref = sel, card, ref
        self.matches, self.inflight, self.extra = matches, inflight, extra

    def refs(self):
        return [self.ref(**r) for r in REFS]

    def ctx(self, q):
        sm = self.matches()
        sm.add("complexity", f"reasoning:{q['complexity']}", 0.7)
        return self.sel.SelectionContext(
            query=q["query"], category=q["category"],
            session_id=q["session_id"], token_count=q["token_count"],
            signals=sm, model_cards={c["name"]: self.card(**c)
                                     for c in CARDS},
            embed_fn=lambda text: EMBS[text])

    def feedback(self, fb):
        return self.sel.Feedback(**fb, query_embedding=EMBS[fb["query"]])


JAX = _Pkg(jsel, JCard, JRef, JMatches, jinflight, {})
PORT = _Pkg(tsel, TCard, TRef, TMatches, tinflight, {"device": "cpu"})


def _run(pkg: _Pkg, algo: str, kwargs: dict):
    """(selector, [(model, reason, score)]) over the feedback sequence with
    a selection every MID_EVERY feedbacks, then the queries."""
    sel = pkg.sel.registry.create(algo, **kwargs, **pkg.extra)
    refs = pkg.refs()
    tokens = [pkg.inflight.begin("large-70b") for _ in range(2)]
    try:
        out = []
        for i, fb in enumerate(FEEDBACK):
            if i % MID_EVERY == 0:
                q = QUERIES[(i // MID_EVERY) % N_QUERIES]
                r = sel.select(refs, pkg.ctx(q))
                out.append((r.ref.model, r.reason, float(r.score)))
            sel.update(pkg.feedback(fb))
        for q in QUERIES:
            r = sel.select(refs, pkg.ctx(q))
            out.append((r.ref.model, r.reason, float(r.score)))
    finally:
        for t in tokens:
            pkg.inflight.end("large-70b", t)
    return sel, out


def test_registry_has_every_jax_algorithm():
    # the JAX selection package's own 15; the flywheel of either package
    # registers its cost_bandit into its registry when imported (another
    # test file may have imported it in this process)
    names = sorted(a for a, _ in ALGORITHMS)
    assert sorted(set(tsel.registry.known()) - {"cost_bandit"}) == names
    assert set(names) <= set(jsel.registry.known())
    import semantic_router_tpu.flywheel  # noqa: F401
    import semantic_router_tpu_torch.flywheel  # noqa: F401

    assert "cost_bandit" in tsel.registry.known()
    assert "cost_bandit" in jsel.registry.known()


@pytest.mark.parametrize("algo,kwargs", ALGORITHMS,
                         ids=[a for a, _ in ALGORITHMS])
def test_same_choices_as_jax(algo, kwargs):
    _, want = _run(JAX, algo, kwargs)
    _, got = _run(PORT, algo, kwargs)
    assert len(got) == len(want)
    for i, ((gm, gr, gs), (wm, wr, ws)) in enumerate(zip(got, want)):
        assert (gm, gr) == (wm, wr), (i, got[i], want[i])
        if algo == "mlp" and wr == "mlp":
            continue  # trained from different initial weights
        if algo in TORCH_ALGOS:
            assert abs(gs - ws) <= SCORE_TOL, (i, gs, ws)
        else:
            assert gs == ws, (i, gs, ws)
    reasons = {r for _, r, _ in want}
    if algo != "static":
        # the learned path ran, not only the fallback
        assert reasons - {"weighted static"}, reasons


@pytest.mark.parametrize("algo", ["knn", "kmeans", "svm", "mlp",
                                  "gmtrouter"])
def test_json_round_trip_between_packages(algo):
    kwargs = dict(ALGORITHMS)[algo]
    jsel_, _ = _run(JAX, algo, kwargs)
    tsel_, _ = _run(PORT, algo, kwargs)
    jcls = type(jsel_)
    tcls = type(tsel_)
    blob = jsel_.to_json()
    loaded = tcls.from_json(blob, device="cpu")
    assert loaded.to_json() == blob
    back = jcls.from_json(tsel_.to_json())
    assert back.to_json() == tsel_.to_json()
    # the JAX package's state, loaded into the port, scores alike
    refs_j, refs_t = JAX.refs(), PORT.refs()
    for q in QUERIES:
        w = jsel_.select(refs_j, JAX.ctx(q))
        g = loaded.select(refs_t, PORT.ctx(q))
        assert (g.ref.model, g.reason) == (w.ref.model, w.reason)
        assert abs(float(g.score) - float(w.score)) <= SCORE_TOL


def test_kmeans_fit_matches_jax_given_the_same_start():
    rng = np.random.default_rng(5)
    x = np.concatenate([c + 0.3 * rng.standard_normal((40, D))
                        for c in CENTERS]).astype(np.float32)
    want = jsel.KMeansSelector.fit_kmeans(x, 3)
    got = tsel.KMeansSelector(device="cpu").fit_kmeans(x, 3)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    # the iterations themselves, from an empty-cluster start
    init = np.stack([x[0], x[1], x[0] + 100.0]).astype(np.float32)
    got = tsel.ml.lloyd(x, init, 5, tsel.DeviceWork(device="cpu"))
    assert np.allclose(got[2], init[2])  # no rows: the centroid stays


def test_unknown_algorithm_raises_as_in_jax():
    with pytest.raises(KeyError):
        jsel.registry.create("no_such_algorithm")
    with pytest.raises(KeyError, match="no_such_algorithm"):
        tsel.registry.create("no_such_algorithm")


def test_torch_work_holds_the_gate_and_needs_a_device():
    entered = []

    class Gate:
        def __enter__(self):
            entered.append(1)

        def __exit__(self, *exc):
            return False

    sel = tsel.registry.create("mlp", hidden=8, epochs=3, device="cpu",
                               gate=Gate)
    x = np.concatenate([CENTERS[0] + 0.1 * _rng.standard_normal((8, D)),
                        CENTERS[1] + 0.1 * _rng.standard_normal((8, D))])
    sel.fit(x.astype(np.float32), ["a"] * 8 + ["b"] * 8)
    assert sel.classes == ["a", "b"] and entered
    n = len(entered)
    sel.scores(x[0])
    km = tsel.registry.create("kmeans", device="cpu", gate=Gate)
    km.fit_kmeans(x.astype(np.float32), 2)
    assert len(entered) == n + 2
    if not torch.cuda.is_available():
        # no device named: the card, never a silent CPU fit
        with pytest.raises(RuntimeError, match="CUDA"):
            tsel.registry.create("mlp", hidden=8, epochs=1).fit(
                x.astype(np.float32), ["a"] * 8 + ["b"] * 8)
