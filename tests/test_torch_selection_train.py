"""Selector artifacts in the port against the JAX package, on the CPU:
the corpus loader, the feature hash and ``featurize`` equal the
reference's; each algorithm's artifact trained by both packages on the
same seeded features equal (host-trained ones exactly, kmeans and
gmtrouter within 1e-4; the MLP starts from each package's own random
weights, so its structure is compared and each package serves the
other's MLP artifact with the reference's picks and scores); an artifact
of either package loaded by the other's ``load_selector`` and
``evaluate_artifact`` alike; the pipeline serving ``algorithm.artifact``
(hash-featured, and trained on the engine pair's embedding task) picking
the JAX router's models, a near-tie between a pick's two best scores
reported rather than hidden; a missing or corrupt artifact falling back
to the untrained selector with ``artifact_load_failed``; a
``cost_bandit`` artifact (the flywheel's policy) served at load, at the
router's boot and by ``load_selector`` as the reference serves it; and
``main``."""

import copy
import json
import logging
import os

import numpy as np
import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.selection import SelectionContext as JContext
from semantic_router_tpu.training import selection_train as jst
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.selection import SelectionContext
from semantic_router_tpu_torch.training import selection_train as tst

TOL = 1e-4
ALGOS = ["knn", "svm", "kmeans", "gmtrouter", "mlp"]
HOST_ALGOS = {"knn", "svm"}
MODELS = ["code-7b", "general-7b", "premium-70b"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded corpus written as JSONL by the JAX package, read by
    both."""
    path = tmp_path_factory.mktemp("corpus") / "routing.jsonl"
    rows = jst.synthetic_routing_dataset(n_queries=48, seed=3)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r.__dict__) + "\n")
    return str(path)


def test_corpus_and_features_equal_the_reference(corpus):
    jrec, trec = jst.load_routing_jsonl(corpus), tst.load_routing_jsonl(corpus)
    assert [r.__dict__ for r in trec] == [r.__dict__ for r in jrec]
    assert [r.__dict__ for r in tst.synthetic_routing_dataset(30, 1)] \
        == [r.__dict__ for r in jst.synthetic_routing_dataset(30, 1)]
    texts = [r.query for r in trec[:20]] + ["", "a b a b", "x" * 50]
    for dim in (16, 64):
        np.testing.assert_array_equal(tst.hash_embed(texts, dim=dim),
                                      jst.hash_embed(texts, dim=dim))
    assert tst.group_best(trec) == jst.group_best(jrec)
    tf, tl, tc = tst.featurize(trec)
    jf, jl, jc = jst.featurize(jrec)
    np.testing.assert_array_equal(tf, jf)
    assert (tl, tc) == (jl, jc)
    for cat in tst.CATEGORIES + ["unknown"]:
        np.testing.assert_array_equal(tst.category_onehot(cat),
                                      jst.category_onehot(cat))


def _close(a, b, path=""):
    if isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= TOL, path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _train(mod, algo, corpus, **kw):
    recs = mod.load_routing_jsonl(corpus)
    feats, labels, _ = mod.featurize(recs)
    return json.loads(mod.train_selector(algo, feats, labels, records=recs,
                                         **kw))


def _shapes(x):
    if isinstance(x, dict):
        return {k: _shapes(v) for k, v in x.items()}
    if isinstance(x, list):
        return np.asarray(x).shape if x and not isinstance(x[0], str) \
            else x
    return x


@pytest.mark.parametrize("algo", ALGOS)
def test_artifacts_equal_the_reference(algo, corpus):
    want = _train(jst, algo, corpus)
    got = _train(tst, algo, corpus, device="cpu")
    if algo in HOST_ALGOS:
        assert got == want
    elif algo == "mlp":
        # each package's own initial weights: the layout, the classes and
        # the feature recipe are the reference's
        assert _shapes(got) == _shapes(want)
        assert got["features"] == want["features"]
    else:
        _close(got, want, algo)


def _serve_picks(mod, path, corpus, ctx_cls, **kw):
    """(picks, scores) of an artifact's serving selector over the
    corpus's queries."""
    from semantic_router_tpu.config import ModelRef as JRef
    from semantic_router_tpu_torch.config.schema import ModelRef as TRef

    sel = mod.load_selector(path, **kw)
    recs = mod.load_routing_jsonl(corpus)
    queries, _, cats = mod.group_best(recs)
    ref = JRef if mod is jst else TRef
    cands = [ref(model=m) for m in MODELS]
    out = []
    for q, c in zip(queries, cats):
        r = sel.select(cands, ctx_cls(query=q, category=c))
        out.append((r.ref.model, float(r.score)))
    return out


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_serves_the_others_artifact(algo, writer, corpus,
                                                   tmp_path):
    blob = json.dumps(_train(jst, algo, corpus) if writer == "jax"
                      else _train(tst, algo, corpus, device="cpu"))
    path = str(tmp_path / f"{algo}.json")
    with open(path, "w") as f:
        f.write(blob)
    want = _serve_picks(jst, path, corpus, JContext)
    got = _serve_picks(tst, path, corpus, SelectionContext, device="cpu")
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= TOL
    sel = tst.load_selector(path, device="cpu")
    assert isinstance(sel, tst.CategoryFeatureSelector)
    assert sel.hash_fallback and sel.embedding_dim == 64
    assert sel.name == algo
    recs = tst.load_routing_jsonl(corpus)
    assert tst.evaluate_artifact(path, recs, device="cpu") \
        == jst.evaluate_artifact(path, jst.load_routing_jsonl(corpus))


def test_gmtrouter_needs_records_and_unknown_algorithms_raise(corpus):
    recs = tst.load_routing_jsonl(corpus)
    feats, labels, _ = tst.featurize(recs)
    with pytest.raises(ValueError, match="full records"):
        tst.train_selector("gmtrouter", feats, labels, device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        tst.train_selector("nope", feats, labels)


def test_a_foreign_embedding_width_raises(corpus, tmp_path):
    path = str(tmp_path / "knn.json")
    with open(path, "w") as f:
        f.write(json.dumps(_train(tst, "knn", corpus)))
    sel = tst.load_selector(path)
    sel.hash_fallback = False
    from semantic_router_tpu_torch.config.schema import ModelRef

    ctx = SelectionContext(query="q", category="math",
                           embed_fn=lambda q: np.ones(32, np.float32))
    with pytest.raises(ValueError, match="trained dim 64"):
        sel.select([ModelRef(model=m) for m in MODELS], ctx)


# -- the pipeline -------------------------------------------------------------

CASES = [("implement quicksort in python", "computer science"),
         ("prove the alpha theorem", "math"),
         ("is this clause enforceable under contract law", "law"),
         ("what are symptoms of the flu", "health"),
         ("draft a lambda business plan", "business"),
         ("tell me about omega", "other")]


def _artifact_config(path, algo="knn"):
    return {
        "default_model": "general-7b",
        "model_cards": [{"name": m} for m in MODELS],
        "routing": {"signals": {"keywords": [
            {"name": "any", "operator": "OR",
             "keywords": ["the", "a", "in", "of", "is", "about"]}]},
            "decisions": [{
                "name": "trained", "priority": 1,
                "rules": {"operator": "OR", "conditions": [
                    {"type": "keyword", "name": "any"}]},
                "modelRefs": [{"model": m} for m in MODELS],
                # the untrained fallback draws by weight: seeded
                "algorithm": {"type": algo, "artifact": path,
                              "seed": 0}}]}}


def _route_picks(router, cases):
    out = []
    for q, _ in cases:
        res = router.route({"model": "auto", "messages": [
            {"role": "user", "content": q}]})
        out.append((res.model, res.selection_reason))
    return out


@pytest.mark.parametrize("algo", ["knn", "kmeans", "svm"])
def test_pipeline_serves_a_hash_featured_artifact_like_the_reference(
        algo, corpus, tmp_path):
    path = str(tmp_path / f"{algo}.json")
    with open(path, "w") as f:
        f.write(json.dumps(_train(jst, algo, corpus)))
    d = _artifact_config(path, algo)
    jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(d)))
    tr = Router(load_config(copy.deepcopy(d)))
    try:
        got, want = _route_picks(tr, CASES), _route_picks(jr, CASES)
        assert [m for m, _ in got] == [m for m, _ in want]
        assert isinstance(tr._selectors["trained"],
                          tst.CategoryFeatureSelector)
    finally:
        jr.shutdown()
        tr.shutdown()


def test_pipeline_serves_an_engine_embedding_artifact(corpus, tmp_path,
                                                      fixture_config_path):
    """Artifacts trained on the engine pair's embedding task (``external``
    recipe) served by both routers: the picks agree, or the pick is a
    near-tie (two scores within 1e-4 on the CPU port), reported."""
    from semantic_router_tpu.runtime.registry import \
        RuntimeRegistry as JRuntimeRegistry
    from semantic_router_tpu_torch.runtime import RuntimeRegistry
    from test_torch_replay import engine_pair

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jreg, treg = JRuntimeRegistry.isolated(), RuntimeRegistry.isolated()
    jeng, teng = engine_pair(jreg, treg)
    routers = []
    try:
        recs = jst.load_routing_jsonl(corpus)
        feats, labels, _ = jst.featurize(
            recs, embed_fn=lambda qs: jeng.embed("embedding", list(qs)))
        tfeats, _, _ = tst.featurize(
            tst.load_routing_jsonl(corpus),
            embed_fn=lambda qs: teng.embed("embedding", list(qs)))
        np.testing.assert_allclose(tfeats, feats, atol=TOL)
        near_ties = []
        for algo in ("knn", "svm"):
            blob = jst.train_selector(algo, feats, labels, records=recs,
                                      embed_fn=lambda qs: qs)
            assert json.loads(blob)["features"]["embed"] == "external"
            path = str(tmp_path / f"ext-{algo}.json")
            with open(path, "w") as f:
                f.write(blob)
            d = _artifact_config(path, algo)
            jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(d)),
                         engine=jeng)
            tr = Router(load_config(copy.deepcopy(d)), engine=teng)
            routers += [jr, tr]
            got, want = _route_picks(tr, CASES), _route_picks(jr, CASES)
            for (gm, gr), (wm, wr), (q, _) in zip(got, want, CASES):
                if gm != wm:
                    near_ties.append((algo, q, gm, wm, gr, wr))
            assert len(near_ties) <= 1, near_ties
        print("near-ties:", near_ties)
    finally:
        for r in routers:
            r.shutdown()
        treg.runtimestats.stop()
        jeng.shutdown()
        teng.shutdown()
        torch.set_num_threads(n_threads)


class _Events(logging.Handler):
    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        try:
            self.rows.append(json.loads(record.getMessage()))
        except ValueError:
            pass


@pytest.mark.parametrize("content", [None, "{not json", '{"algorithm": '
                                     '"nope"}'])
def test_missing_or_corrupt_artifact_serves_untrained(content, tmp_path):
    path = str(tmp_path / "a.json")
    if content is not None:
        with open(path, "w") as f:
            f.write(content)
    d = _artifact_config(path)
    events = _Events()
    log = logging.getLogger("semantic_router_tpu_torch")
    log.addHandler(events)
    jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(d)))
    tr = Router(load_config(copy.deepcopy(d)))
    try:
        got, want = _route_picks(tr, CASES), _route_picks(jr, CASES)
        assert got == want
        assert type(tr._selectors["trained"]).__name__ == "KNNSelector"
    finally:
        log.removeHandler(events)
        jr.shutdown()
        tr.shutdown()
    failed = [r for r in events.rows
              if r.get("event") == "artifact_load_failed"]
    assert len(failed) == 1 and failed[0]["decision"] == "trained" \
        and failed[0]["artifact"] == path


@pytest.fixture
def cost_bandit(tmp_path):
    """A cost_bandit artifact the JAX flywheel's policy writes, fitted on
    the reference tests' synthetic corpus over ``MODELS``."""
    from semantic_router_tpu.flywheel.policy import CostAwareBanditSelector
    from test_flywheel import synth_rows

    sel = CostAwareBanditSelector()
    sel.fit_offline(synth_rows(60))
    path = str(tmp_path / "bandit.json")
    with open(path, "w") as f:
        f.write(sel.to_json())
    return path


BANDIT_QUERIES = ["tell me about the sea", "what is in a name",
                  "the history of the world"]


def _bandit_picks_equal(router, jrouter):
    """The port's router picks what the JAX router picks, reason and all,
    through the artifact's bandit."""
    for q in BANDIT_QUERIES:
        body = {"model": "auto", "messages": [{"role": "user", "content": q}]}
        got, want = router.route(copy.deepcopy(body)), jrouter.route(body)
        assert (got.model, got.selection_reason) \
            == (want.model, want.selection_reason)
        assert got.selection_reason.startswith("cost_bandit")
    assert type(router._selectors["trained"]).__name__ \
        == "CostAwareBanditSelector"


def test_a_cost_bandit_artifact_is_refused(cost_bandit):
    """Served now (refused until the flywheel was ported): a cost_bandit
    artifact loads at load, through ``load_selector`` (the same blob as
    the reference's load) and in the pipeline, picking the JAX router's
    models."""
    from semantic_router_tpu.training.selection_train import \
        load_selector as jload

    d = _artifact_config(cost_bandit)
    want = jload(cost_bandit)
    got = tst.load_selector(cost_bandit)
    assert type(got).__name__ == type(want).__name__ \
        == "CostAwareBanditSelector"
    assert got.to_json() == want.to_json()
    router = Router(load_config(copy.deepcopy(d)))
    jrouter = JRouter(JRouterConfig.from_dict(copy.deepcopy(d)))
    try:
        _bandit_picks_equal(router, jrouter)
    finally:
        router.shutdown()
        jrouter.shutdown()


def test_a_cost_bandit_written_after_load_is_refused_at_boot(
        cost_bandit, tmp_path):
    """Served now: a cost_bandit artifact written after the config loaded
    boots and serves, as the reference's does."""
    path = str(tmp_path / "later.json")
    cfg = load_config(_artifact_config(path))  # no file yet: loads
    os.replace(cost_bandit, path)
    router = Router(cfg)
    jrouter = JRouter(JRouterConfig.from_dict(_artifact_config(path)))
    try:
        _bandit_picks_equal(router, jrouter)
    finally:
        router.shutdown()
        jrouter.shutdown()


def test_a_cost_bandit_swapped_in_after_boot_is_never_served(
        cost_bandit, tmp_path):
    """Served now: a cost_bandit artifact swapped in after the boot and
    before the decision's first request is the selector that request
    builds, as the reference's is."""
    path = str(tmp_path / "swap.json")
    router = Router(load_config(_artifact_config(path)))
    jrouter = JRouter(JRouterConfig.from_dict(_artifact_config(path)))
    os.replace(cost_bandit, path)
    try:
        _bandit_picks_equal(router, jrouter)
    finally:
        router.shutdown()
        jrouter.shutdown()


def test_main_trains_and_reports(tmp_path, capsys):
    out = str(tmp_path / "out")
    tst.main(["--output-dir", out, "--algorithms", "knn,svm,kmeans",
              "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    jst.main(["--output-dir", str(tmp_path / "j"), "--algorithms",
              "knn,svm,kmeans"])
    want = json.loads(capsys.readouterr().out)
    assert report["label_counts"] == want["label_counts"]
    for algo in ("knn", "svm", "kmeans"):
        assert os.path.exists(report[algo]["artifact"])
        assert abs(report[algo]["accuracy"] - want[algo]["accuracy"]) \
            <= TOL, algo
    assert report["knn"]["accuracy"] > 0.5
