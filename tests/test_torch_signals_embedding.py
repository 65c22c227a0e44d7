"""The port's embedding, preference and complexity families against the JAX
evaluators on the same tiny embedding engine weights, on the CPU: the
same hits, scores within 1e-4.  The cases of tests/test_signals_embedding
that need no multimodal task, plus the decision engine's bare complexity
name and the composers applied by the port's dispatcher."""

import pytest

from semantic_router_tpu.config import ComplexityRule as JComplexityRule
from semantic_router_tpu.config import EmbeddingRule as JEmbeddingRule
from semantic_router_tpu.config import PreferenceRule as JPreferenceRule
from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.config import RuleNode as JRuleNode
from semantic_router_tpu.decision.engine import SignalMatches as JMatches
from semantic_router_tpu.engine.testing import make_embedding_engine as \
    jmake
from semantic_router_tpu.signals import Message as JMessage
from semantic_router_tpu.signals import RequestContext as JContext
from semantic_router_tpu.signals import SignalDispatcher as JDispatcher
from semantic_router_tpu.signals import embedding_signal as jsig
from semantic_router_tpu_torch.config import (
    ComplexityRule,
    EmbeddingRule,
    PreferenceRule,
    RuleNode,
    load_config,
)
from semantic_router_tpu_torch.decision import DecisionEngine
from semantic_router_tpu_torch.decision.engine import SignalMatches
from semantic_router_tpu_torch.engine.testing import make_embedding_engine
from semantic_router_tpu_torch.signals import (
    ComplexitySignal,
    EmbeddingSignal,
    Message,
    PreferenceSignal,
    RequestContext,
    SignalDispatcher,
)

TOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    jeng = jmake()
    teng = make_embedding_engine(
        device="cpu", flax_params={n: t.params for n, t in jeng._tasks.items()})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _ctxs(text, images=()):
    return (JContext(messages=[JMessage("user", text, images=list(images))]),
            RequestContext(messages=[Message("user", text,
                                             images=list(images))]))


def _same(got, want):
    assert [h.rule for h in got.hits] == [h.rule for h in want.hits]
    for a, b in zip(got.hits, want.hits):
        assert abs(a.confidence - b.confidence) <= TOL
    assert got.error == want.error


def _run(jcls, tcls, engines, jrules, trules, text, images=(), **kw):
    jeng, teng = engines
    jctx, tctx = _ctxs(text, images)
    want = jcls(jeng, jrules, **kw).evaluate(jctx)
    got = tcls(teng, trules, **kw).evaluate(tctx)
    _same(got, want)
    return got


def _emb_rules(specs):
    return ([JEmbeddingRule(**s) for s in specs],
            [EmbeddingRule(**s) for s in specs])


EMBEDDING_CASES = {
    "identical": ([dict(name="support", threshold=0.99,
                        candidates=["how to configure the system"])],
                  "how to configure the system", ["support"]),
    "unrelated": ([dict(name="support", threshold=0.95,
                        candidates=["how to configure the system"])],
                  "completely different banana topic zzz", []),
    "mean_vs_max_vs_any": (
        [dict(name="m1", threshold=0.9, aggregation_method="max",
              candidates=["alpha beta gamma", "totally unrelated words here"]),
         dict(name="m2", threshold=0.9, aggregation_method="mean",
              candidates=["alpha beta gamma", "totally unrelated words here"]),
         dict(name="m3", threshold=0.9, aggregation_method="any",
              candidates=["alpha beta gamma", "totally unrelated words here"]),
         dict(name="empty", threshold=0.0, candidates=[])],
        "alpha beta gamma", ["m1", "m3"]),
}


class TestEmbeddingSignal:
    @pytest.mark.parametrize("case", sorted(EMBEDDING_CASES))
    def test_matches_jax(self, engines, case):
        specs, text, want = EMBEDDING_CASES[case]
        got = _run(jsig.EmbeddingSignal, EmbeddingSignal, engines,
                   *_emb_rules(specs), text)
        assert [h.rule for h in got.hits] == want
        assert got.error is None
        if case == "identical":
            assert got.hits[0].confidence == pytest.approx(1.0, abs=1e-3)

    def test_missing_task_fails_open(self, engines):
        got = _run(jsig.EmbeddingSignal, EmbeddingSignal, engines,
                   *_emb_rules([dict(name="x", candidates=["y"])]), "hello",
                   task="ghost")
        assert got.hits == [] and "not loaded" in got.error

    def test_image_rule_without_multimodal_task_keeps_text_hits(self,
                                                                 engines):
        specs = [dict(name="support", threshold=0.99,
                      candidates=["how to configure the system"]),
                 dict(name="visual", threshold=0.9, query_modality="image",
                      candidates=["a photo"])]
        got = _run(jsig.EmbeddingSignal, EmbeddingSignal, engines,
                   *_emb_rules(specs), "how to configure the system",
                   images=["data:image/png;base64,AAAA"])
        assert [h.rule for h in got.hits] == ["support"]
        assert got.error == "task 'multimodal' not loaded"
        # no image in the request: the image rule stays silent, no error
        got = _run(jsig.EmbeddingSignal, EmbeddingSignal, engines,
                   *_emb_rules(specs), "how to configure the system")
        assert got.error is None

    def test_candidates_embed_once_query_once_per_request(self, engines):
        _, teng = engines
        sig = EmbeddingSignal(teng, [EmbeddingRule(
            name="r", threshold=0.5, candidates=["a b", "c d"])])
        pref = PreferenceSignal(teng, [PreferenceRule(
            name="p", threshold=0.5, examples=["a b"])])
        steps0 = len(teng.steps())
        _, ctx = _ctxs("a b c")
        sig.evaluate(ctx)
        pref.evaluate(ctx)
        sig.evaluate(_ctxs("a b c")[1])
        # two candidate banks + one example bank + two request queries
        rows = sum(s["rows"] for s in teng.steps()[steps0:])
        assert rows == 2 + 1 + 2


class TestPreferenceSignal:
    @pytest.mark.parametrize("text,want", [
        ("keep it concise", ["terse"]),
        ("write a long detailed essay zz", []),
    ])
    def test_matches_jax(self, engines, text, want):
        spec = dict(name="terse", threshold=0.99, examples=["keep it concise"])
        got = _run(jsig.PreferenceSignal, PreferenceSignal, engines,
                   [JPreferenceRule(**spec)], [PreferenceRule(**spec)], text)
        assert [h.rule for h in got.hits] == want


CX = dict(name="needs_reasoning", threshold=0.9,
          hard_candidates=["solve this step by step"],
          easy_candidates=["answer briefly"])


class TestComplexitySignal:
    @pytest.mark.parametrize("text,want", [
        ("solve this step by step", ["needs_reasoning:hard"]),
        ("answer briefly", ["needs_reasoning:easy"]),
        ("zz qq", None),
    ])
    def test_levels_match_jax(self, engines, text, want):
        got = _run(jsig.ComplexitySignal, ComplexitySignal, engines,
                   [JComplexityRule(**CX)], [ComplexityRule(**CX)], text)
        if want is not None:
            assert [h.rule for h in got.hits] == want

    def test_image_candidates_join_with_an_image(self, engines):
        spec = dict(CX, hard_image_candidates=["a diagram to analyze"],
                    easy_image_candidates=["a simple photo"])
        got = _run(jsig.ComplexitySignal, ComplexitySignal, engines,
                   [JComplexityRule(**spec)], [ComplexityRule(**spec)],
                   "a diagram to analyze", images=["img-ref"])
        assert [h.rule for h in got.hits] == ["needs_reasoning:hard"]

    @pytest.mark.parametrize("leaf,escalates", [
        (("preference", "terse"), True),
        (("context", "long_context"), False),
    ])
    def test_composer_matches_jax_dispatcher(self, engines, leaf, escalates):
        """Easy by prototypes; a matched composer forces hard.  A leaf on a
        family with no evaluator (context) has no hits: no escalation."""
        jeng, teng = engines
        pref = dict(name="terse", threshold=0.5, examples=["answer briefly"])
        jrule = JComplexityRule(**CX, composer=JRuleNode(
            operator="OR", conditions=[JRuleNode(signal_type=leaf[0],
                                                 name=leaf[1])]))
        trule = ComplexityRule(**CX, composer=RuleNode(
            operator="OR", conditions=[RuleNode(signal_type=leaf[0],
                                                name=leaf[1])]))
        jd = JDispatcher([jsig.ComplexitySignal(jeng, [jrule]),
                          jsig.PreferenceSignal(jeng,
                                                [JPreferenceRule(**pref)])],
                         complexity_rules=[jrule])
        td = SignalDispatcher([ComplexitySignal(teng, [trule]),
                               PreferenceSignal(teng, [PreferenceRule(**pref)])],
                              complexity_rules=[trule])
        try:
            jctx, tctx = _ctxs("answer briefly")
            want, _ = jd.evaluate(jctx)
            got, _ = td.evaluate(tctx)
        finally:
            jd.shutdown()
            td.shutdown()
        assert got.matches["complexity"] == want.matches["complexity"]
        assert got.matches["complexity"] == (
            ["needs_reasoning:hard"] if escalates
            else ["needs_reasoning:easy"])
        for key, conf in want.confidences.items():
            assert abs(got.confidences[key] - conf) <= TOL


class TestBareComplexityName:
    @pytest.mark.parametrize("name", ["needs_reasoning", "needs_reasoning:hard",
                                      "needs_reasoning:easy", "other"])
    def test_matches_like_jax(self, name):
        got, want = SignalMatches(), JMatches()
        for m in (got, want):
            m.add("complexity", "needs_reasoning:hard", 0.7)
        assert got.matched("complexity", name) == \
            want.matched("complexity", name)
        assert got.confidence("complexity", name) == \
            want.confidence("complexity", name)

    def test_decision_on_a_bare_rule_name(self):
        cfg = load_config({"routing": {"decisions": [
            {"name": "hard", "rules": {"operator": "AND", "conditions": [
                {"type": "complexity", "name": "needs_reasoning"}]},
             "modelRefs": [{"model": "big"}]}]}})
        m = SignalMatches()
        m.add("complexity", "needs_reasoning:medium", 0.6)
        res = DecisionEngine(cfg.decisions).evaluate(m)
        assert res.decision.name == "hard" and res.confidence == 0.6


SCHEMA = {
    "semantic_cache": {"enabled": True, "backend_type": "hnsw",
                       "similarity_threshold": 0.9, "max_entries": 50,
                       "ttl_seconds": 60, "eviction_policy": "lru",
                       "embedding_model": "cache_emb"},
    "engine": {"matryoshka_layers": [6], "matryoshka_dims": [64]},
    "routing": {
        "signals": {
            "embeddings": [{"name": "e", "candidates": ["a"],
                            "threshold": 0.8, "aggregation_method": "mean",
                            "query_modality": "image"}],
            "preferences": [{"name": "p", "examples": ["b"],
                             "threshold": 0.6}],
            "complexity": [{"name": "c", "threshold": 0.7,
                            "hard": {"candidates": ["h"],
                                     "image_candidates": ["hi"]},
                            "easy": {"candidates": ["e"]},
                            "composer": {"operator": "OR", "conditions": [
                                {"type": "keyword", "name": "k"}]}}],
        },
        "decisions": [
            {"name": "d", "rules": {"operator": "OR", "conditions": [
                {"type": "embedding", "name": "e"},
                {"type": "preference", "name": "p"},
                {"type": "complexity", "name": "c:hard"}]},
             "modelRefs": [{"model": "m"}],
             "plugins": [{"type": "semantic-cache", "configuration": {
                 "enabled": True, "similarity_threshold": 0.95}},
                 {"type": "other", "configuration": {"enabled": False}}]}],
    },
}


def test_schema_reads_the_embedding_families_like_jax():
    got, want = load_config(SCHEMA), JRouterConfig.from_dict(SCHEMA)
    for fam in ("embeddings", "preferences", "complexity"):
        for a, b in zip(getattr(got.signals, fam), getattr(want.signals, fam)):
            da = vars(a).copy()
            db = {k: getattr(b, k) for k in da}
            ca, cb = da.pop("composer", None), db.pop("composer", None)
            assert da == db
            assert (ca is None) == (cb is None)
            if ca is not None:
                assert [(l.signal_type, l.name) for l in ca.leaves()] == \
                    [(l.signal_type, l.name) for l in cb.leaves()]
    for k in ("enabled", "backend_type", "similarity_threshold",
              "max_entries", "ttl_seconds", "eviction_policy",
              "embedding_model", "use_hnsw"):
        assert getattr(got.semantic_cache, k) == \
            getattr(want.semantic_cache, k), k
    assert got.engine.matryoshka_layers == want.engine.matryoshka_layers
    assert got.engine.matryoshka_dims == want.engine.matryoshka_dims
    gd, wd = got.decisions[0], want.decisions[0]
    for ptype in ("semantic-cache", "other", "absent"):
        gp, wp = gd.plugin(ptype), wd.plugin(ptype)
        assert (gp is None) == (wp is None)
        if gp is not None:
            assert (gp.type, gp.configuration, gp.enabled) == \
                (wp.type, wp.configuration, wp.enabled)
    # decision leaves and the composer's keyword leaf
    assert got.used_signal_types() == want.used_signal_types() == \
        ["complexity", "embedding", "keyword", "preference"]


def test_fixture_config_embedding_families_match_jax(fixture_config_path):
    from semantic_router_tpu.config import load_config as jload

    got, want = load_config(fixture_config_path), jload(fixture_config_path)
    assert [r.name for r in got.signals.embeddings] == \
        [r.name for r in want.signals.embeddings]
    assert [r.candidates for r in got.signals.embeddings] == \
        [r.candidates for r in want.signals.embeddings]
    assert [r.name for r in got.signals.preferences] == \
        [r.name for r in want.signals.preferences]
    assert [(r.name, r.hard_candidates, r.easy_candidates)
            for r in got.signals.complexity] == \
        [(r.name, r.hard_candidates, r.easy_candidates)
         for r in want.signals.complexity]
    assert [[p.type for p in d.plugins] for d in got.decisions] == \
        [[p.type for p in d.plugins] for d in want.decisions]


def test_request_context_reads_image_references_like_jax():
    body = {"model": "auto", "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": [
            {"type": "text", "text": "what is in"},
            {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA"}},
            {"type": "text", "text": "this picture"},
            {"type": "input_image", "image_url": "https://example.com/x.png"},
            "not a part"]}]}
    got = RequestContext.from_openai_body(body)
    want = JContext.from_openai_body(body)
    assert [(m.role, m.content, m.images) for m in got.messages] == \
        [(m.role, m.content, m.images) for m in want.messages]
    assert got.user_text == want.user_text == "what is in\nthis picture"
    assert got.has_images() and want.has_images()
    assert not RequestContext.from_openai_body(
        {"messages": [{"role": "user", "content": "hi"}]}).has_images()
