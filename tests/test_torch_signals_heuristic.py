"""The port's heuristic signal families (keyword, context, structure,
conversation, language, authz, event, reask), its request context and its
projections against the JAX package, rule by rule, on the CPU: the same
hits and details, confidences and keyword scores within 1e-6, projection
traces within 1e-6.  The JAX keyword family scores BM25 in its native
library where that is built; the port scores in Python."""

import copy

import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.decision.engine import SignalMatches as JMatches
from semantic_router_tpu.decision.projections import \
    ProjectionEvaluator as JProjections
from semantic_router_tpu.signals import RequestContext as JContext
from semantic_router_tpu.signals import heuristic as jheur
from semantic_router_tpu.signals import keyword as jkw
from semantic_router_tpu.signals.base import text_units as jtext_units
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.decision import ProjectionEvaluator
from semantic_router_tpu_torch.decision.engine import SignalMatches
from semantic_router_tpu_torch.signals import (
    AuthzSignal,
    ContextSignal,
    ConversationSignal,
    EventSignal,
    KeywordSignal,
    LanguageSignal,
    ReaskSignal,
    RequestContext,
    StructureSignal,
    detect_language,
    text_units,
)

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the fixture's rules of each family plus rules for the options it leaves
# out (AND operators, case sensitivity, other arities and predicates)
EXTRA_SIGNALS = {
    "keywords": [
        {"name": "bm25_phrase", "method": "bm25", "bm25_threshold": 0.01,
         "keywords": ["load balancer", "deploy", "kubernetes pod"]},
        {"name": "ngram_bigram", "method": "ngram", "ngram_arity": 2,
         "ngram_threshold": 0.5, "keywords": ["refund", "chargeback"]},
        {"name": "fuzzy_and", "method": "fuzzy", "operator": "AND",
         "fuzzy_threshold": 70, "keywords": ["invoice", "overdue"]},
        {"name": "fuzzy_flag", "fuzzy_match": True,
         "keywords": ["pasword"]},
        {"name": "regex_and", "method": "regex", "operator": "AND",
         "keywords": [r"\bSQL\b", r"select \*"]},
        {"name": "exact_case", "case_sensitive": True,
         "keywords": ["URGENT"]},
    ],
    "context": [{"name": "mid_context", "min_tokens": "0.01k",
                 "max_tokens": 40}],
    "structure": [
        {"name": "has_code_fence", "feature": {
            "type": "exists", "source": {"type": "keyword_set",
                                         "keywords": ["```"]}}},
        {"name": "two_questions", "feature": {
            "type": "count", "source": {"type": "regex", "pattern": r"\?",
                                        "case_sensitive": True}},
         "predicate": {"eq": 2}},
        {"name": "step_density", "feature": {
            "type": "density", "source": {"type": "keyword_set",
                                          "keywords": ["step"]}},
         "predicate": {"gte": 0.1, "lt": 0.9}},
    ],
    "conversation": [
        {"name": "non_user_heavy", "feature": {
            "type": "count", "source": {"type": "message",
                                        "role": "non_user"}},
         "predicate": {"gt": 1}},
        {"name": "has_system", "feature": {
            "type": "exists", "source": {"type": "message",
                                         "role": "system"}}},
    ],
    "language": [{"name": "fr"}, {"name": "ru", "threshold": 0.5},
                 {"name": "ja"}, {"name": "de"}],
    "role_bindings": [{"name": "vip", "subjects": [
        {"kind": "User", "name": "vip-1"}]}],
    "events": [{"name": "any_refund", "event_types": ["refund"]},
               {"name": "sev_only", "severities": ["critical"]}],
    "reasks": [{"name": "two_back", "threshold": 0.6, "lookback_turns": 2}],
}


def _config(fixture_config_path, lib_load):
    """The fixture config with EXTRA_SIGNALS appended to its families, as
    a dict both packages parse."""
    import yaml

    with open(fixture_config_path) as f:
        d = yaml.safe_load(f)
    sig = d["routing"]["signals"]
    for fam, rules in EXTRA_SIGNALS.items():
        sig[fam] = list(sig.get(fam, [])) + copy.deepcopy(rules)
    return lib_load(d)


@pytest.fixture(scope="module")
def configs(fixture_config_path):
    return (_config(fixture_config_path, JRouterConfig.from_dict),
            _config(fixture_config_path, load_config))


def _user(text):
    return {"role": "user", "content": text}


LONG = " ".join(f"word{i}" for i in range(2100))

# (body, headers): every family's rules, hit and missed
CASES = [
    ({"messages": [_user("URGENT: need help asap, this is an emergency")]},
     {}),
    ({"messages": [_user("please debug this function; the algorithm needs "
                         "a refactor and more code")]}, {}),
    ({"messages": [_user("hello world")]}, {}),
    ({"messages": [_user("World says hello to the panel of experts")]},
     {"x-authz-user-id": "vip-1"}),
    ({"messages": [_user("1. install?\n2. configure?\n3. run")]}, {}),
    ({"messages": [_user("first open the file, then save it. 首先 然后")]},
     {"x-authz-user-groups": "platform-admins, premium-tier"}),
    ({"messages": [_user("why? how? what? when? really?")]}, {}),
    ({"messages": [_user("do it under 5 minutes, at most 3 steps, within "
                         "budget, at least once")]}, {}),
    ({"messages": [_user("my social-security number and credit card "
                         "pasword")]}, {}),
    ({"messages": [_user("the invoce is overdue and a refnd is due")]},
     {"x-vsr-event-type": "payment_failed",
      "x-vsr-event-severity": "critical",
      "x-vsr-event-action": "TXN_DECLINE"}),
    ({"messages": [_user("run SQL: select * from t where a = 1")]},
     {"x-vsr-event-type": "refund", "x-vsr-event-severity": "low"}),
    ({"messages": [_user("这是一个关于数据库的问题吗？请解释。")]}, {}),
    ({"messages": [_user("¿Cómo está el clima en la ciudad de Madrid?")]}, {}),
    ({"messages": [_user("Bonjour, comment est-ce que vous allez?")]}, {}),
    ({"messages": [_user("Как дела у вас сегодня?")]}, {}),
    ({"messages": [_user("こんにちは、元気ですか")]}, {}),
    ({"messages": [_user("Wie geht es dir und was ist das?")]}, {}),
    ({"messages": [{"role": "system", "content": "be brief"},
                   _user("how do I reset my password"),
                   {"role": "assistant", "content": "click reset"},
                   _user("how do I reset my password?")]}, {}),
    ({"messages": [_user("deploy to kubernetes"),
                   {"role": "assistant", "content": "ok"},
                   _user("deploy to kubernetes pod please"),
                   {"role": "assistant", "content": "done"},
                   _user("deploy to the kubernetes pod please")]}, {}),
    ({"messages": [_user("what's the weather"),
                   {"role": "assistant", "content": "",
                    "tool_calls": [{"id": "c1", "type": "function",
                                    "function": {"name": "wx"}}]},
                   {"role": "tool", "tool_call_id": "c1",
                    "content": "sunny"}],
      "tools": [{"type": "function", "function": {"name": "wx"}}],
      "stream": True, "user": "u-42"}, {}),
    ({"messages": [_user("```python\nprint(1)\n``` step by step, step two")]},
     {}),
    ({"messages": [_user(LONG)]}, {}),
    ({"messages": [_user("")]}, {}),
    ({"messages": [{"role": "user", "content": [
        {"type": "text", "text": "describe this load balancer diagram"},
        {"type": "image_url", "image_url": {"url": "data:image/png;b64,x"}},
        {"type": "input_audio", "input_audio": {"data": "abc"}}]}]}, {}),
]


def _ctxs(case):
    body, headers = case
    return (JContext.from_openai_body(copy.deepcopy(body), headers),
            RequestContext.from_openai_body(copy.deepcopy(body), headers))


def _close(a, b):
    """Details equal, floats within TOL (lists and dicts compared
    elementwise)."""
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= TOL
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def _same_result(got, want):
    assert got.signal_type == want.signal_type
    assert (got.error is None) == (want.error is None), (got.error,
                                                         want.error)
    assert [h.rule for h in got.hits] == [h.rule for h in want.hits]
    for g, w in zip(got.hits, want.hits):
        assert abs(g.confidence - w.confidence) <= TOL, (g.rule, g, w)
        assert _close(g.detail, w.detail), (g.rule, g.detail, w.detail)


FAMILIES = {
    "keyword": (lambda s, c: jkw.KeywordSignal(s.keywords),
                lambda s, c: KeywordSignal(s.keywords)),
    "context": (lambda s, c: jheur.ContextSignal(s.context),
                lambda s, c: ContextSignal(s.context)),
    "structure": (lambda s, c: jheur.StructureSignal(s.structure),
                  lambda s, c: StructureSignal(s.structure)),
    "conversation": (lambda s, c: jheur.ConversationSignal(s.conversation),
                     lambda s, c: ConversationSignal(s.conversation)),
    "language": (lambda s, c: jheur.LanguageSignal(s.language),
                 lambda s, c: LanguageSignal(s.language)),
    "authz": (lambda s, c: jheur.AuthzSignal(
        s.role_bindings, fail_open=c.authz.get("fail_open", True)),
        lambda s, c: AuthzSignal(
            s.role_bindings, fail_open=c.authz.get("fail_open", True))),
    "event": (lambda s, c: jheur.EventSignal(s.events),
              lambda s, c: EventSignal(s.events)),
    "reask": (lambda s, c: jheur.ReaskSignal(s.reasks),
              lambda s, c: ReaskSignal(s.reasks)),
}


@pytest.fixture(scope="module")
def evaluators(configs):
    jcfg, tcfg = configs
    return {fam: (mk_j(jcfg.signals, jcfg), mk_t(tcfg.signals, tcfg))
            for fam, (mk_j, mk_t) in FAMILIES.items()}


@pytest.fixture(scope="module")
def fired():
    """family → rules that hit in some case (filled by the parity test)."""
    return {fam: set() for fam in FAMILIES}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("i", range(len(CASES)))
def test_family_matches_jax(evaluators, fired, family, i):
    jev, tev = evaluators[family]
    jctx, tctx = _ctxs(CASES[i])
    want, got = jev.evaluate(jctx), tev.evaluate(tctx)
    _same_result(got, want)
    fired[family].update(h.rule for h in got.hits)


def test_every_rule_fires_somewhere(configs, evaluators, fired):
    """The case set exercises every configured rule of every family (the
    parity test above would pass vacuously otherwise)."""
    _, tcfg = configs
    for fam, (_, tev) in evaluators.items():
        for c in CASES:
            fired[fam].update(h.rule for h in tev.evaluate(
                _ctxs(c)[1]).hits)
        want = set(tcfg.signals.rule_names(fam))
        assert fired[fam] == want, (fam, want - fired[fam])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_request_context_matches_jax(i):
    j, t = _ctxs(CASES[i])
    for f in ("model", "headers", "user_id", "user_groups", "tools",
              "stream", "event", "user_text", "full_text"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.user_turns() == j.user_turns()
    assert t.approx_token_count() == j.approx_token_count()
    assert [(m.role, m.content, m.images, m.audio, m.tool_calls,
             m.tool_call_id) for m in t.messages] == \
        [(m.role, m.content, m.images, m.audio, m.tool_calls,
          m.tool_call_id) for m in j.messages]


@pytest.mark.parametrize("text", [
    "", "plain words here", "中文和English混合", "ﾃｽﾄ 全角",
    "naïve café — déjà vu", "x" * 300])
def test_text_units_and_language(text):
    assert text_units(text) == jtext_units(text)
    assert detect_language(text) == pytest.approx(
        jheur.detect_language(text), abs=TOL)


def test_authz_fail_closed_raises():
    """fail_open False: an evaluation error escapes the evaluator (the
    dispatcher records it) in both packages; fail_open records it."""
    from semantic_router_tpu.config.schema import AuthzRule as JAuthzRule
    from semantic_router_tpu_torch.config import AuthzRule

    jrules = [JAuthzRule("bad", subjects=[None])]
    trules = [AuthzRule("bad", subjects=[None])]
    with pytest.raises(AttributeError):
        jheur.AuthzSignal(jrules, fail_open=False).evaluate(JContext())
    with pytest.raises(AttributeError):
        AuthzSignal(trules, fail_open=False).evaluate(RequestContext())
    want = jheur.AuthzSignal(jrules).evaluate(JContext())
    got = AuthzSignal(trules).evaluate(RequestContext())
    assert got.error == want.error and not got.hits


# --------------------------------------------------------------------------
# keyword scorers, score by score


KEYWORD_TEXTS = [t for (b, _) in CASES for t in
                 (m["content"] if isinstance(m["content"], str) else ""
                  for m in b["messages"])] + [
    "Déjà vu: the café's load-balancer", "deploy deploy deploy load",
    "kubernetes podcast", "REFUND!! charge back", "ÅNGSTRÖM units"]


@pytest.mark.parametrize("rule", [
    {"name": "b", "method": "bm25", "keywords": ["load balancer", "deploy",
                                                 "kubernetes pod"]},
    {"name": "b_cs", "method": "bm25", "case_sensitive": True,
     "keywords": ["Deploy", "load"]},
    {"name": "n3", "method": "ngram", "keywords": ["urgent", "refund"]},
    {"name": "n2_cs", "method": "ngram", "ngram_arity": 2,
     "case_sensitive": True, "keywords": ["REFUND", "Déjà"]},
], ids=lambda r: r["name"])
def test_keyword_scores_match_jax(rule):
    jrule = JRouterConfig.from_dict({"routing": {"signals": {"keywords": [rule]}}}) \
        .signals.keywords[0]
    trule = load_config({"routing": {"signals": {"keywords": [rule]}}}) \
        .signals.keywords[0]
    if rule["method"] == "bm25":
        js = jkw.BM25Scorer(jrule.keywords,
                            case_sensitive=jrule.case_sensitive)
        from semantic_router_tpu_torch.signals.keyword import BM25Scorer

        ts = BM25Scorer(trule.keywords, case_sensitive=trule.case_sensitive)
    else:
        js = jkw.NGramScorer(jrule.keywords, arity=jrule.ngram_arity,
                             case_sensitive=jrule.case_sensitive)
        from semantic_router_tpu_torch.signals.keyword import NGramScorer

        ts = NGramScorer(trule.keywords, arity=trule.ngram_arity,
                         case_sensitive=trule.case_sensitive)
    for text in KEYWORD_TEXTS:
        (s_j, m_j), (s_t, m_t) = js.score(text), ts.score(text)
        assert abs(s_j - s_t) <= TOL, text
        assert m_t == m_j, text


@pytest.mark.parametrize("a,b", [
    ("credit card", "credit-card"), ("password", "pasword"), ("", ""),
    ("abc", ""), ("social security", "social-security number"),
    ("héllo", "hello")])
def test_fuzzy_ratio_matches_jax(a, b):
    from semantic_router_tpu_torch.signals.keyword import (
        fuzzy_partial_ratio,
        fuzzy_ratio,
    )

    assert fuzzy_ratio(a, b) == pytest.approx(jkw.fuzzy_ratio(a, b),
                                              abs=TOL)
    assert fuzzy_partial_ratio(a, b) == pytest.approx(
        jkw.fuzzy_partial_ratio(a, b), abs=TOL)


# --------------------------------------------------------------------------
# projections


PROJECTIONS_EXTRA = {
    "partitions": [
        {"name": "tone", "semantics": "overlapping", "temperature": 0.5,
         "members": ["terse_answers", "zh", "en"]},
        {"name": "empty_default", "members": ["nope"], "default": "fallback"},
        {"name": "empty_no_default", "members": ["nope"]},
    ],
    "scores": [
        {"name": "kb_and_score", "inputs": [
            {"type": "kb_metric", "kb": "privacy_kb",
             "metric": "privacy_vs_billing", "weight": 0.5},
            {"type": "kb_metric", "kb": "missing_kb", "metric": "x",
             "weight": 1.0},
            {"type": "keyword", "name": "code_keywords", "weight": 0.3,
             "value_source": "score", "miss": 0.1},
            {"type": "complexity", "name": "needs_reasoning",
             "weight": 0.2, "match": 0.7, "miss": -0.2}]},
    ],
    "mappings": [
        {"name": "kb_band", "source": "kb_and_score", "outputs": [
            {"name": "low", "lt": 0.1}, {"name": "high", "gte": 0.1}]},
        {"name": "dangling", "source": "no_such_score", "outputs": [
            {"name": "never", "gte": 0.0}]},
        {"name": "uncalibrated_eq", "source": "request_difficulty",
         "calibration": {"method": "none"},
         "outputs": [{"name": "exact_zero", "eq": 0.0},
                     {"name": "nonzero", "gt": 0.0}]},
    ],
}

# (type, name, confidence) matches the dispatcher might produce
MATCH_SETS = [
    [],
    [("embedding", "technical_support", 0.91)],
    [("embedding", "technical_support", 0.8),
     ("embedding", "account_management", 0.75),
     ("complexity", "needs_reasoning:hard", 0.66),
     ("context", "long_context", 1.0),
     ("structure", "first_then_flow", 1.0)],
    [("embedding", "account_management", 0.99),
     ("keyword", "code_keywords", 0.37), ("language", "zh", 0.9),
     ("preference", "terse_answers", 0.72)],
    [("complexity", "needs_reasoning:medium", 0.5),
     ("language", "en", 0.3), ("structure", "first_then_flow", 1.0),
     ("context", "long_context", 1.0)],
    [("complexity", "needs_reasoning:hard", 0.5),
     ("structure", "first_then_flow", 1.0),
     ("embedding", "technical_support", 0.45)],
]
KB_METRICS = [{}, {"privacy_kb": {"privacy_vs_billing": 0.42,
                                  "best_score": 0.9}}]


@pytest.fixture(scope="module")
def projection_pair(fixture_config_path):
    import yaml

    with open(fixture_config_path) as f:
        d = yaml.safe_load(f)
    proj = d["routing"]["projections"]
    for k, v in PROJECTIONS_EXTRA.items():
        proj[k] = list(proj.get(k, [])) + copy.deepcopy(v)
    return (JProjections(JRouterConfig.from_dict(d).projections),
            ProjectionEvaluator(load_config(d).projections))


@pytest.mark.parametrize("kb", range(len(KB_METRICS)))
@pytest.mark.parametrize("m", range(len(MATCH_SETS)))
def test_projection_trace_matches_jax(projection_pair, m, kb):
    jproj, tproj = projection_pair
    js, ts = JMatches(), SignalMatches()
    for styp, name, conf in MATCH_SETS[m]:
        js.add(styp, name, conf)
        ts.add(styp, name, conf)
    want = jproj.evaluate(js, kb_metrics=KB_METRICS[kb])
    got = tproj.evaluate(ts, kb_metrics=KB_METRICS[kb])
    assert got.mappings == want.mappings
    assert _close(got.partitions, want.partitions)
    assert _close(got.scores, want.scores)
    assert ts.matches == js.matches
    assert _close(ts.confidences, js.confidences)


def test_fixture_projection_reaches_every_band(projection_pair):
    """The match sets above reach every band of the fixture's mapping."""
    _, tproj = projection_pair
    bands = set()
    for ms in MATCH_SETS:
        s = SignalMatches()
        for styp, name, conf in ms:
            s.add(styp, name, conf)
        bands.add(tproj.evaluate(s).mappings["request_band"])
    assert bands == {"support_fast", "support_balanced",
                     "support_escalated"}


@pytest.mark.parametrize("extra", [
    {},
    {"projections": {"scores": [{"name": "s", "inputs": [
        {"type": "kb_metric", "kb": "k", "metric": "m", "weight": 1},
        {"type": "Event", "name": "e", "weight": 1}]}]}},
    {"projections": {"partitions": [{"name": "p", "members": [
        "zh", "multi_turn_user", "privacy_policy", "wrong_answer"]}]}},
], ids=["fixture", "score_inputs", "partition_members"])
def test_used_signal_types_match_jax(fixture_config_path, extra):
    import yaml

    with open(fixture_config_path) as f:
        d = yaml.safe_load(f)
    d["routing"].update(extra)
    assert load_config(d).used_signal_types() == \
        JRouterConfig.from_dict(d).used_signal_types()
