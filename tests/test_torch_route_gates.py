"""The route's front gates of the port against the JAX ones, on the CPU:
the rate limiter (allow / deny, ``retry_after_s``, ``peek``) under one
monkeypatched clock; prompt compression (identical text for every
profile, on seeded prompts around the 512-token threshold); recipes and
entrypoints (the same parsed config, ``recipe_for_request_model`` and
routed decisions and models, the ``via_entrypoint`` fallback included);
skip-processing (honoured only when enabled, ``x-vsr-skip-signals`` only
behind ``allow_skip_signals_header``) — each routed by the port's Router
and the JAX Router over one seeded shared-trunk engine (the same Flax
weights through ``params_from_flax``).  Over HTTP on the port's server:
a limited user gets 429 with ``retry-after`` and the backend sees
nothing; a passthrough reaches the backend untouched."""

import copy
import http.client
import json
import time
import urllib.parse

import numpy as np
import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.router import promptcompression as jpc
from semantic_router_tpu.router import ratelimit as jrl
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router import headers as H
from semantic_router_tpu_torch.router import promptcompression as tpc
from semantic_router_tpu_torch.router import ratelimit as trl

PROB_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


# ---------------------------------------------------------------------------
# the rate limiter

LIMITS = {
    "default": {"requests_per_minute": 30},
    "burst": {"requests_per_minute": 120, "burst": 3},
    "overrides": {"requests_per_minute": 0, "per_user": {"u1": 60},
                  "per_model": {"m2": 12}},
    "off": {},
}


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_rate_limiter_matches_jax(clock, name):
    cfg = LIMITS[name]
    want_rl = jrl.RateLimiter.from_config(copy.deepcopy(cfg))
    got_rl = trl.RateLimiter.from_config(copy.deepcopy(cfg))
    rng = np.random.default_rng(len(name))
    decisions = []
    for step in range(60):
        clock.t += float(rng.choice([0.0, 0.0, 0.01, 0.1, 0.5, 2.0]))
        user, model = f"u{rng.integers(2)}", f"m{rng.integers(1, 3)}"
        assert got_rl.peek(user, model) == want_rl.peek(user, model)
        w, g = want_rl.check(user, model), got_rl.check(user, model)
        assert (g.allowed, g.source) == (w.allowed, w.source), step
        assert g.retry_after_s == w.retry_after_s, step
        decisions.append(g.allowed)
    if name != "off":
        assert not all(decisions)  # some requests were limited


def test_token_bucket_matches_jax(clock):
    w, g = jrl.TokenBucket(2.0, 2.0), trl.TokenBucket(2.0, 2.0)
    for dt in (0.0, 0.0, 0.0, 0.2, 0.3, 0.6, 0.0, 2.0, 0.0):
        clock.t += dt
        assert g.take() == w.take()


# ---------------------------------------------------------------------------
# prompt compression

_VOCAB = ("the router error function code exception traceback dose mg "
          "symptom diagnosis allergy password token credential "
          "vulnerability exploit request model latency cache thread "
          "patient market budget tensor network 東京 Zürich naïve").split()


def _prompt(n_words: int, seed: int) -> str:
    """Seeded sentences of 4-16 words, ~``n_words`` in all, ending in
    '.', '!' or '?' (some CJK)."""
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < n_words:
        k = int(rng.integers(4, 17))
        words = list(rng.choice(_VOCAB, size=k))
        words[0] = words[0].capitalize()
        end = str(rng.choice([".", "!", "?", "。"]))
        out.append(" ".join(words) + end)
        n += k
    return " ".join(out)


@pytest.mark.parametrize("profile", sorted(jpc.PROFILES))
def test_compressor_matches_jax_on_every_profile(profile):
    assert set(tpc.PROFILES) == set(jpc.PROFILES)
    for i, n in enumerate((40, 480, 511, 512, 513, 560, 900)):
        text = _prompt(n, seed=100 * i + len(profile))
        for ratio in (None, 0.3, 0.5):
            w = jpc.PromptCompressor(profile=profile).compress(text, ratio)
            g = tpc.PromptCompressor(profile=profile).compress(text, ratio)
            assert g.text == w.text
            assert (g.original_sentences, g.kept_sentences, g.ratio) == \
                (w.original_sentences, w.kept_sentences, w.ratio)


def test_sentence_split_matches_jax():
    for text in ("第一句。第二句！third sentence. fourth?", _prompt(200, 3),
                 "One. Two.", ""):
        assert tpc.split_sentences(text) == jpc.split_sentences(text)


# ---------------------------------------------------------------------------
# the routers over one seeded engine

DOMAINS = ["business", "law", "health", "computer science", "other"]
TASKS = [("intent", DOMAINS),
         ("fact_check", ["no_fact_check", "fact_check"]),
         ("user_feedback", ["none", "positive", "negative"])]


def _leaf(t, n):
    return {"type": t, "name": n}


def _dec(name, priority, *conds, model, op="OR"):
    return {"name": name, "priority": priority,
            "rules": {"operator": op, "conditions": list(conds)},
            "modelRefs": [{"model": model}]}


CONFIG = {
    "default_model": "base-model",
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128, 512]},
    "ratelimit": {"requests_per_minute": 0, "burst": 1,
                  "per_user": {"limited": 6}},
    "prompt_compression": {"enabled": True, "profile": "coding",
                           "target_ratio": 0.4, "min_tokens": 96},
    "routing": {
        "modelCards": [{"name": m} for m in
                       ("base-model", "law-model", "fast-law", "fast-kw",
                        "fast-fb")],
        "signals": {
            "keywords": [{"name": "legal", "keywords": ["contract",
                                                        "lease"]}],
            "domains": [{"name": d} for d in DOMAINS],
            "user_feedbacks": [{"name": "positive"}, {"name": "negative"}]},
        "decisions": [
            _dec("legal_kw", 100, _leaf("keyword", "legal"),
                 model="law-model"),
            _dec("domain_law", 50, _leaf("domain", "law"),
                 model="law-model")]},
    # the recipe's heuristic rules are its own; its learned families read
    # the top-level rules (the domain leaf below)
    "recipes": [{"name": "fast", "routing": {
        "strategy": "confidence",
        "signals": {"keywords": [{"name": "hurry",
                                  "keywords": ["quick", "fast"]}]},
        "decisions": [
            _dec("fast_kw", 10, _leaf("keyword", "hurry"),
                 model="fast-kw"),
            _dec("fast_business", 20, _leaf("domain", "business"),
                 model="fast-law"),
            _dec("fast_feedback", 5, _leaf("user_feedback", "negative"),
                 model="fast-fb")]}}],
    "entrypoints": [{"model_names": ["fast-auto", "speedy"],
                     "recipe": "fast"},
                    {"model_names": ["main-auto"], "recipe": "default"},
                    {"model_names": ["ghost-auto"], "recipe": "missing"}],
}
# no default model: an entrypoint's fallback is the first model card
NO_DEFAULT = copy.deepcopy(CONFIG)
NO_DEFAULT["default_model"] = ""
NO_DEFAULT["routing"]["modelCards"].reverse()

LONG = (" ".join(f"Step {i}: the function raises an error on line {i} of "
                 f"the module." for i in range(30))
        + " Please review the contract terms quickly.")

# (model, user text, user, headers)
REQUESTS = [
    ("auto", "please review this contract clause", "", {}),
    ("auto", "what is the weather like", "", {}),
    ("fast-auto", "a quick question about revenue", "", {}),
    ("fast-auto", "what time is it", "", {}),
    ("speedy", "hello there", "", {}),
    ("speedy", "please review this contract clause", "", {}),
    ("main-auto", "please review this lease", "", {}),
    ("ghost-auto", "what is the weather like", "", {}),
    ("fast-auto", "nothing matches here at all", "", {}),
    ("auto", LONG, "", {}),
    ("fast-auto", LONG, "", {}),
    ("auto", "review the lease", "limited", {}),
    ("auto", "review the lease again", "limited", {}),
    ("auto", "review the contract", "u2", {H.SKIP_PROCESSING: "true"}),
    ("auto", "review the contract", "u2", {H.SKIP_SIGNALS: "keyword"}),
]


@pytest.fixture(scope="module")
def engines():
    jeng = jtesting.make_shared_trunk_engine(tasks=TASKS, seed=21)
    teng = ttesting.make_shared_trunk_engine(
        tasks=TASKS, device="cpu", engine_cfg=load_config(CONFIG).engine,
        flax_params={n: jeng._tasks[n].params for n, _ in TASKS})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _body(model, text, user):
    body = {"model": model, "messages": [
        {"role": "system", "content": "You are helpful."},
        {"role": "user", "content": text}]}
    if user:
        body["user"] = user
    return body


class _Spy:
    """The user text each dispatcher evaluation saw."""

    def __init__(self, router) -> None:
        self.seen = []
        disps = [router.dispatcher] + [d for d, _ in
                                       router._recipe_engines.values()]
        for d in disps:
            inner = d.evaluate

            def evaluate(ctx, skip_signals=None, _inner=inner):
                self.seen.append((ctx.user_text, sorted(skip_signals or ())))
                return _inner(ctx, skip_signals=skip_signals)

            d.evaluate = evaluate


def _port_headers(h):
    """The x-vsr-* headers and retry-after; a decision record's id is
    random, so only its presence compares."""
    return {k: (True if k == H.DECISION_RECORD else v) for k, v in h.items()
            if k.startswith("x-vsr-") or k == H.RETRY_AFTER}


def _route_row(res):
    return {"kind": res.kind, "status": res.status, "model": res.model,
            "decision": res.decision.decision.name if res.decision
            else None,
            "body": res.body, "response_body": res.response_body,
            "headers": _port_headers(res.headers),
            "matches": res.signals.matches if res.signals else None}


def _serve(engines, cfg, clock):
    """Every request through both routers, in order, on one clock."""
    jeng, teng = engines
    jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(cfg)), engine=jeng)
    tr = Router(load_config(copy.deepcopy(cfg)), engine=teng)
    jspy, tspy = _Spy(jr), _Spy(tr)
    rows = []
    try:
        for i, (model, text, user, hdrs) in enumerate(REQUESTS):
            clock.t += 0.5
            hdrs = {H.REQUEST_ID: f"req-{i}", **hdrs}
            j = jr.route(_body(model, text, user), dict(hdrs))
            t = tr.route(_body(model, text, user), dict(hdrs))
            rows.append((j, t))
    finally:
        jr.shutdown()
        tr.shutdown()
    return rows, jspy.seen, tspy.seen


@pytest.mark.parametrize("cfg_name", ["default_model", "no_default"])
def test_gated_routes_match_jax(engines, clock, cfg_name):
    cfg = CONFIG if cfg_name == "default_model" else NO_DEFAULT
    rows, jseen, tseen = _serve(engines, cfg, clock)
    for i, (j, t) in enumerate(rows):
        assert _route_row(t) == _route_row(j), REQUESTS[i]
        if j.signals is not None:
            for k, v in j.signals.confidences.items():
                assert abs(t.signals.confidences[k] - v) <= PROB_TOL
    # the text the signals saw: compressed for the long prompts
    assert tseen == jseen
    long_seen = [s for s, _ in tseen if "Step 0" in s]
    assert len(long_seen) == 2 and all(len(s) < len(LONG) for s in
                                       long_seen)
    kinds = [t.kind for _, t in rows]
    assert kinds.count("rate_limited") == 1
    assert "passthrough" not in kinds  # skip-processing is off here
    decisions = {(REQUESTS[i][0], _route_row(t)["decision"])
                 for i, (_, t) in enumerate(rows)}
    # the recipe's heuristic and learned decisions and its fallback ran
    assert {("fast-auto", "fast_kw"), ("fast-auto", None),
            ("speedy", "fast_business"), ("main-auto", "legal_kw")} \
        <= decisions
    fallback = next(t for (_, t), r in zip(rows, REQUESTS)
                    if r[0] == "fast-auto" and t.decision is None)
    assert fallback.model == ("base-model" if cfg_name == "default_model"
                              else "fast-fb")


def test_recipe_config_parses_like_jax():
    j = JRouterConfig.from_dict(copy.deepcopy(CONFIG))
    t = load_config(copy.deepcopy(CONFIG))

    def recipes(c):
        return [(r.name, r.description, r.strategy,
                 [d.name for d in r.decisions],
                 [(d.name, d.priority, [m.model for m in d.model_refs])
                  for d in r.decisions],
                 {f: c_.signals.rule_names(f) for c_ in (r,)
                  for f in ("keyword", "domain")})
                for r in c.recipes]

    assert recipes(t) == recipes(j)
    assert [(e.model_names, e.recipe) for e in t.entrypoints] == \
        [(e.model_names, e.recipe) for e in j.entrypoints]
    for model in ("fast-auto", "speedy", "main-auto", "ghost-auto", "auto",
                  "", "  fast-auto "):
        want = j.recipe_for_request_model(model)
        got = t.recipe_for_request_model(model)
        assert (got.name if got else None) == (want.name if want else None)
    assert t.recipe_by_name("default").decisions == t.decisions
    assert t.recipe_by_name("missing") is None


SKIP_CONFIGS = {
    "off": {"enabled": False, "allow_skip_signals_header": True},
    "on": {"enabled": True},
    "on_header": {"enabled": True, "allow_skip_signals_header": True},
    "on_operator": {"enabled": True, "skip_signals": ["domain"]},
}
SKIP_HEADERS = [{H.SKIP_PROCESSING: "true"}, {H.SKIP_PROCESSING: "1"},
                {H.SKIP_PROCESSING: "no"},
                {H.SKIP_SIGNALS: "keyword, domain"},
                {H.SKIP_SIGNALS: "keyword"}]


@pytest.mark.parametrize("name", sorted(SKIP_CONFIGS))
def test_skip_processing_matches_jax(engines, name):
    jeng, teng = engines
    cfg = dict(copy.deepcopy(CONFIG), skip_processing=SKIP_CONFIGS[name])
    jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(cfg)), engine=jeng)
    tr = Router(load_config(copy.deepcopy(cfg)), engine=teng)
    tspy = _Spy(tr)
    try:
        for i, hdrs in enumerate(SKIP_HEADERS):
            hdrs = {H.REQUEST_ID: f"req-{i}", **hdrs}
            body = _body("auto", "please review this contract", "")
            j, t = jr.route(copy.deepcopy(body), dict(hdrs)), \
                tr.route(copy.deepcopy(body), dict(hdrs))
            assert _route_row(t) == _route_row(j), hdrs
            assert tr.skip_requested(hdrs) == jr.skip_requested(hdrs)
            if t.kind == "passthrough":
                assert name != "off" and t.body == body
    finally:
        jr.shutdown()
        tr.shutdown()
    skipped = {tuple(s) for _, s in tspy.seen}
    if name == "on_header":
        assert ("domain", "keyword") in skipped
    elif name == "on_operator":
        assert skipped == {("domain",)}
    else:
        assert skipped == {()}


# ---------------------------------------------------------------------------
# over HTTP


def _post(url, body, headers=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"content-type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
            json.loads(resp.read())
    finally:
        conn.close()


PASSTHROUGH_CONFIG = {
    "default_model": "base-model",
    "ratelimit": {"per_user": {"limited": 6}, "burst": 1},
    "skip_processing": {"enabled": True},
    "routing": {"decisions": [_dec("legal", 10, _leaf("keyword", "legal"),
                                   model="law-model")],
                "signals": {"keywords": [
                    {"name": "legal", "keywords": ["contract"]}]}}}


@pytest.fixture
def served():
    backend = MockVLLMServer().start()
    router = Router(load_config(copy.deepcopy(PASSTHROUGH_CONFIG)))
    server = RouterServer(router, backend.url).start()
    yield server.url, backend
    server.stop()
    backend.stop()
    router.shutdown()


def test_rate_limited_user_gets_429_and_the_backend_nothing(served):
    url, backend = served
    body = _body("auto", "review the contract", "limited")
    status, _, reply = _post(url, body)
    assert status == 200 and backend.hits == 1
    status, headers, reply = _post(url, body)
    assert status == 429
    assert reply["error"]["type"] == "rate_limit_exceeded"
    assert int(headers[H.RETRY_AFTER]) >= 1
    assert backend.hits == 1
    status, _, _ = _post(url, _body("auto", "review the contract", "other"))
    assert status == 200 and backend.hits == 2


def test_passthrough_reaches_the_backend_untouched(served):
    """The passthrough's request reaches the default backend as sent;
    its answer goes through the response path and feedback as the
    reference's server sends it (equal status, headers and body on the
    JAX server over the same config)."""
    from semantic_router_tpu.router.server import RouterServer as JServer

    url, backend = served
    body = _body("auto", "review the contract", "u1")
    body["reasoning_effort"] = "high"
    status, headers, reply = _post(url, body, {H.SKIP_PROCESSING: "true"})
    assert status == 200 and backend.hits == 1
    echo = json.loads(reply["choices"][0]["message"]["content"])
    # the model and fields the router would rewrite arrive as sent
    assert echo["model"] == "auto"
    assert echo["reasoning_effort"] == "high"
    assert echo["n_messages"] == 2
    assert not any(k.startswith("x-vsr-") for k in headers)
    jbackend = MockVLLMServer().start()
    jcfg = JRouterConfig.from_dict(copy.deepcopy(PASSTHROUGH_CONFIG))
    jrouter = JRouter(jcfg)
    jserver = JServer(jrouter, jcfg, default_backend=jbackend.url).start()
    try:
        jstatus, jheaders, jreply = _post(jserver.url, body,
                                          {H.SKIP_PROCESSING: "true"})
    finally:
        jserver.stop()
        jbackend.stop()
        jrouter.shutdown()
    assert (status, {k: v for k, v in headers.items()
                     if k.startswith("x-vsr-")}) == \
        (jstatus, {k: v for k, v in jheaders.items()
                   if k.startswith("x-vsr-")})
    assert {k: v for k, v in reply.items() if k not in ("id", "created")} \
        == {k: v for k, v in jreply.items() if k not in ("id", "created")}
    status, headers, reply = _post(url, body)
    echo = json.loads(reply["choices"][0]["message"]["content"])
    assert echo["model"] == "law-model"
    assert headers["x-vsr-selected-decision"] == "legal"
