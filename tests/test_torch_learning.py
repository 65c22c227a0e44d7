"""Router learning in the port against the JAX package, on the CPU: the
experience store, ``adapt``, ``SessionProtection`` and ``RouterLearning``
over seeded sequences of records and ``apply`` calls with the same
``random.Random`` seed give equal models, decisions and ledgers (the clock
pinned, so every ledger field is compared exactly); SQLite and the port's
``MiniRedis`` keep the ledgers across a restart, and either package reads
the other's SQLite file; the port's ``Router`` against the JAX ``Router``
with ``learning.enabled`` (a keyword config with protection on, and the
reference's fixture config over one seeded engine pair) selects the same
model with the same reason per request and keeps the same ledgers after
feedback; the JAX tests' own bars (repeated failures shift routing and
survive a restart; disabled learning never interferes; explicit verdicts)
hold on the port."""

import copy
import dataclasses
import random
import time

import numpy as np
import pytest
import torch
import yaml

from semantic_router_tpu import learning as jlrn
from semantic_router_tpu.learning import adaptation as jad
from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.state.resp import MiniRedis as JMiniRedis
from semantic_router_tpu_torch import learning as tlrn
from semantic_router_tpu_torch.learning import adaptation as tad
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.state.resp import MiniRedis

MODELS = ["m-small", "m-mid", "m-large"]
DECISIONS = ["code", "chat", ""]
NOW = 1_800_000_000.0


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """``time.time`` pinned (both packages' ledgers stamp it), advanced by
    the test through ``clock[0]``."""
    now = [NOW]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(seed: int, n: int = 160) -> list:
    """Seeded ``ExperienceStore.record`` calls, unknown verdicts and empty
    models included."""
    rng = np.random.default_rng(seed)
    verdicts = list(tlrn.VERDICTS) + ["bogus"]
    out = []
    for _ in range(n):
        maybe = lambda x: None if rng.random() < 0.4 else x  # noqa: E731
        out.append(dict(
            decision=DECISIONS[rng.integers(3)],
            tier=int(rng.integers(3)),
            model=(MODELS + [""])[rng.integers(4)],
            verdict=verdicts[rng.integers(len(verdicts))],
            count=int(rng.integers(0, 3)),
            latency_norm=maybe(float(rng.uniform(-0.2, 1.3))),
            cache_hit=maybe(bool(rng.integers(2))),
            cost_norm=maybe(float(rng.uniform(0, 1.2))),
            quality_seed=maybe(float(rng.uniform(-0.1, 1.1)))))
    return out


def _ledgers(store) -> dict:
    return {k: dataclasses.asdict(v) for k, v in sorted(store._exp.items())}


def _filled(seed: int):
    js, ts = jlrn.ExperienceStore(), tlrn.ExperienceStore()
    for rec in _records(seed):
        js.record(**rec)
        ts.record(**rec)
    return js, ts


def test_experience_store_matches_jax():
    js, ts = _filled(1)
    assert ts.export() == _ledgers(js)
    assert ts.export()  # the sequence learned something
    for d in DECISIONS + ["unseen"]:
        for tier in range(4):
            for m in MODELS + ["never"]:
                assert dataclasses.asdict(ts.snapshot(d, tier, m)) \
                    == dataclasses.asdict(js.snapshot(d, tier, m))
    assert ts.snapshot("x", 0, "never").total == 0


def _queries(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cands = [m for m in MODELS if rng.random() < 0.8]
        base = (cands or MODELS)[rng.integers(len(cands or MODELS))]
        out.append(dict(
            decision=DECISIONS[rng.integers(3)], tier=int(rng.integers(3)),
            candidates=cands + ([""] if rng.random() < 0.2 else []),
            base_model=base))
    return out


@pytest.mark.parametrize("sampling", [True, False], ids=["thompson", "mean"])
@pytest.mark.parametrize("candidate_set", ["decision", "tier", "global"])
@pytest.mark.parametrize("mode", ["apply", "observe", "bypass"])
def test_adapt_matches_jax(mode, candidate_set, sampling):
    js, ts = _filled(2)
    costs = {"m-small": 0.1, "m-mid": 0.6, "m-large": 2.0}
    seeds = {"m-large": 0.9, "m-small": 0.4}
    jr, tr = random.Random(5), random.Random(5)
    actions = set()
    for q in _queries(3):
        kw = dict(mode=mode, candidate_set=candidate_set,
                  use_sampling=sampling, costs=costs, quality_seeds=seeds)
        want = jlrn.adapt(js, q["decision"], q["tier"], q["candidates"],
                          q["base_model"], rng=jr, **kw)
        got = tlrn.adapt(ts, q["decision"], q["tier"], q["candidates"],
                         q["base_model"], rng=tr, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        actions.add(got.action)
    assert jr.random() == tr.random()  # the same draws were taken
    if mode == "bypass":
        assert actions == {"bypass"}
    elif mode == "observe":
        assert actions == {"keep_base"}


def _proposal(ad, model: str, scores: dict):
    """An ``AdaptationDecision`` of the adaptation module ``ad`` proposing
    ``model`` over candidates scored ``scores``."""
    return ad.AdaptationDecision(
        model=model, action="propose_switch", reason="sampled_winner",
        scores=[ad.CandidateScore(m, s, s, s, 0, 0, 0, 0, 0)
                for m, s in scores.items()])


def test_session_protection_matches_jax(clock):
    rng = np.random.default_rng(4)
    kw = dict(idle_timeout_s=30.0, min_turns_before_switch=2,
              switch_margin=0.05)
    for scope in ("conversation", "session"):
        jp = jlrn.SessionProtection(scope=scope, **kw)
        tp = tlrn.SessionProtection(scope=scope, **kw)
        actions = set()
        for i in range(80):
            headers = {}
            if rng.random() < 0.8:
                headers["X-Session-Id"] = f"s{rng.integers(3)}"
            if rng.random() < 0.5:
                headers["x-conversation-id"] = f"c{rng.integers(2)}"
            scores = {m: float(rng.uniform(0.3, 0.9)) for m in MODELS}
            model = MODELS[rng.integers(3)]
            base = MODELS[rng.integers(3)]
            assert dataclasses.asdict(tp.preflight(headers)) \
                == dataclasses.asdict(jp.preflight(headers))
            got = tp.apply(headers, _proposal(tad, model, scores), base)
            want = jp.apply(headers, _proposal(jad, model, scores), base)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            actions.add(got.action)
            clock[0] += float(rng.choice([1.0, 5.0, 40.0]))
        assert {k: dataclasses.asdict(v) for k, v in tp._sessions.items()} \
            == {k: dataclasses.asdict(v) for k, v in jp._sessions.items()}
        assert {"cold_start", "warm_keep"} <= actions


LEARNING = {
    "enabled": True,
    "adaptation": {"candidate_set": "decision"},
    "protection": {"enabled": True,
                   "tuning": {"min_turns_before_switch": 1,
                              "switch_margin": 0.02,
                              "idle_timeout_seconds": 60}},
}


@pytest.mark.parametrize("protection", [True, False], ids=["protected",
                                                           "open"])
def test_router_learning_matches_jax(protection, clock):
    cfg = copy.deepcopy(LEARNING)
    cfg["protection"]["enabled"] = protection
    costs = {"m-small": 0.2, "m-mid": 0.5, "m-large": 1.5}
    seeds = {"m-mid": 0.7}
    jl_ = jlrn.RouterLearning(cfg, costs, seeds, rng=random.Random(9))
    tl_ = tlrn.RouterLearning(cfg, costs, seeds, rng=random.Random(9))
    rng = np.random.default_rng(6)
    switched = 0
    for i in range(120):
        dec = DECISIONS[rng.integers(2)]
        base = MODELS[rng.integers(3)]
        headers = {"x-session-id": f"s{rng.integers(4)}"} \
            if rng.random() < 0.6 else {}
        mode = [None, "apply", "observe"][rng.integers(3)]
        tier = int(rng.integers(2))
        got = tl_.apply(dec, MODELS, base, headers=headers, tier=tier,
                        mode=mode)
        assert got == jl_.apply(dec, MODELS, base, headers=headers,
                                tier=tier, mode=mode)
        switched += got != base
        ok = got != "m-small" or rng.random() < 0.2
        verdict = ["", "underpowered", "overprovisioned", "bogus"][
            rng.integers(4)]
        kw = dict(verdict=verdict, success=ok,
                  latency_ms=float(rng.uniform(0, 40_000)),
                  cache_hit=[None, True, False][rng.integers(3)], tier=tier)
        tl_.record_outcome(dec, got, **kw)
        jl_.record_outcome(dec, got, **kw)
        clock[0] += 7.0
    assert tl_.store.export() == _ledgers(jl_.store)
    assert switched > 0
    off = tlrn.RouterLearning({"enabled": False})
    assert off.apply("d", MODELS, "m-small") == "m-small"
    off.record_outcome("d", "m-small", success=False)
    assert off.store.export() == {}


def test_sqlite_restart_hydrates_and_reads_across_packages(tmp_path):
    path = str(tmp_path / "exp.db")
    be = {"backend": "sqlite", "path": path}
    s1 = tlrn.ExperienceStore(be)
    for rec in _records(7, 60):
        s1.record(**rec)
    state = s1.export()
    s1.close()
    s2 = tlrn.ExperienceStore(be)
    assert s2.export() == state
    s2.close()
    js = jlrn.ExperienceStore(be)  # the JAX package reads the port's file
    assert _ledgers(js) == state
    js.record("code", 1, "m-mid", "failed")
    js.close()
    s3 = tlrn.ExperienceStore(be)
    assert s3.snapshot("code", 1, "m-mid").failed \
        == state.get("code|1|m-mid", {"failed": 0})["failed"] + 1
    s3.close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_miniredis_restart_hydrates(server):
    mini = (MiniRedis() if server == "port" else JMiniRedis()).start()
    try:
        be = {"backend": "valkey", "port": mini.port, "key_prefix": "t:l"}
        s1 = tlrn.ExperienceStore(be)
        recs = _records(8, 40)
        for rec in recs:
            s1.record(**rec)
        s1.close()
        # another replica (or a restart) hydrates lazily, key by key
        s2 = tlrn.ExperienceStore(be)
        js = jlrn.ExperienceStore(be)
        assert s2.export() == {}
        for d in DECISIONS:
            for tier in range(3):
                for m in MODELS:
                    assert dataclasses.asdict(s2.snapshot(d, tier, m)) \
                        == dataclasses.asdict(s1.snapshot(d, tier, m)) \
                        == dataclasses.asdict(js.snapshot(d, tier, m))
        assert s2.export() == _ledgers(js)
        assert s2.export()
    finally:
        mini.stop()


# -- the routers ---------------------------------------------------------------


def _learning_cfg(tmp_path, enabled=True, protection=False, name="learn"):
    return {
        "model_cards": [{"name": "m-small", "quality_score": 0.5},
                        {"name": "m-large", "quality_score": 0.5,
                         "pricing": {"prompt": 2.0}}],
        "default_model": "m-small",
        "decisions": [{
            "name": "flaky_route", "priority": 10, "tier": 1,
            "rules": {"operator": "OR", "conditions": [
                {"type": "keyword", "name": "task_kw"}]},
            "modelRefs": [{"model": "m-small", "weight": 100},
                          {"model": "m-large", "weight": 1}],
            "algorithm": {"type": "static", "seed": 0},
        }, {
            "name": "watched_route", "priority": 5,
            "adaptations": {"mode": "observe"},
            "rules": {"operator": "OR", "conditions": [
                {"type": "keyword", "name": "watch_kw"}]},
            "modelRefs": [{"model": "m-small"}, {"model": "m-large"}],
            "algorithm": {"type": "static", "seed": 0},
        }],
        "signals": {"keywords": [
            {"name": "task_kw", "operator": "OR", "method": "exact",
             "keywords": ["transpile"]},
            {"name": "watch_kw", "operator": "OR", "method": "exact",
             "keywords": ["audit"]}]},
        "learning": {
            "enabled": enabled,
            "store": {"backend": "sqlite",
                      "path": str(tmp_path / f"{name}.db")},
            "adaptation": {"candidate_set": "decision"},
            "protection": {"enabled": protection,
                           "tuning": {"min_turns_before_switch": 1}},
        },
    }


BODY = {"model": "auto", "messages": [
    {"role": "user", "content": "transpile this module"}]}
WATCH = {"model": "auto", "messages": [
    {"role": "user", "content": "audit this module"}]}


def _pair(tmp_path, **kw):
    jcfg = _learning_cfg(tmp_path, name="jax", **kw)
    tcfg = _learning_cfg(tmp_path, name="port", **kw)
    jr = JRouter(JRouterConfig.from_dict(jcfg), engine=None)
    tr = Router(load_config(tcfg), engine=None)
    for r in (jr, tr):
        if r.learning is not None:
            r.learning.rng = random.Random(11)
    return jr, tr


@pytest.mark.parametrize("protection", [False, True],
                         ids=["open", "protected"])
def test_routers_match_jax_with_learning(tmp_path, protection):
    jr, tr = _pair(tmp_path, protection=protection)
    rng = np.random.default_rng(12)
    reasons = set()
    try:
        for i in range(40):
            body = copy.deepcopy(WATCH if i % 5 == 4 else BODY)
            headers = {"x-session-id": f"s{i % 3}"} if protection else {}
            jres = jr.route(copy.deepcopy(body), dict(headers))
            tres = tr.route(copy.deepcopy(body), dict(headers))
            assert (tres.model, tres.selection_reason) \
                == (jres.model, jres.selection_reason)
            reasons.add(tres.selection_reason)
            ok = tres.model == "m-large" or rng.random() < 0.1
            verdict = "" if i % 4 else ["underpowered", "good_fit"][ok]
            kw = dict(success=ok, latency_ms=120.0, verdict=verdict)
            jr.record_feedback(jres, **kw)
            tr.record_feedback(tres, **kw)
        assert tr.learning.store.export() == _ledgers(jr.learning.store)
        assert any("→ learning:m-large" in r for r in reasons), reasons
    finally:
        jr.shutdown()
        tr.shutdown()


def test_repeated_failures_shift_routing(tmp_path):
    """The JAX test's bar (tests/test_learning.py) on the port: repeated
    outcomes shift the routing, and a restart over the same SQLite store
    keeps the learned preference."""
    cfg = _learning_cfg(tmp_path)
    router = Router(load_config(cfg), engine=None)
    router.learning.rng = random.Random(11)
    for _ in range(15):
        res = router.route(copy.deepcopy(BODY))
        router.record_feedback(res, success=res.model == "m-large",
                               latency_ms=100)
    picks = [router.route(copy.deepcopy(BODY)).model for _ in range(10)]
    assert picks.count("m-large") >= 8, picks
    state = router.learning.store.export()
    router.shutdown()
    router2 = Router(load_config(_learning_cfg(tmp_path)), engine=None)
    router2.learning.rng = random.Random(13)
    assert router2.learning.store.export() == state
    picks2 = [router2.route(copy.deepcopy(BODY)).model for _ in range(10)]
    assert picks2.count("m-large") >= 8, picks2
    # an observe-mode decision never switches, whatever was learned
    assert not any("learning" in router2.route(
        copy.deepcopy(WATCH)).selection_reason for _ in range(5))
    router2.shutdown()


def test_disabled_learning_never_interferes_and_verdicts_record(tmp_path):
    router = Router(load_config(_learning_cfg(tmp_path, enabled=False)),
                    engine=None)
    assert router.learning is None
    assert router.route(copy.deepcopy(BODY)).model == "m-small"
    router.record_feedback(router.route(copy.deepcopy(BODY)), success=False)
    router.shutdown()
    router = Router(load_config(_learning_cfg(tmp_path)), engine=None)
    res = router.route(copy.deepcopy(BODY))
    router.record_feedback(res, verdict="underpowered")
    assert router.learning.store.snapshot("flaky_route", 1,
                                          res.model).underpowered == 1
    # a roll-up over the decision and the tier
    assert router.learning.store.snapshot("other", 0,
                                          res.model).underpowered == 1
    router.shutdown()


def test_flywheel_stays_refused_beside_learning(tmp_path):
    cfg = _learning_cfg(tmp_path)
    cfg["flywheel"] = {"enabled": True}
    with pytest.raises(ValueError, match="flywheel"):
        load_config(cfg)


# -- the reference's fixture config over one seeded engine pair --------------------


DOMAINS = ["business", "computer science", "health", "other"]
SEQ_TASKS = [("intent", DOMAINS),
             ("jailbreak", ["benign", "jailbreak"]),
             ("modality", ["AR", "DIFFUSION", "BOTH"]),
             ("fact_check", ["needs_fact_check", "no_fact_check_needed"]),
             ("user_feedback", ["wrong_answer", "need_clarification"])]
PII_LABELS = ["O", "B-PERSON", "I-PERSON"]


@pytest.fixture(scope="module")
def engines():
    import jax
    import jax.numpy as jnp

    from semantic_router_tpu.models.embeddings import \
        MmBertEmbeddingModel as JEmbeddingModel
    from semantic_router_tpu_torch.models import MmBertEmbeddingModel, \
        params_from_flax

    jeng = jtesting.make_shared_trunk_engine(
        tasks=SEQ_TASKS, token_tasks=[("pii", PII_LABELS)], seed=7)
    emb = JEmbeddingModel(jtesting.tiny_config(2))
    emb_params = emb.init(jax.random.PRNGKey(3), jnp.ones((1, 8), jnp.int32))
    tok = jeng._tasks["intent"].tokenizer
    jeng.register_task("embedding", "embedding", emb, emb_params, tok, [],
                       max_seq_len=512)
    teng = ttesting.make_shared_trunk_engine(
        tasks=SEQ_TASKS, token_tasks=[("pii", PII_LABELS)], device="cpu",
        flax_params={n: jeng._tasks[n].params
                     for n, _ in SEQ_TASKS + [("pii", None)]})
    temb = MmBertEmbeddingModel(ttesting.tiny_config(2))
    temb.load_state_dict(params_from_flax(emb_params))
    teng.register_task("embedding", "embedding", temb,
                       teng.trunk_group("intent").tokenizer, [],
                       max_seq_len=512)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


FIXTURE_TEXTS = [
    "please debug this function and refactor the algorithm code",
    "explain the proof of this theorem step by step",
    "hello world, ask the panel of experts",
    "first solve this step by step, then analyze the root cause",
    "how long do you keep my personal data",
    "what is the capital of France",
]


def test_fixture_routers_match_jax_with_learning(engines, tmp_path,
                                                 fixture_config_path):
    jeng, teng = engines
    with open(fixture_config_path) as f:
        d = yaml.safe_load(f)
    routers = []
    for name, eng, build in (("jax", jeng, lambda c: JRouter(
            JRouterConfig.from_dict(c), engine=jeng)),
            ("port", teng, lambda c: Router(load_config(c), engine=teng))):
        cfg = copy.deepcopy(d)
        cfg["routing"]["learning"] = dict(
            copy.deepcopy(LEARNING),
            store={"backend": "sqlite", "path": str(tmp_path / f"{name}.db")})
        r = build(cfg)
        r.learning.rng = random.Random(21)
        routers.append(r)
    jr, tr = routers
    rng = np.random.default_rng(13)
    multi = learned = 0
    try:
        for i in range(18):
            body = {"model": "auto", "messages": [
                {"role": "user", "content": FIXTURE_TEXTS[i % 6]}]}
            headers = {"x-session-id": f"u{i % 4}"}
            jres = jr.route(copy.deepcopy(body), dict(headers))
            tres = tr.route(copy.deepcopy(body), dict(headers))
            assert tres.kind == jres.kind
            assert (tres.model, tres.selection_reason) \
                == (jres.model, jres.selection_reason)
            if tres.decision is not None and \
                    len(tres.decision.decision.model_refs) > 1:
                multi += 1
                learned += "→ learning:" in tres.selection_reason
            verdict = ["good_fit", "underpowered", "failed",
                       "overprovisioned"][rng.integers(4)]
            jr.record_feedback(jres, verdict=verdict, latency_ms=50.0)
            tr.record_feedback(tres, verdict=verdict, latency_ms=50.0)
        assert tr.learning.store.export() == _ledgers(jr.learning.store)
        assert multi > 0 and learned > 0, (multi, learned)
    finally:
        jr.shutdown()
        tr.shutdown()
