"""The port's operator plane against the JAX package's, on the CPU.

- ``render_config`` / ``reconcile`` / ``FileOperator``: the same config
  dict, the same file bytes, the same status strings; the rendered file
  routes alike on both packages' routers, and drops the boot file's
  other blocks (``classifier_models``, ``kubernetes``, ``engine``, ...)
  alike.
- The CRDs: typed round trips (unknown fields kept), the unknown-kind
  refusal, ``validate_admission``'s verdicts and reasons for the
  reference's cases, and the webhook's AdmissionReview over HTTP.
- ``KubeClient`` / ``KubeOperator``: each package's client against the
  other package's ``MiniKubeAPI`` (list, watch, the bearer token, status
  patches); add / modify / delete, the 410 re-list, an invalid CR never
  touching the file, the resume point after a DELETED event, and a burst
  of concurrent applies converging to the final CR state.
- The status conditions and scale hint for one event sequence, equal to
  the JAX operator's; ``stop()`` is bounded and leaves no thread.
- Both ``serve``s with ``kubernetes.enabled``: each starts an operator,
  and a CR change hot-swaps the live router to the same decision.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import yaml

from semantic_router_tpu.config import load_config as jload_config
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.runtime import crds as jcrds
from semantic_router_tpu.runtime import events as jevents
from semantic_router_tpu.runtime import kubewatch as jkw
from semantic_router_tpu.runtime import operator as jop
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.runtime import crds as tcrds
from semantic_router_tpu_torch.runtime import events as tevents
from semantic_router_tpu_torch.runtime import kubewatch as tkw
from semantic_router_tpu_torch.runtime import operator as top

KW = {"jax": jkw, "port": tkw}

POOL = {"apiVersion": "srt.tpu.dev/v1alpha1", "kind": "IntelligentPool",
        "metadata": {"name": "pool"},
        "spec": {"defaultModel": "m1", "models": [
            {"name": "m1", "qualityScore": 0.7, "contextWindowSize": 8192,
             "pricing": {"promptPerM": 1.0, "completionPerM": 2.0},
             "backends": [{"endpoint": "vllm:8000", "weight": 100},
                          {"endpoint": "vllm:8001"}]},
            {"name": "m2", "loras": [{"name": "cs", "adapterIndex": 1},
                                     {"name": "law"}]}]}}
ROUTE = {"apiVersion": "srt.tpu.dev/v1alpha1", "kind": "IntelligentRoute",
         "metadata": {"name": "route"},
         "spec": {
             "signals": {"keywords": [{
                 "name": "kw", "operator": "OR", "method": "exact",
                 "keywords": ["urgent"]}]},
             "decisions": [{
                 "name": "d1", "priority": 10,
                 "rules": {"operator": "OR", "conditions": [
                     {"type": "keyword", "name": "kw"}]},
                 "modelRefs": [{"model": "m2"}]}]}}
ROUTE2 = {"apiVersion": "srt.tpu.dev/v1alpha1", "kind": "IntelligentRoute",
          "metadata": {"name": "route2"},
          "spec": {
              "signals": {"keywords": [{
                  "name": "code", "operator": "OR",
                  "keywords": ["debug", "function"]}]},
              "knowledgeBases": [{"name": "kb", "source": "docs"}],
              "decisions": [{
                  "name": "code_route", "priority": 20,
                  "rules": {"type": "keyword", "name": "code"},
                  "modelRefs": [{"model": "m1"}]}]}}
BAD_ROUTE = {"kind": "IntelligentRoute", "metadata": {"name": "bad"},
             "spec": {"decisions": [{
                 "name": "d", "rules": {"operator": "OR", "conditions": [
                     {"type": "keyword", "name": "missing"}]},
                 "modelRefs": [{"model": "ghost"}]}]}}
NAMELESS_POOL = {"kind": "IntelligentPool", "metadata": {"name": "pool"},
                 "spec": {"models": [{"qualityScore": 1}]}}

# the reference's admission cases (its CRD tests' POOL_YAML / ROUTE_YAML)
POOL_YAML = """
apiVersion: srt.tpu.dev/v1alpha1
kind: IntelligentPool
metadata: {name: pool, namespace: prod, labels: {team: ml}}
spec:
  defaultModel: m-default
  models:
    - name: m-default
      qualityScore: 0.8
      pricing: {currency: USD, promptPerM: 1.5}
      customField: kept
  futureField: {nested: true}
"""
ROUTE_YAML = """
apiVersion: srt.tpu.dev/v1alpha1
kind: IntelligentRoute
metadata: {name: route}
spec:
  signals:
    keywords:
      - {name: code, operator: OR, keywords: [debug, function]}
  decisions:
    - name: code_route
      priority: 10
      rules: {type: keyword, name: code}
      modelRefs: [{model: m-code}]
"""


def _cp(obj):
    return json.loads(json.dumps(obj))


def _admission_cases() -> dict:
    pool = yaml.safe_load(POOL_YAML)
    route = yaml.safe_load(ROUTE_YAML)
    no_rules = _cp(route)
    no_rules["spec"]["decisions"][0].pop("rules")
    lora = _cp(route)
    lora["spec"]["decisions"][0]["modelRefs"] = [
        {"model": "qwen3-32b", "lora_name": "cs-expert"}]
    sibling = _cp(route)
    sibling["spec"]["signals"] = {}
    empty_route = {"kind": "IntelligentRoute", "metadata": {"name": "e"},
                   "spec": {}}
    return {
        "pool": pool, "route": route, "route_without_rules": no_rules,
        "route_with_lora_ref": lora, "route_with_sibling_signal": sibling,
        "empty_pool": {"kind": "IntelligentPool",
                       "metadata": {"name": "x"}, "spec": {}},
        "empty_route": empty_route,
        "malformed_pool": {"kind": "IntelligentPool",
                           "metadata": {"name": "x"},
                           "spec": {"models": ["not-a-dict"]}},
        "unknown_kind": {"kind": "Gadget"},
        "bad_route": BAD_ROUTE,
        "nameless_pool": NAMELESS_POOL,
    }


def _wait(pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if pred():
                return True
        except (OSError, ValueError, KeyError, TypeError):
            pass
        time.sleep(0.02)
    return False


def _read(path):
    with open(path) as f:
        return f.read()


# -- render / reconcile / FileOperator ----------------------------------------


@pytest.mark.parametrize("routes", [[], [ROUTE], [ROUTE, ROUTE2],
                                    [ROUTE2, ROUTE, BAD_ROUTE]])
def test_render_config_matches(routes):
    assert top.render_config(_cp(POOL), _cp(routes)) == \
        jop.render_config(_cp(POOL), _cp(routes))


def test_render_merges_projections_per_key():
    r1 = _cp(ROUTE)
    r1["spec"]["projections"] = {"partitions": [{"name": "p1"}],
                                 "scores": [{"name": "s1"}]}
    r2 = _cp(ROUTE2)
    r2["spec"]["projections"] = {"partitions": [{"name": "p2"}],
                                 "mappings": None}
    got = top.render_config(_cp(POOL), [r1, r2])
    assert got == jop.render_config(_cp(POOL), [r1, r2])
    assert got["routing"]["projections"]["partitions"] == [
        {"name": "p1"}, {"name": "p2"}]


@pytest.mark.parametrize("case", ["applied", "invalid_route",
                                  "invalid_nameless_model"])
def test_reconcile_matches_bytes_and_status(case, tmp_path):
    pool, routes = {"applied": (POOL, [ROUTE, ROUTE2]),
                    "invalid_route": (POOL, [BAD_ROUTE]),
                    "invalid_nameless_model": (NAMELESS_POOL, [ROUTE])}[case]
    out = {}
    for name, mod in (("jax", jop), ("port", top)):
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as f:
            f.write("default_model: keep\n")
        first = mod.reconcile(_cp(pool), _cp(routes), path)
        second = mod.reconcile(_cp(pool), _cp(routes), path)
        out[name] = (first, second, _read(path))
        assert not os.path.exists(path + ".tmp")
    assert out["port"] == out["jax"]
    first, second, text = out["port"]
    if case == "applied":
        assert first == (True, "applied") and second == (False, "unchanged")
        assert yaml.safe_load(text) == top.render_config(POOL, [ROUTE,
                                                               ROUTE2])
    else:
        assert not first[0] and first[1].startswith("invalid: ")
        assert text == "default_model: keep\n"


def test_reconcile_drops_the_boot_files_other_blocks_on_both(tmp_path):
    # a recorded reference behaviour the port keeps: the rendered file
    # replaces the boot file whole, so a process restarted from it runs no
    # classifier task, no operator and the default engine and ladder
    boot = {"default_model": "keep",
            "classifier_models": {"intent": {"checkpoint": "org/intent",
                                             "kind": "sequence"}},
            "kubernetes": {"enabled": True, "api_url": "http://127.0.0.1:1",
                           "namespace": "default"},
            "engine": {"max_batch_size": 4},
            "resilience": {"enabled": False},
            "observability": {"tracing": {"enabled": False}}}
    out = {}
    for name, mod in (("jax", jop), ("port", top)):
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(boot, f)
        assert mod.reconcile(_cp(POOL), [_cp(ROUTE)], path) == \
            (True, "applied")
        out[name] = yaml.safe_load(_read(path))
    assert out["port"] == out["jax"]
    assert not set(boot) - {"default_model"} & set(out["port"])


def test_file_operator_reconciles_and_routers_agree(tmp_path):
    cr_dir = tmp_path / "crs"
    cr_dir.mkdir()
    (cr_dir / "pool.yaml").write_text(yaml.safe_dump(POOL))
    (cr_dir / "routes.yml").write_text(yaml.safe_dump_all([ROUTE, ROUTE2]))
    (cr_dir / "notes.txt").write_text("ignored")
    paths = {}
    for name, mod in (("jax", jop), ("port", top)):
        paths[name] = str(tmp_path / f"{name}.yaml")
        op = mod.FileOperator(str(cr_dir), paths[name])
        assert op.reconcile_once() == "applied"
        assert op.reconcile_once() == "unchanged"
    assert _read(paths["port"]) == _read(paths["jax"])
    empty = tmp_path / "empty"
    empty.mkdir()
    assert top.FileOperator(str(empty), paths["port"]).reconcile_once() \
        == jop.FileOperator(str(empty), paths["jax"]).reconcile_once() \
        == "no IntelligentPool found"
    trouter = Router(load_config(paths["port"]), engine=None)
    jrouter = JRouter(jload_config(paths["jax"]), engine=None)
    try:
        for text in ("this is urgent", "debug this function",
                     "hello there"):
            body = {"model": "auto",
                    "messages": [{"role": "user", "content": text}]}
            got, want = trouter.route(body), jrouter.route(body)
            assert (got.decision.decision.name if got.decision else None,
                    got.model) == (want.decision.decision.name
                                   if want.decision else None, want.model)
        res = trouter.route({"model": "auto", "messages": [
            {"role": "user", "content": "this is urgent"}]})
        assert (res.decision.decision.name, res.model) == ("d1", "m2")
    finally:
        trouter.shutdown()
        jrouter.shutdown()


# -- the CRDs and admission ---------------------------------------------------


@pytest.mark.parametrize("doc", [POOL_YAML, ROUTE_YAML])
def test_typed_round_trip_matches(doc):
    d = yaml.safe_load(doc)
    got = tcrds.parse_cr(_cp(d)).to_dict()
    assert got == jcrds.parse_cr(_cp(d)).to_dict()
    assert tcrds.parse_cr(got).to_dict() == got
    if d["kind"] == "IntelligentPool":
        pool = tcrds.parse_cr(_cp(d))
        assert isinstance(pool, tcrds.IntelligentPool)
        assert pool.namespace == "prod" and pool.models[0].quality_score \
            == 0.8
        assert got["spec"]["futureField"] == {"nested": True}
        assert got["spec"]["models"][0]["customField"] == "kept"
        assert got["metadata"]["labels"] == {"team": "ml"}
    assert tcrds.API_VERSION == jcrds.API_VERSION == "srt.tpu.dev/v1alpha1"


def test_unknown_kind_raises_alike():
    with pytest.raises(ValueError, match="unknown CR kind") as t:
        tcrds.parse_cr({"kind": "Gadget"})
    with pytest.raises(ValueError) as j:
        jcrds.parse_cr({"kind": "Gadget"})
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("case", sorted(_admission_cases()))
def test_validate_admission_matches(case):
    obj = _admission_cases()[case]
    got = tcrds.validate_admission(_cp(obj))
    assert got == jcrds.validate_admission(_cp(obj))
    # a route whose only fault is a reference another object may satisfy
    # (an undefined signal, a model no pool lists) is admitted: the merged
    # view is reconcile's to refuse
    expected = {"pool": True, "route": True, "route_with_lora_ref": True,
                "route_with_sibling_signal": True, "bad_route": True}
    assert got[0] is expected.get(case, False), got
    if case == "route_without_rules":
        assert "rules" in got[1]


def _post_review(url, review):
    req = urllib.request.Request(
        url + "/validate", data=json.dumps(review).encode(),
        headers={"content-type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


def test_webhook_admissionreview_over_http():
    hook = tcrds.AdmissionWebhook()
    jhook = jcrds.AdmissionWebhook()
    try:
        reviews = []
        for i, (op, obj) in enumerate(
                [("CREATE", yaml.safe_load(ROUTE_YAML)),
                 ("UPDATE", _admission_cases()["route_without_rules"]),
                 ("CREATE", BAD_ROUTE), ("DELETE", {})]):
            reviews.append({"apiVersion": "admission.k8s.io/v1",
                            "kind": "AdmissionReview",
                            "request": {"uid": f"u-{i}", "operation": op,
                                        "object": obj}})
        got = [_post_review(hook.url, r) for r in reviews]
        assert got == [_post_review(jhook.url, r) for r in reviews]
        assert [g["response"]["allowed"] for g in got] == \
            [True, False, True, True]
        assert got[1]["response"]["status"]["code"] == 422
        assert got[1]["response"]["status"]["message"] == \
            tcrds.validate_admission(reviews[1]["request"]["object"])[1]
        assert got[0]["response"]["uid"] == "u-0"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(urllib.request.Request(
                hook.url + "/other", data=b"{}"), timeout=10)
        assert exc.value.code == 404
    finally:
        hook.close()
        jhook.close()


# -- KubeClient against the other package's MiniKubeAPI ------------------------


@pytest.mark.parametrize("client_pkg,api_pkg", [("port", "jax"),
                                                ("jax", "port")])
def test_client_against_the_other_packages_api(client_pkg, api_pkg):
    api = KW[api_pkg].MiniKubeAPI(token="sekrit")
    try:
        bad = KW[client_pkg].KubeClient(api.url)
        with pytest.raises(urllib.error.HTTPError) as exc:
            bad.list("intelligentpools")
        assert exc.value.code == 401
        c = KW[client_pkg].KubeClient(api.url, token="sekrit")
        assert c.list("intelligentpools") == ([], "0")
        api.apply("intelligentpools", _cp(POOL))
        items, rv = c.list("intelligentpools")
        assert len(items) == 1 and rv == "1"
        events = []
        stop = threading.Event()
        t = threading.Thread(
            target=lambda: c.watch("intelligentpools", rv,
                                   lambda e, o: events.append((e, o)),
                                   stop, timeout_s=5), daemon=True)
        t.start()
        time.sleep(0.3)
        pool2 = _cp(POOL)
        pool2["spec"]["defaultModel"] = "m2"
        api.apply("intelligentpools", pool2)
        api.apply("intelligentpools", _cp(dict(POOL, metadata={
            "name": "other"})))
        api.delete("intelligentpools", "pool")
        assert _wait(lambda: len(events) >= 3)
        assert [(e, o["metadata"]["name"]) for e, o in events[:3]] == \
            [("MODIFIED", "pool"), ("ADDED", "other"), ("DELETED", "pool")]
        assert events[0][1]["spec"]["defaultModel"] == "m2"
        assert c.patch_status("intelligentpools", "other",
                              {"scaleHint": "hold"})
        assert not c.patch_status("intelligentpools", "gone", {})
        items, _ = c.list("intelligentpools")
        assert items[0]["status"] == {"scaleHint": "hold"}
        stop.set()
        t.join(timeout=10)
    finally:
        api.close()


# -- KubeOperator ------------------------------------------------------------


@pytest.fixture(params=["port_on_jax_api", "port_on_port_api"])
def op_api(request, tmp_path):
    """The port's operator (debounce 50 ms) over a MiniKubeAPI of either
    package, and its config path."""
    api = KW["jax" if "jax_api" in request.param else "port"].MiniKubeAPI()
    path = str(tmp_path / "router.yaml")
    op = tkw.KubeOperator(tkw.KubeClient(api.url), path, debounce_s=0.05)
    yield op, api, path
    op.stop()
    api.close()


def _cfg(path):
    return yaml.safe_load(_read(path))


def test_operator_add_modify_delete(op_api):
    op, api, path = op_api
    op.start()
    api.apply("intelligentpools", _cp(POOL))
    api.apply("intelligentroutes", _cp(ROUTE))
    assert _wait(lambda: [d["name"] for d in
                          _cfg(path)["routing"]["decisions"]] == ["d1"])
    assert op.last_status in ("applied", "unchanged")
    assert _read(path) == yaml.safe_dump(
        top.render_config(POOL, [ROUTE]), sort_keys=False)
    pool2 = _cp(POOL)
    pool2["spec"]["defaultModel"] = "m2"
    api.apply("intelligentpools", pool2)
    assert _wait(lambda: _cfg(path)["default_model"] == "m2")
    api.apply("intelligentroutes", _cp(ROUTE2))
    assert _wait(lambda: [d["name"] for d in
                          _cfg(path)["routing"]["decisions"]] ==
                 ["d1", "code_route"])
    api.delete("intelligentroutes", "route")
    assert _wait(lambda: [d["name"] for d in
                          _cfg(path)["routing"]["decisions"]] ==
                 ["code_route"])
    api.delete("intelligentroutes", "route2")
    assert _wait(lambda: _cfg(path)["routing"]["decisions"] == [])


def test_operator_relists_after_410(op_api):
    op, api, path = op_api
    api.apply("intelligentpools", _cp(POOL))
    op.start()
    assert _wait(lambda: op.last_status == "applied")
    api.expire_history()  # every stale watch now answers 410
    pool2 = _cp(POOL)
    pool2["spec"]["defaultModel"] = "m2"
    api.apply("intelligentpools", pool2)
    assert _wait(lambda: _cfg(path)["default_model"] == "m2")


@pytest.mark.parametrize("pkg", sorted(KW))
def test_ended_watch_after_compaction_relists_through_410(pkg, tmp_path):
    """The port's fake ends its open streams (``end_watches``) after
    ``expire_history``: each package's operator watches again from its
    newest resourceVersion, is answered 410 and re-lists (again, until a
    change moves the resourceVersion past the compaction), and converges
    on the change applied then."""
    api = tkw.MiniKubeAPI()
    path = str(tmp_path / "router.yaml")
    api.apply("intelligentpools", _cp(POOL))
    op = KW[pkg].KubeOperator(KW[pkg].KubeClient(api.url), path,
                              debounce_s=0.05).start()
    try:
        assert _wait(lambda: op.last_status == "applied")
        assert _wait(lambda: len(op._streams) == 2)
        api.expire_history()
        api.end_watches()
        assert _wait(lambda: api.expired_watches >= 2)
        pool2 = _cp(POOL)
        pool2["spec"]["defaultModel"] = "m2"
        api.apply("intelligentpools", pool2)
        assert _wait(lambda: _cfg(path)["default_model"] == "m2")
        assert _wait(lambda: len(op._streams) == 2)
    finally:
        op.stop()
        api.close()


def test_invalid_cr_never_touches_the_file(op_api):
    op, api, path = op_api
    api.apply("intelligentpools", _cp(POOL))
    op.start()
    assert _wait(lambda: op.last_status == "applied")
    before = _read(path)
    api.apply("intelligentroutes", _cp(BAD_ROUTE))
    assert _wait(lambda: op.last_status.startswith("invalid: "))
    assert op.last_status == jop.reconcile(_cp(POOL), [_cp(BAD_ROUTE)],
                                           path)[1]
    api.apply("intelligentpools", _cp(NAMELESS_POOL))
    assert _wait(lambda: op.last_status.startswith("invalid: ")
                 and "name" in op.last_status)
    assert _read(path) == before


@pytest.mark.parametrize("pkg", sorted(KW))
def test_deleted_event_advances_the_resume_rv(pkg):
    w = KW[pkg].KubeOperator.__new__(KW[pkg].KubeOperator)
    w._state = {"intelligentpools": {}, "intelligentroutes": {}}
    w._last_rv = {}
    w._state_lock = threading.Lock()
    w._dirty = threading.Event()
    obj = {"metadata": {"namespace": "d", "name": "p",
                        "resourceVersion": "7"}}
    w._apply_event("intelligentpools", "ADDED", obj)
    assert w._last_rv["intelligentpools"] == 7
    gone = {"metadata": {"namespace": "d", "name": "p",
                         "resourceVersion": "12"}}
    w._apply_event("intelligentpools", "DELETED", gone)
    assert w._state["intelligentpools"] == {}
    assert w._last_rv["intelligentpools"] == 12
    w._apply_event("intelligentpools", "MODIFIED",
                   {"metadata": {"name": "q", "resourceVersion": "x"}})
    assert w._last_rv["intelligentpools"] == 12


def test_burst_of_applies_converges_to_the_final_state(op_api):
    op, api, path = op_api
    op.debounce_s = 0.02
    op.start()
    base = {"kind": "IntelligentPool", "metadata": {"name": "pool"},
            "spec": {"defaultModel": "m0",
                     "models": [{"name": f"m{i}"} for i in range(8)]}}
    api.apply("intelligentpools", _cp(base))

    def churn(t):
        for i in range(10):
            p = _cp(base)
            p["spec"]["defaultModel"] = f"m{(t * 10 + i) % 8}"
            api.apply("intelligentpools", p)

    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(churn, range(4)))
    final = api._objects["intelligentpools"]["default/pool"]["spec"][
        "defaultModel"]
    assert _wait(lambda: _cfg(path)["default_model"] == final)
    assert _wait(lambda: op.last_status in ("applied", "unchanged"))


def _conditions(client):
    items, _ = client.list("intelligentpools")
    status = items[0].get("status", {}) if items else {}
    conds = {c["type"]: {k: v for k, v in c.items()
                         if k != "lastTransitionTime"}
             for c in status.get("conditions", [])}
    return conds, status.get("scaleHint")


STATUS_STEPS = [
    ("slo_alert_firing", {"objective": "lat_p99", "severity": "fast"}),
    ("degradation_level_changed", {"from_level": 0, "to_level": 2}),
    ("slo_alert_firing", {"objective": "err_rate", "severity": "slow"}),
    ("slo_alert_resolved", {"objective": "lat_p99"}),
    ("degradation_level_changed", {"from_level": 2, "to_level": 1}),
    ("flywheel_state_changed", {"to": "canary"}),
    ("slo_alert_resolved", {"objective": "err_rate"}),
    ("degradation_level_changed", {"from_level": 1, "to_level": 0}),
]


def test_status_conditions_and_scale_hint_match(tmp_path):
    """One event sequence through both operators, each over its own
    package's API: after every step the pool's pushed conditions (but for
    their transition times) and scale hint are the JAX operator's."""
    runs = {}
    for pkg, bus_mod in (("jax", jevents), ("port", tevents)):
        api = KW[pkg].MiniKubeAPI()
        api.apply("intelligentpools", _cp(POOL))
        client = KW[pkg].KubeClient(api.url)
        op = KW[pkg].KubeOperator(client, str(tmp_path / f"{pkg}.yaml"))
        bus = bus_mod.EventBus()
        runs[pkg] = (api, client, op.start().attach_bus(bus), bus)
    try:
        for _pkg, (_api, _c, op, _b) in runs.items():
            assert _wait(lambda: op._state["intelligentpools"])
        for stage, detail in STATUS_STEPS:
            seen = {}
            for pkg, (_api, client, op, bus) in runs.items():
                bus.emit(stage, **detail)
                want = (dict(op.status_conditions), op.scale_hint)
                want = ({k: {f: v for f, v in c.items()
                             if f != "lastTransitionTime"}
                         for k, c in want[0].items()}, want[1])
                assert _wait(lambda: _conditions(client) == want), \
                    (pkg, stage, _conditions(client), want)
                seen[pkg] = want
            assert seen["port"] == seen["jax"], stage
        conds, hint = _conditions(runs["port"][1])
        assert hint == "steady"
        assert conds["SLOAlertFiring"]["status"] == "False"
        assert conds["Degraded"]["status"] == "False"
        assert runs["port"][2].status_push_count >= 1
    finally:
        for api, _c, op, _b in runs.values():
            op.stop()
            api.close()


def test_scale_up_on_a_fast_burn_and_brownout():
    op = tkw.KubeOperator(tkw.KubeClient("http://127.0.0.1:9"), "/dev/null")
    bus = tevents.EventBus()
    op._bus_unsub = bus.subscribe(op._on_runtime_event)
    bus.emit("slo_alert_firing", objective="lat_p99", severity="fast")
    assert op.scale_hint == "scale_up"
    assert op.status_conditions["SLOAlertFiring"]["reason"] == "lat_p99"
    bus.emit("slo_alert_resolved", objective="lat_p99")
    bus.emit("degradation_level_changed", to_level=1)
    assert op.scale_hint == "hold"
    assert op.status_conditions["Degraded"]["reason"] == \
        "DegradationLevel1"
    bus.emit("degradation_level_changed", to_level=3)
    assert op.scale_hint == "scale_up"
    op._bus_unsub()


def _kube_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("kubewatch") and t.is_alive()]


def test_stop_is_bounded_and_leaves_no_thread(tmp_path):
    assert not _kube_threads()
    api = tkw.MiniKubeAPI()
    api.apply("intelligentpools", _cp(POOL))
    op = tkw.KubeOperator(tkw.KubeClient(api.url),
                          str(tmp_path / "r.yaml")).start()
    op.attach_bus(tevents.EventBus())
    try:
        assert _wait(lambda: op.last_status == "applied")
        # both watch streams are open and parked in read
        assert _wait(lambda: len(op._streams) == 2)
        t0 = time.perf_counter()
        op.stop()
        assert time.perf_counter() - t0 < 5.0
        assert not _kube_threads()
    finally:
        api.close()


# -- serve with the kubernetes block ----------------------------------------


def _route_of(router, text):
    res = router.route({"model": "auto",
                        "messages": [{"role": "user", "content": text}]})
    return (res.decision.decision.name if res.decision else None, res.model)


def test_both_serves_run_an_operator_and_hot_swap(tmp_path):
    """Each package's ``serve`` boots a config whose ``kubernetes`` block
    names a MiniKubeAPI; a CR change there reaches the file, the watcher
    swaps the live router, and both route a prompt to the same decision;
    the port's ``server.stop()`` stops its operator."""
    from semantic_router_tpu.runtime.bootstrap import serve as jserve
    from semantic_router_tpu_torch.router import MockVLLMServer
    from semantic_router_tpu_torch.runtime.bootstrap import serve as tserve

    backend = MockVLLMServer().start()
    apis = {"jax": jkw.MiniKubeAPI(), "port": tkw.MiniKubeAPI()}
    paths = {}
    for pkg, api in apis.items():
        paths[pkg] = str(tmp_path / f"{pkg}.yaml")
        base = {"default_model": "boot-model",
                "routing": {"modelCards": [{"name": "boot-model"}],
                            "decisions": []},
                "kubernetes": {"enabled": True, "api_url": api.url,
                               "namespace": "default"}}
        with open(paths[pkg], "w") as f:
            yaml.safe_dump(base, f)
    jserver, _ = jserve(paths["jax"], port=0, default_backend=backend.url,
                        mock_models=False, block=False)
    tserver, tracker = tserve(paths["port"], backend.url, port=0,
                              device="cpu", block=False)
    servers = {"jax": jserver, "port": tserver}
    try:
        assert tracker.ready
        for pkg, srv in servers.items():
            assert srv.kube_operator is not None, pkg
            assert _route_of(srv.router, "this is urgent") == \
                (None, "boot-model")
        for step, docs in enumerate([[("intelligentpools", POOL),
                                      ("intelligentroutes", ROUTE)],
                                     [("intelligentroutes", ROUTE2)]]):
            for pkg, api in apis.items():
                for plural, doc in docs:
                    api.apply(plural, _cp(doc))
            for pkg, srv in servers.items():
                n = 1 + step
                assert _wait(lambda: len((_cfg(paths[pkg]).get("routing")
                                          or {}).get("decisions") or [])
                             == n), pkg
                later = time.time() + 2 + step
                os.utime(paths[pkg], (later, later))
                assert _wait(lambda: srv.watcher.poll_once()
                             or len(srv.cfg.decisions) == n), pkg
            for text in ("this is urgent", "debug this function",
                         "hello"):
                got = _route_of(tserver.router, text)
                assert got == _route_of(jserver.router, text), text
        assert _route_of(tserver.router, "debug this function") == \
            ("code_route", "m1")
        assert tserver.cfg.default_model == jserver.cfg.default_model \
            == "m1"
    finally:
        jserver.watcher.stop()
        jserver.kube_operator.stop()
        jserver.stop()
        tserver.stop()
        tserver.router.shutdown()
        reg = tserver.registry
        reg.runtimestats.stop()
        reg.slo.stop()
        reg.resilience.stop()
        for api in apis.values():
            api.close()
        backend.stop()
    assert _wait(lambda: not any(
        t.name.startswith("kubewatch") and t.is_alive()
        for t in threading.enumerate()), timeout=10)
