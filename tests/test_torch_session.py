"""The port's session telemetry (observability/session.py) against the
JAX one: session ids from user and first user message (multimodal text
parts only), turn numbers, turns, tokens, cost and model transitions
over one sequence of turns, TTL and size eviction under a monkeypatched
clock; and both HTTP servers record the same sessions for the same
answered turns (a non-streamed chat or Messages turn, as the reference
records them)."""

import copy
import http.client
import json
import urllib.parse

import pytest

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.observability import session as js
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.runtime.registry import RuntimeRegistry as \
    JRegistry
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.observability import session as ts
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry

MESSAGES = {
    "plain": [{"role": "user", "content": "hello there"}],
    "system_first": [{"role": "system", "content": "s"},
                     {"role": "user", "content": "x" * 300}],
    "multimodal": [{"role": "user", "content": [
        {"type": "text", "text": "look"},
        {"type": "image_url", "image_url": {"url": "u"}},
        {"type": "text", "text": "here"}]}],
    "later_turn": [{"role": "user", "content": "q1"},
                   {"role": "assistant", "content": "a1"},
                   {"role": "user", "content": "q2"},
                   {"role": "assistant", "content": "a2"},
                   {"role": "user", "content": "q3"}],
    "no_user": [{"role": "system", "content": "only"}],
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
@pytest.mark.parametrize("user", ["", "u-7"])
def test_session_id_and_turn_match_the_reference(name, user):
    msgs = MESSAGES[name]
    assert ts.derive_session_id(msgs, user) == js.derive_session_id(msgs,
                                                                    user)
    assert ts.chat_turn_number(msgs) == js.chat_turn_number(msgs)


TURNS = [("plain", "m1", "u", 10, 5, 0.1),
         ("plain", "m1", "u", 3, 4, 0.0),
         ("plain", "m2", "u", 1, 1, 0.5),
         ("later_turn", "m2", "", 7, 7, 0.0),
         ("later_turn", "m3", "", 0, 0, 0.2),
         ("multimodal", "", "v", 2, 2, 0.0)]


def _replay(mod, now):
    tel = mod.SessionTelemetry(ttl_s=100.0, max_sessions=2)
    rows = []
    for i, (name, model, user, p, c, cost) in enumerate(TURNS):
        now[0] = 1000.0 + 10 * i
        tr = tel.record_turn(MESSAGES[name], model, user_id=user,
                             prompt_tokens=p, completion_tokens=c,
                             cost=cost, domain="d")
        sid = mod.derive_session_id(MESSAGES[name], user)
        st = tel.get(sid)
        rows.append((tr and (tr.turn, tr.from_model, tr.to_model,
                             tr.seconds_since_last),
                     st and (st.turns, st.total_cost,
                             st.total_prompt_tokens,
                             st.total_completion_tokens, st.last_model,
                             st.models_used), tel.count(),
                     tel.last_model(MESSAGES[name], user)))
    now[0] += 1000.0
    rows.append(tel.count())
    return rows


def test_turns_and_eviction_match_the_reference(monkeypatch):
    now = [0.0]
    for mod in (ts, js):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
    assert _replay(ts, now) == _replay(js, now)


CONFIG = {"default_model": "m-base",
          "routing": {"modelCards": [{"name": "m-base", "pricing": {
              "prompt": 1.0, "completion": 2.0}}]}}


def _post(url, path, body, headers=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"content-type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        r.read()
        return r.status
    finally:
        conn.close()


def test_both_servers_record_the_same_sessions():
    backend = MockVLLMServer().start()
    jreg, treg = JRegistry.isolated(), RuntimeRegistry.isolated(
        runtimestats=None)
    jcfg = JRouterConfig.from_dict(copy.deepcopy(CONFIG))
    jrouter = JRouter(jcfg, metrics=jreg.metric_series(),
                      explain=jreg.get("explain"),
                      resilience=jreg.get("resilience"))
    trouter = Router(load_config(copy.deepcopy(CONFIG)),
                     metrics=treg.metric_series(), explain=treg.explain,
                     resilience=treg.resilience)
    servers = [JServer(jrouter, jcfg, default_backend=backend.url,
                       registry=jreg).start(),
               RouterServer(trouter, backend.url, registry=treg).start()]
    chat = {"model": "auto", "messages": MESSAGES["plain"], "user": "u1"}
    turns = [("/v1/chat/completions", chat, {}),
             ("/v1/chat/completions", dict(chat, stream=True), {}),
             ("/v1/chat/completions", chat, {"x-authz-user-id": "u9"}),
             ("/v1/messages", {"model": "auto", "max_tokens": 8,
                               "messages": MESSAGES["plain"]}, {})]
    try:
        for path, body, headers in turns:
            for s in servers:
                assert _post(s.url, path, copy.deepcopy(body),
                             headers) == 200
        rows = []
        for reg, mod in ((jreg, js), (treg, ts)):
            tel = reg.sessions
            rows.append((tel.count(), [
                (st.turns, st.total_prompt_tokens,
                 st.total_completion_tokens, round(st.total_cost, 12),
                 st.last_model)
                for st in (tel.get(mod.derive_session_id(
                    MESSAGES["plain"], u)) for u in ("u1", "u9", ""))
                if st is not None]))
        assert rows[1] == rows[0]
        assert rows[1][0] == 3
    finally:
        for s in servers:
            s.stop()
        backend.stop()
        trouter.shutdown()
