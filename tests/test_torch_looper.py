"""The port's looper (looper/looper.py) against the JAX one, each over a
scripted client (as the reference's tests/test_looper_memory_replay.py
drives it): confidence by logprob and by the hedging heuristic, both
escalation orders, failed candidates, ratings with a judge, remom's
rounds and synthesis, fusion with and without NLI grounding, and the
errors when every candidate fails.  The answer, model, candidates,
usage, rounds and every call the client saw are equal.  The HTTP client
marks each call ``x-vsr-looper-request`` and drops hop-by-hop headers,
as the reference's does."""

import copy

import pytest

from semantic_router_tpu.config import ModelRef as JModelRef
from semantic_router_tpu.looper import HTTPLLMClient as JClient
from semantic_router_tpu.looper import Looper as JLooper
from semantic_router_tpu_torch.config import ModelRef
from semantic_router_tpu_torch.looper import (
    LOOPER_MARKER_HEADER,
    HTTPLLMClient,
    Looper,
)
from semantic_router_tpu_torch.router import MockVLLMServer
from semantic_router_tpu_torch.router import headers as H


class ScriptedClient:
    """Answers keyed by model (a callable gets the body), logprobs per
    model, models that fail; every call logged."""

    def __init__(self, responses=None, logprobs=None, failing=()):
        self.responses = responses or {}
        self.logprobs = logprobs or {}
        self.failing = set(failing)
        self.calls = []

    def complete(self, body, model, headers=None):
        self.calls.append((model, copy.deepcopy(body), dict(headers or {})))
        if model in self.failing:
            raise ConnectionError(f"{model} down")
        text = self.responses.get(model, f"answer from {model}")
        if callable(text):
            text = text(body)
        resp = {"choices": [{"message": {"role": "assistant",
                                         "content": text},
                             "finish_reason": "stop"}],
                "usage": {"prompt_tokens": 10, "completion_tokens": 5,
                          "total_tokens": 15}}
        if model in self.logprobs:
            resp["choices"][0]["logprobs"] = {"content": [
                {"logprob": lp} for lp in self.logprobs[model]]}
        return resp


BODY = {"messages": [{"role": "system", "content": "be exact"},
                     {"role": "user", "content": "explain tunneling"}]}
MODELS = ["small", "mid", "large"]


def _judge(body):
    text = body["messages"][0]["content"]
    if text.startswith("Rate 0-10"):
        return "8.5" if "from mid" in text else "score: 3"
    return "answer from small"


SCENARIOS = {
    "confidence_logprob_stops": (
        {"type": "confidence", "confidence": {
            "threshold": 0.7, "confidence_method": "logprob"}},
        dict(logprobs={"small": [-0.05, -0.02]})),
    "confidence_logprob_escalates": (
        {"type": "confidence", "confidence": {
            "threshold": 0.9, "confidence_method": "hybrid"}},
        dict(logprobs={"small": [-2.0], "mid": [-0.01]})),
    "confidence_heuristic": (
        {"type": "confidence", "confidence": {"threshold": 0.7}},
        dict(responses={"small": "I'm not sure, possibly unclear.",
                        "mid": "Definitive long answer. " * 12})),
    "confidence_large_to_small": (
        {"type": "confidence", "confidence": {
            "threshold": 0.95, "escalation_order": "large_to_small"}},
        dict(failing={"large"})),
    "confidence_all_fail": (
        {"type": "confidence"}, dict(failing=set(MODELS))),
    "ratings": (
        {"type": "ratings", "ratings": {"max_concurrent": 3}},
        dict(responses={"small": _judge})),
    "ratings_judge_model": (
        {"type": "ratings", "ratings": {"max_concurrent": 2,
                                        "rating_model": "large"}},
        dict(failing={"small"})),
    "remom": (
        {"type": "remom", "remom": {"breadth_schedule": [3, 2],
                                    "synthesis_model": "large",
                                    "synthesis_template": "Fuse.",
                                    "compaction_tokens": 4}}, {}),
    "remom_default": ({"type": "remom"}, {}),
    "fusion": (
        {"type": "fusion", "fusion": {"max_concurrent": 2,
                                      "synthesis_model": "mid"}}, {}),
    "fusion_grounded": (
        {"type": "fusion", "fusion": {"grounding": {"enabled": True}}}, {}),
    "fusion_all_fail": ({"type": "fusion"}, dict(failing=set(MODELS))),
    "unknown": ({"type": "tournament"}, {}),
}


def _run(looper_cls, ref_cls, algorithm, script, nli):
    client = ScriptedClient(**copy.deepcopy(script))
    looper = looper_cls(client, nli_classify=nli)
    refs = [ref_cls(model=m, weight=1.0 / (i + 1))
            for i, m in enumerate(MODELS)]
    try:
        res = looper.execute(copy.deepcopy(algorithm), refs,
                             copy.deepcopy(BODY),
                             headers={"traceparent": "t"},
                             headers_for=lambda m: {"authorization": m})
        out = ("ok", res.body, res.model, res.algorithm,
               res.candidates_used, res.usage, res.rounds)
    except (RuntimeError, ValueError) as exc:
        out = ("error", type(exc).__name__, str(exc))
    finally:
        looper.shutdown()
    return out, sorted(client.calls, key=repr)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_algorithm_matches_the_reference(name):
    algorithm, script = SCENARIOS[name]
    scores = []

    def nli(premise, claim):
        scores.append((premise, claim))
        return 0.25 + 0.5 * (len(claim) % 2)

    got = _run(Looper, ModelRef, algorithm, script, nli)
    n_port = len(scores)
    want = _run(JLooper, JModelRef, algorithm, script, nli)
    assert got == want
    if name == "fusion_grounded":
        # one NLI classification per panel answer
        assert n_port == len(scores) - n_port == len(MODELS)


def test_http_client_marks_calls_and_drops_hop_by_hop():
    backend = MockVLLMServer().start()
    try:
        hdrs = {"authorization": "Bearer k", "connection": "keep-alive",
                "host": "elsewhere", "content-type": "text/plain",
                "x-trace": "1"}
        seen = []
        for cls in (HTTPLLMClient, JClient):
            client = cls(lambda m: backend.url, timeout_s=10)
            out = client.complete({"messages": [{"role": "user",
                                                 "content": "q"}],
                                   "stream": True}, "m-x", headers=hdrs)
            assert out["model"] == "m-x"
            h = backend.headers_seen[-1]
            seen.append({k: h.get(k) for k in (
                LOOPER_MARKER_HEADER, "authorization", "x-trace",
                "content-type", "host")})
        assert seen[0] == seen[1]
        assert LOOPER_MARKER_HEADER == H.LOOPER
        assert seen[0][LOOPER_MARKER_HEADER] == "true"
        assert seen[0]["host"] != "elsewhere"
    finally:
        backend.stop()


def test_http_client_without_a_backend_raises_like_the_reference():
    for cls in (HTTPLLMClient, JClient):
        with pytest.raises(ValueError, match="no backend"):
            cls(lambda m: "").complete({}, "m")
