"""Looper: router-initiated multi-model execution strategies (the port's
copy of ``semantic_router_tpu.looper.looper``).

Capability parity with pkg/looper (16.9k LoC; dispatch looper.go:123-129):

- ``confidence``: small→large cascade; each response is confidence-scored
  (logprob mean when the backend returns logprobs, else a judge/heuristic
  self-eval); escalate while below threshold (confidence cascade).
- ``ratings``: query up to max_concurrent candidates in parallel, rate each
  response with the judge model, return the best.
- ``remom``: re-mixture-of-models — breadth_schedule rounds of sampling
  across candidates (round_robin/weighted distribution), inter-round
  compaction of prior responses, final synthesis call (remom.go +
  remom_distribution.go).
- ``fusion``: a panel of models answers in parallel; optional NLI grounding
  scores each candidate's claims against the panel; a synthesis call fuses
  (fusion.go + grounding.go).

The router re-enters itself as a client for these calls in the reference
(looper markers short-circuit, processor_req_body.go:64); here the client is
injected (HTTP backend client or the router's own forward path), and
responses aggregate per-model usage (usage.go).
"""

from __future__ import annotations

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence

from ..config.schema import ModelRef

# router.headers.LOOPER (the router package imports this one)
LOOPER_MARKER_HEADER = "x-vsr-looper-request"


class LLMClient(Protocol):
    def complete(self, body: Dict[str, Any], model: str,
                 headers: Optional[Dict[str, str]] = None
                 ) -> Dict[str, Any]: ...


_HOP_BY_HOP = {"content-length", "host", "connection", "transfer-encoding",
               "keep-alive", "upgrade"}


class HTTPLLMClient:
    """OpenAI-compatible HTTP client with per-model base URLs
    (pkg/looper/client.go role). Caller headers (credentials, traceparent)
    are forwarded minus hop-by-hop fields; every call carries the looper
    marker so a router-pointing backend short-circuits instead of
    recursing (isLooperRequest, processor_req_body.go:64)."""

    def __init__(self, resolve: Callable[[str], str],
                 timeout_s: float = 120.0) -> None:
        self.resolve = resolve
        self.timeout_s = timeout_s

    def complete(self, body: Dict[str, Any], model: str,
                 headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        url = self.resolve(model)
        if not url:
            raise ValueError(f"no backend for model {model!r}")
        payload = dict(body)
        payload["model"] = model
        payload.pop("stream", None)
        req = urllib.request.Request(
            url + "/v1/chat/completions",
            data=json.dumps(payload).encode(), method="POST")
        req.add_header("content-type", "application/json")
        for k, v in (headers or {}).items():
            if k.lower() not in _HOP_BY_HOP and k.lower() != "content-type":
                req.add_header(k, v)
        req.add_header(LOOPER_MARKER_HEADER, "true")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())


@dataclass
class LooperResponse:
    body: Dict[str, Any]
    model: str
    algorithm: str
    candidates_used: List[str] = field(default_factory=list)
    usage: Dict[str, Dict[str, int]] = field(default_factory=dict)  # model → usage
    rounds: int = 1


def _content(resp: Dict[str, Any]) -> str:
    try:
        return resp["choices"][0]["message"]["content"] or ""
    except (KeyError, IndexError, TypeError):
        return ""


def _mean_logprob(resp: Dict[str, Any]) -> Optional[float]:
    try:
        entries = resp["choices"][0]["logprobs"]["content"]
        vals = [e["logprob"] for e in entries]
        return sum(vals) / len(vals) if vals else None
    except (KeyError, IndexError, TypeError):
        return None


class Looper:
    """One Looper per execute() caller (it carries per-request header/error
    state); the thread pool may be shared across instances via ``pool`` —
    a shared pool is NOT shut down by this instance's shutdown()."""

    def __init__(self, client: LLMClient,
                 nli_classify: Optional[Callable[[str, str], float]] = None,
                 max_workers: int = 8,
                 pool: Optional[ThreadPoolExecutor] = None) -> None:
        self.client = client
        self.nli_classify = nli_classify  # (premise, claim) → entail prob
        self._owns_pool = pool is None
        self.pool = pool or ThreadPoolExecutor(max_workers=max_workers,
                                               thread_name_prefix="looper")

    def execute(self, algorithm: Dict[str, Any], refs: Sequence[ModelRef],
                body: Dict[str, Any],
                headers: Optional[Dict[str, str]] = None,
                headers_for: Optional[Callable[[str], Dict[str, str]]] = None
                ) -> LooperResponse:
        """``headers_for(model)`` resolves per-candidate upstream credentials
        for every fan-out call (appendCredentialHeaders parity — the
        reference resolves credentials per upstream request, not once per
        client request). A raise from it fails that candidate closed."""
        algo = str(algorithm.get("type", "confidence"))
        conf = dict(algorithm.get(algo, {}) or {})
        self._headers = dict(headers or {})
        self._headers_for = headers_for
        self._errors: List[str] = []
        try:
            if algo == "confidence":
                return self._confidence(conf, refs, body)
            if algo == "ratings":
                return self._ratings(conf, refs, body)
            if algo == "remom":
                return self._remom(conf, refs, body)
            if algo == "fusion":
                return self._fusion(conf, refs, body)
        except RuntimeError as exc:
            if self._errors:
                raise RuntimeError(
                    f"{exc} (candidate errors: {'; '.join(self._errors[:4])})"
                ) from exc
            raise
        raise ValueError(f"unknown looper algorithm {algo!r}")

    # -- shared ------------------------------------------------------------

    def _call(self, body: Dict[str, Any], model: str,
              usage: Dict[str, Dict[str, int]]) -> Optional[Dict[str, Any]]:
        try:
            hdrs = dict(getattr(self, "_headers", None) or {})
            headers_for = getattr(self, "_headers_for", None)
            if headers_for is not None:
                hdrs.update(headers_for(model))
            resp = self.client.complete(body, model, headers=hdrs)
        except Exception as exc:  # on_error: skip (fail open), but remember
            self._errors.append(f"{model}: {type(exc).__name__}: {exc}")
            return None
        u = resp.get("usage") or {}
        if u:
            agg = usage.setdefault(model, {})
            for k, v in u.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + int(v)
        return resp

    def _parallel(self, body: Dict[str, Any], models: Sequence[str],
                  usage: Dict) -> List[tuple]:
        futures = {m: self.pool.submit(self._call, body, m, usage)
                   for m in models}
        out = []
        for m, f in futures.items():
            resp = f.result()
            if resp is not None and _content(resp):
                out.append((m, resp))
        return out

    def _judge(self, prompt: str, judge_model: str,
               usage: Dict) -> str:
        resp = self._call({"messages": [{"role": "user", "content": prompt}],
                           "temperature": 0.0}, judge_model, usage)
        return _content(resp) if resp else ""

    @staticmethod
    def _heuristic_confidence(text: str) -> float:
        """Self-eval fallback when no logprobs: hedging markers lower
        confidence, substance raises it."""
        if not text:
            return 0.0
        t = text.lower()
        score = 0.7
        for marker in ("i'm not sure", "i am not sure", "cannot answer",
                       "i don't know", "might be", "possibly", "unclear"):
            if marker in t:
                score -= 0.15
        if len(text) > 200:
            score += 0.1
        return max(0.0, min(1.0, score))

    # -- algorithms --------------------------------------------------------

    def _confidence(self, conf: Dict[str, Any], refs: Sequence[ModelRef],
                    body: Dict[str, Any]) -> LooperResponse:
        threshold = float(conf.get("threshold", 0.7))
        # escalation_order small_to_large = configured modelRefs order
        # (the reference config lists cascade candidates smallest-first);
        # large_to_small reverses it.
        ordered = list(refs)
        if conf.get("escalation_order") == "large_to_small":
            ordered = list(reversed(ordered))
        usage: Dict[str, Dict[str, int]] = {}
        used = []
        last = None
        for i, ref in enumerate(ordered):
            ask = dict(body)
            if conf.get("confidence_method") in ("logprob", "hybrid"):
                ask["logprobs"] = True
            resp = self._call(ask, ref.model, usage)
            if resp is None:
                continue
            used.append(ref.model)
            last = (ref.model, resp)
            lp = _mean_logprob(resp)
            if lp is not None:
                import math

                c = math.exp(max(min(lp, 0.0), -10.0))
            else:
                c = self._heuristic_confidence(_content(resp))
            if c >= threshold or i == len(ordered) - 1:
                return LooperResponse(resp, ref.model, "confidence", used,
                                      usage)
        if last is None:
            raise RuntimeError("all confidence-cascade candidates failed")
        return LooperResponse(last[1], last[0], "confidence", used, usage)

    def _ratings(self, conf: Dict[str, Any], refs: Sequence[ModelRef],
                 body: Dict[str, Any]) -> LooperResponse:
        max_concurrent = int(conf.get("max_concurrent", 3))
        models = [r.model for r in refs][:max_concurrent]
        usage: Dict[str, Dict[str, int]] = {}
        responses = self._parallel(body, models, usage)
        if not responses:
            raise RuntimeError("all ratings candidates failed")
        judge = conf.get("rating_model") or models[0]
        question = _last_user(body)
        best, best_score = responses[0], -1.0
        for m, resp in responses:
            prompt = (f"Rate 0-10 how well this answers the question.\n"
                      f"Question: {question}\nAnswer: {_content(resp)[:2000]}\n"
                      f"Reply with only the number.")
            verdict = self._judge(prompt, judge, usage)
            score = _parse_score(verdict)
            if score > best_score:
                best, best_score = (m, resp), score
        return LooperResponse(best[1], best[0], "ratings",
                              [m for m, _ in responses], usage)

    def _remom(self, conf: Dict[str, Any], refs: Sequence[ModelRef],
               body: Dict[str, Any]) -> LooperResponse:
        schedule = list(conf.get("breadth_schedule", [3, 2]))
        compaction_tokens = int(conf.get("compaction_tokens", 512))
        synthesis_model = conf.get("synthesis_model") or refs[0].model
        template = conf.get(
            "synthesis_template",
            "Fuse the strongest findings into one final answer.")
        usage: Dict[str, Dict[str, int]] = {}
        question = _last_user(body)
        models = [r.model for r in refs]
        prior_digest = ""
        all_used: List[str] = []
        rounds = 0
        for breadth in schedule:
            rounds += 1
            ask = dict(body)
            if prior_digest:
                ask = {"messages": [
                    {"role": "user",
                     "content": f"{question}\n\nEarlier candidate answers "
                                f"(digest):\n{prior_digest}\n\nImprove on "
                                f"them."}],
                    "temperature": conf.get("temperature", 0.7)}
            # round_robin distribution over candidates
            round_models = [models[i % len(models)] for i in range(breadth)]
            responses = self._parallel(ask, list(dict.fromkeys(round_models)),
                                       usage)
            all_used.extend(m for m, _ in responses)
            digests = []
            for m, resp in responses:
                text = _content(resp)
                digests.append(f"[{m}] {text[-compaction_tokens * 4:]}")
            prior_digest = "\n---\n".join(digests)
        synth_prompt = (f"{template}\nQuestion: {question}\n\n"
                        f"Candidates:\n{prior_digest}")
        synth = self._call({"messages": [
            {"role": "user", "content": synth_prompt}]},
            synthesis_model, usage)
        if synth is None:
            raise RuntimeError("remom synthesis failed")
        return LooperResponse(synth, synthesis_model, "remom",
                              all_used, usage, rounds=rounds)

    def _fusion(self, conf: Dict[str, Any], refs: Sequence[ModelRef],
                body: Dict[str, Any]) -> LooperResponse:
        usage: Dict[str, Dict[str, int]] = {}
        models = [r.model for r in refs][:int(conf.get("max_concurrent", 4))]
        responses = self._parallel(body, models, usage)
        if not responses:
            raise RuntimeError("all fusion panel models failed")
        question = _last_user(body)

        grounding_scores: Dict[str, float] = {}
        if conf.get("grounding", {}).get("enabled") and self.nli_classify:
            # each candidate's claims scored for entailment against the
            # union of the other candidates (grounding.go)
            for m, resp in responses:
                others = "\n".join(_content(r) for mm, r in responses
                                   if mm != m)[:4000]
                try:
                    grounding_scores[m] = self.nli_classify(
                        others, _content(resp)[:2000])
                except Exception:
                    grounding_scores[m] = 0.5

        panel = []
        for m, resp in responses:
            grounded = (f" (grounding={grounding_scores[m]:.2f})"
                        if m in grounding_scores else "")
            panel.append(f"[{m}{grounded}]\n{_content(resp)[:2000]}")
        synthesis_model = conf.get("synthesis_model") or models[0]
        synth_prompt = (
            f"Question: {question}\n\nPanel answers:\n"
            + "\n---\n".join(panel)
            + "\n\nSynthesize the best single answer, preferring "
              "well-grounded claims.")
        synth = self._call({"messages": [
            {"role": "user", "content": synth_prompt}]},
            synthesis_model, usage)
        if synth is None:
            raise RuntimeError("fusion synthesis failed")
        return LooperResponse(synth, synthesis_model, "fusion",
                              [m for m, _ in responses], usage)

    def shutdown(self) -> None:
        if self._owns_pool:
            self.pool.shutdown(wait=False, cancel_futures=True)


def _last_user(body: Dict[str, Any]) -> str:
    for m in reversed(body.get("messages", [])):
        if m.get("role") == "user":
            c = m.get("content", "")
            return c if isinstance(c, str) else ""
    return ""


def _parse_score(text: str) -> float:
    import re

    m = re.search(r"\d+(?:\.\d+)?", text)
    if not m:
        return 0.0
    try:
        return min(10.0, float(m.group(0)))
    except ValueError:
        return 0.0
