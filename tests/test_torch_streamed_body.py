"""The port's STREAMED request-body handler
(``semantic_router_tpu_torch.extproc.streamed``) against the JAX one, on
the CPU: the resumable top-level scanner on hypothesis-drawn JSON objects
(nested keys named ``model``, escapes, unicode, truncated scalars), each
fed whole, cut at every byte and in random chunkings, with ``fields``,
``done``, ``broken`` and ``pos`` equal after every chunk; the handler's
state machine against a spy router on both (passthrough, the prefetch
before end of stream, the rate-limit decline and ``peek`` consuming
nothing, the late ``tools`` restart, the tools-at-EOS inline fallback, the
413 / 408 / 400 guards); and the overlap of a slow evaluator with a
trickled 30 KB body through the port's filter: classification runs once,
starts before the last chunk, and the end-of-stream tail stays under
0.5 s."""

import json
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from semantic_router_tpu.extproc import streamed as jstreamed
from semantic_router_tpu.router.ratelimit import RateLimiter as JRateLimiter
from semantic_router_tpu_torch.extproc import streamed as tstreamed
from semantic_router_tpu_torch.router.ratelimit import RateLimiter

MODULES = (jstreamed, tstreamed)

# ---------------------------------------------------------------------------
# the scanner

_keys = st.sampled_from(["model", "messages", "tools", "stream", "user",
                         "metadata", "n", "mödel", 'a"b', "x\\y", ""])
_scalars = (st.none() | st.booleans() | st.integers(-10**6, 10**6)
            | st.floats(allow_nan=False, allow_infinity=False)
            | st.text(alphabet=st.characters(codec="utf-8"), max_size=12)
            | st.sampled_from(['"model": "x"', "}", "{", "\\", "\n", "é"]))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=4)
                   | st.dictionaries(_keys, inner, max_size=4)),
    max_leaves=12)
_objects = st.dictionaries(_keys, _values, max_size=6)


def _encode(obj, ensure_ascii: bool, pretty: bool) -> bytes:
    return json.dumps(obj, ensure_ascii=ensure_ascii,
                      indent=1 if pretty else None).encode()


def _state(sc) -> tuple:
    return (dict(sc.fields), sc.done, sc.broken, sc.pos)


def _feed_both(raw: bytes, cuts) -> None:
    """Feed ``raw`` to both scanners as the body grows past each cut;
    their state must agree after every chunk."""
    scanners = [m.TopLevelScanner() for m in MODULES]
    for end in list(cuts) + [len(raw)]:
        for sc in scanners:
            sc.feed(raw[:end])
        assert _state(scanners[1]) == _state(scanners[0]), end


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(obj=_objects, ensure_ascii=st.booleans(), pretty=st.booleans())
def test_scanner_every_byte_cut(obj, ensure_ascii, pretty):
    raw = _encode(obj, ensure_ascii, pretty)
    _feed_both(raw, range(len(raw)))
    for end in range(len(raw) + 1):   # and one-shot on every prefix
        assert jstreamed.partial_top_level_fields(raw[:end]) == \
            tstreamed.partial_top_level_fields(raw[:end])


@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(obj=_objects, ensure_ascii=st.booleans(),
       data=st.data())
def test_scanner_random_chunkings(obj, ensure_ascii, data):
    raw = _encode(obj, ensure_ascii, False)
    cuts = sorted(data.draw(st.sets(st.integers(0, len(raw)), max_size=8)))
    _feed_both(raw, cuts)
    sc = tstreamed.TopLevelScanner()
    sc.feed(raw)
    assert sc.done and not sc.broken
    # keys are kept as their raw (escaped) text
    assert {json.loads(f'"{k}"'): json.loads(v)
            for k, v in sc.fields.items()} == obj


@settings(max_examples=60, deadline=None)
@given(raw=st.binary(max_size=64) | st.sampled_from([
    b'{"stream": tru', b'{"stream": true,', b"[1, 2]", b"",
    b'{"model": "auto", "messages": [{"role": "user", "con',
    b'{"model" "x"}', b'  {"n": 1e', b'{"a": "\\u00e9\\"', b'{,,"k":1}']))
def test_scanner_truncated_and_malformed(raw):
    _feed_both(raw, range(len(raw)))


# ---------------------------------------------------------------------------
# the handler's state machine against a spy router

class _SpyRouter:
    def __init__(self, delay: float = 0.0):
        self.evaluated = []
        self.delay = delay

    def evaluate_signals(self, body, headers):
        self.evaluated.append(body)
        if self.delay:
            time.sleep(self.delay)
        return ("SIGNALS", "REPORT")


def _both(run):
    """``run(module)`` on each package; the outcomes must be equal."""
    want, got = run(jstreamed), run(tstreamed)
    assert got == want
    return got


def test_pinned_model_goes_passthrough():
    def run(m):
        h = m.StreamedBodyHandler(_SpyRouter(), {})
        raw = json.dumps({"model": "gpt-x", "messages": [
            {"role": "user", "content": "hello"}]}).encode()
        first = h.handle_chunk(raw[:18], False)
        return first, h.model, h.model_detected_at, \
            h.handle_chunk(raw[18:], True)

    first, model, at, last = _both(run)
    assert first == ("continue", None) and model == "gpt-x" and at == 1
    assert last[0] == "passthrough" and last[1]["model"] == "gpt-x"


def test_auto_model_prefetches_signals_before_eos():
    body = {"model": "auto",
            "messages": [{"role": "user", "content": "classify me"}],
            "metadata": {"k": "v" * 400}}   # an inert trailing field

    def run(m):
        spy = _SpyRouter()
        pool = ThreadPoolExecutor(max_workers=1)
        h = m.StreamedBodyHandler(spy, {"x-a": "b"}, prefetch_pool=pool)
        raw = json.dumps(body).encode()
        cut = raw.index(b'"metadata"')
        first = h.handle_chunk(raw[:cut], False)
        started = h.prefetch_started_at
        h._prefetch.result(timeout=5)   # classified while the body arrives
        last = h.handle_chunk(raw[cut:], True)
        pool.shutdown()
        return first, started, last, spy.evaluated

    first, started, (action, (final, signals)), evaluated = _both(run)
    assert first == ("continue", None) and started == 1
    assert action == "route" and signals == ("SIGNALS", "REPORT")
    assert final == body
    assert evaluated[0]["messages"] == body["messages"]


class _Limiter:
    def __init__(self):
        self.peeked = []

    def peek(self, user, model):
        self.peeked.append((user, model))
        return False


def test_prefetch_skipped_when_rate_limited():
    body = {"model": "auto",
            "messages": [{"role": "user", "content": "classify"}],
            "metadata": {"k": "v" * 200}}

    def run(m):
        spy = _SpyRouter()
        spy.rate_limiter = _Limiter()
        pool = ThreadPoolExecutor(max_workers=1)
        h = m.StreamedBodyHandler(spy, {"x-authz-user-id": "flooder"},
                                  prefetch_pool=pool)
        raw = json.dumps(body).encode()
        cut = raw.index(b'"metadata"')
        first = h.handle_chunk(raw[:cut], False)
        # the same view again: the decline is cached, no second peek
        again = h.handle_chunk(b"", False)
        out = (first, again, h.prefetch_started_at,
               list(spy.rate_limiter.peeked),
               h.handle_chunk(raw[cut:], True), spy.evaluated)
        pool.shutdown()
        return out

    first, again, started, peeked, last, evaluated = _both(run)
    assert first == again == ("continue", None) and started is None
    assert peeked == [("flooder", "auto")]
    assert last == ("route", (body, None))   # route() still runs (and 429s)
    assert evaluated == []


def test_prefetch_peek_takes_the_body_user():
    body = {"model": "auto", "user": "u-7",
            "messages": [{"role": "user", "content": "classify"}],
            "metadata": {"k": "v" * 50}}

    def run(m):
        spy = _SpyRouter()
        spy.rate_limiter = _Limiter()
        h = m.StreamedBodyHandler(spy, {}, prefetch_pool=ThreadPoolExecutor(1))
        raw = json.dumps(body).encode()
        h.handle_chunk(raw[:raw.index(b'"metadata"')], False)
        h.pool.shutdown()
        return spy.rate_limiter.peeked

    assert _both(run) == [("u-7", "auto")]


@pytest.mark.parametrize("cls", [JRateLimiter, RateLimiter])
def test_prefetch_peek_does_not_consume_budget(cls):
    rl = cls(requests_per_minute=60, burst=2)
    assert rl.check("u", "m").allowed     # the bucket at 1
    for _ in range(50):
        assert rl.peek("u", "m")          # consumes nothing
    assert rl.check("u", "m").allowed     # the last real token
    assert not rl.peek("u", "m")          # now empty: peek says so
    assert not rl.check("u", "m").allowed


def test_late_tools_restart_prefetch_and_stay_reusable():
    body = {"model": "auto",
            "messages": [{"role": "user", "content": "hi"}],
            "tools": [{"type": "function", "function": {"name": "t"}}],
            "metadata": {"pad": "x" * 500}}

    def run(m):
        spy = _SpyRouter()
        pool = ThreadPoolExecutor(max_workers=2)
        h = m.StreamedBodyHandler(spy, {}, prefetch_pool=pool)
        raw = json.dumps(body).encode()
        c1, c2 = raw.index(b'"tools"'), raw.index(b'"metadata"')
        h.handle_chunk(raw[:c1], False)
        s1 = h.prefetch_started_at
        h.handle_chunk(raw[c1:c2], False)
        s2 = h.prefetch_started_at
        h._prefetch.result(timeout=5)
        last = h.handle_chunk(raw[c2:], True)
        pool.shutdown()
        return s1, s2, last, spy.evaluated[-1]

    s1, s2, (action, (_final, signals)), last_seen = _both(run)
    assert (s1, s2) == (1, 2)          # tools completed: restarted
    assert action == "route" and signals == ("SIGNALS", "REPORT")
    assert last_seen["tools"] == body["tools"]


def test_tools_completing_at_eos_falls_back_inline():
    body = {"model": "auto",
            "messages": [{"role": "user", "content": "hi"}],
            "tools": [{"type": "function", "function": {"name": "t" * 500}}]}

    def run(m):
        pool = ThreadPoolExecutor(max_workers=1)
        h = m.StreamedBodyHandler(_SpyRouter(), {}, prefetch_pool=pool)
        raw = json.dumps(body).encode()
        cut = raw.index(b'"tools"')
        h.handle_chunk(raw[:cut], False)
        started = h.prefetch_started_at
        last = h.handle_chunk(raw[cut:], True)
        pool.shutdown()
        return started, last

    started, (action, (_final, signals)) = _both(run)
    # the prefetch saw another signal view: never reused
    assert started == 1 and action == "route" and signals is None


def test_queued_prefetch_is_cancelled_at_eos():
    """Cancel first: a prefetch still queued behind other work at end of
    stream is cancelled and route() evaluates inline."""
    body = {"model": "auto",
            "messages": [{"role": "user", "content": "hi"}],
            "metadata": {"pad": "x" * 50}}

    def run(m):
        spy = _SpyRouter()
        pool = ThreadPoolExecutor(max_workers=1)
        blocker = pool.submit(time.sleep, 0.3)   # the pool's one worker
        h = m.StreamedBodyHandler(spy, {}, prefetch_pool=pool)
        raw = json.dumps(body).encode()
        cut = raw.index(b'"metadata"')
        h.handle_chunk(raw[:cut], False)
        last = h.handle_chunk(raw[cut:], True)
        cancelled = h._prefetch.cancelled()
        blocker.result()
        pool.shutdown()
        return last, cancelled, spy.evaluated

    last, cancelled, evaluated = _both(run)
    assert last == ("route", (body, None)) and cancelled and evaluated == []


def test_no_pool_still_routes():
    def run(m):
        h = m.StreamedBodyHandler(_SpyRouter(), {})
        raw = json.dumps({"model": "auto", "messages": []}).encode()
        return h.handle_chunk(raw, True)

    assert _both(run) == ("route", ({"model": "auto", "messages": []}, None))


def test_max_bytes_guard_413():
    def run(m):
        return m.StreamedBodyHandler(_SpyRouter(), {}, max_bytes=64) \
            .handle_chunk(b"x" * 100, False)

    action, (status, _payload) = _both(run)
    assert action == "error" and status == 413


def test_deadline_guard_408():
    def run(m):
        h = m.StreamedBodyHandler(_SpyRouter(), {}, deadline_s=0.01)
        first = h.handle_chunk(b'{"model"', False)
        time.sleep(0.03)
        return first, h.handle_chunk(b': "auto"', False)

    first, (action, (status, _)) = _both(run)
    assert first[0] == "continue" and action == "error" and status == 408


def test_invalid_json_400():
    def run(m):
        return m.StreamedBodyHandler(_SpyRouter(), {}).handle_chunk(
            b"{nope", True)

    action, (status, _) = _both(run)
    assert action == "error" and status == 400


# ---------------------------------------------------------------------------
# the overlap through the port's filter (JAX tests/test_streamed_body.py
# TestExtProcStreamedE2E)

def test_first_chunk_routing_before_eos_on_large_body(fixture_config_path):
    from semantic_router_tpu_torch.config import load_config
    from semantic_router_tpu_torch.extproc import ExtProcService
    from semantic_router_tpu_torch.extproc import external_processor_pb2 \
        as pb
    from semantic_router_tpu_torch.router import Router

    router = Router(load_config(fixture_config_path), engine=None)
    orig = router.dispatcher.evaluators["keyword"]
    calls = []

    class SlowKeyword:
        signal_type = "keyword"

        def evaluate(self, ctx):
            calls.append(time.perf_counter())
            time.sleep(0.6)
            return orig.evaluate(ctx)

    router.dispatcher.evaluators["keyword"] = SlowKeyword()
    svc = ExtProcService(router)
    big = {"model": "auto", "messages": [
        {"role": "user", "content": "urgent asap: " + "ctx " * 2000}],
        # a large signal-inert trailing field: the prefetch view stays
        # valid while it arrives
        "metadata": {"trace": "d" * 30000}}
    raw = json.dumps(big).encode()
    cut = raw.index(b'"metadata"')
    body_done = []

    def msgs():
        yield pb.ProcessingRequest(
            request_headers=pb.HttpHeaders(end_of_stream=False))
        # chunk 1: model + the whole messages array (the classify text)
        yield pb.ProcessingRequest(request_body=pb.HttpBody(
            body=raw[:cut], end_of_stream=False))
        step = max(1, (len(raw) - cut) // 7)
        for i in range(cut, len(raw), step):
            time.sleep(0.1)
            yield pb.ProcessingRequest(request_body=pb.HttpBody(
                body=raw[i:i + step], end_of_stream=i + step >= len(raw)))
        body_done.append(time.perf_counter())

    try:
        t0 = time.perf_counter()
        resps = list(svc.Process(msgs(), None))
        total = time.perf_counter() - t0
    finally:
        svc.close()
        router.shutdown()
    final = resps[-1]
    assert final.WhichOneof("response") == "request_body"
    assert json.loads(final.request_body.response.body_mutation.body)[
        "model"] == "qwen3-8b"
    assert len(calls) == 1, f"classify ran {len(calls)}x"
    assert calls[0] < body_done[0], "classify started after the body"
    tail = total - (body_done[0] - t0)
    assert tail < 0.5, f"EOS tail {tail:.2f}s: classify did not overlap"
