"""OTLP export in the port against the JAX package, on the CPU: span and
log payloads equal the reference's for the same spans and decision
records; the failure cases of ``tests/test_otlp_failures.py`` against a
loopback collector (a retry inside one flush, a batch dropped after two
refusals, an unreachable collector, the flusher woken at ``max_batch``,
the bounded buffer dropping its oldest, a raising sink never reaching
the request); both ``build_*_from_config``; and a port server with
``observability.tracing.otlp_endpoint`` whose ``stop()`` detaches and
flushes: the collector holds every finished span of the requests' traces
once and every decision record.  Every collector and flusher thread is
joined; waits are bounded events, never sleeps."""

import copy
import http.client
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import yaml

from semantic_router_tpu.observability import otlp as jotlp
from semantic_router_tpu.observability import tracing as jtracing
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.observability import otlp as totlp
from semantic_router_tpu_torch.observability import tracing as ttracing
from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    attach_otlp, build_router

WAIT_S = 20.0


class Collector:
    """A loopback OTLP/HTTP collector whose first ``fail_first`` posts
    answer 500; ``wait_for(n)`` blocks (bounded) until ``n`` spans
    arrived."""

    def __init__(self, fail_first: int = 0):
        self.fail_remaining = fail_first
        self.posts = []            # (path, payload)
        self._cond = threading.Condition()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("content-length", 0)))
                with outer._cond:
                    if outer.fail_remaining > 0:
                        outer.fail_remaining -= 1
                        fail = True
                    else:
                        fail = False
                        outer.posts.append((self.path, json.loads(body)))
                        outer._cond.notify_all()
                self.send_response(500 if fail else 200)
                self.send_header("content-length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def spans(self):
        with self._cond:
            return [s for path, p in self.posts if path == "/v1/traces"
                    for rs in p["resourceSpans"]
                    for ss in rs["scopeSpans"] for s in ss["spans"]]

    def logs(self):
        with self._cond:
            return [r for path, p in self.posts if path == "/v1/logs"
                    for rl in p["resourceLogs"]
                    for sl in rl["scopeLogs"] for r in sl["logRecords"]]

    def wait_for(self, n):
        """True once ``n`` spans arrived, False after ``WAIT_S``."""
        with self._cond:
            return self._cond.wait_for(lambda: len(self.spans()) >= n,
                                       WAIT_S)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(WAIT_S)


@pytest.fixture
def collector():
    made = []

    def make(**kw):
        c = Collector(**kw)
        made.append(c)
        return c

    yield make
    for c in made:
        c.close()


def _span_pair(name="s", links=(), **attrs):
    """The same finished span in both packages."""
    out = []
    for mod in (jtracing, ttracing):
        s = mod.Span(name, "a" * 32, "b" * 16, "c" * 16 if attrs else "",
                     start_t=1700000000.25, attributes=dict(attrs))
        for t, sp in links:
            s.add_link(t, sp)
        s.end_t = 1700000001.5
        out.append(s)
    return out


def _dead_span(name="s"):
    s = ttracing.Span(name, "a" * 32, "b" * 16)
    s.end()
    return s


@pytest.mark.parametrize("attrs", [
    {}, {"flag": True, "n": 3, "x": 0.5, "s": "text", "obj": [1, 2]}])
@pytest.mark.parametrize("links", [(), (("d" * 32, "e" * 16),)])
def test_span_payloads_equal_the_reference(attrs, links):
    j, t = _span_pair(links=links, **attrs)
    assert totlp.span_to_otlp(t) == jotlp.span_to_otlp(j)
    assert totlp.build_payload([t, t], "svc") \
        == jotlp.build_payload([j, j], "svc")
    assert totlp.build_payload([t]) == jotlp.build_payload([j])


def _decision_records(path):
    """Decision records of a few routed requests (the fixture config's
    heuristic families, no engine)."""
    from semantic_router_tpu_torch.observability.explain import \
        DecisionExplainer

    reg = RuntimeRegistry.isolated(explain=DecisionExplainer())
    router = build_router(load_config(path), None, registry=reg)
    try:
        for q in ("URGENT: help asap", "please debug this function",
                  "password reset"):
            router.route({"model": "auto", "messages": [
                {"role": "user", "content": q}]})
        return [reg.explain.get(r["record_id"])
                for r in reg.explain.list(limit=10)]
    finally:
        router.shutdown()


def test_log_payloads_equal_the_reference(fixture_config_path):
    recs = _decision_records(fixture_config_path)
    assert len(recs) == 3
    for rec in recs:
        assert totlp.record_to_otlp_log(rec) == jotlp.record_to_otlp_log(rec)
    assert totlp.build_log_payload(recs, "svc") \
        == jotlp.build_log_payload(recs, "svc")


# -- the failure cases -----------------------------------------------------


def test_one_failure_then_success_retries_within_flush(collector):
    c = collector(fail_first=1)
    exp = totlp.OTLPExporter(c.url, flush_interval_s=60.0, timeout_s=5.0)
    exp(_dead_span())
    assert exp.flush() == 1
    assert exp.exported == 1 and exp.dropped == 0
    assert len(c.spans()) == 1


def test_drop_after_bounded_retries(collector):
    c = collector(fail_first=99)
    exp = totlp.OTLPExporter(c.url, flush_interval_s=60.0, timeout_s=5.0)
    exp(_dead_span())
    exp(_dead_span())
    assert exp.flush() == 0
    assert exp.dropped == 2 and exp.exported == 0
    assert exp.flush() == 0 and exp.dropped == 2


def test_unreachable_endpoint_drops_without_raising():
    exp = totlp.OTLPExporter("http://127.0.0.1:9", flush_interval_s=60.0,
                             timeout_s=0.5)
    exp(_dead_span())
    assert exp.flush() == 0
    assert exp.dropped == 1


def test_pressure_wakes_the_flusher(collector):
    c = collector()
    # an interval far past the test: only the pressure wake explains a
    # prompt export
    exp = totlp.OTLPExporter(c.url, flush_interval_s=3600.0, max_batch=4,
                             timeout_s=5.0)
    tracer = ttracing.Tracer()
    exp.attach(tracer)
    try:
        for _ in range(4):
            with tracer.span("x"):
                pass
        assert c.wait_for(4), "max_batch pressure did not flush"
    finally:
        exp.detach(tracer)
    assert not exp._thread.is_alive()
    assert exp.exported == 4


def test_buffer_overflow_drops_oldest_boundedly():
    exp = totlp.OTLPExporter("http://127.0.0.1:9", flush_interval_s=3600.0,
                             max_batch=10**6, max_buffer=8)
    for i in range(12):
        exp(_dead_span(f"s{i}"))
    assert exp.dropped == 4
    with exp._lock:
        names = [s.name for s in exp._buffer]
    assert len(names) == 8 and names[0] == "s4"


def test_raising_sink_never_reaches_the_request():
    tracer = ttracing.Tracer()

    def bad_sink(span):
        raise RuntimeError("collector exploded")

    tracer.add_sink(bad_sink)
    try:
        with tracer.span("request"):
            pass
        tracer.record(_dead_span("external"))
        assert tracer.spans("request") and tracer.spans("external")
    finally:
        tracer.remove_sink(bad_sink)


def test_detach_flushes_the_backlog(collector):
    c = collector()
    exp = totlp.OTLPExporter(c.url, flush_interval_s=3600.0, max_batch=3)
    tracer = ttracing.Tracer()
    exp.attach(tracer)
    for _ in range(7):
        with tracer.span("y"):
            pass
    exp.detach(tracer)
    assert not exp._thread.is_alive()
    assert len(c.spans()) == 7 and exp.exported == 7
    with tracer.span("after"):
        pass
    assert len(c.spans()) == 7


@pytest.mark.parametrize("block", [
    {}, {"otlp_endpoint": ""},
    {"otlp_endpoint": "COLLECTOR", "service_name": "edge",
     "flush_interval_s": 7, "otlp_headers": {"x-k": "v"}}])
def test_build_from_config_like_the_reference(block, collector):
    c = collector()
    block = {k: (c.url if v == "COLLECTOR" else v) for k, v in block.items()}
    from semantic_router_tpu_torch.observability.explain import \
        DecisionExplainer

    tracer, explainer = ttracing.Tracer(), DecisionExplainer()
    got = [totlp.build_exporter_from_config(block, tracer),
           totlp.build_log_exporter_from_config(block, explainer),
           totlp.build_log_exporter_from_config(block, None)]
    jgot = [jotlp.build_exporter_from_config(
                dict(block, otlp_endpoint=""), jtracing.Tracer())]
    assert jgot[0] is None
    if not block.get("otlp_endpoint"):
        assert got == [None, None, None]
        return
    span_exp, log_exp, none = got
    try:
        assert none is None
        assert (span_exp.endpoint, span_exp.service_name,
                span_exp.flush_interval_s, span_exp.headers,
                span_exp.max_batch) == (c.url, "edge", 7.0, {"x-k": "v"},
                                        256)
        assert (log_exp.service_name, log_exp.max_batch,
                log_exp.max_buffer) == ("edge", 64, 1024)
        assert span_exp in tracer._sinks and log_exp in explainer.sinks
    finally:
        span_exp.detach(tracer)
        log_exp.detach(explainer)
    assert span_exp not in tracer._sinks and log_exp not in explainer.sinks


def _post(url, body):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_server_exports_spans_and_records_and_flushes_at_stop(
        collector, fixture_config_path):
    """A served config with ``otlp_endpoint``: after ``stop()`` the
    collector holds the tracer's finished spans of the requests' traces,
    none lost and none twice, and each decision record."""
    from semantic_router_tpu_torch.observability.explain import \
        DecisionExplainer

    c = collector()
    d = {"observability": {"tracing": {"otlp_endpoint": c.url,
                                       "flush_interval_s": 3600}}}
    with open(fixture_config_path) as f:
        d.update(yaml.safe_load(f))
    cfg = load_config(copy.deepcopy(d))
    reg = RuntimeRegistry.isolated(explain=DecisionExplainer())
    router = build_router(cfg, None, registry=reg)
    backend = MockVLLMServer().start()
    server = RouterServer(router, backend.url, registry=reg)
    attach_otlp(server, cfg)
    server.start()
    try:
        for q in ("URGENT: help asap", "please debug this function",
                  "password reset", "tell me a story"):
            status, _ = _post(server.url, {"model": "auto", "messages": [
                {"role": "user", "content": q}]})
            assert status == 200
    finally:
        server.stop()
        backend.stop()
        router.shutdown()
    assert not server.otlp_exporter._thread.is_alive()
    assert not server.otlp_log_exporter._thread.is_alive()
    spans = c.spans()
    ids = [s["spanId"] for s in spans]
    assert len(ids) == len(set(ids))
    want = {s.span_id for s in reg.tracer.spans()}
    assert set(ids) == want and len(want) >= 4
    logs = c.logs()
    rec_ids = {a["value"]["stringValue"] for r in logs
               for a in r["attributes"] if a["key"] == "record_id"}
    assert rec_ids == {r["record_id"] for r in reg.explain.list(limit=100)}
    assert len(logs) == reg.explain.recorded + reg.explain.re_exported
