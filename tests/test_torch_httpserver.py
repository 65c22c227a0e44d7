"""The port's pooled front end (router/httpserver.py, and the router's
handler over it) under the reference's tests/test_httpserver.py cases:
idle keep-alive connections parked without pinning a worker, sequential
reuse, an early answer that drains the unread body, a chunked POST
routed like its content-length twin on a connection that stays usable,
pipelined requests; and what the chat surface adds: an SSE answer closes
its connection and gives its worker back, ``api_server.http_workers``
sizes the pool, a malformed chunk size closes the connection."""

import http.client
import json
import socket
import time

import pytest

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer


def _chat(conn, text="hello", stream=False):
    body = json.dumps({"model": "m", "stream": stream, "messages": [
        {"role": "user", "content": text}]}).encode()
    conn.request("POST", "/v1/chat/completions", body=body,
                 headers={"content-type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def test_idle_connections_do_not_pin_workers():
    """Far more idle keep-alive connections than pool workers; a fresh
    request is still served promptly."""
    backend = MockVLLMServer().start()
    backend.httpd._executor._max_workers = 4
    idle = []
    try:
        for _ in range(32):
            c = http.client.HTTPConnection("127.0.0.1", backend.port,
                                           timeout=10)
            assert _chat(c)[0] == 200
            idle.append(c)
        time.sleep(0.3)
        fresh = http.client.HTTPConnection("127.0.0.1", backend.port,
                                           timeout=5)
        t0 = time.perf_counter()
        status, _ = _chat(fresh)
        dt = time.perf_counter() - t0
        assert status == 200
        assert dt < 2.0, f"fresh request starved: {dt:.2f}s"
        fresh.close()
        assert _chat(idle[0])[0] == 200
    finally:
        for c in idle:
            c.close()
        backend.stop()


def test_sequential_requests_reuse_connection():
    backend = MockVLLMServer().start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", backend.port,
                                          timeout=10)
        for i in range(5):
            status, data = _chat(conn, f"msg {i}")
            assert status == 200 and b"msg" in data
        conn.close()
    finally:
        backend.stop()


def test_two_pipelined_requests_both_answered():
    backend = MockVLLMServer().start()
    try:
        s = socket.create_connection(("127.0.0.1", backend.port),
                                     timeout=10)
        req = b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n"
        s.sendall(req + req)
        data = b""
        deadline = time.time() + 5
        while data.count(b'"status": "ok"') < 2 and time.time() < deadline:
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                break
            if not chunk:
                break
            data += chunk
        assert data.count(b"200 OK") == 2, data[:400]
        s.close()
    finally:
        backend.stop()


@pytest.fixture
def served(fixture_config_path):
    backend = MockVLLMServer().start()
    cfg = load_config(fixture_config_path)
    cfg.api_server = {"http_workers": 2}
    router = Router(cfg)
    server = RouterServer(router, backend.url).start()
    yield server, backend
    server.stop()
    backend.stop()
    router.shutdown()


def test_http_workers_sizes_the_pool(served):
    server, _ = served
    assert server.httpd._executor._max_workers == 2


def test_early_answer_drains_the_body(served):
    """A GET answered without reading its body must not leave the body
    to be parsed as the connection's next request line."""
    server, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    conn.request("GET", "/no/such/route",
                 body=json.dumps({"padding": "x" * 4096}).encode(),
                 headers={"content-type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()
    conn.request("GET", "/health")
    resp = conn.getresponse()
    assert resp.status == 200
    assert json.loads(resp.read())["status"] == "healthy"
    conn.close()


def _post_chunked(conn, body: bytes, pieces=3):
    step = max(1, len(body) // pieces)
    conn.request("POST", "/v1/chat/completions",
                 body=iter([body[i:i + step]
                            for i in range(0, len(body), step)]),
                 headers={"content-type": "application/json"})
    resp = conn.getresponse()
    return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
        resp.read()


def test_chunked_post_routes_like_its_twin_and_keeps_connection(served):
    server, _ = served
    body = json.dumps({"model": "auto", "messages": [
        {"role": "user", "content": "urgent asap please"}]}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    status, headers, _ = _post_chunked(conn, body)
    assert status == 200
    assert headers["x-vsr-selected-decision"] == "urgent_route"
    # the connection is still in step: a content-length twin on it
    conn.request("POST", "/v1/chat/completions", body=body,
                 headers={"content-type": "application/json"})
    r2 = conn.getresponse()
    r2.read()
    assert r2.status == 200
    assert r2.getheader("x-vsr-selected-decision") == "urgent_route"
    conn.close()


def test_malformed_chunk_size_closes_the_connection(served):
    server, _ = served
    s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
              b"Transfer-Encoding: chunked\r\n\r\nzz\r\n{}\r\n0\r\n\r\n")
    data = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break  # the server closed it
        data += chunk
    s.close()
    assert data.startswith(b"HTTP/1.1 ")


def test_stream_closes_its_connection_and_frees_its_worker(served):
    """Two pool workers; four streams in a row, then a kept-alive chat:
    every stream closes its connection and returns its worker."""
    server, _ = served
    for _ in range(4):
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        status, data = _chat(conn, "urgent asap please", stream=True)
        assert status == 200 and data.endswith(b"data: [DONE]\n\n")
        assert conn.sock is None  # the server said connection: close
        conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=5)
    for _ in range(2):
        assert _chat(conn, "urgent asap please")[0] == 200
    conn.close()


def test_chunked_body_over_the_cap_closes_the_connection(served,
                                                         monkeypatch):
    """A chunked body past the cap (64 MiB; 16 bytes here) is not read
    on: the request is answered 400 without reaching the backend, and
    its connection closed."""
    from semantic_router_tpu_torch.router import server as srv_mod

    server, backend = served
    monkeypatch.setattr(srv_mod._Handler, "_MAX_CHUNKED", 16)
    hits = backend.hits
    s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
              b"Transfer-Encoding: chunked\r\n\r\n"
              + b"".join(b"9\r\n" + piece + b"\r\n" for piece in (
                  b'{"model":', b' "auto", ', b'"x": 123}'))
              + b"0\r\n\r\n")
    data = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break  # the server closed it
        data += chunk
    s.close()
    assert data.startswith(b"HTTP/1.1 400 ")
    assert backend.hits == hits
