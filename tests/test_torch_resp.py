"""The port's RESP family (state/resp.py, state/rediscluster.py) against
the JAX package's, over real sockets: each client against the other
package's ``MiniRedis`` on the cases of
``tests/test_state_backends.py::TestRespProtocol``; ``encode_command``
bytes equal on seeded arguments of every kind; the cluster spec's CRC16
vector; ``hash_slot`` equal on random keys with and without ``{tags}``;
MOVED / ASK redirection against either package's ``MiniRedisClusterNode``;
and the server's TTL, WRONGTYPE and SCAN replies byte for byte."""

import socket
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from semantic_router_tpu.state import rediscluster as jcl
from semantic_router_tpu.state import resp as jresp
from semantic_router_tpu_torch.state import rediscluster as tcl
from semantic_router_tpu_torch.state import resp as tresp

PAIRS = {"port-client/jax-server": (tresp, jresp),
         "jax-client/port-server": (jresp, tresp),
         "port-client/port-server": (tresp, tresp)}


@pytest.fixture(scope="module")
def servers():
    srv = {"jax": jresp.MiniRedis().start(), "port": tresp.MiniRedis().start()}
    yield srv
    for s in srv.values():
        s.stop()


@pytest.fixture(params=sorted(PAIRS))
def client(request, servers):
    client_mod, server_mod = PAIRS[request.param]
    srv = servers["jax" if server_mod is jresp else "port"]
    c = client_mod.RedisClient(port=srv.port)
    c.flushdb()
    c.errors = client_mod.RespError
    yield c
    c.close()


class TestWire:
    def test_strings_ttl_and_counters(self, client):
        assert client.ping()
        assert client.set("k", "v")
        assert client.get("k") == b"v"
        assert client.set("tmp", "x", ex=50)
        assert 0 < client.ttl("tmp") <= 50
        assert client.ttl("k") == -1
        assert client.ttl("missing") == -2
        assert client.incr("n") == 1
        assert client.incr("n", 5) == 6
        assert client.delete("k", "n") == 2
        assert client.get("k") is None

    def test_expiry_enforced(self, client):
        client.execute("SET", "gone", "x", "PX", 30)
        assert client.get("gone") == b"x"
        deadline = time.time() + 5.0
        while client.get("gone") is not None and time.time() < deadline:
            time.sleep(0.02)
        assert client.get("gone") is None
        assert not client.exists("gone")

    def test_hashes_and_binary_values(self, client):
        blob = bytes(range(256))
        client.hset("h", {"a": "1", "emb": blob})
        assert client.hget("h", "a") == b"1"
        assert client.hgetall("h")[b"emb"] == blob
        assert client.execute("HDEL", "h", "a") == 1
        assert client.hget("h", "a") is None

    def test_scan_and_keys_patterns(self, client):
        for i in range(5):
            client.set(f"pfx:{i}", "v")
        client.set("other", "v")
        assert sorted(client.scan_iter("pfx:*")) == \
            [f"pfx:{i}".encode() for i in range(5)]
        assert client.keys("other") == [b"other"]

    def test_pipeline(self, client):
        out = client.pipeline([("SET", "p1", "a"), ("SET", "p2", "b"),
                               ("GET", "p1"), ("GET", "p2")])
        assert out == ["OK", "OK", b"a", b"b"]

    def test_wrongtype_error(self, client):
        client.hset("h2", {"f": "v"})
        with pytest.raises(client.errors, match="WRONGTYPE"):
            client.get("h2")

    def test_reconnect_after_server_side_close(self, client):
        assert client.ping()
        client.execute("QUIT")
        assert client.ping()  # the next command reconnects (retries=1)


_ARG = st.one_of(st.binary(max_size=40), st.text(max_size=40),
                 st.integers(-2**40, 2**40),
                 st.floats(allow_nan=False, allow_infinity=False))


@settings(max_examples=200, deadline=None)
@given(st.lists(_ARG, min_size=1, max_size=8))
def test_encode_command_bytes_equal(args):
    assert tresp.encode_command(*args) == jresp.encode_command(*args)


def test_crc16_known_vector():
    assert tcl.crc16(b"123456789") == jcl.crc16(b"123456789") == 0x31C3


def test_hash_slot_equal_on_random_keys():
    rng = np.random.default_rng(17)
    alphabet = list("abcxyz019:{}_-.")
    keys = ["".join(rng.choice(alphabet, int(rng.integers(1, 24))))
            for _ in range(2000)]
    keys += ["{user1}.following", "{user1}.followers", "foo{}bar",
             "{}", "{a}{b}", "x{tag}y{other}", "no-tag-at-all"]
    assert [tcl.hash_slot(k) for k in keys] == \
        [jcl.hash_slot(k) for k in keys]
    assert tcl.hash_slot("{user1}.following") == \
        tcl.hash_slot("{user1}.followers")


def _cluster(mod):
    half = 16384 // 2
    a = mod.MiniRedisClusterNode((0, half - 1)).start()
    b = mod.MiniRedisClusterNode((half, 16383)).start()
    for slot in range(16384):
        owner, other = (a, b) if slot < half else (b, a)
        other.peers[slot] = f"127.0.0.1:{owner.port}"
    return a, b


@pytest.mark.parametrize("client_mod,server_mod",
                         [(tcl, jcl), (jcl, tcl), (tcl, tcl)],
                         ids=["port-client/jax-nodes",
                              "jax-client/port-nodes",
                              "port-client/port-nodes"])
def test_moved_and_ask_redirection(client_mod, server_mod):
    a, b = _cluster(server_mod)
    cli = client_mod.RedisClusterClient([("127.0.0.1", a.port)])
    try:
        wrote = {f"k{i}": f"v{i}".encode() for i in range(24)}
        for key, val in wrote.items():
            assert cli.set(key, val)
        for key, want in wrote.items():
            assert cli.get(key) == want
        assert a._data and b._data  # routing really split
        b_key = next(k for k in wrote if tcl.hash_slot(k) >= 16384 // 2)
        assert cli._slot_owner[tcl.hash_slot(b_key)][1] == b.port
        # ASK mid-migration: one-shot, the slot map is not updated
        key = next(f"mig{i}" for i in range(999)
                   if tcl.hash_slot(f"mig{i}") < 16384 // 2)
        slot = tcl.hash_slot(key)
        a.migrating[slot] = f"127.0.0.1:{b.port}"
        b.slot_range = (0, 16383)
        assert cli.set(key, "during-migration")
        assert any(k.decode() == key for k in b._data)
        assert cli._slot_owner.get(slot, ("", a.port))[1] == a.port
    finally:
        cli.close()
        a.stop()
        b.stop()


def _replay(port: int, payload: bytes) -> bytes:
    """The server's reply bytes to ``payload``, whose last command is a
    PING: read until its ``+PONG``."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(payload)
        buf = b""
        deadline = time.time() + 5
        while not buf.endswith(b"+PONG\r\n") and time.time() < deadline:
            buf += s.recv(65536)
        return buf


SERVER_SCRIPT = [
    ("FLUSHDB",), ("SET", "a", "1"), ("HSET", "h", "f", "v", "g", "w"),
    ("GET", "h"), ("INCRBY", "h", "2"), ("SET", "n", "x"),
    ("INCRBY", "n", "1"), ("TTL", "a"), ("EXPIRE", "a", "100"),
    ("TYPE", "h"), ("TYPE", "a"), ("TYPE", "nope"), ("EXISTS", "a", "h",
                                                     "z"),
    ("SCAN", "0", "MATCH", "*", "COUNT", "10"), ("KEYS", "[ah]"),
    ("HGETALL", "h"), ("HDEL", "h", "f", "zz"), ("DBSIZE",),
    ("DEL", "a", "h", "z"), ("NOSUCH", "x"), ("PING",),
]


def test_server_replies_byte_equal(servers):
    payload = b"".join(jresp.encode_command(*c) for c in SERVER_SCRIPT)
    got = {name: _replay(srv.port, payload)
           for name, srv in servers.items()}
    assert got["port"] == got["jax"]
    assert b"WRONGTYPE" in got["port"]
    assert got["port"].endswith(b"+PONG\r\n")
