"""The port's Postgres v3 wire client, ``MiniPostgres`` and store registry
against the JAX package's, on the CPU: each client against the other
package's server (simple and extended query, NULLs, reused placeholders,
multi-statement strings, error-until-Sync recovery, trust / cleartext /
md5 auth) with the JAX client's results; the port's client replaying
the golden wire transcripts of ``tests/test_postgres.py``; the SQL
helpers equal to JAX's; a registry written by a JAX manager attached by
a port manager (and back) with the same stores and search hits; and the
bootstrap's ``vectorstore.registry.backend: postgres`` branch, attaching
at start and failing open."""

import pytest

import test_postgres as jtp
from semantic_router_tpu.state import postgres as jpg
from semantic_router_tpu.vectorstore import pg_registry as jreg
from semantic_router_tpu.vectorstore import store as jvs
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.observability import logging as tlog
from semantic_router_tpu_torch.runtime import bootstrap as tboot
from semantic_router_tpu_torch.runtime.bootstrap import build_router
from semantic_router_tpu_torch.state import postgres as tpg
from semantic_router_tpu_torch.stateplane.harness import hash_embed
from semantic_router_tpu_torch.vectorstore import pg_registry as treg
from semantic_router_tpu_torch.vectorstore import store as tvs

PKG = {"jax": jpg, "port": tpg}
EMBED = hash_embed(48)


@pytest.fixture
def servers():
    made = {}

    def make(pkg, **kw):
        srv = PKG[pkg].MiniPostgres(**kw)
        made.setdefault(pkg, []).append(srv)
        return srv

    yield make
    for srvs in made.values():
        for srv in srvs:
            srv.close()


def _session(client_mod, port, **kw):
    """One scripted session; every result as plain data."""
    c = client_mod.PostgresClient(port=port, **kw)
    out = []
    try:
        out.append(c.query("CREATE TABLE t (id INTEGER, v TEXT, w TEXT)"))
        for i, (v, w) in enumerate([("a", None), ("b;c", "x'y"),
                                    (None, "z")]):
            out.append(c.execute("INSERT INTO t (id, v, w) "
                                 "VALUES ($1, $2, $3)", (i, v, w)))
        out.append(c.execute("SELECT id, v, w FROM t ORDER BY id"))
        out.append(c.execute("SELECT id FROM t WHERE v = $1 OR w = $1",
                             ("z",)))
        out.append(c.query("INSERT INTO t (id, v) VALUES (7, 'q;r'); "
                           "SELECT COUNT(*) AS n FROM t"))
        out.append(c.execute("SELECT id FROM t ORDER BY id OFFSET $1",
                             (1,)))
        out.append(c.execute("UPDATE t SET w = $1 WHERE id >= $2",
                             ("u", 1)))
        out.append(c.execute("DELETE FROM t WHERE id = $1", (7,)))
        for bad in ("SELECT * FROM missing", "SELEC 1"):
            for run in (c.query, c.execute):
                try:
                    run(bad)
                    out.append("no error")
                except client_mod.PostgresError as e:
                    out.append(("error", e.severity, e.code))
        # the session survives every error
        out.append(c.execute("SELECT COUNT(*) FROM t"))
        out.append(c.ping())
        out.append(sorted(k for k in c.server_params))
    finally:
        c.close()
    return [(r.columns, r.rows, r.command_tag)
            if isinstance(r, (jpg.PGResult, tpg.PGResult)) else r
            for r in out]


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_each_client_against_the_other_server(servers, client, server):
    want = _session(jpg, servers("jax").port)
    got = _session(PKG[client], servers(server).port)
    assert got == want
    assert want[4][1] == [["0", "a", None], ["1", "b;c", "x'y"],
                          ["2", None, "z"]]
    assert want[-2] is True


@pytest.mark.parametrize("auth", ["cleartext", "md5"])
@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_password_auth_across_packages(servers, client, server, auth):
    srv = servers(server, auth=auth, password="s3cret")
    c = PKG[client].PostgresClient(port=srv.port, password="s3cret")
    assert c.query("SELECT 1").scalar() == "1"
    c.close()
    bad = PKG[client].PostgresClient(port=srv.port, password="wrong")
    with pytest.raises(PKG[client].PostgresError) as err:
        bad.query("SELECT 1")
    assert err.value.code == "28P01"


@pytest.mark.parametrize("case", [
    "test_startup_packet_format", "test_simple_query_response_parse",
    "test_extended_query_message_sequence",
    "test_error_response_fields_parse"])
def test_port_client_replays_the_golden_transcripts(case, monkeypatch):
    """The reference's transcripts, authored from the protocol docs with
    no MiniPostgres in the loop, replayed against the port's client."""
    monkeypatch.setattr(jtp, "PostgresClient", tpg.PostgresClient)
    monkeypatch.setattr(jtp, "PostgresError", tpg.PostgresError)
    getattr(jtp.TestWireConformance(), case)()


SQL = [
    "SELECT 1; SELECT 2",
    "INSERT INTO t VALUES ('a;b'); SELECT ';'",
    "SELECT $$x;y$$; SELECT $tag$ ; $tag$",
    "SELECT 1 /* a; /* nested; */ b */; SELECT 2 -- c; d\n; SELECT 3",
    'SELECT "we;ird" FROM t; ',
    "SELECT * FROM t WHERE a = $1 AND b = $2 OR c = $1",
    "SELECT * FROM t WHERE s = '$1' OFFSET 5",
    "SELECT * FROM t LIMIT 2 OFFSET 1",
    "SELECT 'it''s; fine' OFFSET $1",
]


@pytest.mark.parametrize("sql", SQL)
def test_sql_helpers_equal_jax(sql):
    assert tpg._split_statements(sql) == jpg._split_statements(sql)
    assert tpg._translate_placeholders(sql) == \
        jpg._translate_placeholders(sql)


def _registry(mod, port):
    return mod.PostgresMetadataRegistry(
        client=PKG["jax" if mod is jreg else "port"].PostgresClient(
            port=port))


CORPUS = [("pasta", "Boil the pasta in salted water. Drain it well."),
          ("tea", "Steep the tea for three minutes. Add milk after."),
          ("bike", "Oil the chain monthly. Check the tyre pressure.")]


def _hits(store, q):
    return [(h.chunk.text, round(h.score, 6), h.chunk.metadata)
            for h in store.search(q, top_k=2)]


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_registry_written_by_one_package_is_attached_by_the_other(
        tmp_path, servers, writer, reader):
    vs = {"jax": jvs, "port": tvs}
    reg = {"jax": jreg, "port": treg}
    db, base = str(tmp_path / "reg.db"), str(tmp_path / "stores")
    srv = servers(writer, path=db)
    r1 = _registry(reg[writer], srv.port)
    mgr = vs[writer].VectorStoreManager(EMBED, backend="sqlite",
                                        base_path=base, registry=r1)
    for name in ("kb", "docs"):
        store = mgr.create(name)
        for title, text in CORPUS:
            mgr.record_file(name, store.ingest(title, text,
                                               metadata={"source": title}))
    want = {n: [_hits(mgr.get(n), q) for q in ("boil pasta", "chain oil")]
            for n in ("kb", "docs")}
    files = r1.list_files("kb")
    r1.close()
    srv.close()
    # restart: the other package's server on the same file, its manager
    srv2 = servers(reader, path=db)
    r2 = _registry(reg[reader], srv2.port)
    mgr2 = vs[reader].VectorStoreManager(EMBED, backend="sqlite",
                                         base_path=base, registry=r2)
    assert mgr2.load_from_registry() == ["docs", "kb"]
    assert mgr2.list() == ["docs", "kb"]
    got = {n: [_hits(mgr2.get(n), q) for q in ("boil pasta", "chain oil")]
           for n in ("kb", "docs")}
    assert got == want
    assert [(f["name"], f["chunks"], f["metadata"])
            for f in r2.list_files("kb")] == \
        [(f["name"], f["chunks"], f["metadata"]) for f in files]
    assert [f["name"] for f in files] == [t for t, _ in CORPUS]
    # a delete unregisters the store and its files
    assert mgr2.delete("docs")
    assert r2.list_stores() == ["kb"] and r2.list_files("docs") == []
    r2.close()


def test_registry_statements_equal_jax(servers):
    """The same calls on each package's registry leave the same rows."""
    rows = {}
    for pkg, mod in (("jax", jreg), ("port", treg)):
        srv = servers(pkg)
        r = _registry(mod, srv.port)
        r.register_store("kb", backend="memory", config={"x": 1})
        r.register_store("docs", backend="sqlite")
        r.register_store("kb", backend="memory")  # an upsert
        r.register_file("kb", "f1", name="a.txt", chunks=3,
                        metadata={"source": "a"})
        r.register_file("kb", "f2", name="b.txt", chunks=1)
        r.register_file("kb", "f1", name="a.txt", chunks=4)
        c = r.client
        rows[pkg] = (r.list_stores(), r.list_files("kb"),
                     c.execute("SELECT name, backend, config FROM "
                               "vector_store_registry ORDER BY name").rows)
        r.unregister_store("kb")
        rows[pkg] += (r.list_stores(), r.list_files("kb"))
        r.close()
    assert rows["port"] == rows["jax"]
    assert rows["jax"][1][0]["chunks"] == 4


def test_bootstrap_attaches_the_registry_and_fails_open(tmp_path, servers,
                                                        monkeypatch):
    events = []

    def note(component, event, level="info", **fields):
        events.append(event)

    monkeypatch.setattr(tboot, "component_event", note)
    monkeypatch.setattr(tlog, "component_event", note)
    db = str(tmp_path / "reg.db")
    srv = servers("jax", path=db)
    r = _registry(jreg, srv.port)
    r.register_store("kb", backend="memory")
    r.close()
    cfg = load_config({"default_model": "m", "vectorstore": {
        "enabled": True, "backend": "memory",
        "registry": {"backend": "postgres", "port": srv.port}}})
    router = build_router(cfg)
    try:
        mgr = router.vectorstores
        assert isinstance(mgr.registry, treg.PostgresMetadataRegistry)
        # load_from_registry ran at start: the memory backend re-attaches
        # the names, stamped
        assert mgr.list() == ["kb"]
        assert "vectorstore_registry_attach" in events
        assert "registry_reattach_names_only" in events
        store = mgr.get_or_create("fresh")
        mgr.record_file("fresh", store.ingest("n", "note text"))
        assert mgr.registry.list_stores() == ["fresh", "kb"]
        assert [f["name"] for f in mgr.registry.list_files("fresh")] == ["n"]
    finally:
        router.shutdown()
    # an unreachable registry: no registry, stamped, the stores serve
    srv.close()
    cfg = load_config({"default_model": "m", "vectorstore": {
        "registry": {"backend": "postgres", "port": srv.port}}})
    router = build_router(cfg)
    try:
        assert router.vectorstores.registry is None
        assert "vectorstore_registry_failed" in events
        assert router.vectorstores.get_or_create("kb") is not None
    finally:
        router.shutdown()


def _http(url, method, path, body=None):
    import http.client
    import json
    import urllib.parse

    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_the_files_route_records_each_ingest_in_the_registry(servers):
    """``POST /v1/vector_stores/{id}/files`` registers the store and the
    document in the Postgres registry, as the reference's server does."""
    from semantic_router_tpu_torch.router import MockVLLMServer, \
        RouterServer
    from semantic_router_tpu_torch.runtime import RuntimeRegistry

    srv = servers("port")
    cfg = load_config({"default_model": "m", "vectorstore": {
        "registry": {"backend": "postgres", "port": srv.port}}})
    reg = RuntimeRegistry.isolated(runtimestats=None)
    router = build_router(cfg, registry=reg)
    backend = MockVLLMServer().start()
    server = RouterServer(router, backend.url, registry=reg).start()
    try:
        assert _http(server.url, "POST", "/v1/vector_stores",
                     {"name": "docs"})[0] == 200
        for title, text in CORPUS:
            status, body = _http(server.url, "POST",
                                 "/v1/vector_stores/docs/files",
                                 {"name": title, "text": text})
            assert status == 200 and body["chunks"] == 1
        files = router.vectorstores.registry.list_files("docs")
        assert [(f["name"], f["chunks"]) for f in files] == \
            [(t, 1) for t, _ in CORPUS]
        assert router.vectorstores.registry.list_stores() == ["docs"]
    finally:
        server.stop()
        backend.stop()
        router.shutdown()
