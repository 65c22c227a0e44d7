"""PostgreSQL v3 wire-protocol client + embedded MiniPostgres stand-in.

The port's copy of ``semantic_router_tpu.state.postgres``: the same bytes
on the wire, so each package's client talks to the other's
``MiniPostgres``, and the port's client replays the JAX package's golden
transcripts.

Reference role: pkg/postgres (shared PG connector) and the Postgres
production defaults behind router replay (pkg/routerreplay/store/
postgres_store.go) and the vectorstore metadata registry
(pkg/vectorstore/metadata_registry_postgres.go). Zero-dependency like
state/resp.py: the frontend/backend protocol v3 is hand-framed from the
public documentation (postgresql.org/docs/current/protocol-message-
formats.html), no libpq.

Client surface:
  - ``query(sql)``            — simple-query protocol ('Q')
  - ``execute(sql, params)``  — extended protocol (Parse/Bind/Execute/
                                Sync) with text-format parameters, the
                                injection-safe path stores use
Both return a ``PGResult`` (columns, rows-as-text, command tag).

Auth: trust, cleartext password, and md5 (md5(md5(password+user)+salt))
are supported — the mechanisms PG enables out of the box.

``MiniPostgres`` is the embedded stand-in (same role as MiniRedis/
MiniQdrant): it speaks the real wire format — SSLRequest refusal,
startup, auth, ParameterStatus/BackendKeyData, simple AND extended
query, error-until-Sync recovery — and executes the SQL against an
in-process SQLite engine ($N placeholders translated positionally), so
PG-shaped SQL round-trips without a server in the image. The
wire-conformance suite (tests/test_postgres.py) additionally replays
golden byte transcripts authored from the protocol docs with no Mini*
code in the loop; the port's client replays them in
tests/test_torch_postgres.py).
"""

from __future__ import annotations

import hashlib
import re
import socket
import sqlite3
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

PROTOCOL_VERSION = 196608  # 3.0
SSL_REQUEST_CODE = 80877103


class PostgresError(Exception):
    """Server ErrorResponse; carries the documented severity/code/message
    fields."""

    def __init__(self, fields: Dict[str, str]):
        self.severity = fields.get("S", "ERROR")
        self.code = fields.get("C", "")
        super().__init__(
            f"{self.severity} {self.code}: {fields.get('M', '')}")
        self.fields = fields


@dataclass
class PGResult:
    columns: List[str] = field(default_factory=list)
    rows: List[List[Optional[str]]] = field(default_factory=list)
    command_tag: str = ""

    def scalar(self) -> Optional[str]:
        return self.rows[0][0] if self.rows and self.rows[0] else None


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("postgres: connection closed mid-message")
        buf += chunk
    return buf


def read_message(sock: socket.socket) -> Tuple[bytes, bytes]:
    """Read one typed backend/frontend message: (type byte, payload)."""
    head = _read_exact(sock, 5)
    mtype = head[:1]
    length = struct.unpack("!I", head[1:5])[0]
    payload = _read_exact(sock, length - 4) if length > 4 else b""
    return mtype, payload


def _cstr(b: bytes, off: int) -> Tuple[str, int]:
    end = b.index(b"\x00", off)
    return b[off:end].decode("utf-8", "replace"), end + 1


def _msg(mtype: bytes, payload: bytes) -> bytes:
    return mtype + struct.pack("!I", len(payload) + 4) + payload


def parse_error_fields(payload: bytes) -> Dict[str, str]:
    """ErrorResponse/NoticeResponse body: (field-type byte, cstring)*
    terminated by a zero byte."""
    fields: Dict[str, str] = {}
    off = 0
    while off < len(payload) and payload[off] != 0:
        code = chr(payload[off])
        val, off = _cstr(payload, off + 1)
        fields[code] = val
    return fields


def parse_row_description(payload: bytes) -> List[str]:
    (n,) = struct.unpack_from("!H", payload, 0)
    off = 2
    cols = []
    for _ in range(n):
        name, off = _cstr(payload, off)
        off += 18  # table oid(4) attnum(2) type oid(4) typlen(2)
        #           typmod(4) format(2)
        cols.append(name)
    return cols


def parse_data_row(payload: bytes) -> List[Optional[str]]:
    (n,) = struct.unpack_from("!H", payload, 0)
    off = 2
    row: List[Optional[str]] = []
    for _ in range(n):
        (ln,) = struct.unpack_from("!i", payload, off)
        off += 4
        if ln < 0:
            row.append(None)
        else:
            row.append(payload[off:off + ln].decode("utf-8", "replace"))
            off += ln
    return row


class PostgresClient:
    """One pooled connection per client; a lock serializes queries (the
    PG session is strictly request/response). Reconnects only when the
    failure happens before the request bytes are written (connect phase)
    — never after, so non-idempotent statements keep exactly-once
    semantics from the client's view (ADVICE r2 RESP lesson)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5432,
                 user: str = "postgres", database: str = "postgres",
                 password: str = "", connect_timeout: float = 5.0,
                 timeout: float = 30.0) -> None:
        self.host, self.port = host, port
        self.user, self.database, self.password = user, database, password
        self.connect_timeout, self.timeout = connect_timeout, timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self.server_params: Dict[str, str] = {}

    # -- connection ---------------------------------------------------

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        sock.settimeout(self.timeout)
        params = (f"user\x00{self.user}\x00"
                  f"database\x00{self.database}\x00\x00").encode()
        body = struct.pack("!I", PROTOCOL_VERSION) + params
        sock.sendall(struct.pack("!I", len(body) + 4) + body)
        while True:
            mtype, payload = read_message(sock)
            if mtype == b"R":
                (auth,) = struct.unpack_from("!I", payload, 0)
                if auth == 0:
                    continue
                if auth == 3:  # cleartext
                    sock.sendall(_msg(b"p", self.password.encode() + b"\x00"))
                elif auth == 5:  # md5
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        (self.password + self.user).encode()).hexdigest()
                    digest = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    sock.sendall(_msg(b"p", b"md5" + digest.encode() +
                                      b"\x00"))
                else:
                    sock.close()
                    raise PostgresError({"S": "FATAL", "C": "28000",
                                         "M": f"unsupported auth {auth}"})
            elif mtype == b"S":
                k, off = _cstr(payload, 0)
                v, _ = _cstr(payload, off)
                self.server_params[k] = v
            elif mtype == b"K":
                pass  # BackendKeyData (cancel key; we don't cancel)
            elif mtype == b"E":
                sock.close()
                raise PostgresError(parse_error_fields(payload))
            elif mtype == b"Z":
                return sock
            # NoticeResponse ('N') and anything else: skip

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            self._sock = self._connect()
        return self._sock

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(_msg(b"X", b""))
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    # -- protocol ------------------------------------------------------

    def _collect(self, sock: socket.socket) -> PGResult:
        """Consume backend messages until ReadyForQuery; raise the first
        ErrorResponse AFTER draining to ReadyForQuery so the session
        stays usable."""
        res = PGResult()
        error: Optional[PostgresError] = None
        while True:
            mtype, payload = read_message(sock)
            if mtype == b"T":
                res.columns = parse_row_description(payload)
            elif mtype == b"D":
                res.rows.append(parse_data_row(payload))
            elif mtype == b"C":
                res.command_tag, _ = _cstr(payload, 0)
            elif mtype == b"E":
                error = error or PostgresError(parse_error_fields(payload))
            elif mtype == b"Z":
                if error is not None:
                    raise error
                return res
            # '1' ParseComplete, '2' BindComplete, 'n' NoData,
            # 's' PortalSuspended, 'I' EmptyQueryResponse, 'N' notices:
            # no client action needed

    def _send_retriable(self, sock: socket.socket,
                        packet: bytes) -> socket.socket:
        """Send ``packet``; reconnect + resend ONLY when zero bytes
        reached the old socket.  A partial write followed by a blind
        resend could double-execute a non-idempotent statement, so a
        mid-stream failure surfaces to the caller instead."""
        sent = 0
        try:
            while sent < len(packet):
                sent += sock.send(packet[sent:])
            return sock
        except OSError:
            self._sock = None
            try:
                sock.close()  # don't leak the dead fd until GC
            except Exception:
                pass  # best-effort: never mask the send failure below
            if sent:
                raise
            fresh = self._connect()
            try:
                fresh.sendall(packet)
            except OSError:
                # the resend itself may partially write; never cache a
                # socket holding a truncated frame
                fresh.close()
                raise
            self._sock = fresh
            return fresh

    def query(self, sql: str) -> PGResult:
        """Simple-query protocol — DDL / fixed statements."""
        with self._lock:
            sock = self._send_retriable(
                self._ensure(), _msg(b"Q", sql.encode() + b"\x00"))
            try:
                return self._collect(sock)
            except (OSError, ConnectionError):
                self._sock = None
                raise

    def execute(self, sql: str,
                params: Sequence[Any] = ()) -> PGResult:
        """Extended protocol with text-format parameters ($1..$N)."""
        texts: List[Optional[bytes]] = []
        for p in params:
            if p is None:
                texts.append(None)
            elif isinstance(p, bool):
                texts.append(b"true" if p else b"false")
            elif isinstance(p, bytes):
                texts.append(p)
            else:
                texts.append(str(p).encode())
        parse = _msg(b"P", b"\x00" + sql.encode() + b"\x00" +
                     struct.pack("!H", 0))
        bind_body = (b"\x00\x00" + struct.pack("!H", 0) +
                     struct.pack("!H", len(texts)))
        for t in texts:
            bind_body += struct.pack("!i", -1) if t is None else \
                struct.pack("!i", len(t)) + t
        bind_body += struct.pack("!H", 0)  # result formats: all text
        bind = _msg(b"B", bind_body)
        describe = _msg(b"D", b"P\x00")
        execute = _msg(b"E", b"\x00" + struct.pack("!i", 0))
        sync = _msg(b"S", b"")
        packet = parse + bind + describe + execute + sync
        with self._lock:
            sock = self._send_retriable(self._ensure(), packet)
            try:
                return self._collect(sock)
            except (OSError, ConnectionError):
                self._sock = None
                raise

    def ping(self) -> bool:
        try:
            return self.query("SELECT 1").scalar() == "1"
        except (OSError, ConnectionError, PostgresError):
            return False


# ---------------------------------------------------------------------------
# MiniPostgres — embedded stand-in


def _split_statements(sql: str) -> List[str]:
    """Split a simple-query string on TOP-LEVEL semicolons only — a
    ``;`` inside a ``'...'`` literal (with ``''`` escapes), a ``"..."``
    identifier, a ``--`` line comment, a ``/* ... */`` block comment, or
    a ``$tag$ ... $tag$`` dollar-quoted literal is data, not a statement
    boundary (the naive ``sql.split(';')`` corrupted such statements)."""
    stmts: List[str] = []
    buf: List[str] = []
    i = 0
    while i < len(sql):
        ch = sql[i]
        if ch == "$":
            # dollar quoting: $$...$$ or $tag$...$tag$ (tag = word chars)
            m = re.match(r"\$\w*\$", sql[i:])
            if m:
                tag = m.group(0)
                j = sql.find(tag, i + len(tag))
                j = len(sql) if j < 0 else j + len(tag)
                buf.append(sql[i:j])
                i = j
                continue
        if ch == "/" and sql[i:i + 2] == "/*":
            # PG block comments NEST: scan with a depth counter
            depth = 1
            j = i + 2
            while j < len(sql) and depth:
                if sql[j:j + 2] == "/*":
                    depth += 1
                    j += 2
                elif sql[j:j + 2] == "*/":
                    depth -= 1
                    j += 2
                else:
                    j += 1
            buf.append(sql[i:j])
            i = j
            continue
        if ch in ("'", '"'):
            q = ch
            j = i + 1
            while j < len(sql):
                if sql[j] == q:
                    if j + 1 < len(sql) and sql[j + 1] == q:
                        j += 2  # doubled quote: escaped, keep scanning
                        continue
                    break
                j += 1
            buf.append(sql[i:j + 1])
            i = j + 1
            continue
        if ch == "-" and sql[i:i + 2] == "--":
            j = sql.find("\n", i)
            j = len(sql) if j < 0 else j
            buf.append(sql[i:j])
            i = j
            continue
        if ch == ";":
            stmts.append("".join(buf))
            buf = []
            i += 1
            continue
        buf.append(ch)
        i += 1
    if buf:
        stmts.append("".join(buf))
    return [s for s in stmts if s.strip()]


def _translate_placeholders(sql: str) -> str:
    """PG dialect → SQLite for the embedded engine: $N placeholders map
    to SQLite's numbered ?N (preserving out-of-order/reuse), and PG's
    bare ``OFFSET n`` (legal without LIMIT in PG, a parse error in
    SQLite) gains the ``LIMIT -1`` SQLite requires. String literals are
    left untouched."""
    out = []
    i = 0
    while i < len(sql):
        ch = sql[i]
        if ch == "'":  # skip string literals
            j = i + 1
            while j < len(sql):
                if sql[j] == "'":
                    if j + 1 < len(sql) and sql[j + 1] == "'":
                        j += 2
                        continue
                    break
                j += 1
            out.append(sql[i:j + 1])
            i = j + 1
            continue
        if ch == "$" and i + 1 < len(sql) and sql[i + 1].isdigit():
            j = i + 1
            while j < len(sql) and sql[j].isdigit():
                j += 1
            out.append("?" + sql[i + 1:j])
            i = j
            continue
        if sql[i:i + 6].upper() == "OFFSET" and \
                (i == 0 or not (sql[i - 1].isalnum() or sql[i - 1] == "_")):
            # bare-OFFSET shim: only when no LIMIT governs this clause
            # (scan back over the already-emitted text)
            emitted = "".join(out).upper()
            if "LIMIT" not in emitted.rsplit("SELECT", 1)[-1]:
                out.append("LIMIT -1 ")
        out.append(ch)
        i += 1
    return "".join(out)


def _command_tag(sql: str, cursor: sqlite3.Cursor,
                 nrows: int) -> str:
    head = sql.lstrip().split(None, 1)
    verb = head[0].upper() if head else ""
    if verb == "SELECT":
        return f"SELECT {nrows}"
    if verb == "INSERT":
        return f"INSERT 0 {max(cursor.rowcount, 0)}"
    if verb in ("UPDATE", "DELETE"):
        return f"{verb} {max(cursor.rowcount, 0)}"
    return verb or "OK"


class MiniPostgres:
    """Embedded PG-wire server over SQLite. ``path`` makes it durable
    (restart-e2e: new MiniPostgres on the same path sees the data)."""

    def __init__(self, port: int = 0, password: str = "",
                 auth: str = "trust", path: str = "") -> None:
        assert auth in ("trust", "cleartext", "md5")
        self.password, self.auth = password, auth
        self.path = path
        self._db = sqlite3.connect(path or ":memory:",
                                   check_same_thread=False)
        self._db_lock = threading.Lock()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._db_lock:
            self._db.close()

    # -- serving -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _startup(self, conn: socket.socket) -> bool:
        head = _read_exact(conn, 4)
        length = struct.unpack("!I", head)[0]
        body = _read_exact(conn, length - 4)
        (code,) = struct.unpack_from("!I", body, 0)
        if code == SSL_REQUEST_CODE:
            conn.sendall(b"N")  # SSL refused; client continues plaintext
            return self._startup(conn)
        if code != PROTOCOL_VERSION:
            conn.sendall(_msg(b"E", b"SFATAL\x00C08P01\x00"
                              b"Munsupported protocol\x00\x00"))
            return False
        expected_user = "postgres"
        off = 4
        params: Dict[str, str] = {}
        while off < len(body) and body[off] != 0:
            k, off = _cstr(body, off)
            v, off = _cstr(body, off)
            params[k] = v
        user = params.get("user", expected_user)
        if self.auth == "cleartext":
            conn.sendall(_msg(b"R", struct.pack("!I", 3)))
            mtype, payload = read_message(conn)
            given, _ = _cstr(payload, 0)
            if mtype != b"p" or given != self.password:
                conn.sendall(_msg(b"E", b"SFATAL\x00C28P01\x00"
                                  b"Mpassword authentication failed\x00\x00"))
                return False
        elif self.auth == "md5":
            salt = b"\x01\x02\x03\x04"
            conn.sendall(_msg(b"R", struct.pack("!I", 5) + salt))
            mtype, payload = read_message(conn)
            given, _ = _cstr(payload, 0)
            inner = hashlib.md5(
                (self.password + user).encode()).hexdigest()
            want = "md5" + hashlib.md5(inner.encode() + salt).hexdigest()
            if mtype != b"p" or given != want:
                conn.sendall(_msg(b"E", b"SFATAL\x00C28P01\x00"
                                  b"Mpassword authentication failed\x00\x00"))
                return False
        conn.sendall(_msg(b"R", struct.pack("!I", 0)))
        conn.sendall(_msg(b"S", b"server_version\x00mini-16.0\x00"))
        conn.sendall(_msg(b"S", b"client_encoding\x00UTF8\x00"))
        conn.sendall(_msg(b"K", struct.pack("!II", 1, 1)))
        conn.sendall(_msg(b"Z", b"I"))
        return True

    def _run_sql(self, conn: socket.socket, sql: str,
                 params: Sequence[Optional[str]] = (),
                 translated: bool = False) -> None:
        sql_run = sql if translated else _translate_placeholders(sql)
        with self._db_lock:
            cur = self._db.cursor()
            cur.execute(sql_run, tuple(params))
            cols = [d[0] for d in cur.description] if cur.description \
                else []
            rows = cur.fetchall() if cols else []
            self._db.commit()
        if cols:
            desc = struct.pack("!H", len(cols))
            for c in cols:
                desc += c.encode() + b"\x00" + struct.pack(
                    "!IhIhih", 0, 0, 25, -1, -1, 0)  # type oid 25 = text
            conn.sendall(_msg(b"T", desc))
            for row in rows:
                body = struct.pack("!H", len(row))
                for v in row:
                    if v is None:
                        body += struct.pack("!i", -1)
                    else:
                        if isinstance(v, float) and v == int(v):
                            v = repr(v)
                        t = v if isinstance(v, bytes) else \
                            str(v).encode()
                        body += struct.pack("!i", len(t)) + t
                conn.sendall(_msg(b"D", body))
        conn.sendall(_msg(b"C", _command_tag(sql, cur,
                                             len(rows)).encode() + b"\x00"))

    def _serve(self, conn: socket.socket) -> None:
        try:
            if not self._startup(conn):
                conn.close()
                return
            prepared: Dict[str, str] = {}
            portal: Tuple[str, List[Optional[str]]] = ("", [])
            skip_to_sync = False
            while True:
                mtype, payload = read_message(conn)
                if mtype == b"X":
                    break
                if mtype == b"S":  # Sync always answers ReadyForQuery
                    skip_to_sync = False
                    conn.sendall(_msg(b"Z", b"I"))
                    continue
                if skip_to_sync:
                    continue
                try:
                    if mtype == b"Q":
                        sql, _ = _cstr(payload, 0)
                        if not sql.strip():
                            conn.sendall(_msg(b"I", b""))
                        else:
                            for stmt in _split_statements(sql):
                                self._run_sql(conn, stmt)
                        conn.sendall(_msg(b"Z", b"I"))
                    elif mtype == b"P":
                        name, off = _cstr(payload, 0)
                        sql, off = _cstr(payload, off)
                        prepared[name] = _translate_placeholders(sql)
                        prepared[name + "\x00raw"] = sql
                        conn.sendall(_msg(b"1", b""))
                    elif mtype == b"B":
                        _portal, off = _cstr(payload, 0)
                        stmt, off = _cstr(payload, off)
                        (nfmt,) = struct.unpack_from("!H", payload, off)
                        off += 2 + 2 * nfmt
                        (nparams,) = struct.unpack_from("!H", payload, off)
                        off += 2
                        vals: List[Optional[str]] = []
                        for _ in range(nparams):
                            (ln,) = struct.unpack_from("!i", payload, off)
                            off += 4
                            if ln < 0:
                                vals.append(None)
                            else:
                                vals.append(
                                    payload[off:off + ln].decode())
                                off += ln
                        portal = (stmt, vals)
                        conn.sendall(_msg(b"2", b""))
                    elif mtype == b"D":
                        conn.sendall(_msg(b"n", b""))  # described at Execute
                    elif mtype == b"E":
                        stmt, vals = portal
                        self._run_sql_prepared(conn, prepared, stmt, vals)
                    elif mtype == b"C":  # Close statement/portal
                        conn.sendall(_msg(b"3", b""))
                    # 'H' Flush and others: no-op
                except sqlite3.Error as exc:
                    conn.sendall(_msg(
                        b"E", b"SERROR\x00C42601\x00M" +
                        str(exc).encode() + b"\x00\x00"))
                    if mtype == b"Q":
                        conn.sendall(_msg(b"Z", b"I"))
                    else:
                        skip_to_sync = True
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _run_sql_prepared(self, conn: socket.socket,
                          prepared: Dict[str, str], stmt: str,
                          vals: Sequence[Optional[str]]) -> None:
        sql_t = prepared.get(stmt, "")
        raw = prepared.get(stmt + "\x00raw", sql_t)
        with self._db_lock:
            cur = self._db.cursor()
            cur.execute(sql_t, tuple(vals))
            cols = [d[0] for d in cur.description] if cur.description \
                else []
            rows = cur.fetchall() if cols else []
            self._db.commit()
        if cols:
            desc = struct.pack("!H", len(cols))
            for c in cols:
                desc += c.encode() + b"\x00" + struct.pack(
                    "!IhIhih", 0, 0, 25, -1, -1, 0)
            conn.sendall(_msg(b"T", desc))
            for row in rows:
                body = struct.pack("!H", len(row))
                for v in row:
                    if v is None:
                        body += struct.pack("!i", -1)
                    else:
                        if isinstance(v, float) and v == int(v):
                            v = repr(v)
                        t = str(v).encode()
                        body += struct.pack("!i", len(t)) + t
                conn.sendall(_msg(b"D", body))
        conn.sendall(_msg(b"C", _command_tag(raw, cur,
                                             len(rows)).encode() + b"\x00"))
