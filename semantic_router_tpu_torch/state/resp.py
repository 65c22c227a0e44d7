"""RESP (REdis Serialization Protocol) wire client + embedded mini-server.

The port's copy of ``semantic_router_tpu.state.resp``: the same command
encoding byte for byte, the same reply parser, and the same server
command subset with its TTL, WRONGTYPE and SCAN semantics.

The reference reaches external state over Redis/Valkey clients
(pkg/responsestore redis backend, pkg/cache backends via their factories;
state taxonomy: docs/architecture/state-taxonomy-and-inventory.md).  This
module provides the same capability with zero dependencies:

- :class:`RedisClient` — a real RESP2 socket client (pipelining, auth,
  reconnect) that talks to any Redis/Valkey/KeyDB server in production.
- :class:`MiniRedis` — an embedded RESP2 server implementing the command
  subset the framework uses (strings+TTL, hashes, scan, counters).  It
  backs tests and single-node dev deployments the way the reference's test
  suites use an embedded store; the client cannot tell the difference.

Both speak the public RESP2 protocol over real sockets.
"""

from __future__ import annotations

import fnmatch
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class RespError(Exception):
    """Server-reported -ERR reply."""


class ConnectionError_(Exception):
    """Socket-level failure after retry."""


def encode_command(*args) -> bytes:
    """RESP array-of-bulk-strings command encoding."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, str):
            b = a.encode()
        elif isinstance(a, float):
            b = repr(a).encode()
        else:
            b = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class _Reader:
    """Buffered RESP reply parser over a socket."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = b""

    def _read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError_("connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError_("connection closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def read_reply(self) -> Any:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self.read_reply() for _ in range(n)]
        raise RespError(f"unknown reply type {line!r}")


class RedisClient:
    """Thread-safe RESP2 client (one pooled connection guarded by a lock;
    commands are short and the router's state calls are not the hot path)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, password: str = "",
                 timeout_s: float = 5.0, retries: int = 1) -> None:
        self.host, self.port, self.db = host, port, db
        self.password = password
        self.timeout_s = timeout_s
        self.retries = retries
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[_Reader] = None
        self._lock = threading.Lock()

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._reader = _Reader(sock)
        if self.password:
            self._roundtrip("AUTH", self.password)
        if self.db:
            self._roundtrip("SELECT", self.db)

    def _roundtrip(self, *args) -> Any:
        self._sock.sendall(encode_command(*args))
        return self._reader.read_reply()

    # commands safe to re-send after the full payload reached the server:
    # re-executing them server-side cannot change state beyond a single
    # execution (reads, connection setup, absolute SET/EXPIRE). INCRBY /
    # DEL / LPUSH etc. are NOT here — the server may have executed the
    # command even though the reply was lost; a retry would run it twice.
    _IDEMPOTENT = frozenset({
        "PING", "ECHO", "AUTH", "SELECT", "INFO", "GET", "MGET", "EXISTS",
        "TTL", "PTTL", "TYPE", "KEYS", "SCAN", "STRLEN", "GETRANGE",
        "HGET", "HMGET", "HGETALL", "HKEYS", "HLEN", "SMEMBERS", "SCARD",
        "SISMEMBER", "LRANGE", "LLEN", "LINDEX", "ZRANGE", "ZSCORE",
        "ZCARD", "SET", "EXPIRE", "PEXPIRE",
    })

    @classmethod
    def _retry_safe(cls, args: Tuple) -> bool:
        cmd = str(args[0]).upper()
        if cmd not in cls._IDEMPOTENT:
            return False
        # conditional variants flip meaning when run twice: SET..NX that
        # succeeded server-side returns nil on the retry (caller would
        # wrongly conclude the lock was NOT acquired)
        if cmd == "SET":
            return not any(str(a).upper() in ("NX", "XX", "GET")
                           for a in args[3:])
        if cmd in ("EXPIRE", "PEXPIRE"):
            return not any(str(a).upper() in ("NX", "XX", "GT", "LT")
                           for a in args[3:])
        return True

    def _drop_if_stale(self) -> None:
        """Close a connection the server has already half-closed (restart,
        idle timeout). A readable socket with a pending EOF would make the
        NEXT send 'succeed' into a dead pipe — detecting it here lets
        non-idempotent commands reconnect without at-most-once risk."""
        if self._sock is None:
            return
        import select

        try:
            readable, _, _ = select.select([self._sock], [], [], 0)
            if readable:  # unsolicited data or EOF: connection is dead
                self.close_nolock()
        except (OSError, ValueError):
            self.close_nolock()

    def execute(self, *args) -> Any:
        """Run one command; reconnects on socket failure.

        Failures during connect or send (incomplete RESP frame — the
        server cannot have executed it) always retry. Failures while
        reading the reply (the command fully reached the server) retry
        only for idempotent commands — otherwise a lost reply could
        silently run a non-idempotent command (INCRBY, DEL, ...) twice."""
        retry_after_send = self._retry_safe(args)
        with self._lock:
            for attempt in range(self.retries + 1):
                sent = False
                try:
                    self._drop_if_stale()
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(encode_command(*args))
                    sent = True
                    return self._reader.read_reply()
                except (OSError, ConnectionError_):
                    self.close_nolock()
                    if attempt == self.retries or (
                            sent and not retry_after_send):
                        raise ConnectionError_(
                            f"redis {self.host}:{self.port} unreachable")

    def pipeline(self, commands: List[Tuple]) -> List[Any]:
        """Send N commands in one write, read N replies (RESP pipelining).
        Reconnect retry on connect-phase failure; once any byte of the
        batch may be in flight a retry happens only when EVERY command in
        the batch is idempotent — unlike execute(), a multi-command
        payload can partially transmit COMPLETE frames (the server ran a
        prefix), so a send failure is not proof nothing executed. Raises
        ConnectionError_ — never raw OSError."""
        retry_after_send = all(self._retry_safe(c) for c in commands)
        with self._lock:
            for attempt in range(self.retries + 1):
                sent = False
                try:
                    self._drop_if_stale()
                    if self._sock is None:
                        self._connect()
                    payload = b"".join(encode_command(*c) for c in commands)
                    sent = True
                    self._sock.sendall(payload)
                    out = []
                    for _ in commands:
                        try:
                            out.append(self._reader.read_reply())
                        except RespError as e:
                            out.append(e)
                    return out
                except (OSError, ConnectionError_):
                    self.close_nolock()
                    if attempt == self.retries or (
                            sent and not retry_after_send):
                        raise ConnectionError_(
                            f"redis {self.host}:{self.port} unreachable")

    # -- convenience wrappers -------------------------------------------

    def ping(self) -> bool:
        return self.execute("PING") == "PONG"

    def set(self, key: str, value, ex: Optional[int] = None) -> bool:
        args = ["SET", key, value]
        if ex:
            args += ["EX", ex]
        return self.execute(*args) == "OK"

    def get(self, key: str) -> Optional[bytes]:
        return self.execute("GET", key)

    def delete(self, *keys: str) -> int:
        return self.execute("DEL", *keys) if keys else 0

    def exists(self, key: str) -> bool:
        return bool(self.execute("EXISTS", key))

    def expire(self, key: str, seconds: int) -> bool:
        return bool(self.execute("EXPIRE", key, seconds))

    def ttl(self, key: str) -> int:
        return self.execute("TTL", key)

    def incr(self, key: str, by: int = 1) -> int:
        return self.execute("INCRBY", key, by)

    def keys(self, pattern: str = "*") -> List[bytes]:
        return self.execute("KEYS", pattern) or []

    def hset(self, key: str, mapping: Dict[str, Any]) -> int:
        args: List[Any] = ["HSET", key]
        for k, v in mapping.items():
            args += [k, v]
        return self.execute(*args)

    def hget(self, key: str, field: str) -> Optional[bytes]:
        return self.execute("HGET", key, field)

    def hgetall(self, key: str) -> Dict[bytes, bytes]:
        flat = self.execute("HGETALL", key) or []
        return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}

    def scan_iter(self, pattern: str = "*", count: int = 500):
        cursor = 0
        while True:
            cursor_b, batch = self.execute("SCAN", cursor, "MATCH", pattern,
                                           "COUNT", count)
            for k in batch:
                yield k
            cursor = int(cursor_b)
            if cursor == 0:
                return

    def flushdb(self) -> bool:
        return self.execute("FLUSHDB") == "OK"

    def dbsize(self) -> int:
        return self.execute("DBSIZE")

    def close_nolock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._reader = None

    def close(self) -> None:
        with self._lock:
            self.close_nolock()


# ---------------------------------------------------------------------------
# embedded server
# ---------------------------------------------------------------------------


class MiniRedis:
    """Embedded RESP2 server (strings+TTL, hashes, counters, scan/keys).

    One python dict guarded by one lock; lazy TTL expiry on access plus a
    sweep on DBSIZE/KEYS/SCAN.  Runs a thread per connection — suitable for
    tests and dev, not for production fleets (point RedisClient at a real
    Redis/Valkey there)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._data: Dict[bytes, Any] = {}
        self._expiry: Dict[bytes, float] = {}
        self._lock = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        self._running = False
        # open connections, tracked so stop() can sever them: a
        # "killed" server whose established sockets keep answering
        # would make backend-loss chaos tests prove nothing
        self._conns: set = set()

    def start(self) -> "MiniRedis":
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="miniredis-accept").start()
        return self

    def stop(self) -> None:
        self._running = False
        try:
            # shutdown BEFORE close: a thread blocked in accept() holds
            # a kernel reference to the listening socket, so close()
            # alone leaves it accepting (and the port unbindable) until
            # that accept returns — shutdown wakes it immediately
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:  # sever live clients like a real crash
            try:
                conn.close()
            except OSError:
                pass

    # -- internals -------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # daemon threads are not tracked: retaining a Thread object per
            # connection would leak in long-lived dev servers
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="miniredis-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.add(conn)
        reader = _Reader(conn)
        try:
            while True:
                try:
                    cmd = reader.read_reply()
                except (ConnectionError_, OSError):
                    return
                if not isinstance(cmd, list) or not cmd:
                    conn.sendall(b"-ERR protocol error\r\n")
                    continue
                name = cmd[0].decode().upper() if isinstance(cmd[0], bytes) \
                    else str(cmd[0]).upper()
                try:
                    reply = self._dispatch(name, cmd[1:])
                except RespError as e:
                    msg = str(e)
                    # cluster redirects are their own error codes on the
                    # wire (-MOVED / -ASK), not -ERR
                    first = msg.split(" ", 1)[0]
                    prefix = b"-" if first in ("MOVED", "ASK") else b"-ERR "
                    conn.sendall(prefix + msg.encode() + b"\r\n")
                    continue
                except Exception as e:  # malformed args must not kill the
                    # connection silently — real Redis replies with -ERR
                    conn.sendall(b"-ERR " + type(e).__name__.encode()
                                 + b": " + str(e).encode()[:200] + b"\r\n")
                    continue
                try:
                    if reply == "__QUIT__":
                        conn.sendall(b"+OK\r\n")
                        return
                    conn.sendall(reply)
                except OSError:
                    return  # peer (or stop()) severed the socket
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- encoding helpers ------------------------------------------------

    @staticmethod
    def _bulk(v: Optional[bytes]) -> bytes:
        if v is None:
            return b"$-1\r\n"
        return b"$%d\r\n%s\r\n" % (len(v), v)

    @staticmethod
    def _int(n: int) -> bytes:
        return b":%d\r\n" % n

    @staticmethod
    def _arr(items: List[bytes]) -> bytes:
        return b"*%d\r\n" % len(items) + b"".join(items)

    # -- state helpers ---------------------------------------------------

    def _alive(self, key: bytes) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and exp <= time.monotonic():
            self._data.pop(key, None)
            self._expiry.pop(key, None)
            return False
        return key in self._data

    def _sweep(self) -> None:
        for k in list(self._expiry):
            self._alive(k)

    # -- command dispatch ------------------------------------------------

    def _dispatch(self, name: str, args: List[bytes]) -> Any:
        with self._lock:
            return getattr(self, f"_cmd_{name.lower()}", self._cmd_unknown)(
                name, args)

    def _cmd_unknown(self, name: str, args):
        raise RespError(f"unknown command '{name}'")

    def _cmd_ping(self, name, args):
        return b"+PONG\r\n"

    def _cmd_quit(self, name, args):
        return "__QUIT__"

    def _cmd_auth(self, name, args):
        return b"+OK\r\n"  # accepts any credentials (dev server)

    def _cmd_select(self, name, args):
        return b"+OK\r\n"  # single logical db

    def _cmd_set(self, name, args):
        key, value = args[0], args[1]
        ex = None
        i = 2
        while i < len(args):
            opt = args[i].upper()
            if opt == b"EX":
                ex = int(args[i + 1]); i += 2
            elif opt == b"PX":
                ex = int(args[i + 1]) / 1000.0; i += 2
            else:
                i += 1
        self._data[key] = value
        if ex is not None:
            self._expiry[key] = time.monotonic() + float(ex)
        else:
            self._expiry.pop(key, None)
        return b"+OK\r\n"

    def _cmd_setex(self, name, args):
        key, secs, value = args[0], int(args[1]), args[2]
        self._data[key] = value
        self._expiry[key] = time.monotonic() + secs
        return b"+OK\r\n"

    def _cmd_get(self, name, args):
        key = args[0]
        if not self._alive(key):
            return self._bulk(None)
        v = self._data[key]
        if not isinstance(v, bytes):
            raise RespError("WRONGTYPE")
        return self._bulk(v)

    def _cmd_del(self, name, args):
        n = 0
        for key in args:
            if self._alive(key):
                del self._data[key]
                self._expiry.pop(key, None)
                n += 1
        return self._int(n)

    def _cmd_exists(self, name, args):
        return self._int(sum(1 for k in args if self._alive(k)))

    def _cmd_expire(self, name, args):
        key, secs = args[0], int(args[1])
        if not self._alive(key):
            return self._int(0)
        self._expiry[key] = time.monotonic() + secs
        return self._int(1)

    def _cmd_ttl(self, name, args):
        key = args[0]
        if not self._alive(key):
            return self._int(-2)
        exp = self._expiry.get(key)
        if exp is None:
            return self._int(-1)
        return self._int(max(0, int(round(exp - time.monotonic()))))

    def _cmd_incrby(self, name, args):
        key, by = args[0], int(args[1])
        if self._alive(key):
            v = self._data[key]
            if not isinstance(v, bytes):
                raise RespError("WRONGTYPE")
            try:
                cur = int(v)
            except ValueError:
                raise RespError("value is not an integer or out of range")
        else:
            cur = 0
        cur += by
        self._data[key] = str(cur).encode()
        return self._int(cur)

    def _cmd_incr(self, name, args):
        return self._cmd_incrby(name, [args[0], b"1"])

    def _cmd_keys(self, name, args):
        self._sweep()
        pattern = args[0].decode() if args else "*"
        out = [self._bulk(k) for k in sorted(self._data)
               if fnmatch.fnmatchcase(k.decode("utf-8", "replace"), pattern)]
        return self._arr(out)

    def _cmd_scan(self, name, args):
        # single-pass cursor: all matching keys in one batch, cursor 0
        self._sweep()
        pattern = "*"
        for i, a in enumerate(args):
            if isinstance(a, bytes) and a.upper() == b"MATCH":
                pattern = args[i + 1].decode()
        keys = [self._bulk(k) for k in sorted(self._data)
                if fnmatch.fnmatchcase(k.decode("utf-8", "replace"), pattern)]
        return self._arr([self._bulk(b"0"), self._arr(keys)])

    def _cmd_hset(self, name, args):
        key = args[0]
        if not self._alive(key):
            self._data[key] = {}
        h = self._data[key]
        if not isinstance(h, dict):
            raise RespError("WRONGTYPE")
        added = 0
        for i in range(1, len(args) - 1, 2):
            if args[i] not in h:
                added += 1
            h[args[i]] = args[i + 1]
        return self._int(added)

    def _cmd_hget(self, name, args):
        key, fld = args[0], args[1]
        if not self._alive(key):
            return self._bulk(None)
        h = self._data[key]
        if not isinstance(h, dict):
            raise RespError("WRONGTYPE")
        return self._bulk(h.get(fld))

    def _cmd_hgetall(self, name, args):
        key = args[0]
        if not self._alive(key):
            return self._arr([])
        h = self._data[key]
        if not isinstance(h, dict):
            raise RespError("WRONGTYPE")
        out = []
        for k, v in h.items():
            out.append(self._bulk(k))
            out.append(self._bulk(v))
        return self._arr(out)

    def _cmd_hdel(self, name, args):
        key = args[0]
        if not self._alive(key):
            return self._int(0)
        h = self._data[key]
        if not isinstance(h, dict):
            raise RespError("WRONGTYPE")
        n = 0
        for fld in args[1:]:
            if fld in h:
                del h[fld]
                n += 1
        return self._int(n)

    def _cmd_flushdb(self, name, args):
        self._data.clear()
        self._expiry.clear()
        return b"+OK\r\n"

    _cmd_flushall = _cmd_flushdb

    def _cmd_dbsize(self, name, args):
        self._sweep()
        return self._int(len(self._data))

    def _cmd_type(self, name, args):
        key = args[0]
        if not self._alive(key):
            return b"+none\r\n"
        v = self._data[key]
        return b"+hash\r\n" if isinstance(v, dict) else b"+string\r\n"
