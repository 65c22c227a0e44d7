"""Redis-Cluster client: CRC16 slot routing + MOVED/ASK redirects.

The port's copy of ``semantic_router_tpu.state.rediscluster``.

Reference role: pkg/responsestore's Redis-Cluster backend (the reference
uses go-redis cluster mode). Zero-dependency like state/resp.py: the
cluster layer sits on top of RedisClient — per-node pooled connections,
the standard CRC16-XMODEM key→slot mapping (with {hashtag} support),
lazy slot-map discovery via CLUSTER SLOTS, and redirect handling:

  -MOVED <slot> <host:port>  → slot ownership changed: update the map,
                               retry on the new owner
  -ASK <slot> <host:port>    → one-shot redirect mid-migration: retry on
                               the target prefixed with ASKING, do NOT
                               update the map

``MiniRedisClusterNode`` extends the embedded MiniRedis with slot
ownership so the redirect protocol is testable without a real cluster.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .resp import MiniRedis, RedisClient, RespError

SLOTS = 16384

# CRC16-CCITT (XMODEM) — the Redis cluster key hash (crc16.c)
_CRC16_TABLE: List[int] = []


def _build_table() -> None:
    poly = 0x1021
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & 0x8000) else (crc << 1)
        _CRC16_TABLE.append(crc & 0xFFFF)


_build_table()


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) ^ b)
                                                   & 0xFF]
    return crc


def hash_slot(key: str) -> int:
    """Key → slot, honoring {hashtag} (only the first non-empty brace
    section hashes, so related keys can colocate)."""
    k = key.encode() if isinstance(key, str) else key
    start = k.find(b"{")
    if start >= 0:
        end = k.find(b"}", start + 1)
        if end > start + 1:
            k = k[start + 1:end]
    return crc16(k) % SLOTS


# first-key position per command we send (None → not key-routed: fan
# out or use any node)
_KEY_INDEX = {"GET": 0, "SET": 0, "DEL": 0, "EXISTS": 0, "EXPIRE": 0,
              "TTL": 0, "INCRBY": 0, "HSET": 0, "HGET": 0, "HGETALL": 0,
              "PERSIST": 0, "TYPE": 0}


class RedisClusterClient:
    """RedisClient-compatible surface over a slot-routed node set —
    drop-in for stores that accept ``client=``."""

    def __init__(self, startup_nodes: List[Tuple[str, int]],
                 password: str = "", max_redirects: int = 5) -> None:
        if not startup_nodes:
            raise ValueError("startup_nodes required")
        self.password = password
        self.max_redirects = max_redirects
        self._nodes: Dict[Tuple[str, int], RedisClient] = {}
        self._slot_owner: Dict[int, Tuple[str, int]] = {}
        self._startup = [tuple(n) for n in startup_nodes]
        self._lock = threading.Lock()

    # -- node/slot management -------------------------------------------

    def _node(self, addr: Tuple[str, int]) -> RedisClient:
        with self._lock:
            cli = self._nodes.get(addr)
            if cli is None:
                cli = RedisClient(addr[0], addr[1],
                                  password=self.password)
                self._nodes[addr] = cli
            return cli

    def refresh_slots(self) -> None:
        """CLUSTER SLOTS from any reachable node → slot map."""
        for addr in list(self._startup) + list(self._nodes):
            try:
                ranges = self._node(addr).execute("CLUSTER", "SLOTS")
            except Exception:
                continue
            if not isinstance(ranges, list):
                continue
            with self._lock:
                self._slot_owner.clear()
                for rng in ranges:
                    start, end, master = int(rng[0]), int(rng[1]), rng[2]
                    host = master[0]
                    host = host.decode() if isinstance(host, bytes) \
                        else str(host)
                    owner = (host, int(master[1]))
                    for s in range(start, end + 1):
                        self._slot_owner[s] = owner
            return

    def _addr_for(self, key: Optional[str]) -> Tuple[str, int]:
        if key is None:
            return self._startup[0]
        with self._lock:
            owner = self._slot_owner.get(hash_slot(key))
        return owner or self._startup[0]

    @staticmethod
    def _parse_redirect(msg: str) -> Tuple[str, int, Tuple[str, int]]:
        kind, slot, hostport = msg.split(" ", 2)
        host, port = hostport.rsplit(":", 1)
        return kind, int(slot), (host, int(port))

    # -- command execution ----------------------------------------------

    def execute(self, *args) -> Any:
        name = str(args[0]).upper()
        ki = _KEY_INDEX.get(name)
        key = str(args[ki + 1]) if ki is not None and len(args) > ki + 1 \
            else None
        addr = self._addr_for(key)
        asking = False
        for _ in range(self.max_redirects + 1):
            cli = self._node(addr)
            try:
                if asking:
                    out = cli.pipeline([("ASKING",), tuple(args)])
                    reply = out[-1]
                    if isinstance(reply, Exception):
                        raise reply
                    return reply
                return cli.execute(*args)
            except RespError as e:
                msg = str(e)
                code = msg.split(" ", 1)[0]
                if code == "MOVED":
                    _, slot, owner = self._parse_redirect(msg)
                    with self._lock:
                        self._slot_owner[slot] = owner
                    addr, asking = owner, False
                    continue
                if code == "ASK":
                    _, _, owner = self._parse_redirect(msg)
                    addr, asking = owner, True
                    continue
                raise
        raise RespError(f"too many cluster redirects for {name}")

    # -- RedisClient-compatible wrappers ---------------------------------

    def ping(self) -> bool:
        try:
            return self._node(self._startup[0]).ping()
        except Exception:
            return False

    def set(self, key: str, value, ex: Optional[int] = None) -> bool:
        args: List[Any] = ["SET", key, value]
        if ex is not None:
            args += ["EX", ex]
        return self.execute(*args) == "OK"

    def get(self, key: str) -> Optional[bytes]:
        return self.execute("GET", key)

    def delete(self, *keys: str) -> int:
        # cross-slot multi-key DEL is a cluster error — one DEL per key
        return sum(int(self.execute("DEL", k)) for k in keys)

    def exists(self, key: str) -> bool:
        return bool(self.execute("EXISTS", key))

    def expire(self, key: str, seconds: int) -> bool:
        return bool(self.execute("EXPIRE", key, seconds))

    def incr(self, key: str, by: int = 1) -> int:
        return int(self.execute("INCRBY", key, by))

    def close(self) -> None:
        with self._lock:
            for cli in self._nodes.values():
                try:
                    cli.close()
                except Exception:
                    pass
            self._nodes.clear()


class MiniRedisClusterNode(MiniRedis):
    """Embedded MiniRedis owning a slot range; keys outside it redirect.

    ``migrating``: {slot: "host:port"} → reply ASK for keys in a slot
    this node owns but is handing off (the mid-migration protocol)."""

    def __init__(self, slot_range: Tuple[int, int],
                 host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host=host, port=port)
        self.slot_range = slot_range
        self.peers: Dict[int, str] = {}       # slot → "host:port"
        self.migrating: Dict[int, str] = {}
        # ASKING is per-CONNECTION in real Redis; connections here are
        # thread-per-conn, so thread-local scoping matches the wire
        self._asking_state = threading.local()

    def owns(self, slot: int) -> bool:
        return self.slot_range[0] <= slot <= self.slot_range[1]

    def _dispatch(self, name: str, args: List[bytes]) -> Any:
        if name == "CLUSTER" and args and \
                args[0].upper() == b"SLOTS":
            return self._arr([self._arr([
                self._int(self.slot_range[0]),
                self._int(self.slot_range[1]),
                self._arr([self._bulk(self.host.encode()),
                           self._int(self.port)])])])
        if name == "ASKING":
            self._asking_state.flag = True
            return b"+OK\r\n"
        ki = _KEY_INDEX.get(name)
        if ki is not None and len(args) > ki:
            key = args[ki].decode()
            slot = hash_slot(key)
            asking = getattr(self._asking_state, "flag", False)
            self._asking_state.flag = False
            if not self.owns(slot) and not asking:
                target = self.peers.get(slot)
                if target:
                    raise RespError(f"MOVED {slot} {target}")
            elif self.owns(slot) and slot in self.migrating \
                    and not self._alive(args[ki]):
                raise RespError(f"ASK {slot} {self.migrating[slot]}")
        return super()._dispatch(name, args)
