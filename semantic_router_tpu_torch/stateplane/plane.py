"""StatePlane: membership, heartbeats, the ring, and fleet pressure.

The port's copy of ``semantic_router_tpu.stateplane.plane``.

One StatePlane per router replica, all pointing at one
:class:`~.backend.GuardedBackend`.  It owns the plane's control state:

- **membership**: each replica heartbeats ``{ns}:replica:{id}`` with a
  TTL of ``ttl_s``; the live member set is whoever's key has not
  expired.  A crashed replica leaves the ring one TTL later — no
  coordinator, no consensus, exactly the availability a shed ladder
  needs (the data plane never blocks on membership).
- **ring**: a consistent-hash ring over the live members, rebuilt on
  every heartbeat; ``owner_of(key)`` is the affinity answer every
  replica computes identically.
- **fleet pressure**: each replica publishes its pressure gauges + SLO
  burn state + ladder level as ``{ns}:pressure:{id}`` (TTL'd JSON);
  ``fleet_pressure()`` aggregates the live set — max queue depth, max
  saturation, union of firing alerts, per-replica levels — the view the
  DegradationController steps the ladder from so N replicas shed as one.

Every backend failure surfaces as StateBackendUnavailable from the
guard; this class catches NOTHING — callers (controller, caches) own
their fail-open policy, and the guard's breaker keeps a dead plane from
costing more than a nanosecond check per call.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .backend import GuardedBackend, StateBackendUnavailable
from .ring import HashRing


def default_replica_id() -> str:
    """host:pid plus a short nonce — unique per process, readable in
    /debug/stateplane and the pressure keys."""
    return f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"


class StatePlane:
    def __init__(self, backend: GuardedBackend,
                 replica_id: str = "", namespace: str = "srt",
                 heartbeat_s: float = 2.0, ttl_s: float = 0.0,
                 ring_vnodes: int = 64, metrics=None) -> None:
        self.backend = backend
        self.replica_id = replica_id or default_replica_id()
        self.ns = namespace.rstrip(":")
        self.heartbeat_s = max(0.05, float(heartbeat_s))
        # membership TTL: 3 missed heartbeats = gone (default 3x; an
        # explicit value is floored at 2 beats — a TTL at or under the
        # heartbeat would expire every member between beats and flap
        # the ring, oscillating owner_of() fleet-wide)
        self.ttl_s = max(float(ttl_s), 2.0 * self.heartbeat_s) \
            if ttl_s else 3.0 * self.heartbeat_s
        self._ring = HashRing([self.replica_id], vnodes=ring_vnodes)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.started_t = time.time()
        self.heartbeats = 0
        self.last_heartbeat_t = 0.0
        self.last_members: List[str] = [self.replica_id]
        # piggyback publishers (observability/fleetobs.py): run after
        # every successful beat, on the heartbeat thread, so periodic
        # publication costs the request path nothing
        self._publishers: List[Any] = []

        self._members_gauge = self._avail_gauge = None
        if metrics is not None:
            try:
                self._members_gauge = metrics.gauge(
                    "llm_stateplane_members",
                    "Live replicas visible through the state plane")
                self._avail_gauge = metrics.gauge(
                    "llm_stateplane_available",
                    "1 when the shared state backend is reachable, "
                    "0 while degraded to local-only state")
                self._members_gauge.set(1.0)
                self._avail_gauge.set(1.0)
            except Exception:
                pass

    # -- keys ---------------------------------------------------------------

    def key(self, *parts: str) -> str:
        return ":".join((self.ns,) + tuple(parts))

    # -- membership ---------------------------------------------------------

    def heartbeat_once(self) -> List[str]:
        """Publish this replica's liveness + refresh the member set and
        ring.  Raises StateBackendUnavailable on a dead plane (callers
        keep their last ring — local-only posture)."""
        payload = json.dumps({
            "replica": self.replica_id,
            "ts_unix": time.time(),
            "pid": os.getpid(),
        }).encode()
        self.backend.put(self.key("replica", self.replica_id), payload,
                         ttl_s=self.ttl_s)
        prefix = self.key("replica", "")
        members = [k[len(prefix):] for k in self.backend.scan(prefix)]
        if self.replica_id not in members:  # scan raced our own TTL
            members.append(self.replica_id)
        with self._lock:
            if sorted(members) != sorted(self._ring.members()):
                self._ring.rebuild(members)
            self.last_members = sorted(members)
            self.heartbeats += 1
            self.last_heartbeat_t = time.time()
        self._publish_gauges()
        self._run_publishers()
        return self.last_members

    def add_publisher(self, fn) -> None:
        """Register a callable run after each successful heartbeat (the
        fleet plane's snapshot publication).  Publishers own their
        fail-open policy; an escape is swallowed, so the membership loop
        never dies."""
        with self._lock:
            if fn not in self._publishers:
                self._publishers.append(fn)

    def remove_publisher(self, fn) -> None:
        with self._lock:
            if fn in self._publishers:
                self._publishers.remove(fn)

    def _run_publishers(self) -> None:
        with self._lock:
            publishers = list(self._publishers)
        for fn in publishers:
            try:
                fn()
            except Exception:
                pass

    def _publish_gauges(self) -> None:
        try:
            if self._members_gauge is not None:
                self._members_gauge.set(float(len(self.last_members)))
            if self._avail_gauge is not None:
                self._avail_gauge.set(
                    1.0 if self.backend.available else 0.0)
        except Exception:
            pass

    def members(self) -> List[str]:
        with self._lock:
            return list(self.last_members)

    @property
    def available(self) -> bool:
        return self.backend.available

    # -- ring / affinity ----------------------------------------------------

    def ring(self) -> HashRing:
        with self._lock:
            return self._ring

    def owner_of(self, key: str) -> str:
        """The replica whose hot local state (EncodingCache rows,
        fused-bank memos) this key should land on.  Falls back to SELF
        when the ring is empty — affinity is an optimization, never a
        failure mode."""
        with self._lock:
            return self._ring.node_for(key) or self.replica_id

    def owns(self, key: str) -> bool:
        return self.owner_of(key) == self.replica_id

    # -- fleet pressure -----------------------------------------------------

    def publish_pressure(self, snapshot: Dict[str, Any]) -> None:
        """Publish this replica's pressure view (controller tick rate);
        TTL'd so a dead replica's stale pressure cannot pin the fleet
        degraded."""
        row = dict(snapshot)
        row["replica"] = self.replica_id
        row["ts_unix"] = time.time()
        self.backend.put(self.key("pressure", self.replica_id),
                         json.dumps(row).encode(),
                         ttl_s=max(self.ttl_s, 2.0 * float(
                             snapshot.get("interval_s", 0.0) or 0.0)))

    def fleet_pressure(self) -> Dict[str, Any]:
        """Aggregate every live replica's published pressure:
        worst-case queues, union of firing alerts, per-replica ladder
        levels.  The deterministic input all controllers step from."""
        prefix = self.key("pressure", "")
        firing: Dict[str, str] = {}
        levels: Dict[str, int] = {}
        pending = sat = 0.0
        engine_down = False
        rows = 0
        for k in self.backend.scan(prefix):
            raw = self.backend.get(k)
            if not raw:
                continue
            try:
                row = json.loads(raw)
            except (ValueError, UnicodeDecodeError):
                continue
            rows += 1
            replica = str(row.get("replica", k[len(prefix):]))
            levels[replica] = int(row.get("level", 0))
            pending = max(pending,
                          float(row.get("pending_items", 0.0)))
            sat = max(sat, float(row.get("pool_saturation", 0.0)))
            engine_down = engine_down or bool(row.get("engine_down"))
            for name, sev in (row.get("firing") or {}).items():
                # fast outranks slow when two replicas disagree
                if firing.get(name) != "fast":
                    firing[name] = str(sev)
        return {
            "replicas": rows,
            "firing": firing,
            "pending_items": pending,
            "pool_saturation": sat,
            "engine_down": engine_down,
            "levels": levels,
            "max_level": max(levels.values()) if levels else 0,
        }

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StatePlane":
        """Run the heartbeat loop; idempotent.  The first beat happens
        inline so the replica is a member before serving."""
        try:
            self.heartbeat_once()
        except StateBackendUnavailable:
            pass  # plane down at boot: local-only until it appears
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.heartbeat_s):
                try:
                    self.heartbeat_once()
                except StateBackendUnavailable:
                    self._publish_gauges()  # reflect degraded state
                except Exception:
                    pass  # the membership loop must never die

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="stateplane-heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        try:  # best-effort deregistration (TTL covers the crash path)
            self.backend.delete(self.key("replica", self.replica_id),
                                self.key("pressure", self.replica_id))
        except StateBackendUnavailable:
            pass

    def close(self) -> None:
        self.stop()
        self.backend.close()

    # -- reads --------------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """GET /debug/stateplane payload."""
        with self._lock:
            ring = self._ring
            members = list(self.last_members)
        try:
            fleet = self.fleet_pressure() if self.backend.available \
                else {"replicas": 0, "unreachable": True}
        except StateBackendUnavailable:
            fleet = {"replicas": 0, "unreachable": True}
        return {
            "replica_id": self.replica_id,
            "namespace": self.ns,
            "members": members,
            "heartbeat_s": self.heartbeat_s,
            "ttl_s": self.ttl_s,
            "heartbeats": self.heartbeats,
            "ring": {
                "vnodes": ring.vnodes,
                "distribution": ring.distribution(1024),
            },
            "backend": self.backend.report(),
            "fleet": fleet,
        }
