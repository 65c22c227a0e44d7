"""Fleet observability plane: metric federation, fleet-scoped SLO
inputs and cross-replica debug aggregation over the state plane.

The port's copy of ``semantic_router_tpu.observability.fleetobs``.  Every
other layer of the observability stack is per-process: the SLO monitor
burns against 1/N of the traffic, and ``/debug/flightrec`` shows one
replica's slowest requests.  This module federates them over the plane:

- :class:`FleetPublisher` serializes the local
  :class:`~.metrics.MetricsRegistry` into the versioned, mergeable wire
  format (``MetricsRegistry.snapshot`` + ``encode_snapshot``) plus a
  bounded debug summary (slowest-N flight records, newest decision
  records, firing SLO alerts) into TTL'd keys next to the heartbeat;
  publication rides the heartbeat thread, so the request path pays
  nothing.
- :class:`FleetAggregator` lazily merges the live members' snapshots
  (heartbeat-aged replicas drop out; per-replica staleness is stamped)
  into one fleet registry served at ``GET /metrics/fleet`` and
  ``GET /debug/fleet``; ``?source=fleet`` on ``/debug/flightrec`` and
  ``/debug/decisions`` merges the sibling summaries.  Merges are
  read-time and cached for ``cache_s``.
- Fail-open: every plane error surfaces as StateBackendUnavailable from
  the guard; the publisher records it, and the aggregator degrades every
  fleet view to local-only with an explicit ``"scope": "local-fallback"``
  stamp: never an error, never a stale number presented as fresh.

Built by ``runtime/bootstrap`` only when both ``stateplane.enabled`` and
``observability.fleet.enabled``: the default-off posture constructs
nothing.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..stateplane.backend import StateBackendUnavailable
from .metrics import SNAPSHOT_VERSION, MetricsRegistry, encode_snapshot

# summary fields shipped per flight record / decision record — summary
# form by design: full records stay on the owning replica (fetch by id
# from its /debug/flightrec or /debug/decisions/<id>?source=durable)
_FLIGHT_FIELDS = ("request_id", "trace_id", "duration_s",
                  "recorded_unix", "meta")
_DECISION_FIELDS = ("record_id", "trace_id", "request_id", "ts_unix",
                    "kind", "model", "fallback_reason",
                    "routing_latency_ms", "degradation_level")


def _canonical(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode()


class FleetPublisher:
    """Publishes this replica's observability state to the plane.

    ``maybe_publish`` is the heartbeat hook (StatePlane.add_publisher):
    cadence-gated by ``interval_s`` (0 = every heartbeat), fail-open on
    a dead plane.  Keys are TTL'd at 3 publication intervals (floored
    at the membership TTL) so a crashed replica's telemetry ages out of
    every sibling's fleet view on the same clock its membership does.
    """

    def __init__(self, plane, registry: MetricsRegistry,
                 flightrec=None, explain=None, slo=None,
                 interval_s: float = 0.0, debug_top_n: int = 8) -> None:
        self.plane = plane
        self.registry = registry
        self.flightrec = flightrec
        self.explain = explain
        self.slo = slo
        self.interval_s = max(0.0, float(interval_s))
        self.debug_top_n = max(1, int(debug_top_n))
        self._last_mono = float("-inf")
        self.publishes = 0
        self.publish_errors = 0
        self.last_error = ""
        self.last_publish_unix = 0.0
        self.last_serialize_ns = 0
        self.last_bytes = 0

    def _ttl_s(self) -> float:
        iv = max(self.interval_s, self.plane.heartbeat_s)
        return max(self.plane.ttl_s, 3.0 * iv)

    def metrics_key(self) -> str:
        return self.plane.key("obs", "metrics", self.plane.replica_id)

    def debug_key(self) -> str:
        return self.plane.key("obs", "debug", self.plane.replica_id)

    # -- publication --------------------------------------------------------

    def publish_once(self) -> None:
        """One publication (metrics envelope + debug summary).  Raises
        StateBackendUnavailable upward — ``maybe_publish`` owns the
        fail-open policy."""
        t0 = time.perf_counter_ns()
        snap = self.registry.snapshot()
        raw = encode_snapshot({"replica": self.plane.replica_id,
                               "ts_unix": time.time(), "snap": snap})
        self.last_serialize_ns = time.perf_counter_ns() - t0
        self.last_bytes = len(raw)
        ttl = self._ttl_s()
        self.plane.backend.put(self.metrics_key(), raw, ttl_s=ttl)
        self.plane.backend.put(self.debug_key(),
                               _canonical(self._debug_summary()),
                               ttl_s=ttl)
        self.publishes += 1
        self.last_publish_unix = time.time()

    def maybe_publish(self) -> bool:
        """Heartbeat hook: honors the publication cadence; a dead plane
        is recorded, never raised (the heartbeat loop must keep
        beating)."""
        now = time.monotonic()
        if now - self._last_mono < self.interval_s:
            return False
        try:
            self.publish_once()
        except StateBackendUnavailable as exc:
            self.publish_errors += 1
            self.last_error = str(exc)[:200]
            return False
        self._last_mono = now
        return True

    # -- summary assembly ---------------------------------------------------

    def _debug_summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"replica": self.plane.replica_id,
                               "ts_unix": time.time()}
        fr = self.flightrec
        if fr is not None:
            try:
                dump = fr.dump()
                out["flightrec"] = {
                    "considered": dump.get("considered", 0),
                    "retained": dump.get("retained", 0),
                    "threshold_s": dump.get("threshold_s"),
                    "breaches": len(dump.get("breaches", [])),
                    "slowest": [
                        {k: r.get(k) for k in _FLIGHT_FIELDS}
                        for r in dump.get("slowest",
                                          [])[:self.debug_top_n]],
                }
            except Exception:
                pass
        ex = self.explain
        if ex is not None:
            try:
                rows = ex.list(limit=self.debug_top_n)
                out["decisions"] = {
                    "recorded": ex.stats().get("recorded", 0),
                    "recent": [
                        {**{k: r.get(k) for k in _DECISION_FIELDS},
                         "decision": (r.get("decision") or {}).get(
                             "name", "")}
                        for r in rows],
                }
            except Exception:
                pass
        slo = self.slo
        if slo is not None:
            try:
                out["slo_firing"] = slo.firing()
            except Exception:
                pass
        return out

    def report(self) -> Dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "ttl_s": round(self._ttl_s(), 3),
            "publishes": self.publishes,
            "publish_errors": self.publish_errors,
            "last_error": self.last_error,
            "last_publish_unix": self.last_publish_unix,
            "last_serialize_ns": self.last_serialize_ns,
            "last_bytes": self.last_bytes,
        }


class FleetAggregator:
    """Read-time merge of the live members' published snapshots.

    ``collect()`` returns a view dict::

        {"scope": "fleet" | "local-fallback",
         "replicas": {id: {"ts_unix", "age_s", "bytes"}},
         "skipped": [ids whose payload was malformed/version-skewed],
         "registry": <fresh MetricsRegistry holding the merged series>}

    The local registry is always folded in LIVE (never through its own
    published copy), so the view is never missing its own replica and a
    fresh boot aggregates before its first publication lands.  Counters
    and histograms merge by sum (re-bucketed onto the edge union);
    gauges merge by max — the worst-of-fleet read the external-metrics
    endpoint autoscales on.  Views are cached ``cache_s`` so scrapes and
    SLO ticks share one merge.
    """

    def __init__(self, plane, registry: MetricsRegistry,
                 cache_s: float = 1.0, debug_top_n: int = 32) -> None:
        self.plane = plane
        self.local_registry = registry
        self.cache_s = max(0.0, float(cache_s))
        self.debug_top_n = max(1, int(debug_top_n))
        self._lock = threading.Lock()
        self._cached: Optional[Dict[str, Any]] = None
        self._cached_mono = float("-inf")
        self.merges = 0
        self.fallbacks = 0
        self.last_merge_wall_s = 0.0

    # -- merged metric view -------------------------------------------------

    def collect(self, force: bool = False) -> Dict[str, Any]:
        with self._lock:
            if not force and self._cached is not None \
                    and time.monotonic() - self._cached_mono < self.cache_s:
                return self._cached
        t0 = time.perf_counter()
        try:
            view = self._collect_fleet()
        except StateBackendUnavailable:
            view = self._local_fallback()
        view["collected_unix"] = time.time()
        wall = time.perf_counter() - t0
        with self._lock:
            self.merges += 1
            self.last_merge_wall_s = wall
            if view["scope"] != "fleet":
                self.fallbacks += 1
            self._cached = view
            self._cached_mono = time.monotonic()
        return view

    def _stamp(self, registry: MetricsRegistry, view: Dict[str, Any]
               ) -> None:
        """The merged exposition carries its own provenance as series —
        a scraper can alert on fallback/staleness without parsing JSON."""
        registry.gauge(
            "llm_fleet_members",
            "Replicas whose snapshots merged into this fleet view"
        ).set(float(len(view["replicas"])))
        registry.gauge(
            "llm_fleet_local_fallback",
            "1 while the fleet view is degraded to local-only "
            "(stateplane unreachable)"
        ).set(0.0 if view["scope"] == "fleet" else 1.0)
        age = registry.gauge(
            "llm_fleet_snapshot_age_seconds",
            "Age of each merged member snapshot at merge time")
        for rid, row in view["replicas"].items():
            age.set(float(row.get("age_s", 0.0)), replica=rid)

    def _fold_local(self, merged: MetricsRegistry,
                    replicas: Dict[str, Any],
                    member_snaps: Dict[str, Any]) -> None:
        snap = self.local_registry.snapshot()
        merged.merge_snapshot(snap)
        member_snaps[self.plane.replica_id] = snap
        replicas[self.plane.replica_id] = {
            "ts_unix": time.time(), "age_s": 0.0, "bytes": 0,
            "local": True}

    def _collect_fleet(self) -> Dict[str, Any]:
        prefix = self.plane.key("obs", "metrics", "")
        live = set(self.plane.members())
        merged = MetricsRegistry()
        replicas: Dict[str, Any] = {}
        member_snaps: Dict[str, Any] = {}
        skipped: List[str] = []
        now = time.time()
        for key in self.plane.backend.scan(prefix):
            rid = key[len(prefix):]
            if rid == self.plane.replica_id:
                continue  # self merges live below (fresher than a put)
            if live and rid not in live:
                continue  # heartbeat-aged out; lingering TTL ignored
            raw = self.plane.backend.get(key)
            if not raw:
                continue
            try:
                env = json.loads(raw)
                snap = env.get("snap") or {}
                if int(snap.get("v", -1)) != SNAPSHOT_VERSION:
                    raise ValueError("snapshot version skew")
                merged.merge_snapshot(snap)
            except (ValueError, TypeError, KeyError,
                    UnicodeDecodeError):
                skipped.append(rid)
                continue
            member_snaps[rid] = snap
            ts = float(env.get("ts_unix", 0.0) or 0.0)
            replicas[rid] = {"ts_unix": ts,
                            "age_s": round(max(0.0, now - ts), 3),
                            "bytes": len(raw)}
        self._fold_local(merged, replicas, member_snaps)
        view = {"scope": "fleet", "replicas": replicas,
                "skipped": sorted(skipped), "registry": merged,
                "member_snaps": member_snaps}
        self._stamp(merged, view)
        return view

    def _local_fallback(self) -> Dict[str, Any]:
        merged = MetricsRegistry()
        replicas: Dict[str, Any] = {}
        member_snaps: Dict[str, Any] = {}
        self._fold_local(merged, replicas, member_snaps)
        view = {"scope": "local-fallback", "replicas": replicas,
                "skipped": [], "registry": merged,
                "member_snaps": member_snaps}
        self._stamp(merged, view)
        return view

    def per_replica_gauge(self, name: str) -> Dict[str, float]:
        """Max sample value of one gauge per merged member (the local
        replica reads live) — per-replica rows for the external-metrics
        endpoint without a second aggregation path."""
        view = self.collect()
        out: Dict[str, float] = {}
        for rid, snap in (view.get("member_snaps") or {}).items():
            fam = (snap.get("series") or {}).get(name)
            if not fam:
                continue
            vals = [float(v) for _, v in (fam.get("samples") or [])]
            if vals:
                out[rid] = max(vals)
        return out

    def scaling_view(self, local_level: float,
                     local_pending: float) -> Dict[str, Any]:
        """The external-metrics endpoint's scaling inputs through ONE
        aggregation point: fleet-max degradation level + per-replica
        levels from the federated ``llm_degradation_level`` series
        (the same values each controller publishes in its pressure
        exchange), worst queue pressure from the plane's pressure rows.
        Fail-open: a dead plane returns the local inputs, stamped."""
        view = self.collect()
        levels = self.per_replica_gauge("llm_degradation_level")
        level = max([local_level] + list(levels.values()))
        pending = local_pending
        if view["scope"] == "fleet":
            try:
                pending = max(pending, float(
                    self.plane.fleet_pressure().get(
                        "pending_items", 0.0)))
            except StateBackendUnavailable:
                pass
        return {"scope": view["scope"], "level": level,
                "pending": pending, "levels": levels}

    def exposition(self) -> tuple:
        """(text, view) for GET /metrics/fleet — classic 0.0.4 grammar
        (merged registries never carry exemplars), with the scope stamp
        as a leading free comment."""
        view = self.collect()
        header = (f"# fleet-scope: {view['scope']} "
                  f"replicas={len(view['replicas'])}\n")
        return header + view["registry"].expose(), view

    def merged_registry(self) -> tuple:
        """(registry, scope) — the SLOMonitor's fleet count source."""
        view = self.collect()
        return view["registry"], view["scope"]

    # -- merged debug views -------------------------------------------------

    def _sibling_summaries(self) -> Dict[str, Any]:
        try:
            prefix = self.plane.key("obs", "debug", "")
            live = set(self.plane.members())
            rows: List[Dict[str, Any]] = []
            for key in self.plane.backend.scan(prefix):
                rid = key[len(prefix):]
                if rid == self.plane.replica_id or \
                        (live and rid not in live):
                    continue
                raw = self.plane.backend.get(key)
                if not raw:
                    continue
                try:
                    row = json.loads(raw)
                except (ValueError, UnicodeDecodeError):
                    continue
                row.setdefault("replica", rid)
                rows.append(row)
            return {"scope": "fleet", "rows": rows}
        except StateBackendUnavailable:
            return {"scope": "local-fallback", "rows": []}

    def flightrec_fleet(self, local_dump: Dict[str, Any]
                        ) -> Dict[str, Any]:
        """/debug/flightrec?source=fleet: slowest-N merged across the
        live fleet, summary-form (full span trees stay on the owning
        replica)."""
        sib = self._sibling_summaries()
        rid = self.plane.replica_id
        slowest = [{**{k: r.get(k) for k in _FLIGHT_FIELDS},
                    "replica": rid}
                   for r in local_dump.get("slowest", [])]
        considered = local_dump.get("considered", 0)
        retained = local_dump.get("retained", 0)
        replicas = [rid]
        for row in sib["rows"]:
            fr = row.get("flightrec") or {}
            replicas.append(str(row.get("replica", "")))
            considered += int(fr.get("considered", 0) or 0)
            retained += int(fr.get("retained", 0) or 0)
            for r in fr.get("slowest", []) or []:
                slowest.append({**r, "replica": row.get("replica")})
        slowest.sort(key=lambda r: -float(r.get("duration_s") or 0.0))
        return {
            "scope": sib["scope"],
            "replicas": sorted(replicas),
            "considered": considered,
            "retained": retained,
            "slowest": slowest[:self.debug_top_n],
            "note": "summary form — fetch full records from the owning "
                    "replica's /debug/flightrec or "
                    "/debug/decisions/<id>?source=durable",
        }

    def decisions_fleet(self, local_rows: List[Dict[str, Any]]
                        ) -> Dict[str, Any]:
        """/debug/decisions?source=fleet: newest decision-record
        summaries merged across the live fleet."""
        sib = self._sibling_summaries()
        rid = self.plane.replica_id
        recent = [{**{k: r.get(k) for k in _DECISION_FIELDS},
                   "decision": (r.get("decision") or {}).get("name", ""),
                   "replica": rid}
                  for r in local_rows]
        replicas = [rid]
        for row in sib["rows"]:
            dec = row.get("decisions") or {}
            replicas.append(str(row.get("replica", "")))
            for r in dec.get("recent", []) or []:
                recent.append({**r, "replica": row.get("replica")})
        recent.sort(key=lambda r: -float(r.get("ts_unix") or 0.0))
        return {
            "scope": sib["scope"],
            "replicas": sorted(replicas),
            "records": recent[:self.debug_top_n],
            "note": "summary form — fetch full records by id from the "
                    "owning replica's durable mirror "
                    "(/debug/decisions/<id>?source=durable)",
        }

    def slo_firing_fleet(self) -> Dict[str, Any]:
        """Union of firing SLO alerts published by the live fleet (fast
        outranks slow, matching fleet_pressure)."""
        sib = self._sibling_summaries()
        firing: Dict[str, str] = {}
        for row in sib["rows"]:
            for name, sev in (row.get("slo_firing") or {}).items():
                if firing.get(name) != "fast":
                    firing[name] = str(sev)
        return {"scope": sib["scope"], "firing": firing}

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cache_s": self.cache_s,
                "merges": self.merges,
                "fallbacks": self.fallbacks,
                "last_merge_wall_ms": round(
                    self.last_merge_wall_s * 1e3, 4),
            }


class FleetObs:
    """The registry-slotted facade: one publisher + one aggregator per
    replica (runtime registry slot ``fleetobs``)."""

    def __init__(self, plane, publisher: FleetPublisher,
                 aggregator: FleetAggregator) -> None:
        self.plane = plane
        self.publisher = publisher
        self.aggregator = aggregator

    def close(self) -> None:
        """Best-effort removal of this replica's published telemetry
        (TTL covers the crash path)."""
        try:
            self.plane.backend.delete(self.publisher.metrics_key(),
                                      self.publisher.debug_key())
        except StateBackendUnavailable:
            pass

    def report(self) -> Dict[str, Any]:
        """GET /debug/fleet payload."""
        view = self.aggregator.collect()
        return {
            "replica_id": self.plane.replica_id,
            "scope": view["scope"],
            "replicas": view["replicas"],
            "skipped": view["skipped"],
            "wire_version": SNAPSHOT_VERSION,
            "publisher": self.publisher.report(),
            "aggregator": self.aggregator.report(),
            "slo": self.aggregator.slo_firing_fleet(),
        }


def build_fleet_obs(fleet_cfg: Dict[str, Any], plane,
                    registry: MetricsRegistry, flightrec=None,
                    explain=None, slo=None) -> FleetObs:
    """FleetObs from a normalized observability.fleet config block
    (config.schema.RouterConfig.fleet_obs_config); caller wires the
    publisher onto the plane's heartbeat."""
    publisher = FleetPublisher(
        plane, registry, flightrec=flightrec, explain=explain, slo=slo,
        interval_s=float(fleet_cfg.get("publish_interval_s", 0.0)),
        debug_top_n=int(fleet_cfg.get("debug_top_n", 8)))
    aggregator = FleetAggregator(
        plane, registry,
        cache_s=float(fleet_cfg.get("cache_s", 1.0)),
        debug_top_n=int(fleet_cfg.get("debug_top_n", 8)) * 4)
    return FleetObs(plane, publisher, aggregator)


__all__ = ["FleetPublisher", "FleetAggregator", "FleetObs",
           "build_fleet_obs"]
