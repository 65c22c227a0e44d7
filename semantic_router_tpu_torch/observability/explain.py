"""Decision explainability: per-request routing audit records.

The port's copy of ``semantic_router_tpu.observability.explain``.  Tracing
and runtime stats answer *how fast*; this layer answers the question a
Mixture-of-Models operator asks first when a request lands on the wrong
backend: **why did the router pick that model?**  For every non-passthrough request the
pipeline assembles one *decision record* — every signal family's hits
with source + latency, the projection outputs, the FULL rule-evaluation
tree (every ``eval_rule_node`` outcome, not just the winner), the
per-candidate selector score breakdown, the plugin-chain verdicts
(cache / jailbreak / PII), and the final model with its fallback reason
— and lands it in a bounded in-process ring.

Records are *replay-grade*: the ``replay`` block carries the exact
``SignalMatches`` payload the decision engine saw, so a replay can
deterministically re-drive the decision engine offline under another
config (the reference's ``replay.recorder.replay_decision``).

Cost posture: record assembly is a handful of dict builds on the routing
thread — no device work, no locks beyond the ring append — gated by
``observability.decisions.{enabled,sample_rate}`` (deterministic per
trace id, same convention as batch-trace sampling).  PII posture:
``redact_pii`` (default ON) drops the query text and the pii family's
detail payload from the record.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# record-id generator: urandom-seeded once, then in-process PRNG — a
# getrandom() syscall per record costs more than the whole assembly on
# older kernels, and record ids only need ring-local uniqueness
_rand = random.Random(int.from_bytes(os.urandom(8), "big"))
_rand_lock = threading.Lock()


def _new_record_id() -> str:
    with _rand_lock:
        return f"{_rand.getrandbits(64):016x}"

SCHEMA_VERSION = 1

# The record contract (validated by validate_record — the same spirit as
# the metrics exposition lint: a schema drift fails the explain-smoke
# gate, not a downstream audit consumer).  Maps required key → allowed
# type(s).
RECORD_SCHEMA: Dict[str, tuple] = {
    "schema_version": (int,),
    "record_id": (str,),
    "trace_id": (str,),
    "request_id": (str,),
    "ts_unix": (float, int),
    "kind": (str,),
    "model": (str,),
    "decision": (dict, type(None)),
    "fallback_reason": (str,),
    "routing_latency_ms": (float, int),
    "signals": (dict,),
    "projections": (dict, type(None)),
    "rule_trace": (list,),
    "selection": (dict, type(None)),
    "plugins": (list,),
    "replay": (dict,),
    "query": (str,),
    "config_hash": (str,),
    # resilience/controller.py: the degradation-ladder level this
    # request routed under — a replay of a brownout-era record must know
    # learned signals were intentionally absent, not broken
    "degradation_level": (int,),
    # resilience/upstream.py: the forward attempt ladder when the proxy
    # path failed over ([] for the clean single-attempt case) — each
    # entry {model, endpoint, outcome, status[, latency_ms]}, stamped
    # after the forward completes via DecisionExplainer.annotate
    "failover_path": (list,),
    # engine/cascade: learned families whose forwards were skipped
    # (never submitted or cancelled) by the early-exit cascade — [] on
    # the full fan-out.  A replay of a cascade-era record must know the
    # families were intentionally absent, not broken.
    "skipped_families": (list,),
    # engine/cascade: the full skip certificate (planner version,
    # submission order, waves, per-family skip reasons, decided winner)
    # — replay.recorder.rederive_cascade_skips re-checks it against the
    # recorded matches.  None = cascade not in the path.
    "cascade": (dict, type(None)),
}

_SIGNAL_KEYS = ("source", "latency_ms", "error", "hits")
_RULE_ENTRY_KEYS = ("decision", "matched", "confidence", "matched_rules",
                    "tree")


def validate_record(rec: Any) -> List[str]:
    """Schema lint for one decision record; returns problem strings
    (empty = valid).  Checks the key/type contract plus the nested
    shapes audit consumers key on."""
    problems: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not dict"]
    for key, types in RECORD_SCHEMA.items():
        if key not in rec:
            problems.append(f"missing key {key!r}")
        elif not isinstance(rec[key], types):
            problems.append(
                f"{key!r} is {type(rec[key]).__name__}, want "
                f"{'/'.join(t.__name__ for t in types)}")
    for extra in set(rec) - set(RECORD_SCHEMA):
        problems.append(f"unknown key {extra!r}")
    if problems:
        return problems
    if rec["schema_version"] != SCHEMA_VERSION:
        problems.append(f"schema_version {rec['schema_version']} != "
                        f"{SCHEMA_VERSION}")
    for family, row in rec["signals"].items():
        for k in _SIGNAL_KEYS:
            if not isinstance(row, dict) or k not in row:
                problems.append(f"signals[{family!r}] missing {k!r}")
    for i, entry in enumerate(rec["rule_trace"]):
        for k in _RULE_ENTRY_KEYS:
            if not isinstance(entry, dict) or k not in entry:
                problems.append(f"rule_trace[{i}] missing {k!r}")
    sel = rec["selection"]
    if isinstance(sel, dict):
        for k in ("algorithm", "reason", "candidates"):
            if k not in sel:
                problems.append(f"selection missing {k!r}")
    rep = rec["replay"]
    for k in ("matches", "confidences"):
        if k not in rep:
            problems.append(f"replay missing {k!r}")
    try:
        json.dumps(rec, sort_keys=True)
    except (TypeError, ValueError) as exc:
        problems.append(f"not JSON-serializable: {exc}")
    return problems


def record_to_json(rec: Dict[str, Any]) -> str:
    """Canonical serialization (sorted keys, no whitespace drift) — the
    byte-stable form the golden test pins and the OTLP log body ships."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _jsonable(value: Any) -> Any:
    """Defensive copy into plain JSON types; unknown objects stringify
    (signal details may carry numpy scalars etc.)."""
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, str)):
        return value
    if isinstance(value, float):
        return round(value, 6)
    try:  # numpy scalars expose item()
        return _jsonable(value.item())
    except AttributeError:
        return str(value)


class RecordDraft:
    """Mutable capture surface the pipeline fills as the request flows;
    ``finish()`` freezes it into the schema dict.  Creating a draft is
    the sampling decision — every later capture call is a cheap
    attribute write guarded by ``if rec is not None``."""

    __slots__ = ("trace_id", "request_id", "signals", "projections",
                 "rule_trace", "decision", "selection", "plugins",
                 "fallback_reason", "query", "replay_payload",
                 "degradation_level", "cascade_cert")

    def __init__(self, trace_id: str, request_id: str) -> None:
        self.trace_id = trace_id
        self.request_id = request_id
        self.signals: Dict[str, Any] = {}
        self.projections: Optional[Dict[str, Any]] = None
        self.rule_trace: List[Dict[str, Any]] = []
        self.decision: Optional[Dict[str, Any]] = None
        self.selection: Optional[Dict[str, Any]] = None
        self.plugins: List[Dict[str, Any]] = []
        self.fallback_reason = ""
        self.query = ""
        self.replay_payload: Dict[str, Any] = {}
        self.degradation_level = 0
        self.cascade_cert: Optional[Dict[str, Any]] = None

    # -- capture methods (called from router.pipeline) --------------------

    def capture_signals(self, signals, report, redact_pii: bool) -> None:
        """Per-family value + source + latency from the dispatch report,
        plus the replay-grade SignalMatches payload."""
        for family, res in report.results.items():
            row = {
                "source": res.source or "heuristic",
                "latency_ms": res.latency_s * 1e3,
                "error": res.error or "",
                "hits": [{"rule": h.rule, "confidence": float(h.confidence)}
                         for h in res.hits],
            }
            if res.metrics:
                # kb-family metric outputs (kb_metric projection
                # inputs): captured so replay can re-drive projections
                # from raw hits; only present when the family produced
                # metrics, so metric-free records keep their bytes
                row["metrics"] = _jsonable(res.metrics)
            self.signals[family] = row
        pt = report.projection_trace
        if pt is not None:
            self.projections = {
                "partitions": _jsonable(pt.partitions),
                "scores": _jsonable(pt.scores),
                "mappings": _jsonable(pt.mappings),
            }
        details = {k: _jsonable(v) for k, v in signals.details.items()
                   if not (redact_pii and k == "pii")}
        # exact float values (no rounding): the replay block must
        # re-drive the decision engine bit-identically
        self.replay_payload = {
            "matches": {k: list(v) for k, v in signals.matches.items()},
            "confidences": {k: float(v)
                            for k, v in signals.confidences.items()},
            "details": details,
        }

    def capture_rule_trace(self, entries) -> None:
        """Every decision's evaluation outcome with its full tree
        (decision.engine.DecisionTraceEntry, tree included)."""
        self.rule_trace = [{
            "decision": e.decision,
            "matched": bool(e.matched),
            "confidence": round(float(e.confidence), 6),
            "matched_rules": list(e.matched_rules),
            "tree": _jsonable(e.tree) if e.tree is not None else None,
        } for e in entries]

    def capture_decision(self, decision_res, strategy: str) -> None:
        d = decision_res.decision
        self.decision = {
            "name": d.name,
            "priority": int(d.priority),
            "strategy": strategy,
            "confidence": round(float(decision_res.confidence), 6),
            "matched_rules": list(decision_res.matched_rules),
            "candidates": [r.model for r in (d.model_refs or [])],
        }

    def capture_selection(self, algorithm: str, reason: str,
                          chosen: str, breakdown) -> None:
        self.selection = {
            "algorithm": algorithm,
            "reason": reason,
            "chosen": chosen,
            "candidates": _jsonable(breakdown or []),
        }

    def capture_cascade(self, cert) -> None:
        """The cascade skip certificate (engine/cascade DispatchReport
        ``cascade`` field) — recorded verbatim so replay can re-derive
        the skips against the captured matches."""
        self.cascade_cert = _jsonable(cert) if cert is not None else None

    def capture_plugin(self, plugin: str, verdict: str, **detail) -> None:
        row = {"plugin": plugin, "verdict": verdict}
        if detail:
            row["detail"] = _jsonable(detail)
        self.plugins.append(row)

    # -- freeze ------------------------------------------------------------

    def finish(self, *, kind: str, model: str, latency_ms: float,
               query: str, redact_pii: bool,
               config_hash: str = "") -> Dict[str, Any]:
        return {
            "schema_version": SCHEMA_VERSION,
            "record_id": _new_record_id(),
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "ts_unix": time.time(),
            "kind": kind,
            "model": model,
            "decision": self.decision,
            "fallback_reason": self.fallback_reason,
            "routing_latency_ms": round(latency_ms, 3),
            "signals": self.signals,
            "projections": self.projections,
            "rule_trace": self.rule_trace,
            "selection": self.selection
            or {"algorithm": "", "reason": "", "chosen": model,
                "candidates": []},
            "plugins": self.plugins,
            "replay": self.replay_payload
            or {"matches": {}, "confidences": {}, "details": {}},
            "query": "" if redact_pii else query,
            "config_hash": config_hash,
            "degradation_level": int(self.degradation_level),
            "failover_path": [],
            "skipped_families": sorted(
                (self.cascade_cert or {}).get("skipped", {})),
            "cascade": self.cascade_cert,
        }


class DecisionExplainer:
    """Bounded in-process ring of decision records + the knobs and query
    surface.  Registry-slotted (``RuntimeRegistry`` ``explain`` slot) so
    embedded routers keep separate audit trails; ``sinks`` feed export
    (the durable mirror, exporters)."""

    def __init__(self, ring_size: int = 512, enabled: bool = True,
                 sample_rate: float = 1.0,
                 redact_pii: bool = True) -> None:
        self.enabled = enabled
        self.ring_size = max(1, int(ring_size))
        self.sample_rate = float(sample_rate)
        self.redact_pii = bool(redact_pii)
        self._ring: List[Dict[str, Any]] = []
        self._by_id: Dict[str, Dict[str, Any]] = {}   # record_id → record
        self._by_trace: Dict[str, str] = {}           # trace_id → record_id
        self._lock = threading.Lock()
        self.sinks: List[Callable[[Dict[str, Any]], None]] = []
        self.recorded = 0
        self.dropped = 0
        # annotate() re-deliveries to sinks (post-commit failover_path
        # stamps re-exporting so the OTLP log line carries them)
        self.re_exported = 0
        # optional durable backend (observability/explain_store.py):
        # attached by bootstrap from observability.decisions.durable so
        # post-restart audits survive the in-process ring
        self.durable_store = None
        self._durable_sink: Optional[Callable] = None

    # -- configuration -----------------------------------------------------

    def configure(self, cfg: Dict[str, Any]) -> None:
        """Apply observability.decisions knobs (boot + hot reload); a
        malformed knob keeps the previous value — telemetry config must
        never stop the server."""
        with self._lock:
            self.enabled = bool(cfg.get("enabled", self.enabled))
            try:
                self.sample_rate = float(
                    cfg.get("sample_rate", self.sample_rate))
            except (TypeError, ValueError):
                pass
            try:
                size = int(cfg.get("ring_size", self.ring_size))
                if size > 0:
                    self.ring_size = size
            except (TypeError, ValueError):
                pass
            self.redact_pii = bool(cfg.get("redact_pii", self.redact_pii))
            self._trim_locked()

    def attach_durable(self, store) -> None:
        """Attach (or replace) the durable record store: records commit
        to the ring AND the store's ``add``; a previous store's sink is
        detached first so hot reloads never double-write.  ``None``
        detaches."""
        with self._lock:
            if self._durable_sink is not None:
                try:
                    self.sinks.remove(self._durable_sink)
                except ValueError:
                    pass
                self._durable_sink = None
            old = self.durable_store
            self.durable_store = store
            if store is not None:
                sink = store.add
                self._durable_sink = sink
                self.sinks.append(sink)
        if old is not None and old is not store:
            try:
                old.close()
            except Exception:
                pass

    # -- recording ---------------------------------------------------------

    def begin(self, trace_id: str, request_id: str
              ) -> Optional[RecordDraft]:
        """The sampling gate: a draft when this request records, else
        None (every capture site downstream is a no-op).  Deterministic
        per trace id — the same rightmost-bytes ratio convention as
        batch-trace sampling, so a request's record and its detailed
        trace sample together."""
        if not self.enabled:
            return None
        from .tracing import trace_id_in_ratio

        if not trace_id_in_ratio(trace_id, self.sample_rate,
                                 default=True):
            return None
        return RecordDraft(trace_id, request_id)

    def commit(self, record: Dict[str, Any]) -> str:
        """Ring-append a finished record; returns its record id.  Sink
        errors never surface into routing."""
        with self._lock:
            self._ring.append(record)
            self._by_id[record["record_id"]] = record
            self._by_trace[record["trace_id"]] = record["record_id"]
            self.recorded += 1
            self._trim_locked()
        for sink in list(self.sinks):
            try:
                sink(record)
            except Exception:
                pass
        return record["record_id"]

    def annotate(self, key: str, **fields: Any) -> bool:
        """Post-commit annotation of a ringed record (the forward path
        finishes AFTER route() committed the record — failover_path can
        only land here).  Schema-gated: unknown keys are dropped so an
        annotation can never break validate_record.

        The annotated record RE-DELIVERS to every sink: the commit-time
        export left (e.g.) the OTLP log line without the failover_path
        it was annotated with, so export-shaped sinks receive a second
        delivery of the same record id carrying the annotation
        (consumers key on record_id — last write wins) and the durable
        mirror upserts in place.  Counted in ``re_exported``."""
        rec = self.get(key)
        if rec is None:
            return False
        clean = {k: _jsonable(v) for k, v in fields.items()
                 if k in RECORD_SCHEMA}
        if not clean:
            return False
        with self._lock:
            rec.update(clean)
            self.re_exported += 1
        for sink in list(self.sinks):
            try:
                sink(rec)
            except Exception:
                pass
        return True

    def _trim_locked(self) -> None:
        while len(self._ring) > self.ring_size:
            old = self._ring.pop(0)
            self.dropped += 1
            self._by_id.pop(old["record_id"], None)
            if self._by_trace.get(old["trace_id"]) == old["record_id"]:
                self._by_trace.pop(old["trace_id"], None)

    # -- queries (GET /debug/decisions*) -----------------------------------

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """Record by record id OR trace id (the extproc echoes the record
        id; traces cross-link through the trace id)."""
        with self._lock:
            rec = self._by_id.get(key)
            if rec is None:
                rid = self._by_trace.get(key)
                rec = self._by_id.get(rid) if rid else None
            return rec

    def list(self, limit: int = 50, model: str = "", decision: str = "",
             rule: str = "", family: str = "",
             kind: str = "") -> List[Dict[str, Any]]:
        """Newest-first filtered listing.  ``rule`` matches any
        "type:name" in the winning decision's matched rules; ``family``
        matches any signal family that produced hits."""
        limit = max(0, int(limit))
        out: List[Dict[str, Any]] = []
        if limit == 0:
            return out
        with self._lock:
            ring = list(self._ring)
        for rec in reversed(ring):
            if model and rec.get("model") != model:
                continue
            if kind and rec.get("kind") != kind:
                continue
            if decision and (rec.get("decision") or {}).get("name") \
                    != decision:
                continue
            if rule and rule not in (rec.get("decision") or {}).get(
                    "matched_rules", ()):
                continue
            if family:
                row = rec.get("signals", {}).get(family)
                if not row or not row.get("hits"):
                    continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": self.enabled,
                    "sample_rate": self.sample_rate,
                    "redact_pii": self.redact_pii,
                    "ring_size": self.ring_size,
                    "retained": len(self._ring),
                    "recorded": self.recorded,
                    "dropped": self.dropped,
                    "re_exported": self.re_exported}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_id.clear()
            self._by_trace.clear()


# process-global default (single-router posture); bootstrap configures
# knobs from observability.decisions
default_decision_explainer = DecisionExplainer()
