"""Flywheel corpus: decision records → a versioned offline training set
(the port's copy of ``semantic_router_tpu.flywheel.corpus``).

The explain layer lands replay-grade decision records in a bounded ring
(plus the durable SQLite / state-plane mirrors); router learning
(learning/experience.py) keeps per-(decision, model) verdict ledgers;
the cost model prices every routed request in device-seconds.  This
module joins the three into one **corpus row** per recorded request::

    (signal features, candidates, chosen model, outcome verdict,
     reward, latency, device-second cost)

— the offline dataset the policy trainer fits on and the counterfactual
evaluator replays against.  Rows are schema-versioned and lint-checked
exactly like decision records (``validate_row`` mirrors
``explain.validate_record``): a drift fails the flywheel-smoke gate, not
a downstream trainer.

Reward definition:

- **observed** — the router's own ``record_feedback`` verdict for this
  exact request (collected through ``FlywheelController.note_outcome``):
  good_fit=1.0, overprovisioned=0.6, underpowered=0.3, failed=0.0,
  blended with the 0-1 quality rating when one was given.
- **ledger** — no per-request outcome: the expected reward from the
  learning ledger's verdict counts for (decision, model), seeded by the
  model card's quality score (fail-open cold start, exactly the
  ledger's own semantics).
- **neutral** — no ledger either: 0.5 (the ledger's neutral seed).

Export is deterministic given the ring contents: rows sort by
(ts_unix, record_id) and serialize canonically (sorted keys, no
whitespace) so a golden corpus row can pin the bytes.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

ROW_VERSION = 1

# verdict → reward mapping (the four reference outcome classes,
# learning/experience.py VERDICTS)
VERDICT_REWARD = {
    "good_fit": 1.0,
    "overprovisioned": 0.6,
    "underpowered": 0.3,
    "failed": 0.0,
}

# required key → allowed type(s); the corpus contract
ROW_SCHEMA: Dict[str, tuple] = {
    "row_version": (int,),
    "record_id": (str,),
    "trace_id": (str,),
    "ts_unix": (float, int),
    "decision": (str,),
    "candidates": (list,),
    "chosen": (str,),
    "signals": (dict,),          # family → [[rule, confidence], ...]
    "projections": (dict, type(None)),
    "degradation_level": (int,),
    "query": (str,),
    "outcome": (dict,),          # {verdict, quality, latency_ms, source}
    "reward": (float, int),
    "cost_device_s": (float, int),
    "config_hash": (str,),
}

_OUTCOME_KEYS = ("verdict", "quality", "latency_ms", "source")


def validate_row(row: Any) -> List[str]:
    """Schema lint for one corpus row; returns problem strings (empty =
    valid)."""
    problems: List[str] = []
    if not isinstance(row, dict):
        return [f"row is {type(row).__name__}, not dict"]
    for key, types in ROW_SCHEMA.items():
        if key not in row:
            problems.append(f"missing key {key!r}")
        elif not isinstance(row[key], types):
            problems.append(
                f"{key!r} is {type(row[key]).__name__}, want "
                f"{'/'.join(t.__name__ for t in types)}")
    for extra in set(row) - set(ROW_SCHEMA):
        problems.append(f"unknown key {extra!r}")
    if problems:
        return problems
    if row["row_version"] != ROW_VERSION:
        problems.append(f"row_version {row['row_version']} != "
                        f"{ROW_VERSION}")
    for k in _OUTCOME_KEYS:
        if k not in row["outcome"]:
            problems.append(f"outcome missing {k!r}")
    if row["outcome"].get("verdict", "") not in \
            tuple(VERDICT_REWARD) + ("",):
        problems.append(
            f"unknown verdict {row['outcome'].get('verdict')!r}")
    for family, hits in row["signals"].items():
        if not isinstance(hits, list) or any(
                not (isinstance(h, list) and len(h) == 2)
                for h in hits):
            problems.append(
                f"signals[{family!r}] is not a [rule, confidence] list")
    if not (0.0 <= float(row["reward"]) <= 1.0):
        problems.append(f"reward {row['reward']} outside [0, 1]")
    try:
        json.dumps(row, sort_keys=True)
    except (TypeError, ValueError) as exc:
        problems.append(f"not JSON-serializable: {exc}")
    return problems


def row_to_json(row: Dict[str, Any]) -> str:
    """Canonical serialization — the byte-stable form the golden corpus
    fixture pins and the JSONL export writes."""
    return json.dumps(row, sort_keys=True, separators=(",", ":"))


def reward_for(verdict: str, quality: float = 0.0) -> float:
    """The ONE reward formula: verdict base, blended
    50/50 with the explicit 0-1 quality rating when one was given."""
    base = VERDICT_REWARD.get(verdict, 0.5)
    if quality > 0.0:
        return round(0.5 * base + 0.5 * min(max(quality, 0.0), 1.0), 6)
    return base


class OutcomeBook:
    """Per-record-id outcome capture: ``record_feedback`` verdicts keyed
    by decision-record id so the exporter can label rows with what
    actually happened to THIS request, not just the ledger average.
    Bounded FIFO — outcomes arrive within the ring's lifetime or not at
    all."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = max(1, int(capacity))
        self._by_record: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()

    def note(self, record_id: str, verdict: str, quality: float = 0.0,
             latency_ms: float = 0.0) -> None:
        if not record_id or verdict not in VERDICT_REWARD:
            return
        with self._lock:
            if record_id not in self._by_record:
                self._order.append(record_id)
            self._by_record[record_id] = {
                "verdict": verdict,
                "quality": round(float(quality), 6),
                "latency_ms": round(float(latency_ms), 3),
            }
            while len(self._order) > self.capacity:
                self._by_record.pop(self._order.pop(0), None)

    def get(self, record_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            out = self._by_record.get(record_id)
            return dict(out) if out else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_record)


def _ledger_reward(experience, decision: str, model: str
                   ) -> Optional[float]:
    """Expected reward from the learning ledger's verdict counts,
    seeded like the ledger itself (quality_seed × seed_weight)."""
    if experience is None:
        return None
    try:
        exp = experience.snapshot(decision, 0, model)
    except Exception:
        return None
    if exp is None:
        return None
    total = exp.total
    if total <= 0 and exp.seed_weight <= 0:
        return None
    num = (exp.good_fit * VERDICT_REWARD["good_fit"]
           + exp.overprovisioned * VERDICT_REWARD["overprovisioned"]
           + exp.underpowered * VERDICT_REWARD["underpowered"]
           + exp.failed * VERDICT_REWARD["failed"]
           + exp.quality_seed * exp.seed_weight)
    den = total + exp.seed_weight
    if den <= 0:
        return None
    return round(min(max(num / den, 0.0), 1.0), 6)


def record_to_row(record: Dict[str, Any],
                  outcomes: Optional[OutcomeBook] = None,
                  experience=None,
                  cost_model=None) -> Optional[Dict[str, Any]]:
    """One decision record → one corpus row; None for records the
    trainer can't learn from (blocked/cache-hit/shed — no model choice
    was made)."""
    if record.get("kind") != "route":
        return None
    decision = record.get("decision") or {}
    chosen = str(record.get("model", ""))
    if not chosen:
        return None
    candidates = [str(c) for c in decision.get("candidates", []) or []]
    if chosen not in candidates:
        candidates = candidates + [chosen]

    # signal view = the record's REPLAY block (the exact post-projection
    # SignalMatches the live selector saw — projection outputs and
    # composer-escalated complexity included), so row_features() is
    # bit-identical to the live signals_obj_features() the shadow/canary
    # paths compute.  Legacy records without a replay block fall back to
    # the raw per-family hits.
    signals: Dict[str, List[List[Any]]] = {}
    replay = record.get("replay") or {}
    matches = replay.get("matches") or {}
    if matches:
        confs = replay.get("confidences") or {}
        for family, names in matches.items():
            signals[str(family)] = [
                [str(n), float(confs.get(f"{family}:{n}", 1.0))]
                for n in names]
    else:
        for family, row in (record.get("signals") or {}).items():
            signals[family] = [[str(h.get("rule", "")),
                                float(h.get("confidence", 1.0))]
                               for h in (row.get("hits") or [])]

    outcome = outcomes.get(record.get("record_id", "")) \
        if outcomes is not None else None
    if outcome is not None:
        source = "observed"
        verdict = outcome["verdict"]
        quality = float(outcome.get("quality", 0.0))
        latency_ms = float(outcome.get("latency_ms", 0.0))
        reward = reward_for(verdict, quality)
    else:
        verdict, quality, latency_ms = "", 0.0, 0.0
        reward = _ledger_reward(experience, decision.get("name", ""),
                                chosen)
        source = "ledger" if reward is not None else "neutral"
        if reward is None:
            reward = 0.5

    # device-second routing cost: one learned-family row per
    # engine-backed signal (the admission controller's own estimate)
    n_learned = sum(
        1 for row in (record.get("signals") or {}).values()
        if row.get("source") in ("engine", "fused_bank"))
    cost_s = 0.0
    if cost_model is not None:
        try:
            cost_s = float(cost_model.request_cost_s(max(1, n_learned)))
        except Exception:
            cost_s = 0.0

    proj = record.get("projections")
    return {
        "row_version": ROW_VERSION,
        "record_id": str(record.get("record_id", "")),
        "trace_id": str(record.get("trace_id", "")),
        "ts_unix": record.get("ts_unix", 0),
        "decision": str(decision.get("name", "")),
        "candidates": candidates,
        "chosen": chosen,
        "signals": signals,
        "projections": dict(proj) if isinstance(proj, dict) else None,
        "degradation_level": int(record.get("degradation_level", 0)),
        "query": str(record.get("query", "")),
        "outcome": {"verdict": verdict,
                    "quality": round(quality, 6),
                    "latency_ms": round(latency_ms, 3),
                    "source": source},
        "reward": round(float(reward), 6),
        "cost_device_s": round(cost_s, 9),
        "config_hash": str(record.get("config_hash", "")),
    }


class CorpusExporter:
    """Drains sampled decision records into corpus rows.

    Sources, in order: the in-process explain ring, then the attached
    durable store (SQLite file or stateplane mirror — whatever
    ``explain.attach_durable`` bound), deduped by record id.  The
    exporter never mutates the explainer; export is a read-side join.
    """

    def __init__(self, explain=None, outcomes: Optional[OutcomeBook] = None,
                 experience=None, cost_model=None,
                 max_rows: int = 10_000) -> None:
        self.explain = explain
        self.outcomes = outcomes or OutcomeBook()
        self.experience = experience
        self.cost_model = cost_model
        self.max_rows = max(1, int(max_rows))
        self.exported = 0
        self.skipped = 0

    def _records(self) -> List[Dict[str, Any]]:
        ex = self.explain
        if ex is None:
            return []
        seen: Dict[str, Dict[str, Any]] = {}
        # kind="route" BEFORE the limit: cache-hit/blocked/shed records
        # carry no model choice, and on a high-hit-rate workload they
        # would otherwise crowd trainable rows out of the export window
        try:
            for rec in ex.list(limit=self.max_rows, kind="route"):
                seen[rec.get("record_id", "")] = rec
        except Exception:
            pass
        store = getattr(ex, "durable_store", None)
        if store is not None and len(seen) < self.max_rows:
            try:
                for rec in store.list(limit=self.max_rows,
                                      kind="route"):
                    rid = rec.get("record_id", "")
                    if rid not in seen:
                        seen[rid] = rec
            except Exception:
                pass
        return list(seen.values())

    def export_rows(self) -> List[Dict[str, Any]]:
        """All exportable rows, deterministically ordered by
        (ts_unix, record_id)."""
        rows: List[Dict[str, Any]] = []
        for rec in self._records():
            row = record_to_row(rec, outcomes=self.outcomes,
                                experience=self.experience,
                                cost_model=self.cost_model)
            if row is None:
                self.skipped += 1
                continue
            rows.append(row)
        rows.sort(key=lambda r: (r["ts_unix"], r["record_id"]))
        rows = rows[-self.max_rows:]
        self.exported += len(rows)
        return rows

    def export_jsonl(self, path: str,
                     rows: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
        """Write rows as JSONL with a manifest header line; returns the
        manifest (versioning contract: a consumer checks row_version
        before parsing rows).  Pass ``rows`` to archive an export you
        already hold — the ring keeps advancing under live traffic, so
        re-exporting here could write a DIFFERENT corpus than the one
        the caller just trained on."""
        if rows is None:
            rows = self.export_rows()
        manifest = {
            "manifest": True,
            "row_version": ROW_VERSION,
            "rows": len(rows),
            "exported_at": time.time(),
            "config_hash": rows[-1]["config_hash"] if rows else "",
        }
        with open(path, "w") as f:
            f.write(json.dumps(manifest, sort_keys=True) + "\n")
            for row in rows:
                f.write(row_to_json(row) + "\n")
        return manifest

    @staticmethod
    def load_jsonl(path: str) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                obj = json.loads(line)
                if obj.get("manifest"):
                    if obj.get("row_version") != ROW_VERSION:
                        raise ValueError(
                            f"corpus row_version "
                            f"{obj.get('row_version')} != {ROW_VERSION}")
                    continue
                rows.append(obj)
        return rows

    def stats(self) -> Dict[str, Any]:
        return {"max_rows": self.max_rows,
                "exported": self.exported,
                "skipped": self.skipped,
                "outcomes_held": len(self.outcomes)}


def rows_to_routing_records(rows: List[Dict[str, Any]]):
    """Corpus rows → training.selection_train.RoutingRecord list, so the
    existing ML trainers (knn/kmeans/svm/mlp/gmtrouter) fit straight
    from recorded traffic.  Quality = the row's reward; category = the
    winning domain-family hit (the same category signal the serving
    selectors see)."""
    from ..training.selection_train import RoutingRecord

    out = []
    for row in rows:
        domain_hits = row["signals"].get("domain") or []
        category = str(domain_hits[0][0]) if domain_hits else "other"
        out.append(RoutingRecord(
            query=row["query"] or row["record_id"],
            category=category,
            model=row["chosen"],
            quality=float(row["reward"]),
            latency_ms=float(row["outcome"].get("latency_ms", 0.0))))
    return out
