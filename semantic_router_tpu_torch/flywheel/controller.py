"""The flywheel controller: recorded traffic → trained policy → shadow
→ canary → promote (or roll back), as one registry-slotted object (the
port's copy of ``semantic_router_tpu.flywheel.controller``).

State machine (the promotion ladder)::

    idle ──run_cycle()──▶ candidate ──eval win──▶ shadow
                              │ eval loss              │ enter_canary()
                              ▼                        ▼
                            idle                    canary ──min requests──▶ promote()
                                                       │ SLO burn                │
                                                       ▼                         ▼
                                                  rolled_back ◀──SLO burn── promoted

- **shadow**: the candidate scores every routed request's candidate set
  and its choice lands in the decision record
  (``plugins: [{plugin: "flywheel", verdict: "shadow", ...}]``) — ZERO
  routing effect, proven by the zero-behavior-change test.
- **canary**: a deterministic per-trace-id fraction of requests route
  by the candidate instead of the incumbent selector; every override is
  visible in the record and counted.
- **rollback**: any SLO alert firing (``promotion.rollback_on: any``,
  or only fast-burn pages with ``fast``) while canarying or promoted
  reverts to the incumbent selectors instantly — the same runtime-event
  bus the degradation ladder listens on.
- **promote**: the candidate replaces the incumbent selector for every
  multi-candidate decision observed in the evaluation corpus; the
  previous selectors are kept for rollback.

The controller also closes the resilience loop: after every evaluation
the per-decision value estimates (reward per device-second) roll up by
priority class over live traffic shares and land in the cost model as
admission value weights — L3 sheds by measured value, not just class
rank.

The cycle's selection trainers (``trainer.algorithms`` beyond
``cost_bandit``) fit on the bound router's engine device, inside the
engine's capture gate (``cuda`` when the router has no engine and the
controller was given no ``device``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..observability.logging import component_event
from .corpus import CorpusExporter, OutcomeBook

STATES = ("idle", "candidate", "shadow", "canary", "promoted",
          "rolled_back")


def _default_cfg() -> Dict[str, Any]:
    """Seed knobs from the ONE interpretation point
    (RouterConfig.flywheel_config over an empty config) — a
    directly-constructed controller and a bootstrap-configured one can
    never drift on defaults."""
    from ..config.schema import RouterConfig

    out = RouterConfig().flywheel_config()
    out.pop("enabled", None)
    return out


class FlywheelController:
    """One per RuntimeRegistry (``flywheel`` slot).  Disabled (the
    default) it is never constructed at all — bootstrap only builds one
    when ``flywheel.enabled`` is true, so the byte-identical posture
    costs nothing."""

    def __init__(self, registry=None, device=None) -> None:
        if registry is None:
            from ..observability.metrics import default_registry

            registry = default_registry
        # where the selection trainers fit when the router has no engine
        self.device = device
        self.cfg: Dict[str, Any] = _default_cfg()
        self.enabled = False
        self.state = "idle"
        # scheduled cycle runner (flywheel.cycle_interval_s): run_cycle
        # fires periodically instead of operator-triggered POST only
        self.cycle_interval_s = 0.0
        self.cycles_run = 0
        self._cycle_thread: Optional[threading.Thread] = None
        self._cycle_stop = threading.Event()
        # serializes run_cycle(): the scheduled runner and the operator
        # POST /debug/flywheel/cycle handler may otherwise interleave
        # candidate installation with the promotion-state transition
        self._cycle_mutex = threading.Lock()
        self.outcomes = OutcomeBook()
        self.candidate = None           # the policy under evaluation
        self.candidate_meta: Dict[str, Any] = {}
        self.last_train: Optional[Dict[str, Any]] = None
        self.last_eval: Optional[Dict[str, Any]] = None
        self.last_cycle_at = 0.0
        self.shadow_seen = 0
        self.shadow_agree = 0
        self.canary_seen = 0
        self.overrides = 0
        self.rollback_reason = ""
        self.transitions: List[Dict[str, Any]] = []
        self._saved_selectors: Dict[str, Any] = {}
        self._promoted_decisions: List[str] = []
        # (priority class → decision → count) live traffic shares for
        # the admission value roll-up
        self._class_traffic: Dict[str, Dict[str, int]] = {}
        self._lock = threading.Lock()

        # bound surfaces (bind())
        self.explain = None
        self.experience = None
        self.cost_model = None
        self.router = None
        self.event_bus = None
        self._unsubscribe = None

        self.state_gauge = registry.gauge(
            "llm_flywheel_state",
            "Flywheel promotion state (0=idle 1=candidate 2=shadow "
            "3=canary 4=promoted 5=rolled_back)")
        self.corpus_rows = registry.counter(
            "llm_flywheel_corpus_rows_total",
            "Corpus rows exported by the flywheel, by outcome source")
        self.shadow_total = registry.counter(
            "llm_flywheel_shadow_total",
            "Shadow-mode policy scores, by agreement with the "
            "incumbent")
        self.overrides_total = registry.counter(
            "llm_flywheel_overrides_total",
            "Canary requests routed by the candidate policy")
        self.transitions_total = registry.counter(
            "llm_flywheel_transitions_total",
            "Flywheel promotion-state transitions, by target state")
        self.reward_delta_gauge = registry.gauge(
            "llm_flywheel_reward_delta",
            "Latest counterfactual reward delta (candidate minus "
            "incumbent)")
        self.state_gauge.set(0.0)

    # -- configuration -----------------------------------------------------

    def configure(self, cfg: Dict[str, Any]) -> None:
        """Apply the normalized flywheel block (boot + hot reload);
        malformed values keep their previous setting."""
        cfg = dict(cfg or {})
        with self._lock:
            self.enabled = bool(cfg.get("enabled", self.enabled))
            for block in ("corpus", "features", "trainer", "evaluator",
                          "promotion", "admission"):
                if isinstance(cfg.get(block), dict):
                    merged = dict(self.cfg[block])
                    merged.update(cfg[block])
                    self.cfg[block] = merged
            self.outcomes.capacity = max(
                self.outcomes.capacity,
                int(self.cfg["corpus"]["max_rows"]))
            try:
                self.cycle_interval_s = max(0.0, float(
                    cfg.get("cycle_interval_s", self.cycle_interval_s)))
            except (TypeError, ValueError):
                pass
        # (re)arm the scheduled runner OUTSIDE the lock: interval > 0
        # starts/retunes it, 0 stops it (operator-triggered only)
        if self.cycle_interval_s > 0 and self.enabled:
            self.start_cycles(self.cycle_interval_s)
        else:
            self.stop_cycles()

    def bind(self, explain=None, events=None, experience=None,
             cost_model=None, router=None) -> "FlywheelController":
        if explain is not None:
            self.explain = explain
        if experience is not None:
            self.experience = experience
        if cost_model is not None:
            self.cost_model = cost_model
        if router is not None:
            old_router = self.router
            self.router = router
            if self.experience is None \
                    and getattr(router, "learning", None) is not None:
                self.experience = router.learning.store
            if router is not old_router and old_router is not None \
                    and self.state == "promoted" \
                    and self.candidate is not None:
                # config hot reload rebuilt the router with fresh
                # incumbent selectors; a promoted candidate must be
                # re-installed on the NEW router or "promoted" would
                # silently serve the incumbents (and a later rollback
                # would write the old router's stale selectors here)
                self._saved_selectors = {
                    name: router._selectors.get(name)
                    for name in self._promoted_decisions}
                for name in self._promoted_decisions:
                    router._selectors[name] = self.candidate
        if events is not None and events is not self.event_bus:
            if self._unsubscribe is not None:
                try:
                    self._unsubscribe()
                except Exception:
                    pass
            self.event_bus = events
            self._unsubscribe = events.subscribe(self._on_event)
        return self

    # -- state machine -----------------------------------------------------

    def _set_state(self, new: str, reason: str = "") -> None:
        with self._lock:
            old, self.state = self.state, new
            self.transitions.append({"from": old, "to": new,
                                     "reason": reason,
                                     "at_unix": time.time()})
            del self.transitions[:-64]
        try:
            self.state_gauge.set(float(STATES.index(new)))
            self.transitions_total.inc(to=new)
        except Exception:
            pass
        bus = self.event_bus
        if bus is not None:
            try:
                from ..runtime.events import FLYWHEEL_STATE_CHANGED

                bus.emit(FLYWHEEL_STATE_CHANGED, from_state=old,
                         to_state=new, reason=reason)
            except Exception:
                pass
        component_event("flywheel", "state_changed", from_state=old,
                        to_state=new, reason=reason)

    def _on_event(self, ev) -> None:
        """Canary / promoted safety net: SLO burn rolls the candidate
        back.  Must never raise."""
        try:
            from ..runtime.events import SLO_ALERT_FIRING

            if ev.stage != SLO_ALERT_FIRING:
                return
            if self.state not in ("canary", "promoted"):
                return
            severity = str(ev.detail.get("severity", "fast"))
            want = str(self.cfg["promotion"].get("rollback_on", "any"))
            if want == "fast" and severity != "fast":
                return
            self.rollback(
                f"slo_burn:{ev.detail.get('objective', '')}"
                f":{severity}")
        except Exception:
            pass

    # -- the cycle ---------------------------------------------------------

    def _work(self) -> Dict[str, Any]:
        """(device, gate) for the selection trainers: the router's engine
        device and capture gate, else ``self.device``."""
        engine = getattr(self.router, "engine", None)
        if engine is not None:
            return {"device": engine.device, "gate": engine.device_work}
        return {"device": self.device, "gate": None}

    def export_corpus(self) -> List[Dict[str, Any]]:
        exporter = CorpusExporter(
            explain=self.explain, outcomes=self.outcomes,
            experience=self.experience, cost_model=self.cost_model,
            max_rows=int(self.cfg["corpus"]["max_rows"]))
        rows = exporter.export_rows()
        path = str(self.cfg["corpus"].get("path", "") or "")
        if path:
            try:
                # archive the EXACT rows this cycle trains on
                exporter.export_jsonl(path, rows=rows)
            except OSError:
                pass
        for row in rows:
            try:
                self.corpus_rows.inc(source=row["outcome"]["source"])
            except Exception:
                pass
        return rows

    def run_cycle(self, out_dir: Optional[str] = None) -> Dict[str, Any]:
        """One full flywheel turn: export → train → counterfactual eval
        → (on win) shadow.  Returns the cycle report served at
        /debug/flywheel.  Serialized: the scheduled runner and the
        operator POST may not interleave (a half-installed candidate
        must never enter the promotion ladder)."""
        with self._cycle_mutex:
            return self._run_cycle_locked(out_dir)

    def _run_cycle_locked(self, out_dir: Optional[str] = None
                          ) -> Dict[str, Any]:
        from .evaluator import counterfactual_eval
        from .trainer import load_policy, train_policies

        t_cfg = self.cfg["trainer"]
        e_cfg = self.cfg["evaluator"]
        work = self._work()
        rows = self.export_corpus()
        report: Dict[str, Any] = {"rows": len(rows)}
        min_rows = int(e_cfg.get("min_rows", 20))
        if len(rows) < min_rows:
            report["skipped"] = (f"corpus has {len(rows)} rows < "
                                 f"min_rows={min_rows}")
            self.last_cycle_at = time.time()
            return report
        train_report = train_policies(
            rows,
            algorithms=list(t_cfg.get("algorithms") or ["cost_bandit"]),
            out_dir=out_dir or str(t_cfg.get("out_dir", "") or "")
            or None,
            dim=int(self.cfg["features"]["dim"]),
            alpha=float(t_cfg.get("alpha", 0.0)),
            cost_weight=float(t_cfg.get("cost_weight", 0.1)), **work)
        self.last_train = {
            k: {kk: vv for kk, vv in v.items() if kk != "blob"}
            if isinstance(v, dict) else v
            for k, v in train_report.items()}
        report["trained"] = list(self.last_train)

        # candidate = the first configured algorithm that trained
        candidate = meta = None
        for algo in t_cfg.get("algorithms") or ["cost_bandit"]:
            entry = train_report.get(algo) or {}
            if entry.get("blob"):
                try:
                    candidate = load_policy(entry["artifact"]
                                            or entry["blob"], **work)
                    meta = {"algorithm": algo,
                            "artifact": entry.get("artifact")}
                    break
                except Exception:
                    continue
        if candidate is None:
            report["skipped"] = "no trainable candidate"
            self.last_cycle_at = time.time()
            return report

        ev = counterfactual_eval(
            rows, candidate,
            n_boot=int(e_cfg.get("bootstrap", 200)),
            seed=int(e_cfg.get("seed", 0)),
            min_rows=min_rows)
        self.last_eval = ev
        report["eval"] = ev
        try:
            self.reward_delta_gauge.set(
                float(ev.get("reward_delta", 0.0)))
        except Exception:
            pass
        self.update_admission_weights(ev)

        # one state read under the state lock, used through the rest of
        # the decision — a rollback landing mid-cycle must not give the
        # skip-check and the report two different answers
        with self._lock:
            state = self.state
        if state in ("canary", "promoted"):
            # the current candidate is SERVING traffic: replacing it
            # mid-flight would leave the installed selectors orphaned
            # and — worse — move state out of the SLO-rollback guard's
            # window.  Cycle results stand as a report; the operator
            # rolls back (or the burn guard does) before a new
            # candidate can enter the ladder.
            report["skipped_promotion"] = (
                f"candidate already serving (state={state}); "
                f"rollback first")
            report["state"] = state
            self.last_cycle_at = time.time()
            return report

        self.candidate = candidate
        self.candidate_meta = meta or {}
        mode = str(self.cfg["promotion"].get("mode", "shadow"))
        if ev.get("evaluated") and ev.get("win") and mode != "off":
            self.enter_shadow(reason="counterfactual_win")
            report["state"] = self.state
        else:
            self._set_state("candidate",
                            "counterfactual_win" if ev.get("win")
                            else "counterfactual_loss")
            report["state"] = self.state
        self.last_cycle_at = time.time()
        return report

    # -- scheduled cycle runner (flywheel.cycle_interval_s) ----------------

    def start_cycles(self, interval_s: float) -> None:
        """Run run_cycle() every ``interval_s`` on a daemon thread
        (the flywheel turns itself instead of waiting for an operator
        POST).  Idempotent: a live
        runner just retunes its interval; cycle errors are contained
        and counted, never fatal."""
        self.cycle_interval_s = max(0.05, float(interval_s))
        if self._cycle_thread is not None \
                and self._cycle_thread.is_alive():
            return

        # each runner owns a FRESH stop event, captured in its closure:
        # stop_cycles' join(timeout) can abandon a runner mid-run_cycle,
        # and a later start_cycles must never resurrect the abandoned
        # one by clearing a SHARED event (two concurrent runners would
        # race on promotion state)
        stop = self._cycle_stop = threading.Event()

        def loop() -> None:
            while not stop.wait(self.cycle_interval_s):
                if not self.enabled:
                    continue
                try:
                    self.run_cycle()
                    with self._lock:
                        # configure() may restart the runner; the old
                        # and new loop threads must not lose a count
                        self.cycles_run += 1
                except Exception as exc:
                    component_event(
                        "flywheel", "scheduled_cycle_failed",
                        error=f"{type(exc).__name__}: {exc}"[:200],
                        level="warning")

        self._cycle_thread = threading.Thread(
            target=loop, daemon=True, name="flywheel-cycles")
        self._cycle_thread.start()

    def stop_cycles(self) -> None:
        self._cycle_stop.set()
        thread = self._cycle_thread
        self._cycle_thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=1.0)

    # -- promotion ladder --------------------------------------------------

    def enter_shadow(self, reason: str = "manual") -> None:
        if self.candidate is None:
            raise RuntimeError("no candidate policy to shadow")
        with self._lock:
            self.shadow_seen = self.shadow_agree = 0
        self._set_state("shadow", reason)

    def enter_canary(self, fraction: Optional[float] = None,
                     reason: str = "manual") -> None:
        if self.candidate is None:
            raise RuntimeError("no candidate policy to canary")
        if fraction is not None:
            self.cfg["promotion"]["canary_fraction"] = float(fraction)
        with self._lock:
            self.canary_seen = 0
        self._set_state("canary", reason)

    def promote(self, reason: str = "manual") -> List[str]:
        """Install the candidate as the serving selector for every
        multi-candidate decision seen in the evaluation corpus; returns
        the decision names it took over."""
        if self.candidate is None:
            raise RuntimeError("no candidate policy to promote")
        router = self.router
        decisions: List[str] = []
        if router is not None and self.last_eval is not None:
            eligible = set((self.last_eval.get("cost_by_decision")
                            or {}).keys())
            for dec in router.cfg.decisions:
                if dec.name in eligible \
                        and len(dec.model_refs or []) > 1:
                    self._saved_selectors[dec.name] = \
                        router._selectors.get(dec.name)
                    router._selectors[dec.name] = self.candidate
                    decisions.append(dec.name)
        self._promoted_decisions = decisions
        self._set_state("promoted", reason)
        return decisions

    def rollback(self, reason: str = "manual") -> None:
        """Revert to the incumbent selectors and stop overriding."""
        router = self.router
        if router is not None:
            for name in self._promoted_decisions:
                prev = self._saved_selectors.get(name)
                if prev is None:
                    router._selectors.pop(name, None)
                else:
                    router._selectors[name] = prev
        self._promoted_decisions = []
        self._saved_selectors = {}
        self.rollback_reason = reason
        self._set_state("rolled_back", reason)

    # -- data-plane hooks (called from Router, always fail-open) -----------

    def _canary_take(self, trace_id: str) -> bool:
        """Deterministic per-trace-id canary membership — the shared
        rightmost-bytes convention (observability.tracing
        trace_id_in_ratio), so a canaried request's record and trace
        sample together.  Unparseable ids fail CLOSED (incumbent)."""
        from ..observability.tracing import trace_id_in_ratio

        frac = float(self.cfg["promotion"].get("canary_fraction", 0.1))
        return trace_id_in_ratio(trace_id, frac, default=False)

    def on_route(self, decision, refs, chosen_ref, rec, signals,
                 trace_id: str = "", priority: str = "normal",
                 query: str = ""):
        """Per-request hook: shadow-score / canary-override.  Returns a
        ModelRef override (canary only) or None.  Never raises into
        routing (the pipeline guards, this guards again).

        The scoring context mirrors what the counterfactual evaluator
        reconstructs from corpus rows — the SAME query-redaction policy
        the records use (redact_pii ⇒ corpus queries are "", so live
        scoring must see "" too, or a query-hashing ML candidate would
        serve behavior the promotion gate never evaluated)."""
        if not self.enabled:
            return None
        with self._lock:
            cls = self._class_traffic.setdefault(priority, {})
            cls[decision.name] = cls.get(decision.name, 0) + 1
        state = self.state
        if state not in ("shadow", "canary") or self.candidate is None \
                or len(refs) < 2:
            return None
        try:
            from ..selection.base import SelectionContext

            if self.explain is not None \
                    and getattr(self.explain, "redact_pii", True):
                query = ""
            ctx = SelectionContext(
                query=query, decision_name=decision.name,
                category=next(iter(
                    signals.matches.get("domain", ())), "")
                if signals is not None else "",
                signals=signals)
            choice = self.candidate.select(list(refs), ctx)
        except Exception:
            return None
        agree = choice.ref.model == chosen_ref.model
        with self._lock:
            self.shadow_seen += 1
            self.shadow_agree += int(agree)
        try:
            self.shadow_total.inc(agree=str(agree).lower())
        except Exception:
            pass
        if state == "shadow":
            if rec is not None:
                rec.capture_plugin(
                    "flywheel", "shadow", chosen=choice.ref.model,
                    agree=agree,
                    algorithm=self.candidate_meta.get("algorithm", ""))
            return None
        # canary
        take = self._canary_take(trace_id)
        with self._lock:
            self.canary_seen += 1
            if take:
                self.overrides += 1
        if rec is not None:
            rec.capture_plugin(
                "flywheel", "canary" if take else "shadow",
                chosen=choice.ref.model, agree=agree,
                algorithm=self.candidate_meta.get("algorithm", ""))
        if not take:
            return None
        try:
            self.overrides_total.inc()
        except Exception:
            pass
        min_req = int(self.cfg["promotion"].get("canary_min_requests",
                                                200))
        if self.canary_seen >= min_req \
                and str(self.cfg["promotion"].get("mode")) == "auto":
            try:
                self.promote(reason="canary_min_requests")
            except Exception:
                pass
        return choice.ref

    def note_outcome(self, record_id: str, verdict: str,
                     quality: float = 0.0,
                     latency_ms: float = 0.0) -> None:
        """record_feedback's flywheel leg: per-request reward labels
        for the next corpus export."""
        self.outcomes.note(record_id, verdict, quality=quality,
                           latency_ms=latency_ms)

    # -- admission value weights ------------------------------------------

    def update_admission_weights(self, eval_report: Dict[str, Any]
                                 ) -> Dict[str, float]:
        """Per-decision value estimates → per-priority-class admission
        weights in the cost model.  A class's weight is the
        traffic-share-weighted mean of its decisions' values,
        normalized so the mean class weighs 1.0 and clamped to
        [floor, ceiling] — L3 buckets then charge low-value traffic
        more device-seconds per request than high-value traffic."""
        adm = self.cfg["admission"]
        if not bool(adm.get("enabled", True)) \
                or self.cost_model is None:
            return {}
        values = dict(eval_report.get("decision_values") or {})
        if not values:
            return {}
        with self._lock:
            traffic = {c: dict(d) for c, d in
                       self._class_traffic.items()}
        # normalize by the TRAFFIC-weighted mean value (not the plain
        # per-decision mean): the average routed request must keep
        # being charged ~request_cost_s, or skewed traffic would
        # silently inflate/deflate every L3 bucket's effective capacity
        total_num = total_den = 0.0
        per_class: Dict[str, tuple] = {}
        for cls, decisions in traffic.items():
            num = den = 0.0
            for dec, n in decisions.items():
                if dec in values:
                    num += values[dec] * n
                    den += n
            if den > 0:
                per_class[cls] = (num, den)
                total_num += num
                total_den += den
        if total_den <= 0:
            return {}
        mean_value = total_num / total_den
        if mean_value <= 0:
            return {}
        class_weights = {cls: num / den / mean_value
                         for cls, (num, den) in per_class.items()}
        floor = float(adm.get("floor", 0.25))
        ceil = float(adm.get("ceiling", 4.0))
        class_weights = {c: round(min(max(w, floor), ceil), 6)
                         for c, w in class_weights.items()}
        try:
            self.cost_model.set_value_weights(class_weights)
        except Exception:
            return {}
        return class_weights

    # -- reporting ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            shadow_seen = self.shadow_seen
            shadow_agree = self.shadow_agree
            canary_seen = self.canary_seen
            overrides = self.overrides
            transitions = list(self.transitions[-16:])
            traffic = {c: dict(d) for c, d in
                       self._class_traffic.items()}
        cm = self.cost_model
        return {
            "enabled": self.enabled,
            "state": self.state,
            "candidate": dict(self.candidate_meta),
            "last_cycle_at": self.last_cycle_at,
            "cycle_interval_s": self.cycle_interval_s,
            "scheduled_cycles_run": self.cycles_run,
            "corpus": {"max_rows": self.cfg["corpus"]["max_rows"],
                       "outcomes_held": len(self.outcomes)},
            "shadow": {"seen": shadow_seen, "agree": shadow_agree,
                       "agreement": round(shadow_agree
                                          / max(shadow_seen, 1), 4)},
            "canary": {
                "seen": canary_seen, "overrides": overrides,
                "fraction": self.cfg["promotion"]["canary_fraction"]},
            "promoted_decisions": list(self._promoted_decisions),
            "rollback_reason": self.rollback_reason,
            "last_train": self.last_train,
            "last_eval": self.last_eval,
            "admission_weights": dict(
                getattr(cm, "value_weights", {}) or {}) if cm else {},
            "class_traffic": traffic,
            "transitions": transitions,
        }

    def close(self) -> None:
        self.stop_cycles()
        if self._unsubscribe is not None:
            try:
                self._unsubscribe()
            except Exception:
                pass
            self._unsubscribe = None
