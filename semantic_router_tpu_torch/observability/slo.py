"""In-process SLO engine: declarative objectives + burn-rate monitors.

The port's copy of ``semantic_router_tpu.observability.slo``.  The router
evaluates its own objectives from the streaming histograms it already
keeps and surfaces the verdict in the ``llm_slo_*`` series,
``GET /debug/slo`` and a ``degraded`` body in ``/health``; alert
transitions go out on the runtime event bus, where the degradation
controller reads them.

Objectives come from ``observability.slo``, as a compact expression or an
explicit dict::

    observability:
      slo:
        evaluation_interval_s: 10
        objectives:
          - routing_latency p99 < 25ms over 5m
          - name: signal_errors
            objective: signal error-rate < 0.1% over 5m

``p99 < 25ms`` means at most 1% of requests may exceed 25ms: budget 1%,
and a bad event is a request above the threshold (counted from the
histogram's cumulative buckets, ``Histogram.le_total``).  Error-rate
objectives divide a failure counter by an attempt count.

Alerting is multiwindow, multi-burn-rate: with a base window *w* (the
``over`` clause) a **fast** alert fires when the budget burns > 14.4x in
both (w, 12w), a **slow** one at > 6x in both (6w, 72w).  Each tick
snapshots cumulative (good, bad) counts into a bounded ring.

Objectives scoped ``fleet`` read the fleet's merged counts, which the
fleet observability plane (``observability.fleet``, over the state
plane) publishes and this port does not serve yet: the loader refuses
them, and the monitor records one as a configuration error.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# friendly metric aliases for the compact objective DSL; raw series names
# are accepted too
METRIC_ALIASES: Dict[str, str] = {
    "routing_latency": "llm_model_routing_latency_seconds",
    "completion_latency": "llm_model_completion_latency_seconds",
    "ttft": "llm_model_ttft_seconds",
    "signal_latency": "llm_signal_latency_seconds",
    "queue_wait": "llm_batcher_queue_wait_seconds",
    "step": "llm_runtime_step_seconds",
    "decision_latency": "llm_decision_evaluation_seconds",
}

# error-rate numerator → denominator for the aliases the DSL understands;
# only numerators that count failures exclusively qualify
RATIO_ALIASES: Dict[str, Tuple[str, str]] = {
    "signal": ("llm_signal_errors_total", "llm_signal_latency_seconds"),
}

FAST_BURN = 14.4   # 2% of a 30d budget in 1h (SRE workbook page pair)
SLOW_BURN = 6.0    # 10% of a 30d budget in 6h (ticket pair)

FLEET_REFUSED = ("scope: fleet reads merged fleet counts, which the fleet "
                 "observability plane publishes; this port does not serve "
                 "it yet")

_DURATION_RE = re.compile(r"^\s*([\d.]+)\s*(ms|s|m|h|d)?\s*$")
_DUR_MULT = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
             None: 1.0}

_LATENCY_RE = re.compile(
    r"^\s*(?P<metric>[\w.]+)\s*(?:\{(?P<sel>[^}]*)\})?"
    r"\s+p(?P<pct>[\d.]+)\s*<\s*"
    r"(?P<thresh>[\d.]+\s*(?:ms|s|m)?)\s*(?:over\s+(?P<win>[\w.]+))?\s*$",
    re.IGNORECASE)
# one {label=value} member (quotes optional): per-model objectives like
# routing_latency{model=qwen3-8b} p99 < 25ms
_SEL_MEMBER_RE = re.compile(r'\s*(?P<k>\w+)\s*=\s*"?(?P<v>[^,"]*)"?\s*$')
_RATIO_RE = re.compile(
    r"^\s*(?P<metric>[\w.-]+?)\s+error[-_ ]?rate\s*<\s*"
    r"(?P<budget>[\d.]+)\s*%\s*(?:over\s+(?P<win>[\w.]+))?\s*$",
    re.IGNORECASE)


def _parse_selector(raw: Optional[str]) -> Dict[str, str]:
    """``model=qwen3-8b, tier=premium`` → label dict; a malformed member
    raises (the objective is then skipped and reported)."""
    out: Dict[str, str] = {}
    for member in (raw or "").split(","):
        if not member.strip():
            continue
        m = _SEL_MEMBER_RE.match(member)
        if not m or not m.group("v"):
            raise ValueError(f"bad label selector member {member!r}")
        out[m.group("k")] = m.group("v").strip()
    return out


def parse_duration_s(raw: Any, default: float = 300.0) -> float:
    if raw is None:
        return default
    if isinstance(raw, (int, float)):
        return float(raw)
    m = _DURATION_RE.match(str(raw))
    if not m:
        raise ValueError(f"bad duration {raw!r}")
    return float(m.group(1)) * _DUR_MULT[m.group(2)]


@dataclass
class SLOObjective:
    """One parsed objective in error-budget form: ``budget`` is the
    allowed bad fraction; ``kind`` selects how (good, bad) counts read
    from the registry."""

    name: str
    kind: str                 # "latency" | "ratio"
    metric: str               # histogram (latency) / bad counter (ratio)
    budget: float             # allowed bad fraction, e.g. 0.01 for p99
    threshold_s: float = 0.0  # latency: the bound
    total_metric: str = ""    # ratio: denominator series
    window_s: float = 300.0   # the "over" clause — the fast short window
    raw: str = ""             # original expression (reports)
    # latency objectives: restrict the histogram read to label sets
    # carrying every pair
    labels: Dict[str, str] = field(default_factory=dict)
    scope: str = "local"

    def describe(self) -> Dict[str, Any]:
        d = {"name": self.name, "kind": self.kind, "metric": self.metric,
             "budget": self.budget, "window_s": self.window_s,
             "objective": self.raw, "scope": self.scope}
        if self.kind == "latency":
            d["threshold_s"] = self.threshold_s
        else:
            d["total_metric"] = self.total_metric
        if self.labels:
            d["labels"] = dict(self.labels)
        return d

    def gauge_labels(self) -> Dict[str, str]:
        """The selector pairs as extra labels on the llm_slo_* reads;
        reserved keys never collide with the monitor's own."""
        return {k: v for k, v in self.labels.items()
                if k not in ("objective", "window", "severity")}


def parse_objective(spec: Any) -> SLOObjective:
    """Objective from a compact expression string or an explicit dict
    (``{name?, objective}`` or fully spelled-out fields).  A dict may name
    ``scope: local | fleet``."""
    scope = "local"
    if isinstance(spec, dict):
        scope = str(spec.get("scope", "local")).lower() or "local"
        if scope not in ("local", "fleet"):
            raise ValueError(f"bad SLO scope {scope!r} "
                             f"(want local|fleet)")
    obj = _parse_objective_spec(spec)
    obj.scope = scope
    if scope == "fleet" and (not isinstance(spec, dict)
                             or not spec.get("name")):
        obj.name = f"fleet:{obj.name}"
    return obj


def _parse_objective_spec(spec: Any) -> SLOObjective:
    name = ""
    if isinstance(spec, dict):
        name = str(spec.get("name", ""))
        expr = spec.get("objective", "")
        if not expr:
            # fully explicit dict form
            kind = str(spec.get("kind", "latency"))
            metric = METRIC_ALIASES.get(spec["metric"], str(spec["metric"]))
            window_s = parse_duration_s(spec.get("window", spec.get(
                "window_s", 300.0)))
            if kind == "latency":
                budget = float(spec.get(
                    "budget", 1.0 - float(spec.get("target", 0.99))))
                return SLOObjective(
                    name or f"{metric}_latency", "latency", metric,
                    budget,
                    threshold_s=parse_duration_s(spec["threshold"]),
                    window_s=window_s, raw=repr(spec),
                    labels={str(k): str(v) for k, v in
                            (spec.get("labels", {}) or {}).items()})
            return SLOObjective(
                name or f"{metric}_ratio", "ratio", metric,
                float(spec["budget"]),
                total_metric=METRIC_ALIASES.get(
                    spec.get("total_metric", ""),
                    str(spec.get("total_metric", ""))),
                window_s=window_s, raw=repr(spec))
    else:
        expr = str(spec)

    m = _LATENCY_RE.match(expr)
    if m:
        alias = m.group("metric")
        metric = METRIC_ALIASES.get(alias, alias)
        pct = float(m.group("pct"))
        if not 0.0 < pct < 100.0:
            raise ValueError(f"bad percentile p{pct} in {expr!r}")
        labels = _parse_selector(m.group("sel"))
        sel_suffix = "".join(f"[{k}={v}]"
                             for k, v in sorted(labels.items()))
        return SLOObjective(
            name or f"{alias}{sel_suffix}_p{m.group('pct')}",
            "latency", metric,
            budget=1.0 - pct / 100.0,
            threshold_s=parse_duration_s(m.group("thresh")),
            window_s=parse_duration_s(m.group("win"), 300.0),
            raw=expr, labels=labels)
    m = _RATIO_RE.match(expr)
    if m:
        alias = m.group("metric")
        bad, total = RATIO_ALIASES.get(alias, (alias, ""))
        if not total:
            raise ValueError(
                f"unknown error-rate alias {alias!r} in {expr!r} — use "
                f"the dict form with explicit metric/total_metric")
        return SLOObjective(
            name or f"{alias}_error_rate", "ratio", bad,
            budget=float(m.group("budget")) / 100.0,
            total_metric=total,
            window_s=parse_duration_s(m.group("win"), 300.0),
            raw=expr)
    raise ValueError(f"unparseable SLO objective {expr!r}")


@dataclass
class _AlertState:
    firing: bool = False
    severity: str = ""       # "fast" | "slow" when firing
    since_unix: float = 0.0
    burn: Dict[str, float] = field(default_factory=dict)


class SLOMonitor:
    """Evaluates objectives from a metrics registry's live series.

    ``tick()`` snapshots each objective's cumulative (good, bad) counts
    into a bounded ring and recomputes windowed burn rates and alert
    state; a background thread ticks every ``evaluation_interval_s`` and
    ``report()`` (GET /debug/slo) ticks inline so the view is never
    stale.  The monitor owns the ``llm_slo_*`` series; ``degraded()`` is
    the /health read (the firing objectives; no tick)."""

    def __init__(self, registry=None,
                 fast_burn: float = FAST_BURN,
                 slow_burn: float = SLOW_BURN) -> None:
        if registry is None:
            from .metrics import default_registry

            registry = default_registry
        self.registry = registry
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.enabled = False
        self.evaluation_interval_s = 10.0
        self.objectives: List[SLOObjective] = []
        # name → ring of (monotonic_t, good, bad) cumulative snapshots
        self._rings: Dict[str, List[Tuple[float, float, float]]] = {}
        self._alerts: Dict[str, _AlertState] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.config_errors: List[str] = []
        self._last_tick_t = float("-inf")
        # alert transitions go out as slo_alert_firing / _resolved on
        # this bus (bootstrap wires the registry's)
        self.event_bus = None
        # rings are bounded by the 72w horizon and by count: an
        # aggressive scraper ticking inline must not grow them
        self.max_ring = 4096

        self.burn_gauge = registry.gauge(
            "llm_slo_burn_rate",
            "Error-budget burn multiple per objective and window "
            "(1.0 = burning exactly the budget)")
        self.alert_gauge = registry.gauge(
            "llm_slo_alert_firing",
            "1 when an objective's multi-window burn-rate alert fires "
            "(severity: fast=page, slow=ticket)")
        self.sli_gauge = registry.gauge(
            "llm_slo_good_ratio",
            "Fraction of good events per objective over its base window")

    # -- configuration -----------------------------------------------------

    def configure(self, slo_cfg: Dict[str, Any]) -> None:
        """Apply the observability.slo block.  Malformed objectives (and
        fleet-scoped ones) are recorded in ``config_errors`` and skipped —
        a telemetry typo never stops the server."""
        objectives: List[SLOObjective] = []
        errors: List[str] = []
        for spec in slo_cfg.get("objectives", []) or []:
            try:
                obj = parse_objective(spec)
            except (ValueError, KeyError, TypeError) as exc:
                errors.append(f"{spec!r}: {exc}")
                continue
            if obj.scope == "fleet":
                errors.append(f"{spec!r}: {FLEET_REFUSED}")
                continue
            objectives.append(obj)
        with self._lock:
            old_by_name = {o.name: o for o in self.objectives}
            old_names = set(old_by_name)
            self.enabled = bool(slo_cfg.get("enabled", True)) \
                and bool(objectives)
            self.evaluation_interval_s = max(0.05, float(
                slo_cfg.get("evaluation_interval_s", 10.0)))
            self.fast_burn = float(slo_cfg.get("fast_burn", FAST_BURN))
            self.slow_burn = float(slo_cfg.get("slow_burn", SLOW_BURN))
            self.objectives = objectives
            self.config_errors = errors
            keep = {o.name for o in objectives}
            if not self.enabled:
                # a disabled monitor never ticks again, so firing state
                # would latch /health on "degraded" forever
                keep = set()
            for name in list(self._rings):
                if name not in keep:
                    del self._rings[name]
            for name in list(self._alerts):
                if name not in keep:
                    del self._alerts[name]
        # zero the firing gauge of every series no longer ticked
        stale = old_names - keep | ({o.name for o in objectives} - keep)
        by_name = {**old_by_name, **{o.name: o for o in objectives}}
        self._zero_alert_gauges(stale, by_name)
        # an objective that keeps its name but changes its label selector
        # stops writing the old labeled series: zero those too
        new_by_name = {o.name: o for o in objectives}
        for name in keep & old_names:
            old_obj, new_obj = old_by_name[name], new_by_name.get(name)
            if new_obj is not None and \
                    old_obj.gauge_labels() != new_obj.gauge_labels():
                self._zero_alert_gauges([name], {name: old_obj})

    def _zero_alert_gauges(self, names, by_name=None) -> None:
        for name in names:
            obj = (by_name or {}).get(name)
            extra = obj.gauge_labels() if obj is not None else {}
            for sev in ("fast", "slow"):
                self.alert_gauge.set(0.0, objective=name, severity=sev,
                                     **extra)

    def windows_for(self, obj: SLOObjective) -> Dict[str, Any]:
        """The objective's four evaluation windows from its base window
        w: fast pair (w, 12w) at fast_burn, slow pair (6w, 72w) at
        slow_burn."""
        w = obj.window_s
        return {"fast": ((w, 12 * w), self.fast_burn),
                "slow": ((6 * w, 72 * w), self.slow_burn)}

    # -- count reads -------------------------------------------------------

    def _counts(self, obj: SLOObjective) -> Tuple[float, float]:
        """Cumulative (good, bad) event counts for an objective right
        now; (0, 0) when the series does not exist yet."""
        find = getattr(self.registry, "find", None)
        if find is None:
            return 0.0, 0.0
        if obj.kind == "latency":
            h = find(obj.metric)
            if h is None or not hasattr(h, "le_total"):
                return 0.0, 0.0
            # objective-aware buckets: a 25ms bound gets an exact 25ms
            # edge (lazy: the histogram may be created after configure)
            if obj.threshold_s not in h.buckets:
                h.add_bucket_edge(obj.threshold_s)
            good, total = h.le_total(obj.threshold_s,
                                     labels=obj.labels or None)
            return float(good), float(total - good)
        bad_m = find(obj.metric)
        total_m = find(obj.total_metric)
        bad = float(bad_m.total()) if hasattr(bad_m, "total") else 0.0
        if total_m is None:
            total = bad
        elif hasattr(total_m, "totals"):  # histogram: observation count
            total = float(sum(total_m.totals().values()))
        elif hasattr(total_m, "total"):
            total = float(total_m.total())
        else:
            total = bad
        return max(0.0, total - bad), bad

    # -- evaluation --------------------------------------------------------

    def _burn_over(self, ring: List[Tuple[float, float, float]],
                   now: float, window_s: float, budget: float
                   ) -> Tuple[float, float]:
        """(burn multiple, bad fraction) over the trailing window: the
        delta between the newest snapshot at or before now - window
        (falling back to the oldest retained — a young process evaluates
        over its whole life) and the newest one."""
        if not ring:
            return 0.0, 0.0
        end = ring[-1]
        start = ring[0]
        cutoff = now - window_s
        for snap in reversed(ring):
            if snap[0] <= cutoff:
                start = snap
                break
        d_good = max(0.0, end[1] - start[1])
        d_bad = max(0.0, end[2] - start[2])
        total = d_good + d_bad
        if total <= 0:
            return 0.0, 0.0
        frac = d_bad / total
        return (frac / budget if budget > 0 else float("inf")
                if frac > 0 else 0.0), frac

    def tick(self, now: Optional[float] = None) -> None:
        """One evaluation pass: snapshot counts, recompute burns, update
        alert state and gauges.  ``now`` is injectable for tests."""
        now = time.monotonic() if now is None else now
        self._last_tick_t = time.monotonic()
        with self._lock:
            objectives = list(self.objectives)
        for obj in objectives:
            good, bad = self._counts(obj)
            windows = self.windows_for(obj)
            longest = max(w_long for (_, w_long), _ in windows.values())
            with self._lock:
                ring = self._rings.setdefault(obj.name, [])
                ring.append((now, good, bad))
                # keep one point past the horizon so the longest window
                # always has a start anchor
                while len(ring) > 2 and ring[1][0] <= now - longest:
                    ring.pop(0)
                if len(ring) > self.max_ring:
                    # count cap: thin oldest-first (every other point)
                    del ring[1:len(ring) - self.max_ring // 2:2]
                state = self._alerts.setdefault(obj.name, _AlertState())
                burns: Dict[str, float] = {}
                firing = ""
                for sev, ((w_short, w_long), threshold) in windows.items():
                    b_short, _ = self._burn_over(ring, now, w_short,
                                                 obj.budget)
                    b_long, _ = self._burn_over(ring, now, w_long,
                                                obj.budget)
                    burns[f"{sev}_short"] = b_short
                    burns[f"{sev}_long"] = b_long
                    if b_short > threshold and b_long > threshold:
                        firing = firing or sev
                _, frac = self._burn_over(ring, now, obj.window_s,
                                          obj.budget)
                was_firing, was_severity = state.firing, state.severity
                if firing and not state.firing:
                    state.since_unix = time.time()
                state.firing = bool(firing)
                state.severity = firing
                state.burn = burns
            extra = obj.gauge_labels()
            for key, b in burns.items():
                self.burn_gauge.set(round(b, 4), objective=obj.name,
                                    window=key, **extra)
            # every severity series each tick, so a cleared or changed
            # severity never latches the old one at 1.0
            for sev in ("fast", "slow"):
                self.alert_gauge.set(1.0 if firing == sev else 0.0,
                                     objective=obj.name, severity=sev,
                                     **extra)
            self.sli_gauge.set(round(1.0 - frac, 6), objective=obj.name,
                               **extra)
            # transitions → runtime events, outside the monitor lock
            # (subscribers may call back into the monitor)
            if firing != was_severity or bool(firing) != was_firing:
                self._emit_alert_event(obj, firing, was_firing, burns)

    def _emit_alert_event(self, obj: SLOObjective, firing: str,
                          was_firing: bool,
                          burns: Dict[str, float]) -> None:
        """An alert transition as a runtime event; failures are
        swallowed."""
        bus = self.event_bus
        if bus is None:
            return
        try:
            from ..runtime.events import (
                SLO_ALERT_FIRING,
                SLO_ALERT_RESOLVED,
            )

            if firing:
                bus.emit(SLO_ALERT_FIRING, objective=obj.name,
                         severity=firing, scope=obj.scope,
                         labels=dict(obj.labels),
                         burn_rates={k: round(v, 4)
                                     for k, v in burns.items()},
                         objective_raw=obj.raw)
            elif was_firing:
                bus.emit(SLO_ALERT_RESOLVED, objective=obj.name,
                         scope=obj.scope, labels=dict(obj.labels))
        except Exception:
            pass

    # -- reads -------------------------------------------------------------

    def degraded(self) -> List[str]:
        """Names of objectives whose burn-rate alert fires — the /health
        degraded flag (reads state; never ticks)."""
        with self._lock:
            return sorted(n for n, s in self._alerts.items() if s.firing)

    def report(self, tick: bool = True) -> Dict[str, Any]:
        """GET /debug/slo: every objective with its burn rates, alert
        state and windows; ticks first (at most once per evaluation
        interval, floored at 1 s) so the report is never stale."""
        min_gap = max(self.evaluation_interval_s, 1.0)
        if tick and self.objectives \
                and time.monotonic() - self._last_tick_t >= min_gap:
            try:
                self.tick()
            except Exception:
                pass
        with self._lock:
            rows = []
            for obj in self.objectives:
                state = self._alerts.get(obj.name, _AlertState())
                windows = {
                    sev: {"short_s": w_short, "long_s": w_long,
                          "burn_threshold": thr}
                    for sev, ((w_short, w_long), thr)
                    in self.windows_for(obj).items()}
                rows.append({
                    **obj.describe(),
                    "windows": windows,
                    "burn_rates": {k: round(v, 4)
                                   for k, v in state.burn.items()},
                    "firing": state.firing,
                    "severity": state.severity,
                    "since_unix": state.since_unix if state.firing
                    else None,
                    "source": "local",
                })
            return {
                "enabled": self.enabled,
                "evaluation_interval_s": self.evaluation_interval_s,
                "degraded": sorted(n for n, s in self._alerts.items()
                                   if s.firing),
                "objectives": rows,
                "config_errors": list(self.config_errors),
            }

    # -- lifecycle ---------------------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> "SLOMonitor":
        """Start (or retune) the background evaluator; idempotent."""
        if interval_s is not None:
            self.evaluation_interval_s = max(0.05, float(interval_s))
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.evaluation_interval_s):
                try:
                    self.tick()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


# the process default (single-router posture); no objectives and no
# thread until bootstrap configures it
default_slo_monitor = SLOMonitor()
