"""Grafana dashboard generation from the metric catalog.

The port's copy of ``semantic_router_tpu.observability.grafana``: the CLI
(``python -m semantic_router_tpu_torch grafana --out-dir DIR``) renders
provisioning-ready Grafana dashboard JSON so operators monitor the
router without hand-building panels.  The dashboards are generated
from the live metric registry (observability/metrics.py ``families()``)
plus a curated panel catalog for the canonical series, so a metric added
to the registry automatically appears on the "catalog" dashboard.

Output: one JSON file per dashboard + a provisioning provider file,
layout compatible with Grafana's dashboard provisioning directory
(`grafana/provisioning/dashboards/`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from .metrics import default_registry

_DATASOURCE = {"type": "prometheus", "uid": "${DS_PROMETHEUS}"}


def _panel(title: str, exprs: List[str], *, unit: str = "short",
           panel_id: int = 1, x: int = 0, y: int = 0, w: int = 12,
           h: int = 8, legends: Optional[List[str]] = None) -> Dict:
    targets = []
    for i, expr in enumerate(exprs):
        t = {"expr": expr, "refId": chr(ord("A") + i),
             "datasource": _DATASOURCE}
        if legends and i < len(legends):
            t["legendFormat"] = legends[i]
        targets.append(t)
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "datasource": _DATASOURCE,
        "gridPos": {"x": x, "y": y, "w": w, "h": h},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": targets,
    }


def _stat(title: str, expr: str, *, unit: str = "short", panel_id: int = 1,
          x: int = 0, y: int = 0, w: int = 6, h: int = 4) -> Dict:
    return {
        "id": panel_id, "title": title, "type": "stat",
        "datasource": _DATASOURCE,
        "gridPos": {"x": x, "y": y, "w": w, "h": h},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": [{"expr": expr, "refId": "A",
                     "datasource": _DATASOURCE}],
    }


def _text_panel(title: str, markdown: str, *, panel_id: int = 1,
                x: int = 0, y: int = 0, w: int = 12, h: int = 8) -> Dict:
    """Markdown text panel — the link surface for in-process debug
    endpoints (flight recorder, SLO report) that have no Prometheus
    series to chart."""
    return {
        "id": panel_id, "title": title, "type": "text",
        "gridPos": {"x": x, "y": y, "w": w, "h": h},
        "options": {"mode": "markdown", "content": markdown},
        "targets": [],  # text panels query nothing
    }


def _dashboard(uid: str, title: str, panels: List[Dict],
               tags: Optional[List[str]] = None) -> Dict:
    return {
        "uid": uid,
        "title": title,
        "tags": ["semantic-router-tpu"] + (tags or []),
        "timezone": "browser",
        "schemaVersion": 39,
        "version": 1,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "templating": {"list": [{
            "name": "DS_PROMETHEUS", "type": "datasource",
            "query": "prometheus", "label": "Prometheus",
        }]},
        "panels": panels,
    }


def _hist_quantiles(name: str, by: str = "") -> List[str]:
    grp = f", {by}" if by else ""
    return [f"histogram_quantile({q}, sum(rate({name}_bucket[5m])) "
            f"by (le{grp}))" for q in (0.5, 0.95, 0.99)]


def router_overview() -> Dict:
    p = [
        _stat("Requests / s",
              "sum(rate(llm_model_requests_total[5m]))", panel_id=1,
              x=0, y=0),
        _stat("Cost / h (USD)",
              "sum(rate(llm_model_cost_total[5m])) * 3600",
              unit="currencyUSD", panel_id=2, x=6, y=0),
        _stat("Cache hit ratio",
              'sum(rate(llm_cache_lookups_total{outcome="hit"}[5m])) / '
              "sum(rate(llm_cache_lookups_total[5m]))",
              unit="percentunit", panel_id=3, x=12, y=0),
        _stat("Blocked / s",
              # `or vector(0)`: counters expose no samples before their
              # first increment, and a binary op with an empty operand
              # yields an empty vector ("No data" despite real blocks)
              "(sum(rate(llm_jailbreak_blocked_total[5m])) or vector(0))"
              " + "
              "(sum(rate(llm_pii_violations_total[5m])) or vector(0))",
              panel_id=4, x=18, y=0),
        _panel("Requests by model",
               ["sum(rate(llm_model_requests_total[5m])) by (model)"],
               panel_id=5, x=0, y=4, legends=["{{model}}"]),
        _panel("Added routing latency",
               _hist_quantiles("llm_model_routing_latency_seconds"),
               unit="s", panel_id=6, x=12, y=4,
               legends=["p50", "p95", "p99"]),
        _panel("Completion latency by model",
               ["histogram_quantile(0.95, sum(rate("
                "llm_model_completion_latency_seconds_bucket[5m])) "
                "by (le, model))"],
               unit="s", panel_id=7, x=0, y=12,
               legends=["p95 {{model}}"]),
        _panel("Cost by model",
               ["sum(rate(llm_model_cost_total[5m])) by (model)"],
               unit="currencyUSD", panel_id=8, x=12, y=12,
               legends=["{{model}}"]),
    ]
    return _dashboard("srt-overview", "Semantic Router — Overview", p)


def signals_decisions() -> Dict:
    p = [
        _panel("Signal latency by family (p95)",
               ["histogram_quantile(0.95, sum(rate("
                "llm_signal_latency_seconds_bucket[5m])) "
                "by (le, family))"],
               unit="s", panel_id=1, x=0, y=0,
               legends=["{{family}}"]),
        _panel("Decision matches",
               ["sum(rate(llm_decision_matches_total[5m])) by (decision)"],
               panel_id=2, x=12, y=0, legends=["{{decision}}"]),
        _panel("Decision engine latency",
               _hist_quantiles("llm_decision_evaluation_seconds"),
               unit="s", panel_id=3, x=0, y=8,
               legends=["p50", "p95", "p99"]),
        _panel("Device batch sizes",
               _hist_quantiles("llm_classifier_batch_size"),
               panel_id=4, x=12, y=8, legends=["p50", "p95", "p99"]),
    ]
    return _dashboard("srt-signals", "Semantic Router — Signals & "
                      "Decisions", p, tags=["signals"])


def safety() -> Dict:
    p = [
        _panel("PII violations",
               ["sum(rate(llm_pii_violations_total[5m])) by (policy)"],
               panel_id=1, x=0, y=0, legends=["{{policy}}"]),
        _panel("Jailbreak blocks",
               ["sum(rate(llm_jailbreak_blocked_total[5m]))"],
               panel_id=2, x=12, y=0),
        _panel("Hallucination detection latency",
               _hist_quantiles(
                   "llm_hallucination_detection_latency_seconds"),
               unit="s", panel_id=3, x=0, y=8,
               legends=["p50", "p95", "p99"]),
    ]
    return _dashboard("srt-safety", "Semantic Router — Safety", p,
                      tags=["safety"])


def serving() -> Dict:
    p = [
        _panel("TTFT", _hist_quantiles("llm_model_ttft_seconds",
                                       by="model"),
               unit="s", panel_id=1, x=0, y=0),
        _panel("TPOT", _hist_quantiles("llm_model_tpot_seconds",
                                       by="model"),
               unit="s", panel_id=2, x=12, y=0),
        _panel("Cache lookups by outcome",
               ["sum(rate(llm_cache_lookups_total[5m])) by (outcome)"],
               panel_id=3, x=0, y=8, legends=["{{outcome}}"]),
    ]
    return _dashboard("srt-serving", "Semantic Router — Serving", p,
                      tags=["serving"])


_FLIGHTREC_MD = """\
The router keeps its own evidence in-process — no collector required:

- **Flight recorder** — full span trees for the slowest-N requests and
  every `threshold_ms` breach (tail-kept: retained traces are pinned
  force-sampled, so their continued activity gets detailed batch
  tracing):
  `GET http://<router>/debug/flightrec` · clear with
  `POST /debug/flightrec/clear`
- **SLO report** — objectives, per-window burn rates, firing alerts:
  `GET http://<router>/debug/slo` (the same verdict `/health` summarizes
  as `degraded`)
- **Runtime stats** — per-jit-program compile/execute registry,
  padding-waste accounting, process/device gauges:
  `GET http://<router>/debug/runtime`

All three are management-API routes (same RBAC gate as `/config/*`).
See docs/OBSERVABILITY.md.
"""


def runtime_slo() -> Dict:
    """The "Runtime & SLO" row: always-on engine health —
    step-time quantiles, compile/padding accounting, process/device
    gauges — next to the in-process SLO burn rates and a link panel
    into the flight-recorder / SLO / runtime debug dumps."""
    p = [
        _panel("SLO burn rate (fast window)",
               ['sum(llm_slo_burn_rate{window="fast_short"}) '
                "by (objective)"],
               panel_id=1, x=0, y=0, legends=["{{objective}}"]),
        _stat("SLO alerts firing",
              "sum(llm_slo_alert_firing) or vector(0)",
              panel_id=2, x=12, y=0),
        _stat("Good-event ratio (worst objective)",
              "min(llm_slo_good_ratio)",
              unit="percentunit", panel_id=3, x=18, y=0),
        _panel("Device step time by group (p95)",
               ["histogram_quantile(0.95, sum(rate("
                "llm_runtime_step_seconds_bucket[5m])) by (le, group))"],
               unit="s", panel_id=4, x=0, y=8, legends=["{{group}}"]),
        _panel("XLA compiles / padding waste",
               ["sum(rate(llm_runtime_program_compiles_total[5m])) "
                "by (group)",
                'sum(rate(llm_runtime_step_rows_total{kind="padding"}'
                "[5m])) / sum(rate(llm_runtime_step_rows_total[5m]))"],
               panel_id=5, x=12, y=8,
               legends=["compiles {{group}}", "padding waste ratio"]),
        _panel("Host RSS / device memory",
               ["llm_process_rss_bytes",
                'sum(llm_device_memory_bytes{stat="bytes_in_use"}) '
                "by (device)"],
               unit="bytes", panel_id=6, x=0, y=16,
               legends=["rss", "device {{device}}"]),
        _panel("Dispatcher queues & pool saturation",
               ['sum(llm_dispatcher_queue_depth{stat="pending_items"}) '
                "by (batcher)",
                'sum(llm_dispatcher_queue_depth{stat="pool_saturation"})'
                " by (batcher)"],
               panel_id=7, x=12, y=16,
               legends=["queued {{batcher}}", "saturation {{batcher}}"]),
        _panel("GC pauses (p99)",
               ["histogram_quantile(0.99, sum(rate("
                "llm_gc_pause_seconds_bucket[5m])) by (le))"],
               unit="s", panel_id=8, x=0, y=24),
        _text_panel("Flight recorder & debug dumps", _FLIGHTREC_MD,
                    panel_id=9, x=12, y=24),
        _panel("Cascade skipped forwards / waves",
               ["sum(rate(llm_engine_cascade_skipped_forwards_total"
                "[5m])) by (family)",
                "sum(rate(llm_engine_cascade_waves_total[5m]))"],
               panel_id=10, x=0, y=32,
               legends=["skipped {{family}}", "waves"]),
    ]
    return _dashboard("srt-runtime-slo", "Semantic Router — Runtime & "
                      "SLO", p, tags=["runtime", "slo"])


_DECISIONS_MD = """\
Every routed request leaves a **decision record** — signals (value,
source, latency), projections, the full rule-evaluation tree, the
per-candidate selector scores, plugin verdicts, and the final model
with its fallback reason:

- `GET /debug/decisions` — filtered listing (`?model=` / `?decision=` /
  `?rule=` / `?family=`)
- `GET /debug/decisions/<id>` — one record, by record id (echoed on
  responses as `x-vsr-decision-record`) or trace id
- `POST /debug/decisions/<id>/replay` — deterministically re-drive the
  decision engine over the stored signals; pass `{"config": {...}}` for
  the counterfactual ("would config v2 have routed this differently?")

Records cross-link to the flight recorder and batch-trace spans via the
trace id, and export as OTLP log records when `otlp_endpoint` is set.
See docs/OBSERVABILITY.md § Decision explainability.
"""


def decisions() -> Dict:
    """The "Decisions" dashboard: routing mix, fallback rate,
    rule-hit frequencies, record-ring accounting, and a link panel into
    the decision-record debug endpoints."""
    p = [
        _panel("Routing mix (requests by decision)",
               ["sum(rate(llm_model_requests_total[5m])) by (decision)"],
               panel_id=1, x=0, y=0, legends=["{{decision}}"]),
        _panel("Routing mix (requests by model)",
               ["sum(rate(llm_model_requests_total[5m])) by (model)"],
               panel_id=2, x=12, y=0, legends=["{{model}}"]),
        _stat("Fallback rate",
              "(sum(rate(llm_decision_fallbacks_total[5m])) or vector(0))"
              " / sum(rate(llm_model_requests_total[5m]))",
              unit="percentunit", panel_id=3, x=0, y=8),
        _panel("Fallbacks by reason",
               ["sum(rate(llm_decision_fallbacks_total[5m])) by (reason)"],
               panel_id=4, x=6, y=8, w=6, legends=["{{reason}}"]),
        _panel("Rule-hit frequencies",
               ["sum(rate(llm_decision_rule_hits_total[5m])) by (rule)"],
               panel_id=5, x=12, y=8, legends=["{{rule}}"]),
        _panel("Decision records committed",
               ["sum(rate(llm_decision_records_total[5m])) by (kind)"],
               panel_id=6, x=0, y=16, legends=["{{kind}}"]),
        _text_panel("Decision explainability", _DECISIONS_MD,
                    panel_id=7, x=12, y=16),
    ]
    return _dashboard("srt-decisions", "Semantic Router — Decisions", p,
                      tags=["decisions", "explainability"])


_RESILIENCE_MD = """\
The degradation ladder (docs/RESILIENCE.md) closes the loop from the
SLO engine to the data plane:

- **L1** sheds optional work (cache writes, compression, trace
  sampling), **L2** browns out learned signals for low-priority
  traffic, **L3** admission-controls with cost-model token buckets
  (lowest class gets 429 + Retry-After), **L4** serves the static
  default model with zero signal extraction.
- `GET /debug/resilience` — level, pressure inputs, bucket fills,
  cost-model estimates, transition history
- Responses under degradation carry `x-vsr-degradation-level`; decision
  records annotate the level so replays of brownout-era traffic stay
  honest.

Every transition is a `degradation_level_changed` runtime event — the
same feed the kube operator turns into CRD status conditions.
"""


def resilience() -> Dict:
    """The "Resilience" dashboard: ladder level, shed rate by
    priority class, admission bucket fill, transition rate — next to a
    link panel into /debug/resilience."""
    p = [
        _stat("Degradation level",
              "max(llm_degradation_level)",
              panel_id=1, x=0, y=0),
        _stat("Shed rate",
              "sum(rate(llm_shed_total[5m])) or vector(0)",
              panel_id=2, x=6, y=0),
        _stat("SLO alerts firing",
              "sum(llm_slo_alert_firing) or vector(0)",
              panel_id=3, x=12, y=0),
        _stat("Admission headroom (worst class)",
              "min(llm_admission_bucket_fill)",
              unit="percentunit", panel_id=4, x=18, y=0),
        _panel("Shed rate by priority class",
               ["sum(rate(llm_shed_total[5m])) by (priority)"],
               panel_id=5, x=0, y=4, legends=["{{priority}}"]),
        _panel("Shed rate by ladder level",
               ["sum(rate(llm_shed_total[5m])) by (level)"],
               panel_id=6, x=12, y=4, legends=["{{level}}"]),
        _panel("Admission bucket fill by class",
               ["llm_admission_bucket_fill"],
               unit="percentunit", panel_id=7, x=0, y=12,
               legends=["{{priority}}"]),
        _panel("Ladder transitions",
               ["sum(rate(llm_degradation_transitions_total[5m])) "
                "by (direction)"],
               panel_id=8, x=12, y=12, legends=["{{direction}}"]),
        _panel("Fail-static fallbacks",
               ['sum(rate(llm_decision_fallbacks_total'
                '{reason="fail_static"}[5m])) or vector(0)'],
               panel_id=9, x=0, y=20),
        _text_panel("Overload control", _RESILIENCE_MD,
                    panel_id=10, x=12, y=20),
    ]
    return _dashboard("srt-resilience", "Semantic Router — Resilience",
                      p, tags=["resilience", "overload"])


_FLYWHEEL_MD = (
    "**Learned routing flywheel** (docs/FLYWHEEL.md): decision records "
    "export as a training corpus, policies train offline, candidates "
    "evaluate counterfactually against recorded traffic, then promote "
    "shadow → canary → serving with automatic rollback on SLO burn.  "
    "State: 0=idle 1=candidate 2=shadow 3=canary 4=promoted "
    "5=rolled_back.  Inspect live state at `/debug/flywheel`."
)


def flywheel() -> Dict:
    """The "Flywheel" dashboard: promotion state, corpus export rate,
    shadow agreement, canary overrides, counterfactual reward delta."""
    p = [
        _stat("Promotion state",
              "max(llm_flywheel_state)",
              panel_id=1, x=0, y=0),
        _stat("Reward delta (candidate - incumbent)",
              "max(llm_flywheel_reward_delta)",
              panel_id=2, x=6, y=0),
        _stat("Shadow agreement",
              'sum(rate(llm_flywheel_shadow_total{agree="true"}[5m])) '
              '/ sum(rate(llm_flywheel_shadow_total[5m]))',
              unit="percentunit", panel_id=3, x=12, y=0),
        _stat("Canary override rate",
              "sum(rate(llm_flywheel_overrides_total[5m])) or vector(0)",
              panel_id=4, x=18, y=0),
        _panel("Corpus export rate by outcome source",
               ["sum(rate(llm_flywheel_corpus_rows_total[5m])) "
                "by (source)"],
               panel_id=5, x=0, y=4, legends=["{{source}}"]),
        _panel("Shadow scores by agreement",
               ["sum(rate(llm_flywheel_shadow_total[5m])) by (agree)"],
               panel_id=6, x=12, y=4, legends=["agree={{agree}}"]),
        _panel("Promotion-state transitions",
               ["sum(rate(llm_flywheel_transitions_total[5m])) by (to)"],
               panel_id=7, x=0, y=12, legends=["→ {{to}}"]),
        _text_panel("Flywheel", _FLYWHEEL_MD, panel_id=8, x=12, y=12),
    ]
    return _dashboard("srt-flywheel", "Semantic Router — Flywheel",
                      p, tags=["flywheel", "learning"])


_UPSTREAMS_MD = (
    "**Upstream resilience plane** (docs/RESILIENCE.md \"Upstream "
    "failover\"): every forward outcome feeds a per-(model, endpoint) "
    "health scorer — EWMA error rate + latency and a consecutive-"
    "failure circuit breaker with half-open probing.  Open circuits "
    "are masked at selection time, the proxy path fails over to the "
    "ranked next-best candidates under a token-bucket retry budget "
    "(no retries at degradation ≥ L2), and per-attempt timeouts "
    "derive from the `x-vsr-deadline` end-to-end budget.  Inspect "
    "live state at `/debug/upstreams`."
)


def upstreams() -> Dict:
    """The "Upstreams" dashboard: open circuits, per-outcome
    forward rate, failover rate, retry-budget decisions, attempt
    latency — next to a link panel into /debug/upstreams."""
    p = [
        _stat("Open circuits",
              "max(llm_upstream_breaker_open) or vector(0)",
              panel_id=1, x=0, y=0),
        _stat("Failover rate",
              "sum(rate(llm_upstream_failovers_total[5m])) or vector(0)",
              panel_id=2, x=6, y=0),
        _stat("Upstream error rate",
              'sum(rate(llm_upstream_requests_total{outcome!="ok"}[5m]))'
              ' / sum(rate(llm_upstream_requests_total[5m]))',
              unit="percentunit", panel_id=3, x=12, y=0),
        _stat("Retries denied",
              'sum(rate(llm_upstream_retries_total{granted="false"}'
              '[5m])) or vector(0)',
              panel_id=4, x=18, y=0),
        _panel("Forward attempts by outcome",
               ["sum(rate(llm_upstream_requests_total[5m])) "
                "by (outcome)"],
               panel_id=5, x=0, y=4, legends=["{{outcome}}"]),
        _panel("Failovers by serving model",
               ["sum(rate(llm_upstream_failovers_total[5m])) "
                "by (model)"],
               panel_id=6, x=12, y=4, legends=["{{model}}"]),
        _panel("Breaker transitions",
               ["sum(rate(llm_upstream_breaker_transitions_total[5m])) "
                "by (state)"],
               panel_id=7, x=0, y=12, legends=["→ {{state}}"]),
        _panel("Attempt latency",
               _hist_quantiles("llm_upstream_attempt_latency_seconds"),
               unit="s", panel_id=8, x=12, y=12,
               legends=["p50", "p95", "p99"]),
        _panel("Retry budget decisions",
               ["sum(rate(llm_upstream_retries_total[5m])) "
                "by (granted, reason)"],
               panel_id=9, x=0, y=20,
               legends=["granted={{granted}} {{reason}}"]),
        _text_panel("Upstream failover", _UPSTREAMS_MD,
                    panel_id=10, x=12, y=20),
    ]
    return _dashboard("srt-upstreams", "Semantic Router — Upstreams",
                      p, tags=["resilience", "upstreams"])


_PROGRAMS_MD = """\
**Program-level performance observatory** (docs/OBSERVABILITY.md
§ Program catalog & roofline): every compiled XLA program the engine
serves — fused, packed, quantized, bgmv/epilogue-kernel, mesh-sharded —
is cost-accounted at compile time (`cost_analysis()` flops/bytes,
`memory_analysis()` peak HBM) and joined with the measured warm-step
EWMAs into achieved-FLOP/s and roofline fractions against the device
peak table (v5e/v5p/v6e tiers; CPU rows use a placeholder tier and say
so).

- `GET /debug/programs` — the full catalog: cost-model + measured rows
  per `(group, bucket, variant, quant, kernels, mesh)` key
- `make perfgate` — compares the live catalog against the pinned
  baseline in `perf/program_baseline.json`; a cost regression ≥ the
  gate factor fails CI
- SLO burn fires a bounded profiler trace + catalog snapshot
  automatically (`slo_capture` knob), cross-linked from
  `GET /debug/flightrec`
"""


def programs() -> Dict:
    """The "Programs" dashboard: per-program cost-model gauges and the
    roofline fraction each variant achieves, next to the measured step
    time the fractions are computed from."""
    p = [
        _stat("Programs in catalog",
              "count(llm_program_flops)",
              panel_id=1, x=0, y=0),
        _stat("Best roofline fraction",
              "max(llm_program_roofline_fraction)",
              unit="percentunit", panel_id=2, x=6, y=0),
        _stat("Worst roofline fraction",
              "min(llm_program_roofline_fraction)",
              unit="percentunit", panel_id=3, x=12, y=0),
        _stat("Peak HBM (largest program)",
              "max(llm_program_hbm_peak_bytes)",
              unit="bytes", panel_id=4, x=18, y=0),
        _panel("Roofline fraction by variant",
               ["max(llm_program_roofline_fraction) by (variant, quant, "
                "kernels, mesh)"],
               unit="percentunit", panel_id=5, x=0, y=4,
               legends=["{{variant}} q={{quant}} k={{kernels}} "
                        "m={{mesh}}"]),
        _panel("Cost-model FLOPs by program",
               ["max(llm_program_flops) by (group, bucket, variant)"],
               panel_id=6, x=12, y=4,
               legends=["{{group}}/{{bucket}} {{variant}}"]),
        _panel("Bytes accessed by program",
               ["max(llm_program_bytes) by (group, bucket, variant)"],
               unit="bytes", panel_id=7, x=0, y=12,
               legends=["{{group}}/{{bucket}} {{variant}}"]),
        _panel("Peak HBM by program",
               ["max(llm_program_hbm_peak_bytes) by (group, bucket, "
                "variant)"],
               unit="bytes", panel_id=8, x=12, y=12,
               legends=["{{group}}/{{bucket}} {{variant}}"]),
        _panel("Measured step time by group (p95)",
               ["histogram_quantile(0.95, sum(rate("
                "llm_runtime_step_seconds_bucket[5m])) by (le, group))"],
               unit="s", panel_id=9, x=0, y=20, legends=["{{group}}"]),
        _text_panel("Program catalog & perf gate", _PROGRAMS_MD,
                    panel_id=10, x=12, y=20),
    ]
    return _dashboard("srt-programs", "Semantic Router — Programs",
                      p, tags=["programs", "roofline"])


_FLEET_MD = (
    "**Fleet observability plane** (docs/OBSERVABILITY.md \"Fleet "
    "observability\"): every replica publishes a mergeable snapshot of "
    "its metric registry to the state plane on the heartbeat thread; "
    "every replica merges the live members' snapshots into the fleet "
    "view scraped at `/metrics/fleet` (counters/histograms summed, "
    "gauges worst-of-fleet).  Fleet-scoped SLO objectives burn against "
    "the merged counts and export as `llm_fleet_slo_*`.  "
    "`llm_fleet_local_fallback` = 1 means the state plane is down and "
    "the view degraded to local-only.  Inspect live state at "
    "`/debug/fleet`."
)


def fleet() -> Dict:
    """The "Fleet" dashboard: merged-view membership and
    fallback state, snapshot staleness, fleet-scoped SLO burn — scraped
    from /metrics/fleet, next to a link panel into /debug/fleet."""
    p = [
        _stat("Merged replicas",
              "max(llm_fleet_members)",
              panel_id=1, x=0, y=0),
        _stat("Local fallback",
              "max(llm_fleet_local_fallback)",
              panel_id=2, x=6, y=0),
        _stat("Fleet SLO alerts firing",
              "sum(llm_fleet_slo_alert_firing) or vector(0)",
              panel_id=3, x=12, y=0),
        _stat("Stalest member snapshot",
              "max(llm_fleet_snapshot_age_seconds)",
              unit="s", panel_id=4, x=18, y=0),
        _panel("Snapshot age by replica",
               ["max(llm_fleet_snapshot_age_seconds) by (replica)"],
               unit="s", panel_id=5, x=0, y=4,
               legends=["{{replica}}"]),
        _panel("Fleet SLO burn rate by objective/window",
               ["max(llm_fleet_slo_burn_rate) by (objective, window)"],
               panel_id=6, x=12, y=4,
               legends=["{{objective}} {{window}}"]),
        _panel("Fleet SLO good ratio",
               ["min(llm_fleet_slo_good_ratio) by (objective)"],
               unit="percentunit", panel_id=7, x=0, y=12,
               legends=["{{objective}}"]),
        _panel("State plane membership vs merged view",
               ["max(llm_stateplane_members)", "max(llm_fleet_members)"],
               panel_id=8, x=12, y=12,
               legends=["plane members", "merged snapshots"]),
        _text_panel("Fleet observability", _FLEET_MD,
                    panel_id=9, x=0, y=20),
    ]
    return _dashboard("srt-fleet", "Semantic Router — Fleet",
                      p, tags=["fleet", "observability"])


_ANN_MD = (
    "**On-device ANN plane** (docs/ANN.md): semantic-cache similarity "
    "and RAG retrieval served as a sharded on-device matmul — "
    "`scores = Q @ bank.T` + `lax.top_k` over a device-resident "
    "embedding bank in bucketed pow2 capacity tiers (bf16/int8 with a "
    "calibrated recall-parity gate).  Overflow rides a host-RAM tier; "
    "a background cycle promotes hot rows (EWMA), evicts cold ones "
    "(LRU), and compacts tombstones.  `llm_ann_local_fallback` = 1 "
    "means the state-plane sync degraded to local-only serving — "
    "lookups keep answering from the resident bank."
)


def ann_dashboard() -> Dict:
    """The "ANN" dashboard: bank fill and host-tier depth,
    lookup rate by serving path, promotion/eviction churn, device
    top-k step latency, sync fallback state."""
    p = [
        _stat("Bank fill (fullest index)",
              "max(llm_ann_bank_fill)",
              unit="percentunit", panel_id=1, x=0, y=0),
        _stat("Host-tier entries",
              "sum(llm_ann_host_entries)",
              panel_id=2, x=6, y=0),
        _stat("Lookups / s",
              "sum(rate(llm_ann_lookups_total[5m])) or vector(0)",
              panel_id=3, x=12, y=0),
        _stat("Local-only fallback",
              "max(llm_ann_local_fallback) or vector(0)",
              panel_id=4, x=18, y=0),
        _panel("Lookups by serving path",
               ["sum(rate(llm_ann_lookups_total[5m])) "
                "by (index, path)"],
               panel_id=5, x=0, y=4, legends=["{{index}} {{path}}"]),
        _panel("Device top-k step latency",
               _hist_quantiles("llm_ann_topk_step_seconds"),
               unit="s", panel_id=6, x=12, y=4,
               legends=["p50", "p95", "p99"]),
        _panel("Maintenance churn / failures",
               ["sum(rate(llm_ann_promotions_total[5m])) by (index)",
                "sum(rate(llm_ann_evictions_total[5m])) by (index)",
                "sum(rate(llm_ann_maintenance_failures_total[5m])) "
                "by (index)"],
               panel_id=7, x=0, y=12,
               legends=["promote {{index}}", "evict {{index}}",
                        "FAILED {{index}}"]),
        _panel("Bank fill by index",
               ["max(llm_ann_bank_fill) by (index)",
                "max(llm_ann_host_entries) by (index)"],
               panel_id=8, x=12, y=12,
               legends=["fill {{index}}", "host {{index}}"]),
        _text_panel("ANN plane", _ANN_MD, panel_id=9, x=0, y=20),
    ]
    return _dashboard("srt-ann", "Semantic Router — ANN Plane",
                      p, tags=["ann", "retrieval"])


def catalog(registry=None) -> Dict:
    """Auto-generated dashboard: one panel per registered series —
    anything new in the registry shows up here without template edits."""
    registry = registry or default_registry
    panels = []
    pid = 0
    x = y = 0
    for name, kind, help_ in registry.families():
        pid += 1
        if kind == "histogram":
            exprs = _hist_quantiles(name)
            legends = ["p50", "p95", "p99"]
        elif kind == "gauge":
            exprs = [f"sum({name})"]
            legends = [name]
        else:
            exprs = [f"sum(rate({name}[5m]))"]
            legends = [name]
        panels.append(_panel(help_ or name, exprs, panel_id=pid, x=x,
                             y=y, legends=legends))
        x = 12 - x
        if x == 0:
            y += 8
    return _dashboard("srt-catalog", "Semantic Router — Metric Catalog",
                      panels, tags=["catalog"])


_PROVIDER = {
    "apiVersion": 1,
    "providers": [{
        "name": "semantic-router-tpu",
        "orgId": 1,
        "folder": "Semantic Router",
        "type": "file",
        "disableDeletion": False,
        "updateIntervalSeconds": 30,
        "options": {"path": "/var/lib/grafana/dashboards/semantic-router"},
    }],
}


def render_all(out_dir: str, registry=None) -> List[str]:
    """Write every dashboard + the provisioning provider; returns the
    written paths (CLI surface)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    dashboards = {
        "router_overview.json": router_overview(),
        "signals_decisions.json": signals_decisions(),
        "safety.json": safety(),
        "serving.json": serving(),
        "runtime_slo.json": runtime_slo(),
        "decisions.json": decisions(),
        "resilience.json": resilience(),
        "flywheel.json": flywheel(),
        "upstreams.json": upstreams(),
        "programs.json": programs(),
        "fleet.json": fleet(),
        "ann.json": ann_dashboard(),
        "metric_catalog.json": catalog(registry),
    }
    for fname, dash in dashboards.items():
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            json.dump(dash, f, indent=2, sort_keys=True)
        written.append(path)
    prov = os.path.join(out_dir, "provider.yaml")
    # YAML provider file: render via json-compatible YAML (flow-style
    # free) without importing yaml at module import time
    import yaml

    with open(prov, "w") as f:
        yaml.safe_dump(_PROVIDER, f, sort_keys=False)
    written.append(prov)
    return written
