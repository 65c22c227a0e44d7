"""Metrics registry with Prometheus text exposition.

Capability parity with pkg/observability/metrics (metrics.go:100-330 + the
per-domain files): counters, gauges, histograms with labels, exposed in
Prometheus text format on the management server's /metrics. Series names
match the reference's so existing Grafana dashboards read them unchanged
(llm_model_requests_total, llm_model_cost_total,
llm_model_completion_latency_seconds, llm_model_ttft_seconds,
llm_model_tpot_seconds, llm_model_routing_latency_seconds,
llm_pii_violations_total, llm_hallucination_detection_latency_seconds,
cache/signal/decision/plugin series).

The port's copy of ``semantic_router_tpu.observability.metrics``: the same
series names, help texts, buckets and labels, so the reference's
dashboards read the port's ``/metrics`` unchanged.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# registry snapshot wire format (the reference's fleet plane): bump on
# any change to the snapshot shape below — the aggregator SKIPS members
# publishing a different version rather than merging garbage, so a
# mixed-version fleet mid-rollout degrades to fewer members, never to
# wrong numbers
SNAPSHOT_VERSION = 1


def encode_snapshot(snap: Dict[str, Any]) -> bytes:
    """Canonical bytes for a registry snapshot: sorted keys + compact
    separators, so the same registry state always serializes to the same
    bytes."""
    return json.dumps(snap, sort_keys=True,
                      separators=(",", ":")).encode()


def decode_snapshot(raw: bytes) -> Dict[str, Any]:
    """Inverse of :func:`encode_snapshot`; raises ValueError on a
    malformed payload or a version mismatch (callers skip the member)."""
    snap = json.loads(raw)
    if not isinstance(snap, dict) \
            or int(snap.get("v", -1)) != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported metrics snapshot version "
            f"{snap.get('v') if isinstance(snap, dict) else None!r} "
            f"(want {SNAPSHOT_VERSION})")
    return snap


def _pairs_key(pairs: Iterable) -> Tuple[Tuple[str, str], ...]:
    """Wire label pairs ([[k, v], ...]) back to the registry key form."""
    return tuple(sorted((str(k), str(v)) for k, v in pairs))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _help_line(family: str, help_: str) -> List[str]:
    """``# HELP`` line with the format-mandated escaping (backslash and
    newline); both exposition formats pair HELP with TYPE per family —
    ``make metrics-lint`` enforces the pairing."""
    if not help_:
        return []
    esc = help_.replace("\\", "\\\\").replace("\n", "\\n")
    return [f"# HELP {family} {esc}"]


class Counter:
    _kind = "counter"

    def __init__(self, name: str, help_: str = "") -> None:
        self.name, self.help = name, help_
        self._values: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def get(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def remove(self, **labels: str) -> bool:
        """Drop ONE labeled sample.  Program/series retirement (hot
        quant/kernel/mesh flips rebuild jit programs) must also shrink
        exposition — a gauge row describing a dead program is a lie the
        scraper keeps reading forever."""
        with self._lock:
            return self._values.pop(_label_key(labels), None) is not None

    def values(self) -> Dict[tuple, float]:
        """Snapshot of all labeled values (dashboard aggregation)."""
        with self._lock:
            return dict(self._values)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def snapshot(self) -> Dict[str, Any]:
        """Mergeable wire form: rows of [[label pairs], value], sorted
        by label key — deterministic ordering is what makes the registry
        snapshot byte-stable."""
        with self._lock:
            return {"kind": self._kind,
                    "samples": [[[list(p) for p in key], v]
                                for key, v in sorted(self._values.items())]}

    def merge(self, snap: Dict[str, Any]) -> None:
        """Fold a sibling replica's snapshot in.  Counters are
        cumulative, so merge is addition per label set."""
        for pairs, v in snap.get("samples", []) or []:
            key = _pairs_key(pairs)
            with self._lock:
                self._values[key] = self._values.get(key, 0.0) + float(v)

    def expose(self, openmetrics: bool = False) -> List[str]:
        # OpenMetrics declares a counter FAMILY without the _total suffix
        # while its samples keep it ('# TYPE llm_x counter' + 'llm_x_total
        # {...} v'); the classic 0.0.4 format puts the full sample name in
        # the TYPE line.  A strict OpenMetrics parser rejects a _total-
        # suffixed family name, failing the whole scrape.
        family = self.name
        if openmetrics and family.endswith("_total"):
            family = family[:-len("_total")]
        out = _help_line(family, self.help) + [f"# TYPE {family} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge(Counter):
    _kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def merge(self, snap: Dict[str, Any], mode: str = "max") -> None:
        """Fold a sibling's gauge snapshot in.  Gauges are last-values,
        not cumulative, so fleet merge defaults to MAX per label set —
        the worst-of-fleet read the external-metrics endpoint and shed
        ladder want (``mode="sum"`` for additive gauges, ``"last"`` to
        overwrite)."""
        for pairs, v in snap.get("samples", []) or []:
            key = _pairs_key(pairs)
            v = float(v)
            with self._lock:
                if mode == "sum":
                    self._values[key] = self._values.get(key, 0.0) + v
                elif mode == "max":
                    self._values[key] = max(self._values.get(key, v), v)
                else:
                    self._values[key] = v

    def expose(self, openmetrics: bool = False) -> List[str]:
        out = _help_line(self.name, self.help) + \
            [f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = _DEFAULT_BUCKETS) -> None:
        self.name, self.help = name, help_
        self.buckets = sorted(buckets)
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        self._totals: Dict[tuple, int] = {}
        # OpenMetrics exemplars: (labels, bucket idx) → latest
        # (value, trace_id, unix ts); recorded only when the registry
        # enabled exemplars AND the caller passed one (opt-in both ways —
        # the hot path stays a plain counter bump otherwise)
        self.exemplars = False
        self._exemplars: Dict[tuple, Dict[int, tuple]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key,
                                             [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                i = len(self.buckets)
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if self.exemplars and exemplar:
                self._exemplars.setdefault(key, {})[i] = (
                    value, str(exemplar), time.time())

    def percentile(self, p: float, **labels: str) -> float:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.get(key)
            total = self._totals.get(key, 0)
        if not counts or total == 0:
            return 0.0
        target = p / 100.0 * total
        cum = 0
        for i, c in enumerate(counts[:-1]):
            cum += c
            if cum >= target:
                return self.buckets[i]
        return self.buckets[-1] if self.buckets else 0.0

    def count(self, **labels: str) -> int:
        return self._totals.get(_label_key(labels), 0)

    def add_bucket_edge(self, edge: float) -> bool:
        """Insert an exact bucket edge (``merge`` re-buckets a sibling's
        histogram onto the union of both edge vectors).  Past
        observations in the straddling bucket stay in its upper half;
        only new observations split exactly.  Returns True when the edge
        was inserted, False when it already existed."""
        import bisect

        edge = float(edge)
        with self._lock:
            if edge in self.buckets:
                return False
            i = bisect.bisect_left(self.buckets, edge)
            self.buckets.insert(i, edge)
            for counts in self._counts.values():
                counts.insert(i, 0)
            # exemplars are keyed by bucket index: shift the ones at or
            # above the insertion point so they keep matching exposition
            for per_key in self._exemplars.values():
                for idx in sorted((x for x in per_key if x >= i),
                                  reverse=True):
                    per_key[idx + 1] = per_key.pop(idx)
            return True

    def le_total(self, value: float,
                 labels: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, int]:
        """(observations ≤ the largest bucket edge not above ``value``,
        total observations) — the streaming SLI the SLO monitor reads.
        Sums across all label sets; ``labels`` restricts to the sets
        carrying every given (k, v) pair.  A threshold between bucket
        edges rounds down (some good events count as bad, never the
        reverse)."""
        import bisect

        want = set((labels or {}).items())
        with self._lock:
            k = bisect.bisect_right(self.buckets, value)  # [:k] ≤ value
            if not want:
                total = sum(self._totals.values())
                good = sum(sum(counts[:k])
                           for counts in self._counts.values())
            else:
                keys = [key for key in self._counts if want <= set(key)]
                total = sum(self._totals.get(key, 0) for key in keys)
                good = sum(sum(self._counts[key][:k]) for key in keys)
        return good, total

    def totals(self) -> Dict[tuple, int]:
        """Locked snapshot of per-label observation counts."""
        with self._lock:
            return dict(self._totals)

    def snapshot(self) -> Dict[str, Any]:
        """Mergeable wire form.  The snapshot CARRIES its edge vector:
        ``add_bucket_edge`` mutates bucket layout lazily at read time
        (objective-aware edges), so two replicas' histograms routinely
        disagree on layout — without the edges a bucket vector is
        meaningless to a sibling."""
        with self._lock:
            return {"kind": "histogram",
                    "edges": [float(b) for b in self.buckets],
                    "samples": [[[list(p) for p in key],
                                 list(self._counts[key]),
                                 self._sums.get(key, 0.0),
                                 int(self._totals.get(key, 0))]
                                for key in sorted(self._counts)]}

    def merge(self, snap: Dict[str, Any]) -> None:
        """Fold a sibling's histogram snapshot in, re-bucketing onto the
        UNION of edge vectors.  Each incoming bucket's count lands in
        the target bucket ending at the SAME edge (that edge exists
        exactly after the union insert), so cumulative counts at every
        incoming edge are preserved and a finer local layout only splits
        the target's own history — which makes merge(a, b) == merge(b, a)
        """
        edges = [float(e) for e in snap.get("edges", []) or []]
        for e in edges:
            self.add_bucket_edge(e)  # no-op when already present
        with self._lock:
            # exact index of each incoming edge in the unioned layout
            idx = [self.buckets.index(e) for e in edges]
            for pairs, counts, sum_, total in snap.get("samples", []) or []:
                key = _pairs_key(pairs)
                mine = self._counts.setdefault(
                    key, [0] * (len(self.buckets) + 1))
                for i, c in enumerate(counts[:len(idx)]):
                    if c:
                        mine[idx[i]] += int(c)
                if len(counts) > len(idx):  # +Inf overflow slot
                    mine[-1] += int(counts[-1])
                self._sums[key] = self._sums.get(key, 0.0) + float(sum_)
                self._totals[key] = self._totals.get(key, 0) + int(total)

    def summary(self) -> Dict[str, float]:
        """Aggregate count/mean/p50/p95/p99 across all label sets
        (dashboard aggregation)."""
        with self._lock:
            total = sum(self._totals.values())
            total_sum = sum(self._sums.values())
            merged = [0] * (len(self.buckets) + 1)
            for counts in self._counts.values():
                for i, c in enumerate(counts):
                    merged[i] += c

        def pct(p: float) -> float:
            if total == 0:
                return 0.0
            target = p / 100.0 * total
            cum = 0
            for i, c in enumerate(merged[:-1]):
                cum += c
                if cum >= target:
                    return self.buckets[i]
            return self.buckets[-1] if self.buckets else 0.0

        return {"count": total,
                "mean": total_sum / total if total else 0.0,
                "p50": pct(50), "p95": pct(95), "p99": pct(99)}

    def _exemplar_suffix(self, key: tuple, i: int) -> str:
        """OpenMetrics exemplar clause for bucket ``i`` of ``key``:
        ``# {trace_id="..."} value ts`` — links the bucket to the trace
        that landed there."""
        ex = self._exemplars.get(key, {}).get(i)
        if ex is None:
            return ""
        v, tid, ts = ex
        return f' # {{trace_id="{tid}"}} {v} {round(ts, 3)}'

    def expose(self, openmetrics: bool = False) -> List[str]:
        # histogram families are already suffix-less (_bucket/_sum/_count
        # samples hang off the base name) — valid in both formats.
        # Exemplar clauses are ONLY legal in OpenMetrics: even if some
        # were recorded while the knob was on, a 0.0.4 exposition must
        # not carry them (a strict parser fails the whole scrape).
        out = _help_line(self.name, self.help) + \
            [f"# TYPE {self.name} histogram"]
        with self._lock:
            for key in sorted(self._counts):
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += self._counts[key][i]
                    lab = dict(key)
                    lab["le"] = repr(b)
                    ex = self._exemplar_suffix(key, i) if openmetrics \
                        else ""
                    out.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(_label_key(lab))} {cum}{ex}")
                cum += self._counts[key][-1]
                lab = dict(key)
                lab["le"] = "+Inf"
                ex = self._exemplar_suffix(key, len(self.buckets)) \
                    if openmetrics else ""
                out.append(
                    f"{self.name}_bucket{_fmt_labels(_label_key(lab))} "
                    f"{cum}{ex}")
                out.append(f"{self.name}_sum{_fmt_labels(key)} "
                           f"{self._sums[key]}")
                out.append(f"{self.name}_count{_fmt_labels(key)} "
                           f"{self._totals[key]}")
        return out


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.exemplars_enabled = False

    def enable_exemplars(self, enabled: bool = True) -> None:
        """Opt histograms into OpenMetrics exemplars
        (observability.metrics.exemplars config knob): applies to every
        existing and future histogram of this registry."""
        with self._lock:
            self.exemplars_enabled = bool(enabled)
            for m in self._metrics.values():
                if isinstance(m, Histogram):
                    m.exemplars = bool(enabled)

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        def make() -> Histogram:
            h = Histogram(name, help_, buckets)
            h.exemplars = self.exemplars_enabled
            return h

        return self._get(name, make)

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def find(self, name: str):
        """Registered metric by series name, or None — the SLO monitor's
        lookup (it must never CREATE a series of the wrong kind for an
        objective whose emitter isn't wired yet)."""
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
            om = self.exemplars_enabled
        for m in metrics:
            # exemplars flip the whole exposition to OpenMetrics (the
            # server also switches content type + appends '# EOF')
            lines.extend(m.expose(om))  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """Versioned, mergeable snapshot of every registered series —
        the fleet-observability wire unit each replica publishes to the
        stateplane (serialize with :func:`encode_snapshot`)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        series: Dict[str, Any] = {}
        for name, m in metrics:
            take = getattr(m, "snapshot", None)
            if take is None:
                continue
            row = take()
            row["help"] = getattr(m, "help", "")
            series[name] = row
        return {"v": SNAPSHOT_VERSION, "series": series}

    def merge_snapshot(self, snap: Dict[str, Any],
                       gauge_mode: str = "max") -> None:
        """Fold one replica's snapshot into this registry (the fleet
        aggregator builds a fresh registry and folds every live member
        in, then exposes it).  A series whose registered kind disagrees
        with the snapshot's is skipped — never merged as the wrong
        shape."""
        for name, fam in (snap.get("series") or {}).items():
            kind = fam.get("kind")
            if kind == "counter":
                m = self.counter(name, fam.get("help", ""))
                if type(m) is not Counter:  # Gauge subclasses Counter
                    continue
                m.merge(fam)
            elif kind == "gauge":
                m = self.gauge(name, fam.get("help", ""))
                if not isinstance(m, Gauge):
                    continue
                m.merge(fam, mode=gauge_mode)
            elif kind == "histogram":
                m = self.histogram(name, fam.get("help", ""),
                                   buckets=fam.get("edges") or ())
                if not isinstance(m, Histogram):
                    continue
                m.merge(fam)

    def families(self) -> List[Tuple[str, str, str]]:
        """(name, kind, help) for every registered series — the catalog
        the Grafana dashboard generator renders from."""
        kinds = {Counter: "counter", Gauge: "gauge",
                 Histogram: "histogram"}
        with self._lock:
            return [(name, kinds.get(type(m), "counter"),
                     getattr(m, "help", ""))
                    for name, m in sorted(self._metrics.items())]


# process-global default registry (reference: the prometheus default
# registry behind :9190)
default_registry = MetricsRegistry()


class MetricSeries:
    """The canonical series (names match the reference's metrics.go)
    bound to ONE registry.

    pkg/routerruntime decoupling: the in-process emitters (Router via
    its ``metrics`` param, the engine via InferenceEngine(metrics=...))
    take a MetricSeries instead of writing to module singletons, so two
    router instances embedded in one process can each bind their own
    registry — traffic through A never shows in B's /metrics.  The
    extproc gRPC front is one-per-process by design and still counts on
    the default registry.  Construction is idempotent per registry
    (get-or-create by name); ``default_series`` is the single-router/dev
    posture."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.model_requests = registry.counter(
            "llm_model_requests_total", "Requests routed per model")
        self.model_cost = registry.counter(
            "llm_model_cost_total", "Accumulated cost per model (USD)")
        self.completion_latency = registry.histogram(
            "llm_model_completion_latency_seconds",
            "End-to-end completion latency")
        self.ttft = registry.histogram(
            "llm_model_ttft_seconds", "Time to first token")
        self.tpot = registry.histogram(
            "llm_model_tpot_seconds", "Time per output token")
        self.routing_latency = registry.histogram(
            "llm_model_routing_latency_seconds", "Added routing latency")
        self.pii_violations = registry.counter(
            "llm_pii_violations_total", "PII policy violations detected")
        self.jailbreak_blocks = registry.counter(
            "llm_jailbreak_blocked_total",
            "Requests blocked by jailbreak screen")
        self.hallucination_latency = registry.histogram(
            "llm_hallucination_detection_latency_seconds",
            "Hallucination detection latency")
        self.cache_lookups = registry.counter(
            "llm_cache_lookups_total",
            "Semantic cache lookups by outcome")
        self.signal_latency = registry.histogram(
            "llm_signal_latency_seconds",
            "Per-family signal extraction latency")
        self.signal_errors = registry.counter(
            "llm_signal_errors_total",
            "Signal evaluations that failed open, by family — the "
            "numerator of the signal error-rate SLO")
        self.decision_matches = registry.counter(
            "llm_decision_matches_total", "Decision matches by name")
        self.decision_latency = registry.histogram(
            "llm_decision_evaluation_seconds", "Decision engine latency")
        # decision explainability (observability/explain.py): the
        # "Decisions" dashboard row reads these — routing mix comes from
        # llm_model_requests_total{decision}, these add the fallback and
        # rule-frequency views plus the record-ring accounting
        self.decision_fallbacks = registry.counter(
            "llm_decision_fallbacks_total",
            "Requests that fell back from the primary routing path, "
            "by reason (no_decision_matched, selector_error)")
        self.rule_hits = registry.counter(
            "llm_decision_rule_hits_total",
            "Winning-decision matched rules by type:name — the rule-hit "
            "frequency surface (bounded by configured rules)")
        self.decision_records = registry.counter(
            "llm_decision_records_total",
            "Decision records committed to the explain ring, by kind")
        self.batch_size = registry.histogram(
            "llm_classifier_batch_size", "Device batch sizes",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        self.truncated_inputs = registry.counter(
            "llm_tokenizer_truncated_inputs_total",
            "Inputs whose tail was dropped at the task's max_seq_len, "
            "by task")
        self.backend_failovers = registry.counter(
            "llm_backend_failovers_total",
            "Requests shed from an unreachable endpoint to a surviving "
            "one")
        # fused classifier-bank observability: the coalescing win must be
        # visible in series, not inferred from latency deltas
        self.trunk_forwards = registry.counter(
            "llm_engine_trunk_forwards_total",
            "Device trunk forwards, by batch group (fused trunk groups "
            "vs per-task batches)")
        self.tokenizations = registry.counter(
            "llm_engine_tokenizations_total",
            "Host tokenizations actually executed (request-level "
            "tokenize-once cache hits never count)")
        self.fused_dedup_rows = registry.counter(
            "llm_engine_fused_dedup_rows_total",
            "Duplicate token sequences collapsed within fused batches "
            "(each saved one trunk row; logits fan out on demux)")
        self.packed_steps = registry.counter(
            "llm_engine_packed_steps_total",
            "Device steps composed from sequence-packed rows "
            "(engine.packing): several prompts shared each row under a "
            "block-diagonal mask")
        # tuned-kernel / quant serving observability (docs/KERNELS.md):
        # the knobs' presence on the actual hot path, not just in config
        self.kernel_steps = registry.counter(
            "llm_engine_kernel_steps_total",
            "Device steps served through a tuned-kernel path "
            "(engine.quant / engine.kernels), by kernel: quant_bf16 / "
            "quant_int8 / epilogue / bgmv")
        self.kernel_rebuilds = registry.counter(
            "llm_engine_kernel_rebuilds_total",
            "Fused jit program-set rebuilds from engine.quant / "
            "engine.kernels hot flips (in-flight batches finish on the "
            "old programs; the next step serves the new)")
        # serving-mesh observability (docs/PARALLEL.md): proof the
        # dp×tp placement is on the actual hot path, not just in config
        self.mesh_steps = registry.counter(
            "llm_engine_mesh_steps_total",
            "Device steps executed dp-sharded over the serving mesh "
            "(engine.mesh), by trunk group — compare against "
            "llm_engine_trunk_forwards_total for the sharded share")
        self.mesh_devices = registry.gauge(
            "llm_engine_mesh_devices",
            "Serving-mesh axis sizes (engine.mesh), by axis (dp/tp); "
            "0 = no serving mesh active")
        # early-exit cascade observability (docs/CASCADE.md): how much
        # learned-forward work the decision-aware skips actually saved
        self.cascade_skipped = registry.counter(
            "llm_engine_cascade_skipped_forwards_total",
            "Learned classifier forwards never submitted or cancelled "
            "by the decision-aware cascade (engine.cascade), by signal "
            "family — each is a device forward the routing decision "
            "provably could not use")
        self.cascade_waves = registry.counter(
            "llm_engine_cascade_waves_total",
            "Cost-ordered cascade dispatch waves executed "
            "(engine.cascade) — waves-per-request near 0 means most "
            "requests decide on wave-0 heuristics alone")
        self.bucket_overflows = registry.counter(
            "llm_batcher_bucket_overflow_total",
            "Inputs longer than the largest seq bucket — clipped at the "
            "bucket edge and tagged truncated, never silent")
        self.batcher_queue_wait = registry.histogram(
            "llm_batcher_queue_wait_seconds",
            "Time items spend queued before their batch dispatches, "
            "by batcher")
        self.batcher_fill_ratio = registry.histogram(
            "llm_batcher_batch_fill_ratio",
            "Dispatched batch size / max_batch_size, by batcher",
            buckets=(0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                     0.875, 1.0))


default_series = MetricSeries(default_registry)
