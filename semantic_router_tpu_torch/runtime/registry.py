"""Runtime service registry: the per-instance observability sinks.

The port's copy of ``semantic_router_tpu.runtime.registry``, with the
slots this package fills: the metrics registry, the tracer, the session
telemetry, the profiler control, the runtime event bus, the flight recorder, the runtime-stats
sampler, the program-cost catalog, the SLO monitor, the decision-record
ring, the degradation controller, the upstream health plane, the
cascade evaluator, the shared state plane, the fleet observability
plane, the ANN plane and the routing flywheel.  ``RuntimeRegistry.with_defaults()``
binds the process-default singletons (the single-router posture);
``isolated()`` builds fresh sinks, so two routers in one process built
over isolated registries share no series, spans or records.  Consumers
read services through the registry, so ``swap`` takes effect atomically
on the next access.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

_SLOTS = ("metrics", "tracer", "sessions", "profiler", "events",
          "flightrec", "runtimestats", "programstats", "slo", "explain", "resilience",
          "engine",
          # the upstream health plane (resilience.upstream.UpstreamHealth):
          # empty unless resilience.upstream.enabled (apply_upstream_knobs)
          "upstreams",
          # the decision-aware cascade's evaluator: empty unless
          # engine.cascade is enabled (apply_cascade_knobs)
          "cascade",
          # the shared state plane (stateplane.StatePlane): empty unless
          # stateplane.enabled (build_router); per registry, so two
          # embedded routers can sit on different planes
          "stateplane",
          # the fleet observability plane (observability.fleetobs
          # .FleetObs): empty unless both stateplane.enabled and
          # observability.fleet.enabled (bootstrap's _attach_fleetobs)
          "fleetobs",
          # the on-device ANN plane (ann.AnnPlane): empty unless
          # ann.enabled (apply_ann_knobs)
          "ann",
          # the routing flywheel (flywheel.FlywheelController): empty
          # unless flywheel.enabled (apply_flywheel_knobs)
          "flywheel")


class RuntimeRegistry:
    def __init__(self, **services: Any) -> None:
        unknown = set(services) - set(_SLOTS)
        if unknown:
            raise ValueError(f"unknown services: {sorted(unknown)}")
        self._services: Dict[str, Any] = {s: services.get(s)
                                          for s in _SLOTS}
        self._lock = threading.Lock()

    @classmethod
    def with_defaults(cls, **overrides: Any) -> "RuntimeRegistry":
        """Process-default sinks (shared across instances — the
        single-router posture)."""
        from ..observability.explain import default_decision_explainer
        from ..observability.flightrec import default_flight_recorder
        from ..observability.metrics import default_registry
        from ..observability.profiler import default_profiler
        from ..observability.programstats import default_program_stats
        from ..observability.runtimestats import default_runtime_stats
        from ..observability.session import default_session_telemetry
        from ..observability.slo import default_slo_monitor
        from ..observability.tracing import default_tracer
        from ..resilience.controller import default_degradation_controller
        from .events import default_bus

        base: Dict[str, Any] = {
            "metrics": default_registry,
            "tracer": default_tracer,
            "sessions": default_session_telemetry,
            "profiler": default_profiler,
            "events": default_bus,
            "flightrec": default_flight_recorder,
            "runtimestats": default_runtime_stats,
            "programstats": default_program_stats,
            "slo": default_slo_monitor,
            "explain": default_decision_explainer,
            "resilience": default_degradation_controller,
        }
        base.update(overrides)
        return cls(**base)

    @classmethod
    def isolated(cls, **overrides: Any) -> "RuntimeRegistry":
        """Fully per-instance sinks: a fresh metrics registry (the
        runtime-stats, program-catalog, SLO and ladder series register in
        it), tracer, profiler control, event bus, flight recorder, SLO
        monitor, session telemetry, decision ring and degradation
        controller (one router
        browning out never sheds a sibling's traffic).  Wire them
        with ``build_engine(cfg, registry=...)``,
        ``build_router(cfg, engine, registry=...)`` and
        ``RouterServer(..., registry=...)``."""
        from ..observability.explain import DecisionExplainer
        from ..observability.flightrec import FlightRecorder
        from ..observability.metrics import MetricsRegistry
        from ..observability.profiler import ProfilerControl
        from ..observability.programstats import ProgramCatalog
        from ..observability.runtimestats import RuntimeStats
        from ..observability.session import SessionTelemetry
        from ..observability.slo import SLOMonitor
        from ..observability.tracing import Tracer
        from ..resilience.controller import DegradationController
        from ..resilience.costmodel import CostModel
        from .events import EventBus

        metrics = MetricsRegistry()
        base: Dict[str, Any] = {
            "metrics": metrics,
            "tracer": Tracer(),
            "sessions": SessionTelemetry(),
            "profiler": ProfilerControl(),
            "events": EventBus(),
            "flightrec": FlightRecorder(),
            "runtimestats": RuntimeStats(metrics),
            "programstats": ProgramCatalog(metrics),
            "slo": SLOMonitor(metrics),
            "explain": DecisionExplainer(),
        }
        base.update(overrides)
        if "resilience" not in overrides:
            base["resilience"] = DegradationController(
                metrics, cost_model=CostModel(base["runtimestats"]))
        return cls(**base)

    def metric_series(self):
        """The canonical series bound to THIS registry's metrics slot
        (idempotent — get-or-create by name)."""
        from ..observability.metrics import MetricSeries

        return MetricSeries(self.metrics)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        services = object.__getattribute__(self, "_services")
        if name in services:
            with object.__getattribute__(self, "_lock"):
                return services[name]
        raise AttributeError(f"no service {name!r} "
                             f"(slots: {', '.join(_SLOTS)})")

    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            return self._services.get(name, default)

    def swap(self, **services: Any) -> Dict[str, Any]:
        """Atomically replace the named services; returns the replaced
        ones (callers retire them)."""
        unknown = set(services) - set(_SLOTS)
        if unknown:
            raise ValueError(f"unknown services: {sorted(unknown)}")
        with self._lock:
            old = {k: self._services[k] for k in services}
            self._services.update(services)
            return old

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._services)
