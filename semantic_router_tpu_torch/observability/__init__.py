from . import metrics
from .explain import DecisionExplainer, default_decision_explainer
from .flightrec import FlightRecorder, default_flight_recorder
from .inflight import InflightTracker, default_tracker
from .logging import component_event, get_logger
from .metrics import MetricSeries, MetricsRegistry, default_registry
from .tracing import Span, Tracer, active_span, default_tracer

__all__ = ["DecisionExplainer", "FlightRecorder", "InflightTracker",
           "MetricSeries", "MetricsRegistry", "Span", "Tracer",
           "active_span", "component_event", "default_decision_explainer",
           "default_flight_recorder", "default_registry", "default_tracer",
           "default_tracker", "get_logger", "metrics"]
