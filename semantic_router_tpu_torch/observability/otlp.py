"""OTLP export: finished spans to a collector's ``/v1/traces`` and
decision records to its ``/v1/logs``, in the OTLP/HTTP JSON encoding
(standard library only).

Items are buffered in memory (bounded: the oldest drop first) and sent in
batches by a daemon thread every ``flush_interval_s``, or at once when
``max_batch`` are waiting; a batch the collector refuses twice is dropped
and counted (``export_failed`` / ``log_export_failed`` event), so export
never blocks or fails the request that emitted the item.  ``detach``
takes the exporter off its source and waits (bounded) for the flusher to
ship what is buffered.  The payloads, the resource's ``service.name`` and
the scope name are the reference package's, so a collector sees one
service whichever package serves.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from .logging import component_event
from .tracing import Span, Tracer

SERVICE_NAME = "semantic-router-tpu"
SCOPE_NAME = "semantic_router_tpu"
# the longest ``detach`` waits for the flusher to ship the backlog (a dead
# collector costs each batch two attempts of ``timeout_s``)
DETACH_WAIT_S = 30.0


def _attr_value(v) -> Dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def span_to_otlp(span: Span) -> Dict:
    out = {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        **({"parentSpanId": span.parent_id} if span.parent_id else {}),
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(span.start_t * 1e9)),
        "endTimeUnixNano": str(int((span.end_t or time.time()) * 1e9)),
        "attributes": [{"key": k, "value": _attr_value(v)}
                       for k, v in span.attributes.items()],
    }
    if span.links:
        # a request's batch.ride span links the shared batch.execute step
        # span, which lives in a trace of its own
        out["links"] = [{"traceId": l["trace_id"], "spanId": l["span_id"]}
                        for l in span.links]
    return out


def build_payload(spans: List[Span],
                  service_name: str = SERVICE_NAME) -> Dict:
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{
            "scope": {"name": SCOPE_NAME},
            "spans": [span_to_otlp(s) for s in spans],
        }],
    }]}


class _BatchingExporter:
    """The buffer, the daemon flusher and the drop-after-two-attempts
    posture both exporters share.  A subclass sets ``_url_path``,
    ``_event_name`` and ``_thread_name`` and builds a batch's payload."""

    _url_path = "/"
    _event_name = "export_failed"
    _thread_name = "otlp-exporter"

    def __init__(self, endpoint: str,
                 headers: Optional[Dict[str, str]] = None,
                 service_name: str = SERVICE_NAME,
                 flush_interval_s: float = 5.0,
                 max_batch: int = 256,
                 max_buffer: int = 4096,
                 timeout_s: float = 10.0) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.headers = dict(headers or {})
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self.max_buffer = max_buffer
        self.timeout_s = timeout_s
        self._buffer: List = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.exported = 0
        self.dropped = 0

    def _build_payload(self, batch: List) -> Dict:
        raise NotImplementedError

    def __call__(self, item) -> None:
        """The sink: buffer ``item``; wake the flusher at ``max_batch``
        (the network call never runs on the emitting thread)."""
        with self._lock:
            self._buffer.append(item)
            if len(self._buffer) > self.max_buffer:
                overflow = len(self._buffer) - self.max_buffer
                del self._buffer[:overflow]
                self.dropped += overflow
            pressure = len(self._buffer) >= self.max_batch
        if pressure:
            self._wake.set()

    def _start_thread(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=self._thread_name)
            self._thread.start()

    def _stop_thread(self) -> None:
        """Stop the flusher after it shipped the backlog, waiting at most
        ``DETACH_WAIT_S``."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(DETACH_WAIT_S)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            self.drain()
        self.drain()  # the whole backlog at shutdown

    def drain(self) -> int:
        """Flush until the buffer is empty; the items sent."""
        total = 0
        while True:
            sent = self.flush()
            if sent == 0:
                return total
            total += sent

    def flush(self) -> int:
        """Send one batch; the items the collector took (0 when the
        buffer was empty or the batch was dropped)."""
        with self._lock:
            batch, self._buffer = self._buffer[:self.max_batch], \
                self._buffer[self.max_batch:]
        if not batch:
            return 0
        payload = json.dumps(self._build_payload(batch))
        req = urllib.request.Request(
            self.endpoint + self._url_path, data=payload.encode(),
            method="POST")
        req.add_header("content-type", "application/json")
        for k, v in self.headers.items():
            req.add_header(k, v)
        for attempt in range(2):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    with self._lock:
                        self.exported += len(batch)
                    return len(batch)
            except Exception as exc:
                if attempt == 1:
                    with self._lock:
                        self.dropped += len(batch)
                    component_event("otlp", self._event_name,
                                    error=str(exc)[:200],
                                    dropped=len(batch), level="warning")
                else:
                    self._stop.wait(0.2)
        return 0


class OTLPExporter(_BatchingExporter):
    """A tracer sink: ``attach(tracer)`` registers it and starts the
    flusher."""

    _url_path = "/v1/traces"
    _event_name = "export_failed"
    _thread_name = "otlp-exporter"

    def _build_payload(self, batch: List[Span]) -> Dict:
        return build_payload(batch, self.service_name)

    def attach(self, tracer: Tracer) -> "OTLPExporter":
        tracer.add_sink(self)
        self._start_thread()
        return self

    def detach(self, tracer: Tracer) -> None:
        tracer.remove_sink(self)
        self._stop_thread()


def build_exporter_from_config(tr: Dict,
                               tracer: Tracer) -> Optional[OTLPExporter]:
    """The span exporter of a tracing block (``RouterConfig.
    tracing_config()``), attached to ``tracer``; None without an
    ``otlp_endpoint``."""
    tr = tr or {}
    endpoint = tr.get("otlp_endpoint", "")
    if not endpoint:
        return None
    exporter = OTLPExporter(
        endpoint,
        headers=tr.get("otlp_headers"),
        service_name=tr.get("service_name", SERVICE_NAME),
        flush_interval_s=float(tr.get("flush_interval_s", 5.0)))
    return exporter.attach(tracer)


# -- decision records as OTLP log records --------------------------------------


def record_to_otlp_log(record: Dict) -> Dict:
    """One decision record as a logRecord: its canonical JSON the body,
    decision / model / kind / record id attributes, and its trace id,
    which links the log to the request's spans."""
    from .explain import record_to_json

    decision = (record.get("decision") or {}).get("name", "")
    out = {
        "timeUnixNano": str(int(record.get("ts_unix", time.time()) * 1e9)),
        "severityNumber": 9,  # SEVERITY_NUMBER_INFO
        "severityText": "INFO",
        "body": {"stringValue": record_to_json(record)},
        "attributes": [
            {"key": "event.name",
             "value": {"stringValue": "router.decision"}},
            {"key": "decision", "value": {"stringValue": decision}},
            {"key": "model",
             "value": {"stringValue": record.get("model", "")}},
            {"key": "kind",
             "value": {"stringValue": record.get("kind", "")}},
            {"key": "record_id",
             "value": {"stringValue": record.get("record_id", "")}},
        ],
    }
    trace_id = record.get("trace_id", "")
    if trace_id:
        out["traceId"] = trace_id
    return out


def build_log_payload(records: List[Dict],
                      service_name: str = SERVICE_NAME) -> Dict:
    return {"resourceLogs": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeLogs": [{
            "scope": {"name": SCOPE_NAME},
            "logRecords": [record_to_otlp_log(r) for r in records],
        }],
    }]}


class OTLPLogExporter(_BatchingExporter):
    """A decision-record sink (the explainer's ``sinks``) to
    ``/v1/logs``."""

    _url_path = "/v1/logs"
    _event_name = "log_export_failed"
    _thread_name = "otlp-log-exporter"

    def __init__(self, endpoint: str, max_batch: int = 64,
                 max_buffer: int = 1024, **kwargs) -> None:
        super().__init__(endpoint, max_batch=max_batch,
                         max_buffer=max_buffer, **kwargs)

    def _build_payload(self, batch: List[Dict]) -> Dict:
        return build_log_payload(batch, self.service_name)

    def attach(self, explainer) -> "OTLPLogExporter":
        explainer.sinks.append(self)
        self._start_thread()
        return self

    def detach(self, explainer) -> None:
        try:
            explainer.sinks.remove(self)
        except ValueError:
            pass
        self._stop_thread()


def build_log_exporter_from_config(tr: Dict, explainer
                                   ) -> Optional[OTLPLogExporter]:
    """The decision-record exporter to the spans' collector (``/v1/logs``
    of the same ``otlp_endpoint``), attached to ``explainer``; None
    without an endpoint or an explainer."""
    if explainer is None:
        return None
    tr = tr or {}
    endpoint = tr.get("otlp_endpoint", "")
    if not endpoint:
        return None
    exporter = OTLPLogExporter(
        endpoint,
        headers=tr.get("otlp_headers"),
        service_name=tr.get("service_name", SERVICE_NAME),
        flush_interval_s=float(tr.get("flush_interval_s", 5.0)))
    return exporter.attach(explainer)
