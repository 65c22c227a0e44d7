"""Typed CRD objects and the validating admission webhook.

The port's copy of ``semantic_router_tpu.runtime.crds`` (reference roles:
pkg/apis/vllm.ai/v1alpha1/types.go:31 (IntelligentPool) and :152
(IntelligentRoute), and deploy/operator's validating webhook).

- ``ModelSpec``, ``IntelligentPool``, ``IntelligentRoute``: dataclasses
  whose ``from_dict`` / ``to_dict`` round-trip the YAML shape exactly,
  unknown fields included, so tooling can load, edit one field and
  re-emit without loss.  ``parse_cr`` picks the class by ``kind`` and
  raises on any other.
- ``validate_admission(obj)``: would this one CR render into a valid
  router config?  References another object may satisfy (a model, a
  LoRA, a signal of a sibling route) are not held against it.
- ``AdmissionWebhook``: ``POST /validate``, AdmissionReview v1 in and
  out, on loopback (in a cluster TLS ends at the Service or a proxy).

``API_VERSION`` is the group and version ``deploy/k8s/crd.yaml`` defines.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..config.schema import RouterConfig
from ..config.validator import validate_config
from .operator import render_config

API_VERSION = "srt.tpu.dev/v1alpha1"


@dataclass
class ModelSpec:
    name: str
    quality_score: Optional[float] = None
    context_window_size: Optional[int] = None
    pricing: Optional[Dict[str, Any]] = None
    backends: List[Dict[str, Any]] = field(default_factory=list)
    loras: List[Dict[str, Any]] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelSpec":
        known = {"name", "qualityScore", "contextWindowSize", "pricing",
                 "backends", "loras"}
        return cls(
            name=d.get("name", ""),
            quality_score=d.get("qualityScore"),
            context_window_size=d.get("contextWindowSize"),
            pricing=d.get("pricing"),
            backends=list(d.get("backends", []) or []),
            loras=list(d.get("loras", []) or []),
            extra={k: v for k, v in d.items() if k not in known})

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name}
        if self.quality_score is not None:
            d["qualityScore"] = self.quality_score
        if self.context_window_size is not None:
            d["contextWindowSize"] = self.context_window_size
        if self.pricing is not None:
            d["pricing"] = self.pricing
        if self.backends:
            d["backends"] = self.backends
        if self.loras:
            d["loras"] = self.loras
        d.update(self.extra)
        return d


@dataclass
class IntelligentPool:
    name: str
    namespace: str = "default"
    default_model: str = ""
    models: List[ModelSpec] = field(default_factory=list)
    extra_spec: Dict[str, Any] = field(default_factory=dict)
    metadata: Dict[str, Any] = field(default_factory=dict)

    KIND = "IntelligentPool"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IntelligentPool":
        meta = dict(d.get("metadata", {}) or {})
        spec = dict(d.get("spec", {}) or {})
        models = [ModelSpec.from_dict(m)
                  for m in spec.pop("models", []) or []]
        return cls(name=meta.get("name", ""),
                   namespace=meta.get("namespace", "default"),
                   default_model=spec.pop("defaultModel", ""),
                   models=models, extra_spec=spec, metadata=meta)

    def to_dict(self) -> Dict[str, Any]:
        meta = dict(self.metadata)
        meta.setdefault("name", self.name)
        meta.setdefault("namespace", self.namespace)
        spec: Dict[str, Any] = {}
        if self.default_model:
            spec["defaultModel"] = self.default_model
        if self.models:
            spec["models"] = [m.to_dict() for m in self.models]
        spec.update(self.extra_spec)
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "metadata": meta, "spec": spec}


@dataclass
class IntelligentRoute:
    name: str
    namespace: str = "default"
    signals: Dict[str, List[Dict[str, Any]]] = field(default_factory=dict)
    decisions: List[Dict[str, Any]] = field(default_factory=list)
    knowledge_bases: List[Dict[str, Any]] = field(default_factory=list)
    extra_spec: Dict[str, Any] = field(default_factory=dict)
    metadata: Dict[str, Any] = field(default_factory=dict)

    KIND = "IntelligentRoute"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IntelligentRoute":
        meta = dict(d.get("metadata", {}) or {})
        spec = dict(d.get("spec", {}) or {})
        return cls(name=meta.get("name", ""),
                   namespace=meta.get("namespace", "default"),
                   signals=dict(spec.pop("signals", {}) or {}),
                   decisions=list(spec.pop("decisions", []) or []),
                   knowledge_bases=list(
                       spec.pop("knowledgeBases", []) or []),
                   extra_spec=spec, metadata=meta)

    def to_dict(self) -> Dict[str, Any]:
        meta = dict(self.metadata)
        meta.setdefault("name", self.name)
        meta.setdefault("namespace", self.namespace)
        spec: Dict[str, Any] = {}
        if self.signals:
            spec["signals"] = self.signals
        if self.decisions:
            spec["decisions"] = self.decisions
        if self.knowledge_bases:
            spec["knowledgeBases"] = self.knowledge_bases
        spec.update(self.extra_spec)
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "metadata": meta, "spec": spec}


def parse_cr(d: Dict[str, Any]):
    kind = d.get("kind", "")
    if kind == IntelligentPool.KIND:
        return IntelligentPool.from_dict(d)
    if kind == IntelligentRoute.KIND:
        return IntelligentRoute.from_dict(d)
    raise ValueError(f"unknown CR kind {kind!r}")


# -- the validating admission webhook -----------------------------------------


def validate_admission(obj: Dict[str, Any]) -> Tuple[bool, str]:
    """Would this CR render into a valid router config?  The CR is
    rendered (a route beside a placeholder pool holding every model and
    LoRA it references) and the full config validator run; a route's
    findings that another object may satisfy are dropped."""
    kind = obj.get("kind", "")
    try:
        cr = parse_cr(obj)  # the typed parse catches shape errors first
    except Exception as exc:
        return False, f"malformed {kind or 'object'}: {exc}"
    if kind == IntelligentPool.KIND:
        if not cr.default_model and not cr.models:
            return False, "IntelligentPool needs defaultModel or models"
        pool_dict, routes = obj, []
    else:
        if not cr.decisions and not cr.signals:
            return False, ("IntelligentRoute needs decisions and/or "
                           "signals")
        # a webhook sees ONE object: what another object could supply
        # (models, LoRAs) is supplied by the placeholder pool; the merged
        # view is reconcile's to check
        referenced = sorted({ref.get("model", "")
                             for d in cr.decisions
                             for ref in d.get("modelRefs", []) or []
                             if ref.get("model")})
        loras_by_model: Dict[str, List[Dict[str, str]]] = {}
        for d in cr.decisions:
            for ref in d.get("modelRefs", []) or []:
                if ref.get("model") and ref.get("lora_name"):
                    loras_by_model.setdefault(ref["model"], []).append(
                        {"name": ref["lora_name"]})
        pool_dict = {"kind": "IntelligentPool",
                     "metadata": {"name": "placeholder"},
                     "spec": {"defaultModel": referenced[0]
                              if referenced else "placeholder-model",
                              "models": [{"name": m,
                                          "loras":
                                              loras_by_model.get(m, [])}
                                         for m in referenced] or
                              [{"name": "placeholder-model"}]}}
        routes = [obj]
    try:
        raw = render_config(pool_dict, routes)
        cfg = RouterConfig.from_dict(raw)
        fatal = [str(e) for e in validate_config(cfg) if e.fatal]
    except Exception as exc:
        return False, f"render failed: {exc}"
    if kind == IntelligentRoute.KIND:
        fatal = [e for e in fatal if not _cross_object(e)]
    if fatal:
        return False, "; ".join(fatal[:3])
    return True, ""


# findings about references another route or pool may satisfy: checked at
# reconcile, not held against one object at admission
_CROSS_OBJECT_MARKERS = (
    "not produced by any mapping/partition",
    "not configured",
    "signals are configured",
)


def _cross_object(error_text: str) -> bool:
    return any(m in error_text for m in _CROSS_OBJECT_MARKERS)


class AdmissionWebhook:
    """AdmissionReview v1 over HTTP on ``127.0.0.1:port`` (0 picks a free
    port): ``POST /validate`` answers each review; ``DELETE`` is always
    allowed, a denial carries ``status`` 422 and the reason."""

    def __init__(self, port: int = 0) -> None:
        webhook = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if self.path.split("?")[0] != "/validate":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("content-length", 0))
                    review = json.loads(self.rfile.read(n))
                    response = webhook.review(review)
                except Exception as exc:
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(str(exc).encode()[:200])
                    return
                body = json.dumps(response).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="admission-webhook").start()

    def review(self, review: Dict[str, Any]) -> Dict[str, Any]:
        req = review.get("request", {}) or {}
        uid = req.get("uid", "")
        obj = req.get("object", {}) or {}
        if req.get("operation") == "DELETE":
            allowed, msg = True, ""
        else:
            allowed, msg = validate_admission(obj)
        resp: Dict[str, Any] = {"uid": uid, "allowed": allowed}
        if not allowed:
            resp["status"] = {"code": 422, "message": msg}
        return {"apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview", "response": resp}

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
