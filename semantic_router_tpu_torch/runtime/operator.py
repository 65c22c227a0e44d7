"""The operator's reconcile core: IntelligentPool / IntelligentRoute CRs
rendered into a router config and applied through the hot reload.

The port's copy of ``semantic_router_tpu.runtime.operator`` (reference
role: deploy/operator and pkg/apis/vllm.ai/v1alpha1/types.go:31; the
controller watches the CRDs of ``deploy/k8s/crd.yaml`` and reconciles
them into the router's YAML, which the config watcher hot-swaps).

- ``render_config(pool, routes)``: CR dicts → a router config dict.
- ``reconcile(pool, routes, config_path)``: render → ``RouterConfig`` →
  ``validate_config`` → an atomic write, only when the text changed;
  returns ``(changed, status)`` with status ``applied``, ``unchanged`` or
  ``invalid: …``.  An invalid CR never touches the live file.
- ``FileOperator``: the GitOps mode, a directory of CR YAMLs reconciled
  on every poll.  ``runtime/kubewatch.py`` drives the same core from a
  live list / watch.

``yaml`` is imported where a file is read or written, not at import.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..config.schema import RouterConfig
from ..config.validator import validate_config
from ..observability.logging import component_event


def render_config(pool: Dict[str, Any],
                  routes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """IntelligentPool + IntelligentRoute specs → router config dict (the
    operator's template rendering)."""
    pool_spec = pool.get("spec", {}) or {}
    model_cards = []
    for m in pool_spec.get("models", []) or []:
        card: Dict[str, Any] = {"name": m["name"]}
        if m.get("qualityScore") is not None:
            card["quality_score"] = m["qualityScore"]
        if m.get("contextWindowSize"):
            card["context_window_size"] = m["contextWindowSize"]
        pricing = m.get("pricing") or {}
        if pricing:
            card["pricing"] = {
                "currency": pricing.get("currency", "USD"),
                "prompt": pricing.get("promptPerM", 0.0),
                "completion": pricing.get("completionPerM", 0.0)}
        if m.get("backends"):
            card["backend_refs"] = [
                {"endpoint": b.get("endpoint", ""),
                 "weight": b.get("weight", 100)}
                for b in m["backends"]]
        if m.get("loras"):
            card["loras"] = [{"name": lr["name"],
                              "adapter_index": lr.get("adapterIndex", 0)}
                             for lr in m["loras"]]
        model_cards.append(card)

    routing: Dict[str, Any] = {"modelCards": model_cards, "decisions": []}
    knowledge_bases: List[Dict[str, Any]] = []
    for route in routes:
        spec = route.get("spec", {}) or {}
        if spec.get("signals"):
            sig = routing.setdefault("signals", {})
            for fam, rules in spec["signals"].items():
                sig.setdefault(fam, []).extend(rules)
        if spec.get("projections"):
            # a dict of lists (partitions, scores, mappings, threshold
            # bands), merged per key across routes
            proj = routing.setdefault("projections", {})
            for pk, pv in spec["projections"].items():
                proj.setdefault(pk, []).extend(pv or [])
        knowledge_bases.extend(spec.get("knowledgeBases", []) or [])
        routing["decisions"].extend(spec.get("decisions", []) or [])

    cfg: Dict[str, Any] = {
        "default_model": pool_spec.get("defaultModel", ""),
        "routing": routing,
    }
    if knowledge_bases:
        cfg["knowledge_bases"] = knowledge_bases
    return cfg


def reconcile(pool: Dict[str, Any], routes: List[Dict[str, Any]],
              config_path: str) -> Tuple[bool, str]:
    """Render → validate → write (only on change).  Returns
    ``(changed, status)``; an invalid CR never touches the live file."""
    import yaml

    try:
        # rendered inside the guard: the file mode has no CRD schema, so
        # a malformed CR (a model without a name) is a status, not a raise
        raw = render_config(pool, routes)
        cfg = RouterConfig.from_dict(raw)
        fatal = [str(e) for e in validate_config(cfg) if e.fatal]
    except Exception as exc:
        return False, f"invalid: {exc}"
    if fatal:
        return False, "invalid: " + "; ".join(fatal[:3])

    new_text = yaml.safe_dump(raw, sort_keys=False)
    if os.path.exists(config_path):
        with open(config_path) as f:
            if f.read() == new_text:
                return False, "unchanged"
    tmp = config_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(new_text)
    os.replace(tmp, config_path)
    component_event("operator", "reconciled", path=config_path,
                    decisions=len(raw["routing"]["decisions"]))
    return True, "applied"


class FileOperator:
    """File-based reconcile loop: a directory of CR YAMLs (kind
    IntelligentPool / IntelligentRoute) rendered into the live config on
    every change — the GitOps deployment mode, and the core a Kubernetes
    watch drives."""

    def __init__(self, cr_dir: str, config_path: str,
                 poll_interval_s: float = 5.0) -> None:
        self.cr_dir = cr_dir
        self.config_path = config_path
        self.poll_interval_s = poll_interval_s
        self._last_status = ""

    def load_crs(self) -> Tuple[Optional[Dict], List[Dict]]:
        import yaml

        pool, routes = None, []
        for name in sorted(os.listdir(self.cr_dir)):
            if not name.endswith((".yaml", ".yml")):
                continue
            with open(os.path.join(self.cr_dir, name)) as f:
                for doc in yaml.safe_load_all(f):
                    if not isinstance(doc, dict):
                        continue
                    kind = doc.get("kind", "")
                    if kind == "IntelligentPool":
                        pool = doc
                    elif kind == "IntelligentRoute":
                        routes.append(doc)
        return pool, routes

    def reconcile_once(self) -> str:
        pool, routes = self.load_crs()
        if pool is None:
            return "no IntelligentPool found"
        _changed, status = reconcile(pool, routes, self.config_path)
        self._last_status = status
        return status

    def run(self) -> None:  # pragma: no cover - loop shell
        while True:
            try:
                self.reconcile_once()
            except Exception as exc:
                component_event("operator", "reconcile_error",
                                error=str(exc), level="warning")
            time.sleep(self.poll_interval_s)
