"""The canonical v0.3 config contract: detection, export and migration.

The contract's top level is ``version`` / ``listeners`` / ``providers`` /
``routing`` / ``entrypoints`` / ``recipes`` / ``global``.  The loader
reads both the canonical and the flat layout (``RouterConfig.from_dict``
reads ``routing:`` and lifts ``global:``); this module goes the other
way: it lays a loaded config, or a flat dict, out in the contract
(``migrate-config``).
"""

from __future__ import annotations

from typing import Any, Dict

from .schema import RouterConfig

# keys of the canonical top level (everything else is runtime config and
# moves under ``global:``)
_CANONICAL_TOP = {"version", "listeners", "providers", "routing",
                  "entrypoints", "recipes", "global"}

# flat top-level keys the routing block owns
_ROUTING_KEYS = {"modelCards", "model_cards", "signals", "projections",
                 "decisions", "strategy", "learning", "knowledge_bases"}

# flat keys that become provider defaults rather than global ones
_PROVIDER_KEYS = {"default_model"}


def is_canonical(raw: Dict[str, Any]) -> bool:
    """A ``routing:`` or ``global:`` block marks the canonical contract."""
    return "routing" in raw or "global" in raw


def export_canonical(cfg: RouterConfig) -> Dict[str, Any]:
    """``cfg`` laid out in the canonical v0.3 contract.  The raw dict is
    the source of the rule bodies (it keeps their exact spellings); the
    typed fields fill in what it lacks.  Loading the result gives the
    same routing."""
    raw = dict(cfg.raw or {})
    routing_raw = dict(raw.get("routing") or {})
    for key in _ROUTING_KEYS:
        if key in raw and key not in routing_raw:
            routing_raw[key] = raw[key]
    routing_raw.setdefault("strategy", cfg.strategy)
    if "modelCards" not in routing_raw and "model_cards" in routing_raw:
        routing_raw["modelCards"] = routing_raw.pop("model_cards")

    providers = dict(cfg.providers or {})
    defaults = dict(providers.get("defaults") or {})
    if cfg.default_model and "default_model" not in defaults:
        defaults["default_model"] = cfg.default_model
    if defaults:
        providers["defaults"] = defaults

    global_block = dict(raw.get("global") or {})
    for key, value in raw.items():
        if key in _CANONICAL_TOP or key in _ROUTING_KEYS \
                or key in _PROVIDER_KEYS:
            continue
        global_block.setdefault(key, value)

    out: Dict[str, Any] = {"version": cfg.version or "v0.3"}
    if cfg.listeners:
        out["listeners"] = list(cfg.listeners)
    if providers:
        out["providers"] = providers
    out["routing"] = routing_raw
    if cfg.entrypoints:
        out["entrypoints"] = [
            {"model_names": list(e.model_names), "recipe": e.recipe}
            for e in cfg.entrypoints]
    if raw.get("recipes"):
        out["recipes"] = raw["recipes"]
    if global_block:
        out["global"] = global_block
    return out


def migrate_flat(raw: Dict[str, Any]) -> Dict[str, Any]:
    """A flat config dict in the canonical layout, without validating it
    (the ``migrate-config`` path): comments are lost, semantics kept."""
    return export_canonical(RouterConfig.from_dict(raw))
