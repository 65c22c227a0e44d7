"""DSL → RouterConfig compiler and RouterConfig → DSL decompiler.

The compiled output is the config dict the YAML loader reads, parsed and
then held to the config validator (signal references resolved at compile
time); ``emit_yaml`` writes it as flat YAML, and ``decompile`` writes a
config back as DSL so that compiling it gives the same routing.
``yaml`` is imported only by ``emit_yaml``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from ..config.schema import RouterConfig
from ..config.validator import validate_config
from .parser import (
    DecisionDecl,
    DSLSyntaxError,
    Program,
    SignalDecl,
    WhenExpr,
    parse,
)

# DSL family keyword → routing.signals key
_FAMILY_KEYS = {
    "keyword": "keywords",
    "embedding": "embeddings",
    "domain": "domains",
    "fact_check": "fact_check",
    "user_feedback": "user_feedbacks",
    "reask": "reasks",
    "preference": "preferences",
    "language": "language",
    "context": "context",
    "structure": "structure",
    "complexity": "complexity",
    "modality": "modality",
    "authz": "role_bindings",
    "jailbreak": "jailbreak",
    "pii": "pii",
    "kb": "kb",
    "conversation": "conversation",
    "event": "events",
}


class DSLCompileError(ValueError):
    pass


def _when_to_rules(expr: WhenExpr) -> Dict[str, Any]:
    if not expr.op:
        return {"type": expr.family, "name": expr.name}
    if expr.op == "not":
        return {"operator": "NOT",
                "conditions": [_when_to_rules(c) for c in expr.children]}
    return {"operator": expr.op.upper(),
            "conditions": [_when_to_rules(c) for c in expr.children]}


def compile_program(prog: Program, validate: bool = True) -> RouterConfig:
    signals: Dict[str, List[dict]] = {}
    for s in prog.signals:
        key = _FAMILY_KEYS.get(s.family)
        if key is None:
            raise DSLCompileError(f"unknown signal family {s.family!r}")
        entry = {"name": s.name, **s.props}
        signals.setdefault(key, []).append(entry)

    decisions = []
    for d in prog.decisions:
        if d.when is None:
            raise DSLCompileError(f"decision {d.name!r} has no `when`")
        dec: Dict[str, Any] = {
            "name": d.name,
            "priority": d.priority,
            "rules": _wrap_rules(_when_to_rules(d.when)),
            "modelRefs": [
                {k: v for k, v in {
                    "model": r.model,
                    "weight": r.weight,
                    # `reasoning on` = use_reasoning without an effort level
                    "use_reasoning": bool(r.reasoning),
                    "reasoning_effort": ("" if r.reasoning == "on"
                                         else r.reasoning),
                    "lora_name": r.lora,
                }.items() if v not in ("", None)}
                for r in d.routes],
            "algorithm": {"type": d.algorithm, **(
                {d.algorithm: d.algorithm_props} if d.algorithm_props else {})},
        }
        if d.plugins:
            dec["plugins"] = [
                {"type": p.type,
                 "configuration": {"enabled": True, **p.props}}
                for p in d.plugins]
        decisions.append(dec)

    raw = {
        "default_model": prog.default_model,
        "routing": {
            "strategy": prog.strategy,
            "modelCards": [{"name": m.name, **m.props} for m in prog.models],
            "signals": signals,
            "projections": prog.projections,
            "decisions": decisions,
        },
    }
    cfg = RouterConfig.from_dict(raw)
    if validate:
        fatal = [e for e in validate_config(cfg) if e.fatal]
        if fatal:
            raise DSLCompileError(
                "; ".join(str(e) for e in fatal))
    return cfg


def compile_dsl(text: str, validate: bool = True) -> RouterConfig:
    return compile_program(parse(text), validate=validate)


def emit_yaml(cfg: RouterConfig) -> str:
    """A compiled config as flat YAML."""
    import yaml

    return yaml.safe_dump(cfg.raw, sort_keys=False)


# ---------------------------------------------------------------------------
# Decompiler
# ---------------------------------------------------------------------------

_KEY_TO_FAMILY = {v: k for k, v in _FAMILY_KEYS.items()}


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def _q(name: str) -> str:
    if name and all(c.isalnum() or c in "_-." for c in name):
        return name
    return '"' + _escape(name) + '"'


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    if isinstance(v, str):
        return '"' + _escape(v) + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    if isinstance(v, dict):
        inner = " ".join(f"{k}: {_fmt_value(x)}" for k, x in v.items())
        return "{ " + inner + " }"
    return json.dumps(v)


def _rules_to_when(node) -> str:
    if node.is_leaf():
        return f"{node.signal_type}({_q(node.name)})"
    parts = [_rules_to_when(c) for c in node.conditions]
    if node.operator == "NOT":
        inner = parts[0] if len(parts) == 1 else \
            "(" + " or ".join(parts) + ")"
        return f"not {inner}"
    joiner = " and " if node.operator == "AND" else " or "
    joined = joiner.join(
        f"({p})" if (" or " in p and node.operator == "AND") else p
        for p in parts)
    return joined


def decompile(cfg: RouterConfig) -> str:
    """RouterConfig → DSL text.  Signal properties are
    re-emitted from the raw config so compile(decompile(cfg)) round-trips
    the routing semantics."""
    lines: List[str] = []
    routing = (cfg.raw or {}).get("routing", {})

    raw_cards = {c.get("name"): c for c in
                 (routing.get("modelCards")
                  or (cfg.raw or {}).get("model_cards") or [])}
    for card in cfg.model_cards:
        raw = raw_cards.get(card.name)
        if raw is not None:
            props = {k: v for k, v in raw.items() if k != "name"}
        else:  # no raw source (programmatic config): non-default fields
            props = {k: v for k, v in {
                "param_size": card.param_size,
                "quality_score": card.quality_score,
                "tags": card.tags,
                "pricing": card.pricing,
            }.items() if v}
        lines.append(f"model {_q(card.name)}"
                     + (" " + _fmt_props_block(props) if props else ""))
    if cfg.model_cards:
        lines.append("")

    raw_signals = routing.get("signals", {})
    for key, entries in raw_signals.items():
        family = _KEY_TO_FAMILY.get(key, key)
        for entry in entries or []:
            props = {k: v for k, v in entry.items() if k != "name"}
            head = f"signal {family} {_q(entry['name'])}"
            lines.append(head + (" " + _fmt_props_block(props) if props
                                 else ""))
    if raw_signals:
        lines.append("")

    raw_projections = routing.get("projections") or {}
    if raw_projections:
        lines.append("projections " + _fmt_props_block(raw_projections))
        lines.append("")

    for dec in cfg.decisions:
        head = f"decision {_q(dec.name)}"
        if dec.priority:
            head += f" priority {dec.priority}"
        lines.append(head + " {")
        lines.append(f"    when {_rules_to_when(dec.rules)}")
        for ref in dec.model_refs:
            route = f"    route to {_q(ref.model)}"
            if ref.weight != 1.0:
                route += f" weight {json.dumps(ref.weight)}"
            if ref.use_reasoning:
                route += f" reasoning {ref.reasoning_effort or 'on'}"
            if ref.lora_name:
                route += f" lora {_q(ref.lora_name)}"
            lines.append(route)
        algo = dict(dec.algorithm or {})
        algo_type = str(algo.get("type", "static"))
        algo_props = algo.get(algo_type) or {}
        algo_line = f"    algorithm {algo_type}"
        if algo_props:
            algo_line += " " + _fmt_props_block(algo_props)
        lines.append(algo_line)
        for p in dec.plugins:
            conf = {k: v for k, v in p.configuration.items()
                    if k != "enabled"}
            lines.append(f"    plugin {p.type}"
                         + (" " + _fmt_props_block(conf) if conf else ""))
        lines.append("}")
        lines.append("")

    if cfg.strategy != "priority":
        lines.append(f"strategy {cfg.strategy}")
    if cfg.default_model:
        lines.append(f"default model {_q(cfg.default_model)}")
    return "\n".join(lines).rstrip() + "\n"


def _fmt_props_block(props: Dict[str, Any]) -> str:
    inner = " ".join(f"{k}: {_fmt_value(v)}" for k, v in props.items())
    return "{ " + inner + " }"


def _wrap_rules(node: Dict[str, Any]) -> Dict[str, Any]:
    """Top-level rules must be a composite (the schema's decision shape)."""
    if "operator" in node:
        return node
    return {"operator": "OR", "conditions": [node]}
