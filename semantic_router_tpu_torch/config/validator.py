"""Config validation: the port's copy of the reference's semantic checks.

Every decision-rule leaf must name a configured signal rule (a
``projection`` leaf an output some mapping or partition produces);
model refs must name configured model cards (and a ``lora_name`` one of
the card's adapters); names are unique per family, decision, card and
recipe; regexes compile; numeric bands and buckets are ordered; each
recipe's profile gets the same checks; entrypoints name existing
recipes and never shadow a real model card.  ``validate_config`` returns
every finding; a fatal one makes ``load_config`` / ``loads_config``
raise ``ConfigError``.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import List, Optional

from .schema import (
    ALL_SIGNAL_TYPES,
    SIGNAL_COMPLEXITY,
    SIGNAL_PROJECTION,
    RouterConfig,
    RuleNode,
)


def _regex_error(pattern: str) -> Optional[str]:
    try:
        re.compile(pattern)
        return None
    except re.error as e:
        return str(e)


@dataclass
class ValidationError:
    path: str
    message: str
    fatal: bool = True

    def __str__(self) -> str:
        return f"{self.path}: {self.message}"


def _check_dupes(names: List[str], path: str, errors: List[ValidationError]) -> None:
    seen = set()
    for n in names:
        if n in seen:
            errors.append(ValidationError(path, f"duplicate name {n!r}"))
        seen.add(n)


def _projection_output_names(cfg: RouterConfig) -> List[str]:
    out: List[str] = []
    for m in cfg.projections.mappings:
        out.extend(o.name for o in m.outputs)
    for p in cfg.projections.partitions:
        out.extend(p.members)
        out.append(p.name)
    return out


def _validate_rule_node(node: RuleNode, cfg: RouterConfig, path: str,
                        errors: List[ValidationError]) -> None:
    if node.is_leaf():
        styp = node.signal_type.lower()
        if styp not in ALL_SIGNAL_TYPES:
            errors.append(ValidationError(path, f"unknown signal type {styp!r}"))
            return
        if styp == SIGNAL_PROJECTION:
            if node.name not in _projection_output_names(cfg):
                errors.append(ValidationError(
                    path, f"projection output {node.name!r} is not produced by any mapping/partition"))
            return
        names = cfg.signals.rule_names(styp)
        base = node.name.split(":", 1)[0]  # complexity rules match as "rule:level"
        if styp == SIGNAL_COMPLEXITY:
            if base not in names:
                errors.append(ValidationError(
                    path, f"complexity rule {base!r} not configured"))
        elif node.name not in names and names:
            errors.append(ValidationError(
                path, f"{styp} rule {node.name!r} not configured "
                      f"(known: {sorted(names)[:8]})"))
        elif not names:
            errors.append(ValidationError(
                path, f"decision references {styp}:{node.name} but no {styp} "
                      f"signals are configured"))
        return
    if node.operator not in ("AND", "OR", "NOT", ""):
        errors.append(ValidationError(path, f"unknown operator {node.operator!r}"))
    if node.operator and not node.conditions:
        errors.append(ValidationError(path, f"{node.operator} node has no conditions"))
    for i, c in enumerate(node.conditions):
        _validate_rule_node(c, cfg, f"{path}.conditions[{i}]", errors)


def validate_config(cfg: RouterConfig) -> List[ValidationError]:
    errors: List[ValidationError] = []

    # -- uniqueness
    _check_dupes([m.name for m in cfg.model_cards], "routing.modelCards", errors)
    _check_dupes([d.name for d in cfg.decisions], "routing.decisions", errors)
    _check_dupes([r.name for r in cfg.recipes], "recipes", errors)

    # -- recipes and entrypoints: entrypoints name existing recipes, and
    # a virtual model name never shadows the real model catalog
    recipe_names = {r.name for r in cfg.recipes} | {"default"}
    card_names = {m.name for m in cfg.model_cards}
    # each recipe is a full routing profile: its decisions/signals/
    # projections get the SAME deep validation as the top-level profile
    # (a bad model ref inside a recipe routes to a nonexistent backend
    # just as surely as one outside)
    for rec in cfg.recipes:
        if rec.strategy not in ("priority", "confidence"):
            errors.append(ValidationError(
                f"recipes.{rec.name}",
                f"strategy must be priority|confidence, "
                f"got {rec.strategy!r}"))
        sub = dataclasses.replace(cfg, signals=rec.signals,
                          projections=rec.projections,
                          decisions=rec.decisions,
                          strategy="priority",  # checked above, our way
                          recipes=[], entrypoints=[])
        for e in validate_config(sub):
            # model cards are SHARED across recipes (canonical contract)
            # and unchanged in the sub-config — re-reporting their errors
            # under a recipes.* path would send operators chasing phantom
            # per-recipe bugs
            if e.path.startswith("routing.modelCards"):
                continue
            errors.append(ValidationError(
                f"recipes.{rec.name}.{e.path}", e.message,
                fatal=e.fatal))
    for ep in cfg.entrypoints:
        if ep.recipe not in recipe_names:
            errors.append(ValidationError(
                "entrypoints", f"unknown recipe {ep.recipe!r} "
                f"(known: {sorted(recipe_names)})"))
        if not ep.model_names:
            errors.append(ValidationError(
                "entrypoints", f"entrypoint for recipe {ep.recipe!r} "
                "has no model_names"))
        for vname in ep.model_names:
            if vname in card_names:
                errors.append(ValidationError(
                    "entrypoints",
                    f"virtual model name {vname!r} shadows a real model "
                    "card — entrypoint names must never reach a backend"))
    for family in (
        "keywords", "embeddings", "domains", "fact_check", "user_feedbacks",
        "reasks", "preferences", "language", "context", "structure",
        "complexity", "modality", "role_bindings", "jailbreak", "pii", "kb",
        "conversation", "events",
    ):
        rules = getattr(cfg.signals, family)
        _check_dupes([r.name for r in rules], f"routing.signals.{family}", errors)

    # -- signal shape checks
    for kw in cfg.signals.keywords:
        if not kw.keywords:
            errors.append(ValidationError(
                f"signals.keywords.{kw.name}", "empty keyword list"))
        if kw.method not in ("exact", "regex", "fuzzy", "bm25", "ngram"):
            errors.append(ValidationError(
                f"signals.keywords.{kw.name}", f"unknown method {kw.method!r}"))
        if kw.operator not in ("AND", "OR"):
            errors.append(ValidationError(
                f"signals.keywords.{kw.name}", f"operator must be AND|OR, got {kw.operator!r}"))
        if kw.method == "regex":
            for pat in kw.keywords:
                err = _regex_error(pat)
                if err:
                    errors.append(ValidationError(
                        f"signals.keywords.{kw.name}", f"bad regex {pat!r}: {err}"))
    for em in cfg.signals.embeddings:
        if not em.candidates:
            errors.append(ValidationError(
                f"signals.embeddings.{em.name}", "empty candidates"))
        if not 0.0 <= em.threshold <= 1.0:
            errors.append(ValidationError(
                f"signals.embeddings.{em.name}", "threshold must be in [0,1]"))
    for st in cfg.signals.structure:
        if st.feature_type not in ("count", "exists", "sequence", "density"):
            errors.append(ValidationError(
                f"signals.structure.{st.name}", f"unknown feature type {st.feature_type!r}"))
        if st.feature_type in ("count", "density") and st.predicate.is_empty():
            errors.append(ValidationError(
                f"signals.structure.{st.name}",
                f"feature type {st.feature_type!r} requires a predicate"))
        if st.source.type == "regex" and st.source.pattern:
            err = _regex_error(st.source.pattern)
            if err:
                errors.append(ValidationError(
                    f"signals.structure.{st.name}",
                    f"bad regex {st.source.pattern!r}: {err}"))
    for cx in cfg.signals.context:
        if cx.max_tokens and cx.min_tokens > cx.max_tokens:
            errors.append(ValidationError(
                f"signals.context.{cx.name}", "min_tokens > max_tokens"))

    # -- decisions
    if cfg.strategy not in ("priority", "confidence"):
        errors.append(ValidationError("routing.strategy",
                                      f"unknown strategy {cfg.strategy!r}"))
    model_names = {m.name for m in cfg.model_cards}
    for dec in cfg.decisions:
        path = f"decisions.{dec.name}"
        if not dec.rules.is_leaf() and not dec.rules.conditions:
            errors.append(ValidationError(path, "decision has no rules"))
        _validate_rule_node(dec.rules, cfg, path + ".rules", errors)
        for ref in dec.model_refs:
            if model_names and ref.model not in model_names:
                errors.append(ValidationError(
                    path, f"modelRef {ref.model!r} not in modelCards"))
            if ref.lora_name:
                card = cfg.model_card(ref.model)
                if card is not None and ref.lora_name not in [l.name for l in card.loras]:
                    errors.append(ValidationError(
                        path, f"lora {ref.lora_name!r} not declared on model {ref.model!r}"))
        if not dec.model_refs:
            errors.append(ValidationError(path, "decision has no modelRefs",
                                          fatal=False))

    # -- projections
    signal_refs = set()
    for p in cfg.projections.partitions:
        for m in p.members:
            signal_refs.add(m)
        if p.default and p.default not in p.members:
            errors.append(ValidationError(
                f"projections.partitions.{p.name}",
                f"default {p.default!r} not in members"))
    score_names = {s.name for s in cfg.projections.scores}
    kb_names = {k.kb for k in cfg.signals.kb} | {k.name for k in cfg.signals.kb}
    for s in cfg.projections.scores:
        for inp in s.inputs:
            if inp.type == "kb_metric":
                if kb_names and inp.kb and inp.kb not in kb_names:
                    errors.append(ValidationError(
                        f"projections.scores.{s.name}",
                        f"kb {inp.kb!r} not configured", fatal=False))
                continue
            if inp.type and inp.type.lower() not in ALL_SIGNAL_TYPES:
                errors.append(ValidationError(
                    f"projections.scores.{s.name}",
                    f"unknown input signal type {inp.type!r}"))
    for m in cfg.projections.mappings:
        if m.source and m.source not in score_names:
            errors.append(ValidationError(
                f"projections.mappings.{m.name}",
                f"source score {m.source!r} not configured"))
        if not m.outputs:
            errors.append(ValidationError(
                f"projections.mappings.{m.name}", "mapping has no outputs"))

    # -- default model
    if cfg.default_model and model_names and cfg.default_model not in model_names:
        errors.append(ValidationError("default_model",
                                      f"{cfg.default_model!r} not in modelCards"))

    # -- engine
    if cfg.engine.max_batch_size <= 0:
        errors.append(ValidationError("engine.max_batch_size", "must be > 0"))
    if sorted(cfg.engine.seq_len_buckets) != list(cfg.engine.seq_len_buckets):
        errors.append(ValidationError("engine.seq_len_buckets",
                                      "buckets must be ascending"))
    return errors
