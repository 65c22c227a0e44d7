"""The candidate models of a router config: every model card with its
quality hint, modality, tags and per-million-token prices, every model a
decision references with the decisions that do, and the default model.
Config introspection only."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class CandidateModel:
    name: str
    quality_score: float = 0.0
    modality: str = "text"
    tags: List[str] = field(default_factory=list)
    price_per_1m_in: float = 0.0
    price_per_1m_out: float = 0.0
    # the decisions that reference the model
    decisions: List[str] = field(default_factory=list)


def candidates_from_config(cfg) -> List[CandidateModel]:
    """The candidates, sorted by name; a card no decision references is
    one too (a selector may fall back to it)."""
    by_name: Dict[str, CandidateModel] = {}
    for card in getattr(cfg, "model_cards", []) or []:
        pricing = getattr(card, "pricing", None) or {}
        priced = isinstance(pricing, dict)
        by_name[card.name] = CandidateModel(
            name=card.name,
            quality_score=float(getattr(card, "quality_score", 0.0) or 0.0),
            modality=getattr(card, "modality", "ar") or "ar",
            tags=list(getattr(card, "tags", []) or []),
            price_per_1m_in=float(pricing.get(
                "prompt", pricing.get("input", 0.0)) or 0.0)
            if priced else 0.0,
            price_per_1m_out=float(pricing.get(
                "completion", pricing.get("output", 0.0)) or 0.0)
            if priced else 0.0,
        )
    for dec in getattr(cfg, "decisions", []) or []:
        for ref in getattr(dec, "model_refs", []) or []:
            name = getattr(ref, "model", None) or getattr(ref, "name", "")
            if not name:
                continue
            cand = by_name.setdefault(name, CandidateModel(name=name))
            if dec.name not in cand.decisions:
                cand.decisions.append(dec.name)
    default = getattr(cfg, "default_model", "")
    if default and default not in by_name:
        by_name[default] = CandidateModel(name=default)
    return [by_name[k] for k in sorted(by_name)]
