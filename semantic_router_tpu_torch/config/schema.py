"""Typed router configuration, trimmed to what the port serves.

The port's own copy of ``semantic_router_tpu.config.schema``: the same YAML
surface (``routing:`` with ``modelCards``/``signals``/``decisions``, and an
``engine:`` block), parsed into dataclasses for the parts the port's main
path reads — the learned signal families (domain, jailbreak, pii,
fact_check, user_feedback, modality), the embedding-scored families
(embedding, preference, complexity), decisions with their rule trees,
model refs and plugins, model cards, the semantic cache, and the
inference-engine knobs.  Other blocks of a config file are not read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

def _take(d: Dict[str, Any], *names: str, default: Any = None) -> Any:
    for n in names:
        if n in d:
            return d[n]
    return default


# --------------------------------------------------------------------------
# Signal rule configs
# --------------------------------------------------------------------------


@dataclass
class EmbeddingRule:
    """Embedding-similarity rule: the query against the candidates,
    aggregated by max | any | mean and held to the threshold."""

    name: str
    candidates: List[str] = field(default_factory=list)
    threshold: float = 0.75
    aggregation_method: str = "max"  # max | any | mean
    query_modality: str = "text"  # text | image | audio

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EmbeddingRule":
        return cls(
            name=d["name"],
            candidates=list(d.get("candidates", [])),
            threshold=float(d.get("threshold", 0.75)),
            aggregation_method=d.get("aggregation_method", "max"),
            query_modality=d.get("query_modality", "text"),
        )


@dataclass
class PreferenceRule:
    """Example-set similarity: matches when the closest example clears the
    threshold."""

    name: str
    examples: List[str] = field(default_factory=list)
    threshold: float = 0.7

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PreferenceRule":
        return cls(
            name=d["name"],
            examples=list(d.get("examples", [])),
            threshold=float(d.get("threshold", 0.7)),
        )


@dataclass
class ComplexityRule:
    """Difficulty rule with hard/easy prototype candidate sets (text, and
    text describing images) and an optional ``composer`` expression over
    other signals that escalates the rule to hard."""

    name: str
    threshold: float = 0.75
    hard_candidates: List[str] = field(default_factory=list)
    easy_candidates: List[str] = field(default_factory=list)
    hard_image_candidates: List[str] = field(default_factory=list)
    easy_image_candidates: List[str] = field(default_factory=list)
    composer: Optional["RuleNode"] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComplexityRule":
        hard = d.get("hard", {}) or {}
        easy = d.get("easy", {}) or {}
        composer = d.get("composer")
        return cls(
            name=d["name"],
            threshold=float(d.get("threshold", 0.75)),
            hard_candidates=list(hard.get("candidates", [])),
            easy_candidates=list(easy.get("candidates", [])),
            hard_image_candidates=list(hard.get("image_candidates", [])),
            easy_image_candidates=list(easy.get("image_candidates", [])),
            composer=RuleNode.from_dict(composer) if composer else None,
        )


@dataclass
class DomainRule:
    """Domain/intent category; the learned category classifier maps
    prompts onto these."""

    name: str
    mmlu_categories: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DomainRule":
        return cls(name=d["name"],
                   mmlu_categories=list(d.get("mmlu_categories", [])))


@dataclass
class NamedRule:
    """Generic named signal class (fact_check, user_feedback,
    modality)."""

    name: str
    threshold: float = 0.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NamedRule":
        return cls(name=d["name"], threshold=float(d.get("threshold", 0.0)))


@dataclass
class JailbreakRule:
    """method: 'classifier' (learned), 'pattern' (contrastive pattern
    match) or 'hybrid' (both)."""

    name: str
    method: str = "classifier"
    threshold: float = 0.8
    include_history: bool = False
    jailbreak_patterns: List[str] = field(default_factory=list)
    benign_patterns: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JailbreakRule":
        return cls(
            name=d["name"],
            method=d.get("method", "classifier"),
            threshold=float(d.get("threshold", 0.8)),
            include_history=bool(d.get("include_history", False)),
            jailbreak_patterns=list(d.get("jailbreak_patterns", [])),
            benign_patterns=list(d.get("benign_patterns", [])),
        )


@dataclass
class PIIRule:
    """PII policy rule: the token classifier detects entity types; the
    rule matches when a type outside ``pii_types_allowed`` is present."""

    name: str
    threshold: float = 0.85
    include_history: bool = False
    pii_types_allowed: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PIIRule":
        return cls(
            name=d["name"],
            threshold=float(d.get("threshold", 0.85)),
            include_history=bool(d.get("include_history", False)),
            pii_types_allowed=list(d.get("pii_types_allowed", [])),
        )


@dataclass
class SignalsConfig:
    """The learned and embedding-scored signal families the port
    evaluates."""

    embeddings: List[EmbeddingRule] = field(default_factory=list)
    domains: List[DomainRule] = field(default_factory=list)
    fact_check: List[NamedRule] = field(default_factory=list)
    user_feedbacks: List[NamedRule] = field(default_factory=list)
    preferences: List[PreferenceRule] = field(default_factory=list)
    complexity: List[ComplexityRule] = field(default_factory=list)
    modality: List[NamedRule] = field(default_factory=list)
    jailbreak: List[JailbreakRule] = field(default_factory=list)
    pii: List[PIIRule] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SignalsConfig":
        d = d or {}
        return cls(
            embeddings=[EmbeddingRule.from_dict(x)
                        for x in d.get("embeddings", [])],
            preferences=[PreferenceRule.from_dict(x)
                         for x in d.get("preferences", [])],
            complexity=[ComplexityRule.from_dict(x)
                        for x in d.get("complexity", [])],
            domains=[DomainRule.from_dict(x) for x in d.get("domains", [])],
            fact_check=[NamedRule.from_dict(x)
                        for x in d.get("fact_check", [])],
            user_feedbacks=[NamedRule.from_dict(x)
                            for x in d.get("user_feedbacks", [])],
            modality=[NamedRule.from_dict(x)
                      for x in d.get("modality", [])],
            jailbreak=[JailbreakRule.from_dict(x)
                       for x in d.get("jailbreak", [])],
            pii=[PIIRule.from_dict(x) for x in d.get("pii", [])],
        )


# --------------------------------------------------------------------------
# Decisions
# --------------------------------------------------------------------------


@dataclass
class RuleNode:
    """Boolean expression tree node. Leaf: {type, name}. Composite:
    {operator: AND|OR|NOT, conditions: [...]}."""

    operator: str = ""  # "" for leaf
    conditions: List["RuleNode"] = field(default_factory=list)
    signal_type: str = ""
    name: str = ""

    def is_leaf(self) -> bool:
        return self.operator == "" and self.signal_type != ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RuleNode":
        if not d:
            return cls()
        if d.get("operator"):
            return cls(
                operator=str(d["operator"]).upper(),
                conditions=[cls.from_dict(c) for c in d.get("conditions", [])],
            )
        return cls(signal_type=d.get("type", ""), name=d.get("name", ""))

    def leaves(self) -> List["RuleNode"]:
        if self.is_leaf():
            return [self]
        out: List[RuleNode] = []
        for c in self.conditions:
            out.extend(c.leaves())
        return out


@dataclass
class ModelRef:
    """Candidate model for a decision, with reasoning controls."""

    model: str
    use_reasoning: bool = False
    reasoning_effort: str = ""
    lora_name: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelRef":
        return cls(
            model=d["model"],
            use_reasoning=bool(d.get("use_reasoning", False)),
            reasoning_effort=d.get("reasoning_effort", ""),
            lora_name=d.get("lora_name", ""),
        )


@dataclass
class PluginConfig:
    """A decision plugin (``semantic-cache``, ...): its type and its
    configuration block."""

    type: str
    configuration: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PluginConfig":
        return cls(type=d["type"],
                   configuration=dict(d.get("configuration", {}) or {}))

    @property
    def enabled(self) -> bool:
        return bool(self.configuration.get("enabled", True))


@dataclass
class Decision:
    """A routing decision: its rule tree, its priority, its candidate
    models (the port selects statically: the first modelRef) and its
    plugins."""

    name: str
    rules: RuleNode = field(default_factory=RuleNode)
    priority: int = 0
    model_refs: List[ModelRef] = field(default_factory=list)
    plugins: List[PluginConfig] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Decision":
        return cls(
            name=d["name"],
            rules=RuleNode.from_dict(d.get("rules", {}) or {}),
            priority=int(d.get("priority", 0)),
            model_refs=[
                ModelRef.from_dict(m)
                for m in _take(d, "modelRefs", "model_refs", default=[])
            ],
            plugins=[PluginConfig.from_dict(p) for p in d.get("plugins", [])],
        )

    def plugin(self, ptype: str) -> Optional[PluginConfig]:
        for p in self.plugins:
            if p.type == ptype:
                return p
        return None


@dataclass
class ModelCard:
    """Backend model card (routing.modelCards): the catalog of models the
    decisions may name."""

    name: str

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelCard":
        return cls(name=d["name"])


# --------------------------------------------------------------------------
# Semantic cache, engine, top level
# --------------------------------------------------------------------------


@dataclass
class SemanticCacheConfig:
    """The response cache: backend, similarity threshold, capacity, TTL,
    eviction policy, and the embedding task that backs it (empty = the
    router's default embedding task)."""

    enabled: bool = False
    backend_type: str = "memory"  # memory | hnsw | hybrid
    similarity_threshold: float = 0.8
    max_entries: int = 1000
    ttl_seconds: int = 3600
    eviction_policy: str = "fifo"  # fifo | lru | lfu
    embedding_model: str = ""
    use_hnsw: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SemanticCacheConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", False)),
            backend_type=d.get("backend_type", "memory"),
            similarity_threshold=float(d.get("similarity_threshold", 0.8)),
            max_entries=int(d.get("max_entries", 1000)),
            ttl_seconds=int(d.get("ttl_seconds", 3600)),
            eviction_policy=d.get("eviction_policy", "fifo"),
            embedding_model=d.get("embedding_model", ""),
            use_hnsw=bool(d.get("use_hnsw", True)),
        )


@dataclass
class InferenceEngineConfig:
    """Engine knobs: the batching shim, the padding buckets, attention and
    kernel toggles, and the 2D-Matryoshka variants an embedding task
    serves (layer exits x output dims)."""

    max_batch_size: int = 32
    max_wait_ms: float = 2.0
    seq_len_buckets: List[int] = field(
        default_factory=lambda: [128, 512, 2048, 8192, 32768])
    use_flash_attention: bool = True
    matryoshka_layers: List[int] = field(default_factory=list)
    matryoshka_dims: List[int] = field(default_factory=list)
    # concurrent batch-dispatch workers: one slow (group, bucket) step
    # must not park live traffic on other buckets
    dispatch_workers: int = 4
    # tuned-kernel toggles, normalized by engine.kernels.normalize_kernels
    kernels: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferenceEngineConfig":
        d = d or {}
        out = cls(
            max_batch_size=int(d.get("max_batch_size", 32)),
            max_wait_ms=float(d.get("max_wait_ms", 2.0)),
            use_flash_attention=bool(d.get("use_flash_attention", True)),
            matryoshka_layers=list(d.get("matryoshka_layers", [])),
            matryoshka_dims=list(d.get("matryoshka_dims", [])),
            dispatch_workers=int(d.get("dispatch_workers", 4)),
            kernels=dict(d.get("kernels", {}) or {}),
        )
        if d.get("seq_len_buckets"):
            out.seq_len_buckets = [int(x) for x in d["seq_len_buckets"]]
        return out


@dataclass
class RouterConfig:
    model_cards: List[ModelCard] = field(default_factory=list)
    signals: SignalsConfig = field(default_factory=SignalsConfig)
    decisions: List[Decision] = field(default_factory=list)
    strategy: str = "priority"  # priority | confidence
    default_model: str = ""
    engine: InferenceEngineConfig = field(
        default_factory=InferenceEngineConfig)
    semantic_cache: SemanticCacheConfig = field(
        default_factory=SemanticCacheConfig)
    # task name -> {checkpoint, tokenizer, kind, labels, max_seq_len}
    classifier_models: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RouterConfig":
        d = d or {}
        routing = d.get("routing", {}) or {}
        return cls(
            model_cards=[ModelCard.from_dict(m) for m in
                         routing.get("modelCards", d.get("model_cards", []))],
            signals=SignalsConfig.from_dict(
                routing.get("signals", d.get("signals", {}))),
            decisions=[Decision.from_dict(x) for x in
                       routing.get("decisions", d.get("decisions", []))],
            strategy=routing.get("strategy", d.get("strategy", "priority")),
            default_model=d.get("default_model",
                                routing.get("default_model", "")),
            engine=InferenceEngineConfig.from_dict(
                d.get("engine", d.get("inference_engine", {}))),
            semantic_cache=SemanticCacheConfig.from_dict(
                d.get("semantic_cache", {})),
            classifier_models=dict(d.get("classifier_models", {}) or {}),
        )

    def used_signal_types(self) -> List[str]:
        """Signal families referenced by decision rules or complexity
        composers — the dispatcher only evaluates these."""
        leaves = [leaf for dec in self.decisions for leaf in dec.rules.leaves()]
        leaves += [leaf for rule in self.signals.complexity
                   if rule.composer is not None
                   for leaf in rule.composer.leaves()]
        return sorted({leaf.signal_type.lower() for leaf in leaves} - {""})
