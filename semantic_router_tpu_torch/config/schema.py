"""Typed router configuration, trimmed to what the port serves.

The port's own copy of ``semantic_router_tpu.config.schema``: the same YAML
surface (``routing:`` with ``modelCards``/``signals``/``decisions``, and an
``engine:`` block), parsed into dataclasses for the parts the port's main
path reads — every signal family (the heuristic ones: keyword, context,
structure, conversation, language, authz role bindings, event, reask;
the learned ones: domain, jailbreak, pii, fact_check, user_feedback,
modality; the embedding-scored ones: embedding, preference, complexity,
kb with its knowledge bases), projections, decisions with their rule
trees, model refs, selection algorithms and plugins, model cards, the
semantic cache, the ``memory`` and ``tool_selection`` blocks, the
``authz`` block, the inference-engine knobs (``engine.quant`` and
``engine.cascade`` included), the ``observability`` block (tracing,
metrics, flight recorder, runtime and program stats, decision records),
the request gates (``ratelimit``, ``skip_processing``,
``prompt_compression``) and the named routing profiles (``recipes``)
with the virtual model names that select them (``entrypoints``), the
shared state plane (``stateplane``), the vector stores (``vectorstore``)
and the on-device ANN plane (``ann``).  A canonical ``global:`` block
is lifted to the top level first, as the reference does.  Other blocks
of a config file are not read; the options the
reference serves and the port does not yet (``refuse_unported``) are
refused at load, never served as if absent.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SIGNAL_KEYWORD = "keyword"
SIGNAL_EMBEDDING = "embedding"
SIGNAL_DOMAIN = "domain"
SIGNAL_FACT_CHECK = "fact_check"
SIGNAL_USER_FEEDBACK = "user_feedback"
SIGNAL_REASK = "reask"
SIGNAL_PREFERENCE = "preference"
SIGNAL_LANGUAGE = "language"
SIGNAL_CONTEXT = "context"
SIGNAL_STRUCTURE = "structure"
SIGNAL_COMPLEXITY = "complexity"
SIGNAL_MODALITY = "modality"
SIGNAL_AUTHZ = "authz"
SIGNAL_JAILBREAK = "jailbreak"
SIGNAL_PII = "pii"
SIGNAL_KB = "kb"
SIGNAL_CONVERSATION = "conversation"
SIGNAL_EVENT = "event"
SIGNAL_PROJECTION = "projection"

ALL_SIGNAL_TYPES = (
    SIGNAL_KEYWORD, SIGNAL_EMBEDDING, SIGNAL_DOMAIN, SIGNAL_FACT_CHECK,
    SIGNAL_USER_FEEDBACK, SIGNAL_REASK, SIGNAL_PREFERENCE, SIGNAL_LANGUAGE,
    SIGNAL_CONTEXT, SIGNAL_STRUCTURE, SIGNAL_COMPLEXITY, SIGNAL_MODALITY,
    SIGNAL_AUTHZ, SIGNAL_JAILBREAK, SIGNAL_PII, SIGNAL_KB,
    SIGNAL_CONVERSATION, SIGNAL_EVENT, SIGNAL_PROJECTION,
)


def _take(d: Dict[str, Any], *names: str, default: Any = None) -> Any:
    for n in names:
        if n in d:
            return d[n]
    return default


# --------------------------------------------------------------------------
# Signal rule configs
# --------------------------------------------------------------------------


@dataclass
class KeywordRule:
    """Keyword rule: exact substring, regex, fuzzy, BM25 or n-gram
    matching of the keywords against the user text."""

    name: str
    keywords: List[str] = field(default_factory=list)
    operator: str = "OR"  # OR | AND
    method: str = "exact"  # exact | regex | fuzzy | bm25 | ngram
    case_sensitive: bool = False
    fuzzy_match: bool = False
    fuzzy_threshold: float = 80.0  # 0-100 similarity percent
    bm25_threshold: float = 0.1
    ngram_threshold: float = 0.4
    ngram_arity: int = 3

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KeywordRule":
        return cls(
            name=d["name"],
            keywords=list(d.get("keywords", [])),
            operator=str(d.get("operator", "OR")).upper(),
            method=d.get("method",
                         "fuzzy" if d.get("fuzzy_match") else "exact"),
            case_sensitive=bool(d.get("case_sensitive", False)),
            fuzzy_match=bool(d.get("fuzzy_match", False)),
            fuzzy_threshold=float(d.get("fuzzy_threshold", 80.0)),
            bm25_threshold=float(d.get("bm25_threshold", 0.1)),
            ngram_threshold=float(d.get("ngram_threshold", 0.4)),
            ngram_arity=int(d.get("ngram_arity", 3)),
        )


@dataclass
class ReaskRule:
    """Repeated-user-turn dissatisfaction: the current user turn against
    the previous ``lookback_turns`` user turns."""

    name: str
    threshold: float = 0.8
    lookback_turns: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ReaskRule":
        return cls(name=d["name"],
                   threshold=float(d.get("threshold", 0.8)),
                   lookback_turns=int(d.get("lookback_turns", 1)))


_TOKEN_SUFFIX = {"k": 1024, "m": 1024 * 1024}


def parse_token_count(v: Any) -> int:
    """'32K' / '256K' / plain numbers → a token count."""
    if v is None:
        return 0
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    if not s:
        return 0
    if s[-1] in _TOKEN_SUFFIX:
        return int(float(s[:-1]) * _TOKEN_SUFFIX[s[-1]])
    return int(float(s))


@dataclass
class ContextRule:
    """Token-length band (max_tokens 0 = unbounded)."""

    name: str
    min_tokens: int = 0
    max_tokens: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ContextRule":
        return cls(name=d["name"],
                   min_tokens=parse_token_count(d.get("min_tokens")),
                   max_tokens=parse_token_count(d.get("max_tokens")))


@dataclass
class FeatureSource:
    """Where a structure or conversation feature is computed from."""

    # regex | keyword_set | sequence | message | tool_definition |
    # active_tool_loop
    type: str = "regex"
    pattern: str = ""
    keywords: List[str] = field(default_factory=list)
    sequences: List[List[str]] = field(default_factory=list)
    case_sensitive: bool = False
    role: str = ""  # message source: user | assistant | ... | non_user

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FeatureSource":
        return cls(
            type=d.get("type", "regex"),
            pattern=d.get("pattern", ""),
            keywords=list(d.get("keywords", [])),
            sequences=[list(s) for s in d.get("sequences", [])],
            case_sensitive=bool(d.get("case_sensitive", False)),
            role=d.get("role", ""),
        )


@dataclass
class Predicate:
    """Numeric comparison bundle: any subset of gt/gte/lt/lte/eq."""

    gt: Optional[float] = None
    gte: Optional[float] = None
    lt: Optional[float] = None
    lte: Optional[float] = None
    eq: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "Predicate":
        d = d or {}

        def fv(k: str) -> Optional[float]:
            return float(d[k]) if d.get(k) is not None else None

        return cls(gt=fv("gt"), gte=fv("gte"), lt=fv("lt"), lte=fv("lte"),
                   eq=fv("eq"))

    def is_empty(self) -> bool:
        return all(v is None for v in (self.gt, self.gte, self.lt,
                                       self.lte, self.eq))

    def check(self, value: float) -> bool:
        if self.gt is not None and not value > self.gt:
            return False
        if self.gte is not None and not value >= self.gte:
            return False
        if self.lt is not None and not value < self.lt:
            return False
        if self.lte is not None and not value <= self.lte:
            return False
        if self.eq is not None and value != self.eq:
            return False
        return True


@dataclass
class StructureRule:
    """Prompt-structure feature (count | exists | sequence | density over
    a regex, keyword-set or sequence source) held to a predicate.  The
    conversation family reads the same shape over message sources."""

    name: str
    feature_type: str = "count"
    source: FeatureSource = field(default_factory=FeatureSource)
    predicate: Predicate = field(default_factory=Predicate)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StructureRule":
        feat = d.get("feature", {}) or {}
        return cls(
            name=d["name"],
            feature_type=feat.get("type", "count"),
            source=FeatureSource.from_dict(feat.get("source", {}) or {}),
            predicate=Predicate.from_dict(d.get("predicate")),
        )


ConversationRule = StructureRule


@dataclass
class AuthzRule:
    """Role binding: identity groups and users (``subjects`` of
    {kind, name}) mapped to a named role signal."""

    name: str
    role: str = ""
    subjects: List[Dict[str, str]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AuthzRule":
        return cls(name=d["name"], role=d.get("role", d["name"]),
                   subjects=[dict(s) for s in d.get("subjects", [])])


@dataclass
class KBRule:
    """Knowledge-base rule: the query's best label or group score in one
    knowledge base (``target`` {kind: label | group, value}) against the
    threshold."""

    name: str
    kb: str = ""
    target: Dict[str, str] = field(default_factory=dict)
    match: str = "best"  # best | any
    # None = the evaluator's default; an explicit 0.0 is unconditional
    threshold: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KBRule":
        return cls(
            name=d["name"],
            kb=d.get("kb", ""),
            target=dict(d.get("target", {}) or {}),
            match=d.get("match", "best"),
            threshold=None if d.get("threshold") is None
            else float(d["threshold"]),
        )


@dataclass
class KnowledgeBaseDef:
    """Exemplar knowledge base: labels with exemplar texts, label groups,
    and metrics ({name, type: group_margin, positive_group,
    negative_group}) that feed ``kb_metric`` projection inputs."""

    name: str
    labels: Dict[str, List[str]] = field(default_factory=dict)
    groups: Dict[str, List[str]] = field(default_factory=dict)
    metrics: List[Dict[str, str]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KnowledgeBaseDef":
        labels = {}
        for label, spec in (d.get("labels", {}) or {}).items():
            if isinstance(spec, dict):
                labels[label] = list(spec.get("exemplars", []) or [])
            else:
                labels[label] = list(spec or [])
        return cls(
            name=d["name"],
            labels=labels,
            groups={g: list(v or []) for g, v in
                    (d.get("groups", {}) or {}).items()},
            metrics=[dict(m) for m in (d.get("metrics", []) or [])],
        )


@dataclass
class EventRule:
    """Request event metadata (type, severity, action code) against the
    rule's allowed values (an empty list allows any)."""

    name: str
    event_types: List[str] = field(default_factory=list)
    severities: List[str] = field(default_factory=list)
    action_codes: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EventRule":
        return cls(name=d["name"],
                   event_types=list(d.get("event_types", [])),
                   severities=list(d.get("severities", [])),
                   action_codes=list(d.get("action_codes", [])))


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
    """Every configured signal rule, by family."""

    keywords: List[KeywordRule] = field(default_factory=list)
    embeddings: List[EmbeddingRule] = field(default_factory=list)
    domains: List[DomainRule] = field(default_factory=list)
    fact_check: List[NamedRule] = field(default_factory=list)
    user_feedbacks: List[NamedRule] = field(default_factory=list)
    reasks: List[ReaskRule] = field(default_factory=list)
    preferences: List[PreferenceRule] = field(default_factory=list)
    language: List[NamedRule] = field(default_factory=list)
    context: List[ContextRule] = field(default_factory=list)
    structure: List[StructureRule] = field(default_factory=list)
    complexity: List[ComplexityRule] = field(default_factory=list)
    modality: List[NamedRule] = field(default_factory=list)
    role_bindings: List[AuthzRule] = field(default_factory=list)
    jailbreak: List[JailbreakRule] = field(default_factory=list)
    pii: List[PIIRule] = field(default_factory=list)
    kb: List[KBRule] = field(default_factory=list)
    conversation: List[ConversationRule] = field(default_factory=list)
    events: List[EventRule] = field(default_factory=list)

    # signal type → (attribute, rule class)
    FAMILIES = {
        SIGNAL_KEYWORD: ("keywords", KeywordRule),
        SIGNAL_EMBEDDING: ("embeddings", EmbeddingRule),
        SIGNAL_DOMAIN: ("domains", DomainRule),
        SIGNAL_FACT_CHECK: ("fact_check", NamedRule),
        SIGNAL_USER_FEEDBACK: ("user_feedbacks", NamedRule),
        SIGNAL_REASK: ("reasks", ReaskRule),
        SIGNAL_PREFERENCE: ("preferences", PreferenceRule),
        SIGNAL_LANGUAGE: ("language", NamedRule),
        SIGNAL_CONTEXT: ("context", ContextRule),
        SIGNAL_STRUCTURE: ("structure", StructureRule),
        SIGNAL_COMPLEXITY: ("complexity", ComplexityRule),
        SIGNAL_MODALITY: ("modality", NamedRule),
        SIGNAL_AUTHZ: ("role_bindings", AuthzRule),
        SIGNAL_JAILBREAK: ("jailbreak", JailbreakRule),
        SIGNAL_PII: ("pii", PIIRule),
        SIGNAL_KB: ("kb", KBRule),
        SIGNAL_CONVERSATION: ("conversation", ConversationRule),
        SIGNAL_EVENT: ("events", EventRule),
    }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SignalsConfig":
        d = d or {}
        return cls(**{attr: [rule.from_dict(x) for x in d.get(attr, [])]
                      for attr, rule in cls.FAMILIES.values()})

    def rule_names(self, signal_type: str) -> List[str]:
        """Every configured rule name of one signal family."""
        attr = self.FAMILIES.get(signal_type, ("", None))[0]
        return [r.name for r in getattr(self, attr, [])] if attr else []


# --------------------------------------------------------------------------
# Projections
# --------------------------------------------------------------------------


@dataclass
class ProjectionPartition:
    """Mutually interacting signal rules normalized into a distribution
    (temperature softmax over member confidences)."""

    name: str
    members: List[str] = field(default_factory=list)
    semantics: str = "exclusive"  # exclusive | overlapping
    temperature: float = 1.0
    default: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProjectionPartition":
        return cls(name=d["name"], members=list(d.get("members", [])),
                   semantics=d.get("semantics", "exclusive"),
                   temperature=float(d.get("temperature", 1.0)),
                   default=d.get("default", ""))


@dataclass
class ScoreInput:
    type: str = ""
    name: str = ""
    weight: float = 0.0
    value_source: str = "match"  # match | confidence | score
    match: float = 1.0
    miss: float = 0.0
    kb: str = ""
    metric: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScoreInput":
        return cls(type=d.get("type", ""), name=d.get("name", ""),
                   weight=float(d.get("weight", 0.0)),
                   value_source=d.get("value_source", "match"),
                   match=float(d.get("match", 1.0)),
                   miss=float(d.get("miss", 0.0)),
                   kb=d.get("kb", ""), metric=d.get("metric", ""))


@dataclass
class ProjectionScore:
    name: str
    method: str = "weighted_sum"
    inputs: List[ScoreInput] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProjectionScore":
        return cls(name=d["name"], method=d.get("method", "weighted_sum"),
                   inputs=[ScoreInput.from_dict(x)
                           for x in d.get("inputs", [])])


@dataclass
class MappingOutput:
    name: str
    predicate: Predicate = field(default_factory=Predicate)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MappingOutput":
        return cls(name=d["name"], predicate=Predicate.from_dict(d))


@dataclass
class ProjectionMapping:
    """Score → named band, optionally calibrated into a confidence."""

    name: str
    source: str = ""
    method: str = "threshold_bands"
    calibration: Dict[str, Any] = field(default_factory=dict)
    outputs: List[MappingOutput] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProjectionMapping":
        return cls(name=d["name"], source=d.get("source", ""),
                   method=d.get("method", "threshold_bands"),
                   calibration=dict(d.get("calibration", {}) or {}),
                   outputs=[MappingOutput.from_dict(x)
                            for x in d.get("outputs", [])])


@dataclass
class ProjectionsConfig:
    partitions: List[ProjectionPartition] = field(default_factory=list)
    scores: List[ProjectionScore] = field(default_factory=list)
    mappings: List[ProjectionMapping] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProjectionsConfig":
        d = d or {}
        return cls(
            partitions=[ProjectionPartition.from_dict(x)
                        for x in d.get("partitions", [])],
            scores=[ProjectionScore.from_dict(x)
                    for x in d.get("scores", [])],
            mappings=[ProjectionMapping.from_dict(x)
                      for x in d.get("mappings", [])],
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
    weight: float = 1.0
    use_reasoning: bool = False
    reasoning_effort: str = ""
    lora_name: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelRef":
        return cls(
            model=d["model"],
            weight=float(d.get("weight", 1.0)),
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
    models, the selection ``algorithm`` that picks one of them
    (``{type: ..., <keyword arguments>}``) and its plugins."""

    name: str
    rules: RuleNode = field(default_factory=RuleNode)
    priority: int = 0
    model_refs: List[ModelRef] = field(default_factory=list)
    algorithm: Dict[str, Any] = field(default_factory=dict)  # {type: ...}
    plugins: List[PluginConfig] = field(default_factory=list)
    # router learning: the tier its experience ledgers are kept under, and
    # the decision's ``adaptations: {mode: apply | observe | bypass}``
    tier: int = 0
    adaptations: Dict[str, Any] = field(default_factory=dict)

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
            algorithm=dict(d.get("algorithm", {}) or {}),
            plugins=[PluginConfig.from_dict(p) for p in d.get("plugins", [])],
            tier=int(d.get("tier", 0)),
            adaptations=dict(d.get("adaptations", {}) or {}),
        )

    def plugin(self, ptype: str) -> Optional[PluginConfig]:
        for p in self.plugins:
            if p.type == ptype:
                return p
        return None


@dataclass
class LoRACard:
    """A LoRA adapter a model card declares (a decision's ``lora_name``
    must name one)."""

    name: str
    description: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoRACard":
        return cls(name=d["name"], description=d.get("description", ""))


@dataclass
class ModelCard:
    """Backend model card (routing.modelCards): the catalog of models the
    decisions may name, with what selectors read of each, its declared
    LoRA adapters, and the model's own weighted backend endpoints
    (``backend_refs``: [{endpoint, weight}]; none = the server's default
    backend)."""

    name: str
    param_size: str = ""
    context_window_size: int = 0
    quality_score: float = 0.0
    modality: str = "ar"  # ar | diffusion | omni (GET /v1/models)
    tags: List[str] = field(default_factory=list)
    pricing: Dict[str, float] = field(default_factory=dict)  # per 1M tokens
    backend_refs: List[Dict[str, Any]] = field(default_factory=list)
    loras: List[LoRACard] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelCard":
        return cls(
            name=d["name"],
            param_size=str(d.get("param_size", "")),
            context_window_size=parse_token_count(
                d.get("context_window_size", 0)),
            quality_score=float(d.get("quality_score", 0.0)),
            modality=d.get("modality", "ar"),
            tags=list(d.get("tags", [])),
            pricing=dict(d.get("pricing", {}) or {}),
            backend_refs=[dict(b) for b in d.get("backend_refs", [])],
            loras=[LoRACard.from_dict(x) for x in d.get("loras", []) or []],
        )

    def param_size_billions(self) -> float:
        s = self.param_size.strip().upper().rstrip("B")
        try:
            return float(s)
        except ValueError:
            return 0.0


# --------------------------------------------------------------------------
# Semantic cache, engine, top level
# --------------------------------------------------------------------------


@dataclass
class SemanticCacheConfig:
    """The response cache: backend, similarity threshold, capacity, TTL,
    eviction policy, and the embedding task that backs it (empty = the
    router's default embedding task)."""

    enabled: bool = False
    backend_type: str = "memory"  # memory | hnsw | hybrid | redis | valkey
    similarity_threshold: float = 0.8
    max_entries: int = 1000
    ttl_seconds: int = 3600
    eviction_policy: str = "fifo"  # fifo | lru | lfu
    embedding_model: str = ""
    use_hnsw: bool = True
    # the external store's connection: host, port, db, password,
    # key_prefix (redis / valkey)
    backend_config: Dict[str, Any] = field(default_factory=dict)

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
            backend_config=dict(d.get("backend_config", {}) or {}),
        )


@dataclass
class InferenceEngineConfig:
    """Engine knobs: the batching shim, the padding buckets, attention and
    kernel toggles, sequence packing, and the 2D-Matryoshka variants an
    embedding task serves (layer exits x output dims)."""

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
    # fused classifier bank: classifiers whose trunk weights (by content),
    # tokenizer and shape discipline agree batch as ONE (trunk, bucket)
    # group; False serves every task on its own (register_task's ``fuse``
    # overrides it per task)
    fuse_trunks: bool = True
    # sequence-packed continuous batching (enabled, min_segments,
    # max_segments_per_row, max_items_per_step, max_inflight_steps,
    # starvation_steps, autotune), normalized by
    # engine.packing.normalize_packing; on by default, as the reference's
    # (only a fused group on dense attention packs)
    packing: Dict[str, Any] = field(default_factory=dict)
    # tuned-kernel toggles, normalized by engine.kernels.normalize_kernels
    kernels: Dict[str, Any] = field(default_factory=dict)
    # quantized trunk serving (mode off | bf16 | int8, group selector,
    # parity calibration), normalized by engine.kernels.normalize_quant
    quant: Dict[str, Any] = field(default_factory=dict)
    # the decision-aware signal cascade (enabled, wave_size, max_waves,
    # brownout_max_waves, cost_default_ms, value_blend), normalized by
    # engine.cascade.normalize_cascade; off = the full fan-out
    cascade: Dict[str, Any] = field(default_factory=dict)

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
            fuse_trunks=bool(d.get("fuse_trunks", True)),
            packing=dict(d.get("packing", {}) or {}),
            kernels=dict(d.get("kernels", {}) or {}),
            quant=dict(d.get("quant", {}) or {}),
            cascade=dict(d.get("cascade", {}) or {}),
        )
        if d.get("seq_len_buckets"):
            out.seq_len_buckets = [int(x) for x in d["seq_len_buckets"]]
        return out

    def packing_config(self) -> Dict[str, Any]:
        """The normalized ``engine.packing`` block."""
        from ..engine.packing import normalize_packing

        return normalize_packing(self.packing)

    def quant_config(self) -> Dict[str, Any]:
        """The normalized ``engine.quant`` block."""
        from ..engine.kernels import normalize_quant

        return normalize_quant(self.quant)

    def kernels_config(self) -> Dict[str, Any]:
        """The normalized ``engine.kernels`` block."""
        from ..engine.kernels import normalize_kernels

        return normalize_kernels(self.kernels)

    def cascade_config(self) -> Dict[str, Any]:
        """The normalized ``engine.cascade`` block."""
        from ..engine.cascade import normalize_cascade

        return normalize_cascade(self.cascade)


DEFAULT_RECIPE_NAME = "default"


@dataclass
class RoutingRecipe:
    """One named routing profile: signals, projections, decisions and
    strategy, as the top-level routing block has them (the model catalog
    stays shared across recipes).  The profile's keys sit under its
    ``routing:`` key or on the recipe itself."""

    name: str
    description: str = ""
    signals: SignalsConfig = field(default_factory=SignalsConfig)
    projections: ProjectionsConfig = field(default_factory=ProjectionsConfig)
    decisions: List[Decision] = field(default_factory=list)
    strategy: str = "priority"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoutingRecipe":
        d = d or {}
        routing = d.get("routing", d) or {}
        return cls(
            name=str(d.get("name", "")),
            description=str(d.get("description", "")),
            signals=SignalsConfig.from_dict(routing.get("signals", {})),
            projections=ProjectionsConfig.from_dict(
                routing.get("projections", {})),
            decisions=[Decision.from_dict(x)
                       for x in routing.get("decisions", []) or []],
            strategy=str(routing.get("strategy", "priority")),
        )


@dataclass
class Entrypoint:
    """Virtual request model names bound to a recipe: a request naming
    one routes through the recipe's profile; the name never reaches a
    backend."""

    model_names: List[str] = field(default_factory=list)
    recipe: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Entrypoint":
        d = d or {}
        return cls(
            model_names=[str(m) for m in d.get("model_names", []) or []],
            recipe=str(d.get("recipe", "")))


# options the JAX router serves and this port does not yet: a config that
# asks for one is refused at load, never served as if it were absent
UNPORTED = {
    "flywheel": "the routing flywheel (flywheel.enabled)",
}

# top-level blocks the JAX router reads and this port does not: refused
# when enabled (``enabled: true``, or a non-empty block or list without an
# ``enabled`` switch), as the reference's default leaves each off
UNPORTED_BLOCKS = {
    "mcp": "MCP classifiers",
    "external_models": "external models",
}
# engine knobs the JAX engine reads and this port does not
UNPORTED_ENGINE = {
    "mesh": "the serving mesh",
    "mesh_shape": "the engine mesh",
}
# decision algorithms that run several models downstream (the
# reference's looper): the HTTP server executes them
LOOPER_ALGORITHMS = ("confidence", "ratings", "remom", "fusion",
                     "workflows")


def lift_global(d: Dict[str, Any]) -> Dict[str, Any]:
    """The canonical ``global:`` block's keys lifted to the top level;
    explicit top-level keys win (the reference's rule)."""
    if isinstance(d.get("global"), dict):
        d = {**d["global"], **{k: v for k, v in d.items() if k != "global"}}
    return d


def _enabled(block: Any) -> bool:
    """A block or list the reference would act on: ``enabled`` true, or
    non-empty with no ``enabled`` switch."""
    if isinstance(block, dict):
        if "enabled" in block:
            return bool(block["enabled"])
        return bool(block)
    return bool(block)


def config_hash(raw: Dict[str, Any]) -> str:
    """Stable content hash of a config dict (decision-record provenance):
    the reference's, sha256 over the YAML dump, when ``yaml`` is present;
    over canonical JSON otherwise."""
    try:
        import yaml

        dumped = yaml.safe_dump(raw or {}, sort_keys=True)
    except ImportError:
        dumped = json.dumps(raw or {}, sort_keys=True, default=str)
    return hashlib.sha256(dumped.encode()).hexdigest()[:16]


# the Responses API stores the port builds (router/responseapi.py)
RESPONSE_STORE_BACKENDS = ("memory", "redis", "valkey", "redis-cluster",
                           "valkey-cluster")


def refuse_unported(d: Dict[str, Any]) -> None:
    """Raise ValueError naming the first unported option ``d`` (with its
    ``global:`` block lifted) enables: the blocks of ``UNPORTED`` and
    ``UNPORTED_BLOCKS``, the engine knobs of ``UNPORTED_ENGINE``, the
    observability sub-blocks this port does not serve (fleet-scoped SLO
    objectives, the fleet observability plane, a durable decision store
    other than SQLite), a ``response_store`` backend outside
    ``RESPONSE_STORE_BACKENDS``, the ANN bank's row sharding
    (``ann.mesh``), a selector ``algorithm.artifact`` the routing
    flywheel trains (``refuse_flywheel_artifact``).  Router replay
    (``router_replay``, on by default), OTLP span and log export
    (``observability.tracing.otlp_endpoint``) and every other selector
    artifact are served, as are the shared state
    plane (``stateplane``, its fleet-shared ladder and upstream
    circuits), the RESP-backed stores and the retrieval plane (``ann`` on
    one device, ``vectorstore`` with every backend the reference names,
    Llama-Stack included, and its Postgres store registry, the ``rag``
    plugin, qdrant / milvus memory stores and caches) and sequence
    packing (``engine.packing``) are served."""
    d = lift_global(d)
    routing = d.get("routing", {}) or {}
    for key, what in UNPORTED.items():
        block = routing.get(key, d.get(key)) or {}
        if isinstance(block, dict) and block.get("enabled"):
            raise ValueError(f"{what} is not served by this port yet")
    for key, what in UNPORTED_BLOCKS.items():
        if _enabled(routing.get(key, d.get(key))):
            raise ValueError(f"{key}: {what} is not served by this port "
                             f"yet")
    engine = d.get("engine", d.get("inference_engine", {})) or {}
    for key, what in UNPORTED_ENGINE.items():
        if _enabled(engine.get(key)):
            raise ValueError(f"engine.{key}: {what} is not served by this "
                             f"port yet")
    obs = d.get("observability", {}) or {}
    for spec in (obs.get("slo") or {}).get("objectives", []) or []:
        if isinstance(spec, dict) and \
                str(spec.get("scope", "")).lower() == "fleet":
            raise ValueError(f"observability.slo: objective {spec!r} has "
                             f"scope: fleet, which reads the merged fleet "
                             f"counts of the fleet observability plane; "
                             f"this port does not serve it yet")
    if (obs.get("fleet") or {}).get("enabled"):
        raise ValueError("observability.fleet.enabled: the fleet "
                         "observability plane is not served by this port "
                         "yet")
    durable = (obs.get("decisions") or {}).get("durable") or {}
    if str(durable.get("backend", "") or "") not in ("", "sqlite"):
        raise ValueError(f"observability.decisions.durable.backend "
                         f"{durable['backend']!r} is not served by this "
                         f"port yet (sqlite only)")
    # the reference builds the configured store whether or not the block
    # says enabled
    store = d.get("response_store") or {}
    if isinstance(store, dict) and str(store.get("backend", "memory")
                                       or "memory") \
            not in RESPONSE_STORE_BACKENDS:
        raise ValueError(f"response_store.backend {store['backend']!r} is "
                         f"not served by this port yet "
                         f"({'|'.join(RESPONSE_STORE_BACKENDS)})")
    ann = routing.get("ann", d.get("ann")) or {}
    if isinstance(ann, dict) and ann.get("enabled") \
            and _enabled(ann.get("mesh")):
        raise ValueError("ann.mesh: the ANN bank's row sharding is not "
                         "served by this port yet (one device)")
    decisions = list(routing.get("decisions", d.get("decisions", [])) or [])
    for rec in d.get("recipes", []) or []:
        rec = rec or {}
        decisions += (rec.get("routing", rec) or {}).get("decisions", []) \
            or []
    for dec in decisions:
        artifact = (dec.get("algorithm") or {}).get("artifact")
        if artifact:
            refuse_flywheel_artifact(dec.get("name", ""), str(artifact))


# the selector artifact algorithm only the routing flywheel's policy loads
FLYWHEEL_ARTIFACTS = ("cost_bandit",)


def refuse_flywheel_artifact(decision: str, path: str) -> None:
    """Raise ValueError when the selector artifact at ``path`` is one the
    reference loads through the routing flywheel (a ``cost_bandit``
    policy), which this port does not serve.  A missing or unreadable
    file passes: the selector factory falls back to the untrained
    selector for it, as the reference's does."""
    try:
        with open(path) as f:
            algo = json.load(f).get("algorithm")
    except (OSError, ValueError, AttributeError):
        return
    if algo in FLYWHEEL_ARTIFACTS:
        raise ValueError(f"decision {decision!r}: algorithm.artifact "
                         f"{path!r} is a {algo} artifact, which loads "
                         f"through the routing flywheel (flywheel.policy); "
                         f"the flywheel is not served by this port yet")


@dataclass
class RouterConfig:
    model_cards: List[ModelCard] = field(default_factory=list)
    signals: SignalsConfig = field(default_factory=SignalsConfig)
    projections: ProjectionsConfig = field(default_factory=ProjectionsConfig)
    decisions: List[Decision] = field(default_factory=list)
    strategy: str = "priority"  # priority | confidence
    default_model: str = ""
    engine: InferenceEngineConfig = field(
        default_factory=InferenceEngineConfig)
    semantic_cache: SemanticCacheConfig = field(
        default_factory=SemanticCacheConfig)
    # task name -> {checkpoint, tokenizer, kind, labels, max_seq_len}
    classifier_models: Dict[str, Any] = field(default_factory=dict)
    # {fail_open, credentials, trust_identity_headers}: the upstream
    # credentials (router/authz.py) and whether an authz evaluation error
    # passes
    authz: Dict[str, Any] = field(default_factory=dict)
    knowledge_bases: List[KnowledgeBaseDef] = field(default_factory=list)
    # {backend: "" | sqlite | qdrant | milvus, path, base_url, ...}: the
    # user-memory store
    memory: Dict[str, Any] = field(default_factory=dict)
    # {tools: [...]}: the tools database of ``auto_select``
    tool_selection: Dict[str, Any] = field(default_factory=dict)
    # the observability block, read through the accessors below
    observability: Dict[str, Any] = field(default_factory=dict)
    # per-(user, model) token buckets: {requests_per_minute, burst,
    # per_user, per_model}; no rate set = no limit
    ratelimit: Dict[str, Any] = field(default_factory=dict)
    # {enabled, profile, target_ratio, min_tokens}: extractive compression
    # of long prompts before the signals see them
    prompt_compression: Dict[str, Any] = field(default_factory=dict)
    # {enabled, allow_skip_signals_header, skip_signals}: the
    # x-vsr-skip-processing passthrough and the operator's skipped
    # families, both off unless enabled
    skip_processing: Dict[str, Any] = field(default_factory=dict)
    # named routing profiles, and the virtual model names that select them
    recipes: List[RoutingRecipe] = field(default_factory=list)
    # the degradation ladder and the upstream health plane, read through
    # resilience_config() and upstream_config()
    resilience: Dict[str, Any] = field(default_factory=dict)
    entrypoints: List[Entrypoint] = field(default_factory=list)
    # {http_workers}: the pooled front end's request workers
    api_server: Dict[str, Any] = field(default_factory=dict)
    # {workflow_state: {backend: memory | redis | valkey, ttl_seconds,
    # host, port}}: the looper's workflow state store
    looper: Dict[str, Any] = field(default_factory=dict)
    # {backend: memory | redis | valkey | redis-cluster | valkey-cluster,
    # max_entries, ttl_seconds, host, port, nodes, key_prefix}: the
    # Responses API store
    response_store: Dict[str, Any] = field(default_factory=dict)
    # the shared state plane, read through stateplane_config()
    stateplane: Dict[str, Any] = field(default_factory=dict)
    # {backend: memory | sqlite | ann | stateplane | qdrant | milvus, path,
    # backend_config}: the named vector stores the rag plugin searches
    vectorstore: Dict[str, Any] = field(default_factory=dict)
    # {enabled (default true), backend: memory | sqlite | postgres, path,
    # max_records, capture_request_body, capture_response_body, host,
    # port, user, database, password}: the router replay store every
    # routed response is recorded to
    router_replay: Dict[str, Any] = field(default_factory=dict)
    # the on-device ANN plane, read through ann_config()
    ann: Dict[str, Any] = field(default_factory=dict)
    # router learning: {enabled, store: {backend: sqlite | redis | valkey,
    # path, host, port, ...}, adaptation: {enabled, candidate_set, mode},
    # protection: {enabled, scope, identity, tuning}}
    learning: Dict[str, Any] = field(default_factory=dict)
    # the canonical contract's top-level surface, kept for its export
    # (``canonical.export_canonical``)
    listeners: List[Dict[str, Any]] = field(default_factory=list)
    providers: Dict[str, Any] = field(default_factory=dict)
    version: str = ""
    # the dict this config was parsed from (``global:`` lifted)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RouterConfig":
        d = lift_global(d or {})
        routing = d.get("routing", {}) or {}
        refuse_unported(d)
        return cls(
            model_cards=[ModelCard.from_dict(m) for m in
                         routing.get("modelCards", d.get("model_cards", []))],
            signals=SignalsConfig.from_dict(
                routing.get("signals", d.get("signals", {}))),
            projections=ProjectionsConfig.from_dict(
                routing.get("projections", d.get("projections", {}))),
            decisions=[Decision.from_dict(x) for x in
                       routing.get("decisions", d.get("decisions", []))],
            strategy=routing.get("strategy", d.get("strategy", "priority")),
            # the canonical contract keeps it in providers.defaults
            default_model=d.get("default_model", routing.get(
                "default_model",
                ((d.get("providers") or {}).get("defaults") or {})
                .get("default_model", ""))),
            engine=InferenceEngineConfig.from_dict(
                d.get("engine", d.get("inference_engine", {}))),
            semantic_cache=SemanticCacheConfig.from_dict(
                d.get("semantic_cache", {})),
            classifier_models=dict(d.get("classifier_models", {}) or {}),
            authz=dict(d.get("authz", {}) or {}),
            knowledge_bases=[
                KnowledgeBaseDef.from_dict(k) for k in
                d.get("knowledge_bases",
                      routing.get("knowledge_bases", [])) or []],
            memory=dict(d.get("memory", {}) or {}),
            tool_selection=dict(d.get("tool_selection", {}) or {}),
            observability=dict(d.get("observability", {}) or {}),
            ratelimit=dict(d.get("ratelimit", {}) or {}),
            prompt_compression=dict(d.get("prompt_compression", {}) or {}),
            skip_processing=dict(d.get("skip_processing", {}) or {}),
            recipes=[RoutingRecipe.from_dict(r)
                     for r in d.get("recipes", []) or []],
            entrypoints=[Entrypoint.from_dict(e)
                         for e in d.get("entrypoints", []) or []],
            resilience=dict(d.get("resilience", {}) or {}),
            api_server=dict(d.get("api_server", {}) or {}),
            looper=dict(d.get("looper", {}) or {}),
            response_store=dict(d.get("response_store", {}) or {}),
            stateplane=dict(d.get("stateplane", {}) or {}),
            vectorstore=dict(d.get("vectorstore", {}) or {}),
            router_replay=dict(d.get("router_replay", {}) or {}),
            ann=dict(d.get("ann", {}) or {}),
            learning=dict(routing.get("learning",
                                      d.get("learning", {})) or {}),
            listeners=list(d.get("listeners", []) or []),
            providers=dict(d.get("providers", {}) or {}),
            version=str(d.get("version", "")),
            raw=d,
        )

    def model_card(self, name: str) -> Optional[ModelCard]:
        for m in self.model_cards:
            if m.name == name:
                return m
        return None

    # -- recipes -------------------------------------------------------------

    def recipe_by_name(self, name: str) -> Optional[RoutingRecipe]:
        """A recipe by name; ``DEFAULT_RECIPE_NAME`` always resolves, to
        a recipe of the top-level routing fields."""
        for r in self.recipes:
            if r.name == name:
                return r
        if name == DEFAULT_RECIPE_NAME:
            return RoutingRecipe(
                name=DEFAULT_RECIPE_NAME, signals=self.signals,
                projections=self.projections, decisions=self.decisions,
                strategy=self.strategy)
        return None

    def recipe_for_request_model(self, model: str
                                 ) -> Optional[RoutingRecipe]:
        """The recipe an entrypoint binds a request's model name to;
        None when no entrypoint names it."""
        model = (model or "").strip()
        if not model:
            return None
        for ep in self.entrypoints:
            if model in ep.model_names:
                return self.recipe_by_name(ep.recipe)
        return None

    # -- observability knobs ------------------------------------------------
    # The reference's accessors, with its defaults: the ONE place the
    # block's sub-keys are interpreted.  A malformed telemetry value
    # falls back to the default (telemetry config is never fatal).

    def tracing_config(self) -> Dict[str, Any]:
        return dict((self.observability or {}).get("tracing", {}) or {})

    def tracing_sample_rate(self) -> float:
        """Fraction of traces given DETAILED batch tracing (the fenced
        per-stage device timing); continuity spans are never sampled
        away."""
        try:
            return float(self.tracing_config().get("sample_rate", 0.1))
        except (TypeError, ValueError):
            return 0.1

    def metrics_exemplars_enabled(self) -> bool:
        m = (self.observability or {}).get("metrics", {}) or {}
        return bool(m.get("exemplars", False))

    def flight_recorder_config(self) -> Dict[str, Any]:
        """FlightRecorder.configure kwargs (ms → s for the threshold)."""
        fr = (self.observability or {}).get("flight_recorder", {}) or {}
        out: Dict[str, Any] = {}
        try:
            if "slowest_n" in fr:
                out["slowest_n"] = int(fr["slowest_n"])
            if "threshold_ms" in fr:
                out["threshold_s"] = float(fr["threshold_ms"]) / 1e3
            if "breach_capacity" in fr:
                out["breach_capacity"] = int(fr["breach_capacity"])
        except (TypeError, ValueError):
            return {}
        return out

    def runtime_stats_config(self) -> Dict[str, Any]:
        """The always-on device-step sampler + process gauges (on by
        default)."""
        rs = (self.observability or {}).get("runtime_stats", {}) or {}
        try:
            interval = float(rs.get("interval_s", 10.0))
        except (TypeError, ValueError):
            interval = 10.0
        return {"enabled": bool(rs.get("enabled", True)),
                "interval_s": interval}

    def programstats_config(self) -> Dict[str, Any]:
        """The program-cost catalog (on by default).  The reference's
        ``slo_capture`` arm (one bounded profiler trace and a catalog
        snapshot per firing SLO alert, cooldown-gated) is on by default
        too."""
        ps = (self.observability or {}).get("programstats", {}) or {}
        cap = ps.get("slo_capture", {}) or {}
        try:
            trace_s = float(cap.get("trace_s", 2.0))
        except (TypeError, ValueError):
            trace_s = 2.0
        try:
            cooldown_s = float(cap.get("cooldown_s", 300.0))
        except (TypeError, ValueError):
            cooldown_s = 300.0
        return {"enabled": bool(ps.get("enabled", True)),
                "slo_capture": {
                    "enabled": bool(cap.get("enabled", True)),
                    "trace_s": max(0.0, trace_s),
                    "cooldown_s": max(0.0, cooldown_s)}}

    def slo_config(self) -> Dict[str, Any]:
        """The observability.slo block, passed verbatim to
        SLOMonitor.configure (which owns parsing + error containment) —
        absent block = no objectives = monitor disabled."""
        return dict((self.observability or {}).get("slo", {}) or {})

    def resilience_config(self) -> Dict[str, Any]:
        """The ``resilience`` block, passed verbatim to
        DegradationController.configure / PriorityResolver.from_config
        (which own parsing + error containment — a malformed resilience
        knob must never stop the server)::

          resilience:
            enabled: true
            interval_s: 2            # control-loop tick period
            max_level: 4             # ladder ceiling (0..4)
            escalate_ticks: 1        # overloaded ticks per rung up
            hysteresis_ticks: 3      # healthy ticks per rung down
            queue_high_watermark: 64 # batcher pending_items trip point
            saturation_high_watermark: 0.9   # dispatch-pool busy ratio
            brownout_class: normal   # this class and below go
                                     # heuristic-only at L2
            admission:               # L3 token buckets
              target_utilization: 0.8
              burst_s: 2.0
              reject_class: low      # 429'd outright at L3
              default_cost_ms: 5     # pre-telemetry request cost
            fail_static:
              model: ""              # L4 model ("" = default_model)
            priority:
              header: x-vsr-priority
              trust_header: true
              default: normal
              model_classes: {}      # model/entrypoint -> class
              group_classes: {}      # authz group -> class
        """
        return dict(self.resilience or {})

    def upstream_config(self) -> Dict[str, Any]:
        """Normalized ``resilience.upstream`` block — the upstream
        resilience plane (resilience/upstream.py), the one
        interpretation point::

          resilience:
            upstream:
              enabled: false       # default OFF: byte-identical routing
              fleet_share: true    # share open circuits and the retry
                                   # budget over the state plane (only
                                   # with stateplane.enabled)
              breaker:
                failures: 5        # consecutive failures to open
                open_s: 10         # cooldown before the half-open probe
                ewma_alpha: 0.2    # error-rate / latency EWMA weight
                error_rate: 0.5    # ALSO open on sustained EWMA error
                                   # rate >= this once >= 10 samples
                                   # exist (0 or 1 disables this leg)
              retry:
                budget_per_s: 1.0  # token-bucket retry budget
                burst: 10          # bucket burst (retries)
                max_attempts: 3    # total attempts incl. the first
                backoff_ms: 50     # jittered exponential backoff base
                disable_at_level: 2   # no retries at degradation >= L2
                on: [connect, 5xx, timeout, reset]  # retryable kinds
              deadline:
                header: x-vsr-deadline
                default_s: 0       # request budget (0 = flat forward
                                   # timeout)
                floor_s: 0.5       # per-attempt timeout floor

        Malformed values fall back to defaults — resilience config must
        never stop the server."""
        up = dict((self.resilience or {}).get("upstream", {}) or {})
        out: Dict[str, Any] = {
            "enabled": bool(up.get("enabled", False)),
            "fleet_share": bool(up.get("fleet_share", True)),
        }

        def _block(name: str, defaults: Dict[str, Any]) -> Dict[str, Any]:
            raw = dict(up.get(name, {}) or {})
            merged = dict(defaults)
            for k, v in raw.items():
                if k not in defaults:
                    continue
                want = type(defaults[k])
                try:
                    if want is bool:
                        merged[k] = bool(v)
                    elif want is int:
                        merged[k] = int(v)
                    elif want is float:
                        merged[k] = float(v)
                    elif want is list:
                        if isinstance(v, (list, tuple)):
                            merged[k] = [str(x) for x in v]
                        elif v:
                            merged[k] = [str(v)]
                    else:
                        merged[k] = str(v)
                except (TypeError, ValueError):
                    pass
            return merged

        out["breaker"] = _block("breaker", {
            "failures": 5, "open_s": 10.0, "ewma_alpha": 0.2,
            "error_rate": 0.5})
        out["retry"] = _block("retry", {
            "budget_per_s": 1.0, "burst": 10.0, "max_attempts": 3,
            "backoff_ms": 50.0, "disable_at_level": 2,
            "on": ["connect", "5xx", "timeout", "reset"],
            # share the retry budget FLEET-WIDE through the state plane:
            # N replicas spend ONE budget_per_s pool — only with a plane
            # attached and fleet_share on; plane loss degrades to the
            # local per-replica bucket
            "fleet_budget": True})
        out["deadline"] = _block("deadline", {
            "header": "x-vsr-deadline", "default_s": 0.0,
            "floor_s": 0.5})
        return out

    def stateplane_config(self) -> Dict[str, Any]:
        """Normalized ``stateplane`` block — the ONE interpretation
        point (bootstrap, the fleet harness, and tests must never drift
        on defaults)::

          stateplane:
            enabled: false         # default OFF: byte-identical
                                   # single-process behavior
            backend: resp          # memory | resp/redis/valkey | sqlite
            backend_config:
              host: redis.svc      # resp
              port: 6379
              path: /var/lib/vsr/plane.db   # sqlite
            replica_id: ""         # default host-pid-nonce
            namespace: srt         # key prefix on the shared store
            heartbeat_s: 2         # membership beat; TTL = 3x
            ring_vnodes: 64        # consistent-hash ring resolution
            cooldown_s: 2          # breaker reopen probe interval
            share:                 # which layers ride the plane
              cache: true
              vectorstore: true
              explain: true
              fleet: true          # fleet-aggregated shed ladder

        Malformed values fall back to defaults — shared-state config
        must never stop a replica."""
        sp = dict(self.stateplane or {})
        out: Dict[str, Any] = {
            "enabled": bool(sp.get("enabled", False)),
            "backend": str(sp.get("backend", "memory")),
            "replica_id": str(sp.get("replica_id", "")),
            "namespace": str(sp.get("namespace", "srt")) or "srt",
            "backend_config": dict(sp.get("backend_config", {}) or {}),
        }

        def _f(key: str, default: float, lo: float) -> float:
            try:
                return max(lo, float(sp.get(key, default)))
            except (TypeError, ValueError):
                return default

        out["heartbeat_s"] = _f("heartbeat_s", 2.0, 0.05)
        out["ttl_s"] = _f("ttl_s", 0.0, 0.0)  # 0 = 3x heartbeat
        out["cooldown_s"] = _f("cooldown_s", 2.0, 0.05)
        try:
            out["ring_vnodes"] = max(1, int(sp.get("ring_vnodes", 64)))
        except (TypeError, ValueError):
            out["ring_vnodes"] = 64
        share = dict(sp.get("share", {}) or {})
        out["share"] = {k: bool(share.get(k, True))
                        for k in ("cache", "vectorstore", "explain",
                                  "fleet")}
        return out

    def ann_config(self) -> Dict[str, Any]:
        """Normalized ``ann`` block: ``ann.knobs.normalize_ann`` is the
        one interpretation point of the ANN plane's knobs."""
        from ..ann.knobs import normalize_ann

        return normalize_ann(self.ann)

    def decision_explain_config(self) -> Dict[str, Any]:
        """The per-request decision-record knobs: enabled, ring_size,
        sample_rate (deterministic per trace id), redact_pii, and an
        optional SQLite ``durable`` mirror ({backend: sqlite, path,
        max_records})."""
        d = (self.observability or {}).get("decisions", {}) or {}
        out: Dict[str, Any] = {"enabled": bool(d.get("enabled", True)),
                               "redact_pii": bool(d.get("redact_pii",
                                                        True)),
                               "durable": dict(d.get("durable", {})
                                               or {})}
        try:
            out["ring_size"] = int(d.get("ring_size", 512))
        except (TypeError, ValueError):
            out["ring_size"] = 512
        try:
            out["sample_rate"] = float(d.get("sample_rate", 1.0))
        except (TypeError, ValueError):
            out["sample_rate"] = 1.0
        return out

    def used_signal_types(self) -> List[str]:
        """Signal families referenced by decision rules, complexity
        composers or projections — the dispatcher only evaluates these."""
        leaves = [leaf for dec in self.decisions for leaf in dec.rules.leaves()]
        leaves += [leaf for rule in self.signals.complexity
                   if rule.composer is not None
                   for leaf in rule.composer.leaves()]
        used = {leaf.signal_type.lower() for leaf in leaves}
        for score in self.projections.scores:
            for inp in score.inputs:
                # kb_metric values come from the kb family
                used.add(SIGNAL_KB if inp.type == "kb_metric"
                         else inp.type.lower())
        # partition members are rule names of any family: the families
        # that define them are evaluated too
        members = {m for p in self.projections.partitions for m in p.members}
        if members:
            used.update(t for t in ALL_SIGNAL_TYPES
                        if members & set(self.signals.rule_names(t)))
        return sorted(used - {""})


_SECRET_KEY_MARKERS = ("api_key", "apikey", "secret", "password",
                       "private_key", "access_key")


def _is_secret_key(key: str) -> bool:
    lk = key.lower()
    if any(m in lk for m in _SECRET_KEY_MARKERS):
        return True
    # "token" only as the trailing word: auth_token / bearer_token / token
    # are secrets; min_tokens / max_tokens are routing limits
    return lk == "token" or lk.endswith("_token") or lk == "credential"


def redact_config(d: Any) -> Any:
    """A deep copy of ``d`` with every value under a secret-naming key
    (api_key, *_token, secret, password, ...) masked as ``"***"``,
    whatever its type: a list or dict under such a key is masked whole.
    ``GET /config/router`` serves this unless the caller holds
    ``secret_view`` (or ``admin``)."""
    if isinstance(d, dict):
        return {k: "***" if _is_secret_key(str(k)) else redact_config(v)
                for k, v in d.items()}
    if isinstance(d, list):
        return [redact_config(x) for x in d]
    if isinstance(d, tuple):
        return tuple(redact_config(x) for x in d)
    return d
