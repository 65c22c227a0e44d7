"""The x-vsr-* response headers the router stamps, and the request headers
its gates read."""

SCHEMA_VERSION = "v1"

REQUEST_ID = "x-vsr-request-id"
DECISION_RECORD = "x-vsr-decision-record"
DECISION = "x-vsr-selected-decision"
MODEL = "x-vsr-selected-model"
CATEGORY = "x-vsr-selected-category"
REASONING = "x-vsr-selected-reasoning"
REASONING_EFFORT = "x-vsr-selected-reasoning-effort"
SCHEMA = "x-vsr-schema-version"
MATCHED_RULES = "x-vsr-matched-rules"
CACHE_HIT = "x-vsr-cache-hit"
PII_VIOLATION = "x-vsr-pii-violation"
JAILBREAK_BLOCKED = "x-vsr-jailbreak-blocked"
INJECTED_SYSTEM_PROMPT = "x-vsr-injected-system-prompt"
MEMORIES_USED = "x-vsr-memories-used"
TOOLS_INJECTED = "x-vsr-tools-injected"
WARNINGS = "x-vsr-warnings"
HALLUCINATION = "x-vsr-hallucination"
UNVERIFIED_FACTUAL = "x-vsr-unverified-factual"

# request headers, honoured only when skip_processing is enabled: pass the
# request through untouched; drop the named signal families (also behind
# skip_processing.allow_skip_signals_header)
SKIP_PROCESSING = "x-vsr-skip-processing"
SKIP_SIGNALS = "x-vsr-skip-signals"
# seconds a rate-limited or shed client waits before its next request
RETRY_AFTER = "retry-after"
# the degradation ladder: the level echoed while above L0, and the
# request's priority class (also read from the request)
DEGRADATION = "x-vsr-degradation-level"
PRIORITY = "x-vsr-priority"
# the upstream plane: ranked next-best models for failover, and the model
# that finally served when a failover changed it
FALLBACK_MODELS = "x-vsr-fallback-models"
FAILOVER_MODEL = "x-vsr-failover-model"
# marks the looper's own fan-out calls: a request carrying it is served
# single-model and never fans out again
LOOPER = "x-vsr-looper-request"
# a looper answer: the algorithm that ran and the models it used
LOOPER_ALGORITHM = "x-vsr-looper-algorithm"
LOOPER_CANDIDATES = "x-vsr-looper-candidates"


def decision_headers(decision_name: str, model: str, category: str = "",
                     use_reasoning: bool = False, reasoning_effort: str = "",
                     matched_rules: list | None = None) -> dict:
    h = {SCHEMA: SCHEMA_VERSION, DECISION: decision_name, MODEL: model}
    if category:
        h[CATEGORY] = category
    if use_reasoning:
        h[REASONING] = "true"
        if reasoning_effort:
            h[REASONING_EFFORT] = reasoning_effort
    if matched_rules:
        h[MATCHED_RULES] = ",".join(matched_rules[:16])
    return h
