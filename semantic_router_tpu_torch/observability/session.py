"""Session telemetry: derive stable session ids, track per-session turns,
cumulative cost, and model transitions (the port's copy of
``semantic_router_tpu.observability.session``).

Reference: pkg/sessiontelemetry — derive.go (session id = hash of user +
first user message so multi-turn chats correlate with memory),
telemetry.go (per-session turn/cost accumulation in a TTL+size-capped
store), last_model.go (model continuity), transition.go (model-switch
events).  Mirrors into ``llm_session_*`` metric series.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .logging import component_event
from .metrics import default_registry

DEFAULT_TTL_S = 4 * 3600.0
DEFAULT_MAX_SESSIONS = 10_000

session_turns = default_registry.counter(
    "llm_session_turns_total", "Chat turns recorded per session store")
session_transitions = default_registry.counter(
    "llm_session_model_transitions_total",
    "Model switches within a session")
session_cost = default_registry.counter(
    "llm_session_cost_total", "Cumulative session cost (USD)")


def _content_text(content) -> str:
    """String content verbatim; multimodal list-form content reduces to
    its text parts (otherwise every multimodal chat would hash to the
    same per-user session)."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return " ".join(p.get("text", "") for p in content
                        if isinstance(p, dict) and p.get("type") == "text")
    return ""


def derive_session_id(messages: Sequence[dict], user_id: str = "") -> str:
    """Stable id from user + first user message (≤100 chars) —
    DeriveChatCompletionsSessionID parity (prefix "cc-" + 16 hex)."""
    first = ""
    for m in messages:
        if m.get("role") == "user":
            first = _content_text(m.get("content", ""))[:100]
            break
    digest = hashlib.sha256(f"{user_id}:{first}".encode()).hexdigest()
    return "cc-" + digest[:16]


def chat_turn_number(messages: Sequence[dict]) -> int:
    """1-based: the index of the assistant reply this request produces."""
    return sum(1 for m in messages if m.get("role") == "assistant") + 1


@dataclass
class SessionState:
    session_id: str
    turns: int = 0
    total_cost: float = 0.0
    total_prompt_tokens: int = 0
    total_completion_tokens: int = 0
    last_model: str = ""
    last_model_t: float = 0.0
    models_used: List[str] = field(default_factory=list)
    created_t: float = field(default_factory=time.time)
    updated_t: float = field(default_factory=time.time)


@dataclass
class ModelTransition:
    session_id: str
    turn: int
    from_model: str
    to_model: str
    seconds_since_last: float


class SessionTelemetry:
    """TTL + size-capped session store (telemetry.go evict semantics)."""

    def __init__(self, ttl_s: float = DEFAULT_TTL_S,
                 max_sessions: int = DEFAULT_MAX_SESSIONS) -> None:
        self.ttl_s = ttl_s
        self.max_sessions = max_sessions
        self._sessions: Dict[str, SessionState] = {}
        self._lock = threading.Lock()
        self._last_evict_t = 0.0
        # full-store TTL scans are O(n) under the hot-path lock; amortize
        # (scaled to the TTL so short test TTLs still evict promptly)
        self._evict_interval_s = min(60.0, ttl_s / 10)

    # -- recording -------------------------------------------------------

    def record_turn(self, messages: Sequence[dict], model: str,
                    user_id: str = "", prompt_tokens: int = 0,
                    completion_tokens: int = 0,
                    cost: float = 0.0,
                    domain: str = "") -> Optional[ModelTransition]:
        """Record one completed chat turn; returns a ModelTransition when
        the session switched models."""
        sid = derive_session_id(messages, user_id)
        turn = chat_turn_number(messages)
        now = time.time()
        transition: Optional[ModelTransition] = None
        with self._lock:
            self._evict_locked(now)
            state = self._sessions.get(sid)
            if state is None:
                state = SessionState(session_id=sid)
                self._sessions[sid] = state
            if state.last_model and model and state.last_model != model:
                transition = ModelTransition(
                    session_id=sid, turn=turn,
                    from_model=state.last_model, to_model=model,
                    seconds_since_last=now - state.last_model_t)
            state.turns = max(state.turns + 1, turn)
            state.total_cost += cost
            state.total_prompt_tokens += prompt_tokens
            state.total_completion_tokens += completion_tokens
            if model:
                state.last_model = model
                state.last_model_t = now
                if model not in state.models_used:
                    state.models_used.append(model)
            state.updated_t = now
        session_turns.inc(domain=domain or "unknown")
        if cost:
            session_cost.inc(cost)
        if transition is not None:
            session_transitions.inc(from_model=transition.from_model,
                                    to_model=transition.to_model)
            component_event("session", "model_transition",
                            session=sid, turn=turn,
                            from_model=transition.from_model,
                            to_model=transition.to_model)
        return transition

    # -- queries ---------------------------------------------------------

    def get(self, session_id: str) -> Optional[SessionState]:
        with self._lock:
            self._evict_locked(time.time())
            return self._sessions.get(session_id)

    def last_model(self, messages: Sequence[dict],
                   user_id: str = "") -> str:
        """Model continuity lookup (last_model.go GetLastModel role) —
        session-aware selection can prefer the model already serving the
        conversation."""
        state = self.get(derive_session_id(messages, user_id))
        return state.last_model if state else ""

    def count(self) -> int:
        with self._lock:
            self._evict_locked(time.time())
            return len(self._sessions)

    # -- eviction --------------------------------------------------------

    def _evict_locked(self, now: float) -> None:
        over_cap = len(self._sessions) > self.max_sessions
        if not over_cap and now - self._last_evict_t \
                < self._evict_interval_s:
            return  # amortized: skip the O(n) scan on most calls
        self._last_evict_t = now
        cutoff = now - self.ttl_s
        stale = [k for k, v in self._sessions.items()
                 if v.updated_t < cutoff]
        for k in stale:
            del self._sessions[k]
        while len(self._sessions) > self.max_sessions:
            oldest = min(self._sessions, key=lambda k:
                         self._sessions[k].updated_t)
            del self._sessions[oldest]


# process-global store (package-level API parity with the reference)
default_session_telemetry = SessionTelemetry()
