"""Learning protection: agent-session continuity for model switches.

Reference parity: ``pkg/extproc/router_learning_protection*.go`` — an
agent mid-conversation must not be bounced between models by every
Thompson sample. Identity comes from the session / conversation headers
(``x-session-id`` / ``x-conversation-id`` by default,
learning_config.go); scope ``conversation`` protects one conversation,
``session`` the whole declared session. A warm identity:

- suppresses exploration (adaptation scores with the posterior mean,
  not a sample), and
- pins the session's current model unless the proposed winner beats it
  by ``switch_margin`` AND the session has at least
  ``min_turns_before_switch`` turns of evidence.

Idle sessions expire after ``idle_timeout_seconds`` and are
re-evaluated from scratch. All state is in-proc and fail-open: no
identity headers → no protection, adaptation proceeds normally.
The port's own copy of ``semantic_router_tpu.learning.protection``."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from .adaptation import AdaptationDecision


@dataclass
class SessionState:
    model: str = ""
    turns: int = 0
    last_seen_t: float = 0.0


@dataclass
class ProtectionVerdict:
    suppress_sampling: bool = False
    final_model: str = ""
    action: str = "no_identity"    # no_identity | warm_keep |
    #                                warm_switch | cold_start
    identity: str = ""


class SessionProtection:
    def __init__(self, scope: str = "conversation",
                 session_header: str = "x-session-id",
                 conversation_header: str = "x-conversation-id",
                 idle_timeout_s: float = 900.0,
                 min_turns_before_switch: int = 2,
                 switch_margin: float = 0.05) -> None:
        self.scope = scope
        self.session_header = session_header
        self.conversation_header = conversation_header
        self.idle_timeout_s = idle_timeout_s
        self.min_turns_before_switch = min_turns_before_switch
        self.switch_margin = switch_margin
        self._sessions: Dict[str, SessionState] = {}
        self._lock = threading.Lock()

    def identity(self, headers: Dict[str, str]) -> str:
        h = {k.lower(): v for k, v in (headers or {}).items()}
        session = h.get(self.session_header, "")
        convo = h.get(self.conversation_header, "")
        if self.scope == "session":
            return session or ""
        if session or convo:
            return f"{session}/{convo}"
        return ""

    def _state(self, ident: str) -> Optional[SessionState]:
        with self._lock:
            st = self._sessions.get(ident)
            if st is None:
                return None
            if time.time() - st.last_seen_t > self.idle_timeout_s:
                del self._sessions[ident]
                return None
            return st

    def preflight(self, headers: Dict[str, str]) -> ProtectionVerdict:
        """Before adaptation: a warm identity suppresses exploration."""
        ident = self.identity(headers)
        if not ident:
            return ProtectionVerdict(action="no_identity")
        st = self._state(ident)
        if st is None or not st.model:
            return ProtectionVerdict(action="cold_start",
                                     identity=ident)
        return ProtectionVerdict(suppress_sampling=True,
                                 final_model=st.model,
                                 action="warm_keep", identity=ident)

    def apply(self, headers: Dict[str, str],
              adaptation: AdaptationDecision,
              base_model: str) -> ProtectionVerdict:
        """After adaptation: pin the warm session's model unless the
        proposal clears the margin with enough turns of evidence; then
        record this turn."""
        ident = self.identity(headers)
        proposed = adaptation.model
        if not ident:
            return ProtectionVerdict(final_model=proposed,
                                     action="no_identity")
        now = time.time()
        with self._lock:
            st = self._sessions.get(ident)
            if st is not None and now - st.last_seen_t \
                    > self.idle_timeout_s:
                st = None
            if st is None or not st.model:
                # cold start: adopt the proposal
                self._sessions[ident] = SessionState(
                    model=proposed, turns=1, last_seen_t=now)
                return ProtectionVerdict(final_model=proposed,
                                         action="cold_start",
                                         identity=ident)
            # warm: default keep; switch only with margin + evidence
            final = st.model
            action = "warm_keep"
            if proposed != st.model and \
                    st.turns >= self.min_turns_before_switch:
                cur = next((s.score for s in adaptation.scores
                            if s.model == st.model), None)
                new = next((s.score for s in adaptation.scores
                            if s.model == proposed), None)
                if cur is not None and new is not None and \
                        new - cur >= self.switch_margin:
                    final = proposed
                    action = "warm_switch"
            st.model = final
            st.turns += 1
            st.last_seen_t = now
            return ProtectionVerdict(final_model=final, action=action,
                                     identity=ident)
