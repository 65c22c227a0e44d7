"""Signal-extraction base types: the request view evaluators inspect and
the per-family result they report."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol

from ..utils.tokenization import EncodingCache


@dataclass
class Message:
    role: str
    content: str = ""
    # image references (URLs or data URIs) of multi-part content, as
    # given: the port decodes no image
    images: List[str] = field(default_factory=list)
    audio: List[str] = field(default_factory=list)
    tool_calls: List[dict] = field(default_factory=list)
    tool_call_id: str = ""


_WORD_RE = re.compile(r"\w+", re.UNICODE)


def text_units(text: str) -> int:
    """Multilingual text units: word-ish tokens plus CJK characters — the
    cheap token estimate of the context signal and the structure
    densities (no tokenizer on the hot path)."""
    words = len(_WORD_RE.findall(text))
    cjk = sum(1 for ch in text if "\u4e00" <= ch <= "\u9fff")
    return words + cjk


@dataclass
class RequestContext:
    """Everything signal evaluators may inspect about one request."""

    messages: List[Message] = field(default_factory=list)
    model: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    # identity from the ext_authz headers (or the body's ``user``)
    user_id: str = ""
    user_groups: List[str] = field(default_factory=list)
    tools: List[dict] = field(default_factory=list)
    event: Dict[str, Any] = field(default_factory=dict)  # type/severity/...
    stream: bool = False
    body: Dict[str, Any] = field(default_factory=dict)
    # per-request scratch shared across evaluators
    ext: Dict[Any, Any] = field(default_factory=dict)
    # tokenize-once: learned signals thread this cache into every engine
    # call, so K signals sharing a tokenizer pay ONE encode
    enc_cache: EncodingCache = field(default_factory=EncodingCache)
    # (engine id, task, text) → ClassResult, seeded by the dispatcher's
    # fused prefetch; evaluators consult it before touching the engine
    class_memo: Dict[Any, Any] = field(default_factory=dict)
    # the classification input when the router compressed the prompt
    # (router.promptcompression); None = the latest user message
    _user_text: Optional[str] = None

    @property
    def user_text(self) -> str:
        """Latest user message content — the primary classification input
        — or its compressed form."""
        if self._user_text is not None:
            return self._user_text
        for m in reversed(self.messages):
            if m.role == "user" and m.content:
                return m.content
        return ""

    @property
    def full_text(self) -> str:
        """All message content joined (history-aware classifiers)."""
        return "\n".join(m.content for m in self.messages if m.content)

    def text_for(self, include_history: bool) -> str:
        return self.full_text if include_history else self.user_text

    def user_turns(self) -> List[str]:
        return [m.content for m in self.messages if m.role == "user"]

    def approx_token_count(self) -> int:
        return text_units(self.full_text)

    def has_images(self) -> bool:
        return any(m.images for m in self.messages)

    @classmethod
    def from_openai_body(cls, body: Dict[str, Any],
                         headers: Optional[Dict[str, str]] = None
                         ) -> "RequestContext":
        """Build from an OpenAI ChatCompletions-shaped request body (text
        parts of multi-part contents are joined; image and audio parts
        keep their reference).  Identity comes from the
        ``x-authz-user-id`` / ``x-authz-user-groups`` headers."""
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        msgs: List[Message] = []
        for m in body.get("messages", []) or []:
            content = m.get("content", "")
            images: List[str] = []
            audio: List[str] = []
            if isinstance(content, list):
                parts = []
                for part in content:
                    if not isinstance(part, dict):
                        continue
                    ptype = part.get("type", "")
                    if ptype == "text":
                        parts.append(part.get("text", ""))
                    elif ptype in ("image_url", "input_image"):
                        url = part.get("image_url")
                        if isinstance(url, dict):
                            url = url.get("url", "")
                        images.append(url or "")
                    elif ptype in ("input_audio", "audio"):
                        audio.append(str(part.get("input_audio", "")))
                content = "\n".join(parts)
            msgs.append(Message(
                role=m.get("role", "user"),
                content=content if isinstance(content, str) else "",
                images=images, audio=audio,
                tool_calls=list(m.get("tool_calls", []) or []),
                tool_call_id=m.get("tool_call_id", "") or ""))
        groups = headers.get("x-authz-user-groups", "")
        return cls(
            messages=msgs,
            model=body.get("model", ""),
            headers=headers,
            user_id=headers.get("x-authz-user-id", body.get("user", "") or ""),
            user_groups=[g.strip() for g in groups.split(",") if g.strip()],
            tools=list(body.get("tools", []) or []),
            stream=bool(body.get("stream", False)),
            body=body,
        )


@dataclass
class SignalHit:
    rule: str
    confidence: float = 1.0
    detail: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SignalResult:
    signal_type: str
    hits: List[SignalHit] = field(default_factory=list)
    latency_s: float = 0.0
    error: Optional[str] = None  # evaluators fail open: error recorded, no hits
    # kb family: per-knowledge-base metric values that feed kb_metric
    # projection inputs ({kb_name: {metric: value}})
    metrics: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # "heuristic" (model-free), "engine" (direct classify) or
    # "fused_bank" (served from the dispatcher's fused-prefetch memo)
    source: str = ""


class SignalEvaluator(Protocol):
    signal_type: str

    def evaluate(self, ctx: RequestContext) -> SignalResult: ...
