"""MCP-served classifier (the port's copy of
``semantic_router_tpu.mcp.classifier``): a remote MCP server exposes a
``classify_text`` tool, and the router consumes it as a category signal.

The evaluator calls the tool with the request text and maps the JSON
result ({"class"/"label", "confidence", optional "probabilities"}) onto
configured domain rules — same fail-open contract as every other signal
family.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from ..config.schema import DomainRule
from ..signals.base import RequestContext, SignalHit, SignalResult
from .client import _BaseClient


class MCPClassifySignal:
    """Domain-family signal backed by a remote MCP classify tool."""

    signal_type = "domain"

    def __init__(self, client: _BaseClient, rules: List[DomainRule],
                 tool_name: str = "classify_text",
                 threshold: float = 0.0) -> None:
        import threading

        self.client = client
        self.rules = rules
        self.tool_name = tool_name
        self.threshold = threshold
        self._connect_lock = threading.Lock()
        self._by_name = {r.name.lower(): r for r in rules}
        for r in rules:
            for cat in r.mmlu_categories:
                self._by_name.setdefault(cat.lower(), r)

    def classify(self, text: str) -> Optional[Dict]:
        if not self.client.is_connected:
            # lazy connect under a lock: concurrent first requests must
            # not double-connect (a stdio double-connect leaks the first
            # server subprocess). A failed connect is this family's
            # fail-open error.
            with self._connect_lock:
                if not self.client.is_connected:
                    self.client.connect()
        result = self.client.call_tool(self.tool_name, {"text": text})
        if result.is_error:
            raise RuntimeError(f"MCP tool error: {result.text[:200]}")
        try:
            return json.loads(result.text)
        except json.JSONDecodeError:
            return None

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        start = time.perf_counter()
        res = SignalResult(self.signal_type)
        try:
            out = self.classify(ctx.user_text)
            if out:
                label = str(out.get("class", out.get("label", "")))
                conf = float(out.get("confidence", 0.0))
                rule = self._by_name.get(label.lower())
                if rule is not None and conf >= self.threshold:
                    res.hits.append(SignalHit(rule.name, conf,
                                              {"label": label,
                                               "via": "mcp"}))
        except Exception as exc:  # fail open
            res.error = f"{type(exc).__name__}: {exc}"
        res.latency_s = time.perf_counter() - start
        return res
