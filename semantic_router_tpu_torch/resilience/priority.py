"""Request criticality classes for the degradation ladder.

The port's copy of ``semantic_router_tpu.resilience.priority``.  Under
overload the router sheds by business priority, not arrival order
(DAGOR-style admission control): this module is the one place a
request's class is derived, shared by the L2 brownout gate (who keeps
the learned signals), the L3 admission buckets (who pays tokens) and the
shed metrics' ``priority`` label.

Classes, highest first::

    critical > high > normal > low

Resolution order (first match wins):

1. the ``x-vsr-priority`` request header (only with ``trust_header`` on —
   a public listener should turn it off, or every client claims
   ``critical``);
2. the operator's model → class map (``resilience.priority.model_classes``);
3. the operator's group → class map against ``x-authz-user-groups``;
4. the configured default (``normal``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# rank 0 is the most critical; shedding walks from the BOTTOM of this
# tuple upward as the ladder escalates
PRIORITY_CLASSES = ("critical", "high", "normal", "low")
RANKS: Dict[str, int] = {c: i for i, c in enumerate(PRIORITY_CLASSES)}

PRIORITY_HEADER = "x-vsr-priority"


def rank_of(cls: str, default: int = RANKS["normal"]) -> int:
    """Class name → rank; unknown names get the default rank (a typo'd
    header must not accidentally outrank critical)."""
    return RANKS.get((cls or "").strip().lower(), default)


@dataclass
class PriorityResolver:
    """Derives one priority class per request; construction-time config,
    read-only at request time (no locks on the hot path)."""

    header: str = PRIORITY_HEADER
    trust_header: bool = True
    default: str = "normal"
    model_classes: Dict[str, str] = field(default_factory=dict)
    group_classes: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_config(cls, res_cfg: Optional[Dict[str, Any]]
                    ) -> "PriorityResolver":
        """Build from the ``resilience.priority`` block; malformed
        entries fall back to defaults (resilience config must never
        stop the server)."""
        p = dict((res_cfg or {}).get("priority", {}) or {})
        default = str(p.get("default", "normal")).lower()
        if default not in RANKS:
            default = "normal"

        def _class_map(key: str) -> Dict[str, str]:
            out = {}
            for k, v in (p.get(key, {}) or {}).items():
                v = str(v).lower()
                if v in RANKS:
                    out[str(k)] = v
            return out

        return cls(
            header=str(p.get("header", PRIORITY_HEADER)).lower(),
            trust_header=bool(p.get("trust_header", True)),
            default=default,
            model_classes=_class_map("model_classes"),
            group_classes=_class_map("group_classes"))

    def resolve(self, ctx) -> str:
        """Priority class for one request context
        (signals.base.RequestContext)."""
        if self.trust_header:
            hdr = (ctx.headers or {}).get(self.header, "")
            if hdr:
                cls = hdr.strip().lower()
                if cls in RANKS:
                    return cls
        cls = self.model_classes.get(ctx.model or "")
        if cls:
            return cls
        for group in ctx.user_groups or ():
            cls = self.group_classes.get(group)
            if cls:
                return cls
        return self.default
