"""Per-user credential resolution for backend calls (the port's copy of
``semantic_router_tpu.router.authz``).

Capability parity with pkg/authz (977 LoC): identity arrives via
ext_authz-injected headers (x-authz-user-id / x-authz-user-groups — already
consumed by the authz signal); this module resolves which API credential a
given (user, model) pair uses for the upstream call and emits the headers
to append (appendCredentialHeaders, processor_req_body_routing.go:281).
Fail-open: no matching credential → no headers added (the backend's own
default auth applies).

Config shape (under ``authz:``)::

    authz:
      fail_open: true
      credentials:
        - models: [qwen3-32b]          # empty/omitted = all models
          users: [vip-1]               # empty/omitted = all users
          groups: [premium-tier]       # matches any listed group
          api_key: ${PREMIUM_API_KEY}  # env substitution via config loader
          header: authorization        # default: authorization (Bearer)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class CredentialRule:
    api_key: str
    models: List[str] = field(default_factory=list)
    users: List[str] = field(default_factory=list)
    groups: List[str] = field(default_factory=list)
    header: str = "authorization"

    def matches(self, model: str, user_id: str,
                user_groups: Sequence[str]) -> bool:
        if self.models and model not in self.models:
            return False
        if self.users or self.groups:
            user_ok = bool(self.users) and user_id in self.users
            group_ok = bool(self.groups) and any(
                g in self.groups for g in user_groups)
            return user_ok or group_ok
        return True


class CredentialResolver:
    """``trust_identity_headers`` gates user/group-scoped credentials: the
    x-authz-* headers are only trustworthy when an upstream ext_authz
    filter injects them (the reference's deployment). In the self-contained
    reverse-proxy mode any client could forge them, so identity-scoped
    rules are DISABLED unless the operator sets
    ``authz.trust_identity_headers: true`` — model-scoped/default rules
    still apply."""

    def __init__(self, rules: List[CredentialRule],
                 fail_open: bool = True,
                 trust_identity_headers: bool = False) -> None:
        self.rules = rules
        self.fail_open = fail_open
        self.trust_identity_headers = trust_identity_headers

    @classmethod
    def from_config(cls, authz_cfg: Dict) -> "CredentialResolver":
        rules = []
        for entry in (authz_cfg or {}).get("credentials", []) or []:
            if not entry.get("api_key"):
                continue
            rules.append(CredentialRule(
                api_key=str(entry["api_key"]),
                models=list(entry.get("models", []) or []),
                users=list(entry.get("users", []) or []),
                groups=list(entry.get("groups", []) or []),
                header=str(entry.get("header", "authorization")).lower(),
            ))
        return cls(rules,
                   fail_open=bool((authz_cfg or {}).get("fail_open", True)),
                   trust_identity_headers=bool(
                       (authz_cfg or {}).get("trust_identity_headers",
                                             False)))

    def headers_for(self, model: str, user_id: str = "",
                    user_groups: Sequence[str] = ()) -> Dict[str, str]:
        """First matching rule wins (list order = priority). Returns the
        headers to append to the upstream request."""
        if not self.trust_identity_headers:
            user_id, user_groups = "", ()
        for rule in self.rules:
            if rule.matches(model, user_id, user_groups):
                value = rule.api_key
                if rule.header == "authorization" \
                        and not value.lower().startswith(("bearer ", "basic ")):
                    value = f"Bearer {value}"
                return {rule.header: value}
        if not self.fail_open and self.rules:
            raise PermissionError(
                f"no credential for user {user_id!r} on model {model!r}")
        return {}
