"""Config loading: a YAML file (with ``${VAR}`` / ``${VAR:-default}`` env
substitution) or an already-parsed dict.  ``yaml`` is imported only when a
file is read, so a dict-configured deployment needs no YAML package."""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Union

from .schema import RouterConfig

_ENV_PATTERN = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::-([^}]*))?\}")


def substitute_env(text: str, env: Optional[Mapping[str, str]] = None) -> str:
    """Replace ${VAR} and ${VAR:-default} occurrences in *text*."""
    env = os.environ if env is None else env

    def repl(m: "re.Match[str]") -> str:
        val = env.get(m.group(1))
        if not val:
            return m.group(2) if m.group(2) is not None else ""
        return val

    return _ENV_PATTERN.sub(repl, text)


def load_config(source: Union[str, os.PathLike, Dict[str, Any]],
                env: Optional[Mapping[str, str]] = None) -> RouterConfig:
    """``source``: a path to a YAML file, or a config dict."""
    if isinstance(source, dict):
        return RouterConfig.from_dict(source)
    import yaml

    with open(source, "r", encoding="utf-8") as f:
        raw = f.read()
    return RouterConfig.from_dict(yaml.safe_load(substitute_env(raw, env))
                                  or {})
