"""Config version management: backups, merge patches, rollback, hashes.

The management API's write path (``PATCH`` / ``PUT /config/router``, the
config editor's deploy, ``POST /config/router/rollback``) snapshots the
live file into ``<config>.versions/`` (timestamped YAML, the newest 20
kept) and then rewrites the live file atomically; writing the live file
is what the mtime-polled ``ConfigWatcher`` reloads.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .schema import config_hash


def deep_merge(base: Dict[str, Any], patch: Dict[str, Any]) -> Dict[str, Any]:
    """RFC 7396 merge: dicts merge recursively, ``None`` deletes a key,
    everything else replaces."""
    out = dict(base)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


@dataclass
class ConfigVersion:
    version_id: str
    created_t: float
    hash: str
    path: str


class ConfigVersionStore:
    """Timestamped YAML backups of one config file under
    ``<config>.versions/``."""

    def __init__(self, config_path: str, max_versions: int = 20) -> None:
        self.config_path = config_path
        self.dir = config_path + ".versions"
        self.max_versions = max_versions

    # -- queries ---------------------------------------------------------

    def list(self) -> List[ConfigVersion]:
        """Every kept version, newest first."""
        import yaml

        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in sorted(os.listdir(self.dir), reverse=True):
            if not name.endswith(".yaml"):
                continue
            path = os.path.join(self.dir, name)
            try:
                with open(path) as f:
                    raw = yaml.safe_load(f) or {}
                out.append(ConfigVersion(
                    version_id=name[:-len(".yaml")],
                    created_t=os.path.getmtime(path),
                    hash=config_hash(raw), path=path))
            except Exception:
                continue
        return out

    def get(self, version_id: str) -> Optional[str]:
        """A version's text; None for an unknown id (or one that is not a
        plain basename)."""
        if "/" in version_id or ".." in version_id:
            return None
        path = os.path.join(self.dir, version_id + ".yaml")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    # -- mutations -------------------------------------------------------

    def snapshot(self) -> ConfigVersion:
        """Back the CURRENT live file up as a new version."""
        import yaml

        os.makedirs(self.dir, exist_ok=True)
        with open(self.config_path) as f:
            text = f.read()
        vid = time.strftime("%Y%m%dT%H%M%S") \
            + f"-{int(time.time() * 1e3) % 1000:03d}"
        path = os.path.join(self.dir, vid + ".yaml")
        with open(path, "w") as f:
            f.write(text)
        self._prune()
        raw = yaml.safe_load(text) or {}
        return ConfigVersion(vid, time.time(), config_hash(raw), path)

    def write_live(self, raw: Dict[str, Any]) -> None:
        """Write the live file atomically (a rename over it) as YAML."""
        import yaml

        self._replace_live(yaml.safe_dump(raw, sort_keys=False))

    def write_live_text(self, text: str) -> None:
        """Write the live file atomically, verbatim: the editor's deploy
        keeps the operator's comments and key order."""
        self._replace_live(text)

    def rollback(self, version_id: str) -> bool:
        """Make a kept version live again (the current file becomes a
        version too); False for an unknown id."""
        text = self.get(version_id)
        if text is None:
            return False
        self.snapshot()
        self._replace_live(text)
        return True

    def _replace_live(self, text: str) -> None:
        tmp = self.config_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, self.config_path)

    def _prune(self) -> None:
        versions = sorted(v for v in os.listdir(self.dir)
                          if v.endswith(".yaml"))
        while len(versions) > self.max_versions:
            os.remove(os.path.join(self.dir, versions.pop(0)))
