"""Config loading: a YAML file or text (with ``${VAR}`` / ``${VAR:-default}``
env substitution) or an already-parsed dict, the process-global config
slot (``replace`` / ``get``), and the polling file watcher that hot
reloads a served config (``ConfigWatcher``).

A file or text is validated (``validator.validate_config``): a fatal
finding raises ``ConfigError``, as the reference's loader does.  A dict
is parsed as given unless the caller passes ``validate=True`` (the
reference's ``RouterConfig.from_dict``, which tests and embedders feed
partial configs).  ``yaml`` is imported only when YAML is read, so a
dict-configured deployment needs no YAML package."""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Union

from .schema import RouterConfig

log = logging.getLogger(__name__)

_ENV_PATTERN = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::-([^}]*))?\}")


class ConfigError(ValueError):
    pass


def substitute_env(text: str, env: Optional[Mapping[str, str]] = None) -> str:
    """Replace ${VAR} and ${VAR:-default} occurrences in *text*."""
    env = os.environ if env is None else env

    def repl(m: "re.Match[str]") -> str:
        val = env.get(m.group(1))
        if not val:
            return m.group(2) if m.group(2) is not None else ""
        return val

    return _ENV_PATTERN.sub(repl, text)


def load_dict(path: Union[str, os.PathLike],
              env: Optional[Mapping[str, str]] = None) -> Dict[str, Any]:
    """A YAML file's mapping, env placeholders substituted."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        raw = f.read()
    return yaml.safe_load(substitute_env(raw, env)) or {}


def _validated(cfg: RouterConfig) -> RouterConfig:
    from .validator import validate_config

    fatal = [e for e in validate_config(cfg) if e.fatal]
    if fatal:
        raise ConfigError("invalid config: "
                          + "; ".join(str(e) for e in fatal))
    return cfg


def load_config(source: Union[str, os.PathLike, Dict[str, Any]],
                env: Optional[Mapping[str, str]] = None,
                validate: Optional[bool] = None) -> RouterConfig:
    """``source``: a path to a YAML file (validated unless
    ``validate=False``), or a config dict (validated only with
    ``validate=True``)."""
    if isinstance(source, dict):
        cfg = RouterConfig.from_dict(source)
        return _validated(cfg) if validate else cfg
    cfg = RouterConfig.from_dict(load_dict(source, env))
    return cfg if validate is False else _validated(cfg)


def loads_config(text: str, env: Optional[Mapping[str, str]] = None,
                 validate: bool = True) -> RouterConfig:
    """A config from YAML text, validated unless ``validate=False``."""
    import yaml

    cfg = RouterConfig.from_dict(
        yaml.safe_load(substitute_env(text, env)) or {})
    return _validated(cfg) if validate else cfg


class _Global:
    """The process-global config slot: the config a watcher last loaded."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cfg: Optional[RouterConfig] = None

    def replace(self, cfg: RouterConfig) -> None:
        with self._lock:
            self._cfg = cfg

    def get(self) -> Optional[RouterConfig]:
        with self._lock:
            return self._cfg


_global = _Global()
replace = _global.replace
get = _global.get


class ConfigWatcher:
    """Polls a config file's mtime and, when it moved, loads the file and
    hands the new config to ``on_reload`` (the live swap).  A file that
    does not load (half written, invalid, or asking for an option the
    port refuses) leaves the old config serving and is tried again on the
    next poll; a callback that raises is logged and the watcher lives
    on."""

    def __init__(self, path: str, on_reload: Callable[[RouterConfig], None],
                 poll_interval_s: float = 2.0) -> None:
        self.path = path
        self.on_reload = on_reload
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_mtime: float = self._mtime()

    def _mtime(self) -> float:
        try:
            return os.stat(self.path).st_mtime
        except OSError:
            return 0.0

    def start(self) -> "ConfigWatcher":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="config-watcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def poll_once(self) -> bool:
        """Check once; load and call back if the mtime moved.  True when
        a new config was loaded.  ``_last_mtime`` advances only after a
        load succeeds, so a file caught mid-write is retried even under a
        coarse mtime."""
        mtime = self._mtime()
        if mtime == self._last_mtime:
            return False
        try:
            cfg = load_config(self.path)
        except Exception as exc:
            log.warning("config reload of %s failed, the old config stays "
                        "live: %s: %s", self.path, type(exc).__name__, exc)
            return False
        self._last_mtime = mtime
        replace(cfg)
        try:
            self.on_reload(cfg)
        except Exception:
            # the slot holds the new config already; a broken swap must
            # not kill the watcher
            log.warning("config reload callback failed", exc_info=True)
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:
                log.warning("config watcher poll failed", exc_info=True)
