"""Structured component-event logging: JSON lines with
component/event/fields, stdlib-backed.  The port's copy of
``semantic_router_tpu.observability.logging``."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any

_root = logging.getLogger("semantic_router_tpu_torch")
if not _root.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(message)s"))
    _root.addHandler(handler)
    _root.setLevel(logging.INFO)


def component_event(component: str, event: str, level: str = "info",
                    **fields: Any) -> None:
    record = {"ts": time.time(), "component": component, "event": event,
              **fields}
    getattr(_root, level, _root.info)(json.dumps(record, default=str))


def get_logger(component: str) -> logging.Logger:
    return _root.getChild(component)
