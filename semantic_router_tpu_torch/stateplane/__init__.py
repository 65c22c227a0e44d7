"""Shared state plane: N router replicas behaving as one.

The port's copy of ``semantic_router_tpu.stateplane``: the same keys,
values and ring, so JAX replicas and port replicas on one store form one
fleet.  One narrow KV+hash seam (:mod:`.backend`) carries every
cross-replica concern:

- :class:`~.plane.StatePlane` — membership (TTL'd heartbeats), a
  consistent-hash ring for affinity (:mod:`.ring`), and fleet pressure
  aggregation (the DegradationController's shared sensor);
- :class:`~.cache.SharedSemanticCache` — one semantic-cache entry set
  across the fleet, local fallback on plane loss;
- :class:`~.vectorstore.SharedVectorStore` — RAG rows visible to every
  replica, local fallback on plane loss;
- :class:`~.explain_mirror.StatePlaneDecisionStore` — fleet-wide
  durable decision-record mirror behind ``attach_durable``;
- :class:`~.harness.ReplicaFleet` — the in-process multi-replica e2e
  the fleet tests run.

``stateplane.enabled: false`` (the default) constructs NONE of this:
the router runs byte-identical to the single-process posture.
"""

from __future__ import annotations

from typing import Optional

from .backend import (
    GuardedBackend,
    InMemoryStateBackend,
    RespStateBackend,
    SQLiteStateBackend,
    StateBackendUnavailable,
    build_backend,
)
from .cache import SharedSemanticCache
from .explain_mirror import StatePlaneDecisionStore
from .plane import StatePlane
from .ring import HashRing
from .vectorstore import SharedVectorStore


def build_state_plane(cfg, metrics=None) -> Optional[StatePlane]:
    """StatePlane from a RouterConfig (None when disabled — the
    byte-identical default posture).  The caller owns start()/stop()."""
    sp_cfg = cfg.stateplane_config()
    if not sp_cfg.get("enabled"):
        return None
    backend = build_backend(sp_cfg)
    return StatePlane(
        backend,
        replica_id=sp_cfg.get("replica_id", ""),
        namespace=sp_cfg.get("namespace", "srt"),
        heartbeat_s=sp_cfg.get("heartbeat_s", 2.0),
        ttl_s=sp_cfg.get("ttl_s", 0.0),
        ring_vnodes=sp_cfg.get("ring_vnodes", 64),
        metrics=metrics)


__all__ = [
    "GuardedBackend", "HashRing", "InMemoryStateBackend",
    "RespStateBackend", "SQLiteStateBackend", "SharedSemanticCache",
    "SharedVectorStore", "StateBackendUnavailable", "StatePlane",
    "StatePlaneDecisionStore", "build_backend", "build_state_plane",
]
