"""Multi-replica e2e harness: N in-process router replicas, one plane.

The port's copy of ``semantic_router_tpu.stateplane.harness``.  The
stateplane and fleet-plane tests drive this: each replica is a full
Router with its OWN isolated
RuntimeRegistry (metrics, event bus, SLO monitor, degradation
controller — nothing process-global shared), its own StatePlane handle,
and a plane-shared semantic cache; the only thing replicas have in
common is the state backend, exactly like N pods in front of one
Redis.  CPU-cheap by construction: routing is heuristic-only and the
cache embeds through a deterministic hash embedding, so the fleet runs
on the CPU without a model or a card.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..config.schema import (
    Decision,
    KeywordRule,
    ModelRef,
    PluginConfig,
    RouterConfig,
    RuleNode,
    SignalsConfig,
)
from .cache import SharedSemanticCache
from .plane import StatePlane


def hash_embed(dim: int = 32):
    """Deterministic, engine-free embedding: character-trigram counts
    hashed into ``dim`` buckets, L2-normalized.  Similar strings land
    near each other; identical strings are identical — enough for the
    fleet gate's shared-cache assertions without any model."""

    def embed(text: str) -> np.ndarray:
        v = np.zeros(dim, dtype=np.float32)
        t = text.lower()
        for i in range(max(1, len(t) - 2)):
            gram = t[i:i + 3]
            h = int.from_bytes(hashlib.blake2b(
                gram.encode(), digest_size=4).digest(), "big")
            v[h % dim] += 1.0
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    return embed


def fleet_config() -> RouterConfig:
    """A small heuristic-only routing profile with the semantic-cache
    plugin on its decision — the minimum surface the fleet gate needs."""
    return RouterConfig(
        default_model="fallback-model",
        signals=SignalsConfig(keywords=[KeywordRule(
            name="legal",
            keywords=["contract", "sue", "legal", "liability"])]),
        decisions=[Decision(
            name="keyword_route", priority=100,
            rules=RuleNode(operator="OR", conditions=[
                RuleNode(signal_type="keyword", name="legal")]),
            model_refs=[ModelRef(model="model-large")],
            plugins=[PluginConfig(type="semantic-cache",
                                  configuration={"enabled": True})],
        )],
        resilience={"enabled": True, "escalate_ticks": 1,
                    "hysteresis_ticks": 2, "max_level": 3},
    )


@dataclass
class Replica:
    name: str
    plane: StatePlane
    registry: object
    router: object
    controller: object
    fleetobs: object = None

    def route(self, text: str, **headers) -> object:
        return self.router.route(
            {"model": "auto",
             "messages": [{"role": "user", "content": text}]},
            headers=headers or None)


@dataclass
class ReplicaFleet:
    """N replicas over one backend.  ``backend_factory`` returns a
    FRESH GuardedBackend per replica (each replica owns its connection,
    like separate pods) — e.g.
    ``lambda: GuardedBackend(RespStateBackend(port=mini.port))``."""

    backend_factory: object
    n: int = 3
    cfg: Optional[RouterConfig] = None
    heartbeat_s: float = 0.2
    replicas: List[Replica] = field(default_factory=list)
    # the fleet observability plane per replica (publisher on the
    # heartbeat, aggregator and the fleet-scoped SLO source bound)
    fleet_obs: bool = False
    fleet_obs_cfg: Dict[str, object] = field(default_factory=dict)

    def start(self) -> "ReplicaFleet":
        from ..router.pipeline import Router
        from ..runtime.registry import RuntimeRegistry

        cfg = self.cfg or fleet_config()
        embed = hash_embed()
        for i in range(self.n):
            name = f"replica-{i}"
            backend = self.backend_factory()
            plane = StatePlane(backend, replica_id=name,
                               heartbeat_s=self.heartbeat_s)
            registry = RuntimeRegistry.isolated(stateplane=plane)
            controller = registry.get("resilience")
            controller.bind(events=registry.get("events"),
                            fleet=plane)
            controller.configure(cfg.resilience_config())
            router = Router(cfg, metrics=registry.metric_series(),
                            tracer=registry.tracer,
                            flightrec=registry.get("flightrec"),
                            explain=registry.get("explain"),
                            resilience=controller)
            router.cache = SharedSemanticCache(
                plane, embed, similarity_threshold=0.85,
                local=self._local_cache(embed))
            router.stateplane = plane
            fobs = None
            if self.fleet_obs:
                from ..observability.fleetobs import build_fleet_obs

                fl_cfg = {"publish_interval_s": 0.0, "cache_s": 0.0,
                          "debug_top_n": 8}
                fl_cfg.update(self.fleet_obs_cfg)
                fobs = build_fleet_obs(
                    fl_cfg, plane, registry.metrics,
                    flightrec=registry.get("flightrec"),
                    explain=registry.get("explain"),
                    slo=registry.get("slo"))
                plane.add_publisher(fobs.publisher.maybe_publish)
                registry.swap(fleetobs=fobs)
                mon = registry.get("slo")
                if mon is not None:
                    mon.fleet_source = fobs.aggregator.merged_registry
            plane.start()
            self.replicas.append(Replica(
                name=name, plane=plane, registry=registry,
                router=router, controller=controller, fleetobs=fobs))
        # one settle beat so every replica sees the full membership
        for r in self.replicas:
            try:
                r.plane.heartbeat_once()
            except Exception:
                pass
        return self

    @staticmethod
    def _local_cache(embed):
        from ..cache.semantic_cache import InMemorySemanticCache

        return InMemorySemanticCache(embed, similarity_threshold=0.85,
                                     use_hnsw=False)

    def tick_all(self) -> List[int]:
        """One controller tick per replica (deterministic — tests drive
        the ladder directly, like the resilience chaos gate)."""
        return [r.controller.tick() for r in self.replicas]

    def levels(self) -> List[int]:
        return [r.controller.level() for r in self.replicas]

    def heartbeat_all(self) -> None:
        for r in self.replicas:
            try:
                r.plane.heartbeat_once()
            except Exception:
                pass

    def stop(self) -> None:
        for r in self.replicas:
            try:
                r.controller.stop()
            except Exception:
                pass
            try:
                r.router.shutdown()
            except Exception:
                pass
            if r.fleetobs is not None:
                try:
                    r.plane.remove_publisher(
                        r.fleetobs.publisher.maybe_publish)
                    r.fleetobs.close()
                except Exception:
                    pass
            try:
                r.plane.close()
            except Exception:
                pass
        self.replicas = []
