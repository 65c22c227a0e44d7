"""The fleet simulator (the port's copy of
``semantic_router_tpu.fleetsim``; reference: src/fleet-sim)."""

from .sim import (
    FleetAllocation,
    ModelLoad,
    SimReport,
    SliceSpec,
    TPU_CATALOG,
    optimize_fleet,
    simulate,
    workload_from_replay_report,
)

__all__ = ["FleetAllocation", "ModelLoad", "SimReport", "SliceSpec",
           "TPU_CATALOG", "optimize_fleet", "simulate",
           "workload_from_replay_report"]
