"""Fleet simulator: size a fleet of accelerator slices for a routed
workload and evaluate what-if allocations.

The port's copy of ``semantic_router_tpu.fleetsim.sim`` (reference
capability: src/fleet-sim, ``vllm-sr-sim``: fleet sizing for a routed
workload, optimize / whatif).  The model is analytic and host-only: a
slice serves a model of ``param_b`` billion parameters at bf16 at

    tokens/s ≈ min(FLOPs bound, memory-bandwidth bound) × chips × efficiency

(decode reads every weight once a token; 0 when the weights do not fit
the slice's memory with 10% headroom), a model's delay is an M/M/1
estimate, and ``optimize_fleet`` greedily picks the best tokens/s per
dollar slice that fits each model, then adds slices until utilization
clears ``max_util``.

``TPU_CATALOG`` is the simulator's input: the backend slices being
sized, with the published per-chip figures and list prices the
reference's catalog carries, kept here as data so that one workload gets
the same answer from either package.  It describes the LLM backends a
router sends traffic to, not the device this package runs on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

GIB = 1024 ** 3


@dataclass(frozen=True)
class SliceSpec:
    name: str
    chips: int
    bf16_tflops_per_chip: float
    hbm_gib_per_chip: float
    hbm_gbps_per_chip: float
    usd_per_hour: float  # on-demand list-price ballpark


# slice name → (chips, bf16 TFLOP/s, HBM GiB and GB/s per chip, $/hour)
TPU_CATALOG: Dict[str, SliceSpec] = {
    "v5e-1": SliceSpec("v5e-1", 1, 197, 16, 819, 1.2),
    "v5e-4": SliceSpec("v5e-4", 4, 197, 16, 819, 4.8),
    "v5e-8": SliceSpec("v5e-8", 8, 197, 16, 819, 9.6),
    "v5p-8": SliceSpec("v5p-8", 8, 459, 95, 2765, 33.6),
    "v6e-4": SliceSpec("v6e-4", 4, 918, 32, 1640, 11.2),
    "v6e-8": SliceSpec("v6e-8", 8, 918, 32, 1640, 22.4),
}


@dataclass
class ModelLoad:
    """Offered load for one served model."""

    model: str
    param_b: float  # parameters in billions
    requests_per_s: float
    avg_prompt_tokens: int = 512
    avg_completion_tokens: int = 256
    slo_p50_latency_s: float = 5.0


@dataclass
class FleetAllocation:
    """model → {slice_type: count}."""

    slices: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def cost_per_hour(self) -> float:
        return sum(TPU_CATALOG[stype].usd_per_hour * n
                   for per_model in self.slices.values()
                   for stype, n in per_model.items())


def slice_tokens_per_s(spec: SliceSpec, param_b: float,
                       efficiency: float = 0.55) -> float:
    """Decode throughput of one slice serving a param_b-billion model at
    bf16: min(FLOPs roofline, HBM roofline) × chips × efficiency.
    Returns 0 when the weights do not fit in the slice's HBM."""
    params = param_b * 1e9
    weight_gib = params * 2 / GIB  # bf16
    if weight_gib > spec.hbm_gib_per_chip * spec.chips * 0.9:
        return 0.0  # doesn't fit (10% headroom for KV/activations)
    flops_bound = (spec.bf16_tflops_per_chip * 1e12) / (2 * params)
    hbm_bound = (spec.hbm_gbps_per_chip * 1e9) / (2 * params / spec.chips)
    per_chip = min(flops_bound, hbm_bound / spec.chips)
    return per_chip * spec.chips * efficiency


@dataclass
class ModelReport:
    model: str
    capacity_tokens_per_s: float
    demand_tokens_per_s: float
    utilization: float
    est_queue_delay_s: float
    slo_ok: bool
    slices: Dict[str, int] = field(default_factory=dict)


@dataclass
class SimReport:
    models: List[ModelReport]
    cost_per_hour: float
    feasible: bool

    def to_dict(self) -> Dict:
        return {
            "feasible": self.feasible,
            "cost_per_hour": round(self.cost_per_hour, 2),
            "models": [{
                "model": m.model,
                "capacity_tokens_per_s": round(m.capacity_tokens_per_s, 1),
                "demand_tokens_per_s": round(m.demand_tokens_per_s, 1),
                "utilization": round(m.utilization, 3),
                "est_queue_delay_s": round(m.est_queue_delay_s, 3),
                "slo_ok": m.slo_ok,
                "slices": m.slices,
            } for m in self.models],
        }


def _mm1_queue_delay(utilization: float, service_s: float) -> float:
    """M/M/1 queueing delay approximation (delay explodes → inf past
    saturation)."""
    if utilization >= 1.0:
        return math.inf
    return service_s * utilization / (1.0 - utilization)


def simulate(workload: List[ModelLoad], allocation: FleetAllocation,
             efficiency: float = 0.55) -> SimReport:
    """What-if: evaluate an allocation against a workload."""
    reports = []
    feasible = True
    for load in workload:
        per_model = allocation.slices.get(load.model, {})
        capacity = sum(
            slice_tokens_per_s(TPU_CATALOG[stype], load.param_b,
                               efficiency) * n
            for stype, n in per_model.items())
        demand = load.requests_per_s * (load.avg_prompt_tokens * 0.1
                                        + load.avg_completion_tokens)
        # prefill is FLOPs-cheap relative to decode; weight it at 10%
        util = demand / capacity if capacity > 0 else math.inf
        # M/M/1 service rate μ = capacity / tokens-per-request ⇒ the
        # per-request service time is tokens/capacity, INDEPENDENT of
        # arrival rate (arrival rate enters only through utilization)
        tokens_per_req = (load.avg_prompt_tokens * 0.1
                          + load.avg_completion_tokens)
        service_s = tokens_per_req / capacity if capacity > 0 else math.inf
        delay = service_s + _mm1_queue_delay(util, service_s) \
            if capacity > 0 else math.inf
        slo_ok = util < 0.85 and delay < load.slo_p50_latency_s
        feasible = feasible and slo_ok
        reports.append(ModelReport(
            model=load.model, capacity_tokens_per_s=capacity,
            demand_tokens_per_s=demand,
            utilization=util if math.isfinite(util) else 999.0,
            est_queue_delay_s=delay if math.isfinite(delay) else 999.0,
            slo_ok=slo_ok, slices=dict(per_model)))
    return SimReport(models=reports,
                     cost_per_hour=allocation.cost_per_hour(),
                     feasible=feasible)


def optimize_fleet(workload: List[ModelLoad],
                   catalog: Optional[Dict[str, SliceSpec]] = None,
                   efficiency: float = 0.55,
                   max_util: float = 0.8) -> FleetAllocation:
    """Greedy min-cost sizing: for each model pick the slice type with the
    best tokens/s-per-dollar that FITS the model, then add slices until
    utilization clears ``max_util`` (the optimize CLI role)."""
    catalog = catalog or TPU_CATALOG
    alloc = FleetAllocation()
    for load in workload:
        best: Optional[SliceSpec] = None
        best_value = 0.0
        for spec in catalog.values():
            tps = slice_tokens_per_s(spec, load.param_b, efficiency)
            if tps <= 0:
                continue
            value = tps / spec.usd_per_hour
            if value > best_value:
                best, best_value = spec, value
        if best is None:
            raise ValueError(
                f"no slice in the catalog fits model {load.model!r} "
                f"({load.param_b}B params)")
        demand = load.requests_per_s * (load.avg_prompt_tokens * 0.1
                                        + load.avg_completion_tokens)
        per_slice = slice_tokens_per_s(best, load.param_b, efficiency)
        n = max(1, math.ceil(demand / (per_slice * max_util)))
        alloc.slices[load.model] = {best.name: n}
    return alloc


def workload_from_replay_report(report: Dict, model_params: Dict[str, float],
                                decision_models: Optional[Dict[str, str]]
                                = None,
                                requests_per_s: Optional[float] = None
                                ) -> List[ModelLoad]:
    """Build a workload from a replay-bench report (bridges `make
    bench-replay` into sizing).

    ``decision_models`` maps replay decision names → served model names
    (decision names are NOT model names, so a guessy substring match
    would silently mis-split); decisions not in the map — and the whole
    mix when no map is given — spread uniformly. Shares always sum to 1.
    """
    decisions = report.get("decisions", {})
    total = sum(decisions.values()) or 1
    rps = requests_per_s or report.get("signals_per_s", 10.0)
    shares = {m: 0.0 for m in model_params}
    unmapped = 0.0
    for decision, count in decisions.items():
        model = (decision_models or {}).get(decision)
        if model in shares:
            shares[model] += count / total
        else:
            unmapped += count / total
    if not decisions or unmapped:
        spread = (unmapped if decisions else 1.0) / len(model_params)
        for m in shares:
            shares[m] += spread
    return [ModelLoad(model=m, param_b=model_params[m],
                      requests_per_s=rps * share)
            for m, share in shares.items()]
