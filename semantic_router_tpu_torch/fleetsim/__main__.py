"""Fleet simulator CLI (the ``vllm-sr-sim`` optimize / whatif role).

  python -m semantic_router_tpu_torch.fleetsim optimize --workload w.json
  python -m semantic_router_tpu_torch.fleetsim whatif --workload w.json \
      --fleet fleet.json
  python -m semantic_router_tpu_torch.fleetsim catalog

``optimize`` prints the allocation and its report and exits 0;
``whatif`` prints the report and exits 1 when the fleet is infeasible;
``catalog`` prints the slice catalog.

workload JSON: [{"model", "param_b", "requests_per_s",
                 "avg_prompt_tokens"?, "avg_completion_tokens"?,
                 "slo_p50_latency_s"?}]
fleet JSON: {"model": {"v5e-4": 2, ...}}
"""

from __future__ import annotations

import argparse
import json
import sys

from .sim import (
    FleetAllocation,
    ModelLoad,
    TPU_CATALOG,
    optimize_fleet,
    simulate,
)


def _load_workload(path: str):
    with open(path) as f:
        rows = json.load(f)
    return [ModelLoad(**row) for row in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="semantic_router_tpu_torch.fleetsim")
    sub = ap.add_subparsers(dest="command", required=True)
    opt = sub.add_parser("optimize")
    opt.add_argument("--workload", required=True)
    opt.add_argument("--efficiency", type=float, default=0.55)
    wi = sub.add_parser("whatif")
    wi.add_argument("--workload", required=True)
    wi.add_argument("--fleet", required=True)
    wi.add_argument("--efficiency", type=float, default=0.55)
    sub.add_parser("catalog")
    args = ap.parse_args(argv)

    if args.command == "catalog":
        print(json.dumps({name: vars(spec) for name, spec in
                          TPU_CATALOG.items()}, indent=2))
        return 0

    workload = _load_workload(args.workload)
    if args.command == "optimize":
        alloc = optimize_fleet(workload, efficiency=args.efficiency)
        report = simulate(workload, alloc, efficiency=args.efficiency)
        print(json.dumps({"allocation": alloc.slices,
                          **report.to_dict()}, indent=2))
        return 0

    with open(args.fleet) as f:
        alloc = FleetAllocation(slices=json.load(f))
    report = simulate(workload, alloc, efficiency=args.efficiency)
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.feasible else 1


if __name__ == "__main__":
    sys.exit(main())
