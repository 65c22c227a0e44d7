"""Command line.

``python -m semantic_router_tpu_torch serve --config router.yaml --backend
http://127.0.0.1:8000 --port 8801`` serves the router in front of one
OpenAI-compatible backend (on the GPU unless ``--device cpu``), hot
reloading the config file unless ``--no-watch``; ``validate --config``
checks a config file (rc 0 or 1, a JSON line); ``migrate-config --config
[--out FILE] [--check]`` lays a flat config out in the canonical v0.3
contract; ``serve-extproc --config router.yaml [--port 50051] [--backend
URL] [--device cpu]`` serves the Envoy ExtProc gRPC filter (its address on
stderr as ``extproc listening on <addr>``); ``compose --config router.yaml
--out-dir DIR`` renders the router + Envoy docker-compose deployment;
``grafana --out-dir DIR`` renders provisioning-ready Grafana dashboards
from the metric catalog (a JSON line of the files written)."""

from __future__ import annotations

import argparse
import json
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m semantic_router_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve POST /v1/chat/completions")
    s.add_argument("--config", required=True,
                   help="router config (YAML file)")
    s.add_argument("--backend", required=True,
                   help="OpenAI-compatible backend base URL (http://...)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8801)
    s.add_argument("--device", default=None,
                   help="torch device for the classifiers (default: cuda)")
    s.add_argument("--status-file", default="",
                   help="write the boot's startup status here")
    s.add_argument("--no-watch", action="store_true",
                   help="do not hot reload the config file")
    v = sub.add_parser("validate", help="validate a config file")
    v.add_argument("--config", required=True)
    m = sub.add_parser("migrate-config",
                       help="lay a flat config out in the canonical v0.3 "
                            "contract")
    m.add_argument("--config", required=True)
    m.add_argument("--out", default="-",
                   help="output path; '-' for stdout")
    m.add_argument("--check", action="store_true",
                   help="verify the migrated config loads to the same "
                        "routing")
    e = sub.add_parser("serve-extproc",
                       help="serve the Envoy ExtProc gRPC filter")
    e.add_argument("--config", required=True)
    e.add_argument("--port", type=int, default=50051)
    e.add_argument("--backend", default="",
                   help="default backend base URL of looper decisions")
    e.add_argument("--device", default=None,
                   help="torch device for the classifiers (default: cuda)")
    c = sub.add_parser("compose",
                       help="render the router + Envoy docker-compose "
                            "deployment")
    c.add_argument("--config", required=True)
    c.add_argument("--out-dir", required=True)
    c.add_argument("--envoy-image", default="envoyproxy/envoy:v1.31-latest")
    c.add_argument("--router-image", default="semantic-router-tpu:latest")
    g = sub.add_parser("grafana",
                       help="render provisioning-ready Grafana dashboards "
                            "from the metric catalog")
    g.add_argument("--out-dir", required=True)
    args = p.parse_args(argv)

    if args.cmd == "validate":
        from .config import load_config, validate_config

        try:
            cfg = load_config(args.config)
        except Exception as exc:
            print(json.dumps({"valid": False, "error": str(exc)}))
            return 1
        warnings = [str(e) for e in validate_config(cfg) if not e.fatal]
        print(json.dumps({"valid": True, "warnings": warnings,
                          "decisions": len(cfg.decisions),
                          "models": len(cfg.model_cards),
                          "signal_families": cfg.used_signal_types()}))
        return 0

    if args.cmd == "migrate-config":
        import yaml

        from .config import (
            export_canonical,
            is_canonical,
            load_config,
            loads_config,
        )

        cfg = load_config(args.config)
        text = yaml.safe_dump(export_canonical(cfg), sort_keys=False)
        if args.check:
            cfg2 = loads_config(text)
            same = (sorted(d.name for d in cfg2.decisions)
                    == sorted(d.name for d in cfg.decisions)
                    and cfg2.used_signal_types() == cfg.used_signal_types()
                    and cfg2.default_model == cfg.default_model)
            if not same:
                print(json.dumps({"migrated": False,
                                  "error": "behavior mismatch"}),
                      file=sys.stderr)
                return 1
        if args.out == "-":
            print(text)
        else:
            with open(args.out, "w") as f:
                f.write(text)
            print(json.dumps({"migrated": True, "out": args.out,
                              "was_canonical": is_canonical(cfg.raw or {})}))
        return 0

    if args.cmd == "compose":
        from .runtime.compose import render_compose

        paths = render_compose(args.config, args.out_dir,
                               envoy_image=args.envoy_image,
                               router_image=args.router_image)
        print(json.dumps({"rendered": sorted(paths)}))
        return 0

    if args.cmd == "grafana":
        from .observability.grafana import render_all

        print(json.dumps({"rendered": sorted(render_all(args.out_dir))}))
        return 0

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.cmd == "serve-extproc":
        return serve_extproc(args.config, args.port, args.backend,
                             args.device)
    from .runtime.bootstrap import serve

    serve(args.config, args.backend, host=args.host, port=args.port,
          device=args.device, status_path=args.status_file or None,
          watch_config=not args.no_watch)
    return 0


def serve_extproc(config: str, port: int, backend: str, device) -> int:
    """Build the engine (on ``device``, ``cuda`` when None) and the router
    as ``serve`` does, and serve them behind the ExtProc filter, looper
    decisions answered against ``backend``, until interrupted."""
    import time

    from .config import load_config
    from .extproc import ExtProcServer
    from .extproc.server import build_looper_executor
    from .runtime.bootstrap import apply_observability_knobs, \
        build_engine, build_router, close_ann, close_stateplane, \
        warm_engine
    from .runtime.registry import RuntimeRegistry
    from .utils.device import resolve_device

    dev = resolve_device(device)
    cfg = load_config(config)
    registry = RuntimeRegistry.with_defaults()
    apply_observability_knobs(cfg, registry)
    engine = build_engine(cfg, device=dev, registry=registry)
    if engine is not None:
        warm_engine(engine, registry)
    router = build_router(cfg, engine, registry=registry)
    server = ExtProcServer(
        router, port=port,
        looper_execute=build_looper_executor(cfg, backend)).start()
    print(f"extproc listening on {server.address}", file=sys.stderr,
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        router.shutdown()
        if engine is not None:
            engine.shutdown()
        registry.runtimestats.stop()
        registry.slo.stop()
        registry.resilience.stop()
        close_ann(registry)
        close_stateplane(registry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
