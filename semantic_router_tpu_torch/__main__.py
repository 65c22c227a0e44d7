"""Command line.

``python -m semantic_router_tpu_torch serve --config router.yaml --backend
http://127.0.0.1:8000 --port 8801`` serves the router in front of one
OpenAI-compatible backend (on the GPU unless ``--device cpu``), hot
reloading the config file unless ``--no-watch``; ``validate --config``
checks a config file (rc 0 or 1, a JSON line); ``migrate-config --config
[--out FILE] [--check]`` lays a flat config out in the canonical v0.3
contract."""

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

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from .runtime.bootstrap import serve

    serve(args.config, args.backend, host=args.host, port=args.port,
          device=args.device, status_path=args.status_file or None,
          watch_config=not args.no_watch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
