"""Command line: ``python -m semantic_router_tpu_torch serve --config
router.yaml --backend http://127.0.0.1:8000 --port 8801`` serves the
router in front of one OpenAI-compatible backend (on the GPU unless
``--device cpu``)."""

from __future__ import annotations

import argparse
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
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from .runtime.bootstrap import serve

    serve(args.config, args.backend, host=args.host, port=args.port,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
