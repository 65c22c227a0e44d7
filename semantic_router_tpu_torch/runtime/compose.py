"""Compose orchestration: render a runnable docker-compose deployment.

The port's copy of ``semantic_router_tpu.runtime.compose`` (reference
role: src/vllm-sr/cli, compose up/down and config generation): the router
container runs the port's ExtProc gRPC filter
(``python -m semantic_router_tpu_torch serve-extproc``), Envoy fronts it
with a fail-open filter chain, and each model card becomes an upstream
cluster and, with ``with_mock_backends``, a service running the port's
mock backend.

Rendering is deterministic (string templates, no docker invocation): the
files are what an operator runs ``docker compose up`` on.  ``yaml`` is
imported only here, when the files are written.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

from ..config import load_config

PACKAGE = "semantic_router_tpu_torch"


def _sanitize(name: str, sep: str = "-") -> str:
    """Model card name → a DNS / compose-safe token (HF-style 'org/model'
    names carry '/', which service names and hostnames forbid)."""
    return re.sub(r"[^a-zA-Z0-9]+", sep, name).strip(sep).lower()


def _envoy_config(cfg, extproc_host: str = "router",
                  listen_port: int = 8801) -> Dict:
    """An Envoy bootstrap as ``deploy/envoy.yaml`` lays it out (reference
    deploy/local/envoy.yaml:80-118): ext_proc BUFFERED, fail-open,
    header-based cluster selection, one cluster per backend model."""
    routes: List[Dict] = []
    clusters: List[Dict] = []
    backends = {}
    seen_tokens: Dict[str, str] = {}
    for card in cfg.model_cards:
        token = _sanitize(card.name)
        if token in seen_tokens:
            # two names collapsing to one service / cluster name would
            # overwrite each other's topology
            raise ValueError(
                f"model cards {seen_tokens[token]!r} and {card.name!r} "
                f"sanitize to the same service token {token!r} — rename "
                "one")
        seen_tokens[token] = card.name
        backends[card.name] = {
            "cluster": "vllm_" + _sanitize(card.name, "_"),
            "host": f"backend-{token}",
            "port": 8000,
        }
    for name, b in backends.items():
        # exact match, not prefix: a model name that prefixes another
        # ("llama-3" / "llama-3-70b") would capture the longer one's
        # traffic
        routes.append({
            "match": {"prefix": "/", "headers": [
                {"name": "x-vsr-selected-model",
                 "string_match": {"exact": name}}]},
            "route": {"cluster": b["cluster"], "timeout": "300s"}})
        clusters.append({
            "name": b["cluster"],
            "type": "STRICT_DNS",
            "connect_timeout": "5s",
            "load_assignment": {
                "cluster_name": b["cluster"],
                "endpoints": [{"lb_endpoints": [{"endpoint": {"address": {
                    "socket_address": {"address": b["host"],
                                       "port_value": b["port"]}}}}]}]}})
    default_cluster = (clusters[0]["name"] if clusters else "vllm_default")
    routes.append({"match": {"prefix": "/"},
                   "route": {"cluster": default_cluster,
                             "timeout": "300s"}})
    return {
        "static_resources": {
            "listeners": [{
                "name": "main",
                "address": {"socket_address": {
                    "address": "0.0.0.0", "port_value": listen_port}},
                "filter_chains": [{"filters": [{
                    "name": "envoy.filters.network.http_connection_manager",
                    "typed_config": {
                        "@type": "type.googleapis.com/envoy.extensions."
                                 "filters.network.http_connection_manager"
                                 ".v3.HttpConnectionManager",
                        "stat_prefix": "ingress_http",
                        "route_config": {
                            "name": "local_route",
                            "virtual_hosts": [{
                                "name": "backend", "domains": ["*"],
                                "routes": routes}]},
                        "http_filters": [
                            {"name": "envoy.filters.http.ext_proc",
                             "typed_config": {
                                 "@type": "type.googleapis.com/envoy."
                                          "extensions.filters.http."
                                          "ext_proc.v3.ExternalProcessor",
                                 "failure_mode_allow": True,
                                 "processing_mode": {
                                     "request_body_mode": "BUFFERED",
                                     "response_body_mode": "NONE",
                                     "request_header_mode": "SEND",
                                     "response_header_mode": "SKIP"},
                                 "grpc_service": {"envoy_grpc": {
                                     "cluster_name": "extproc"},
                                     "timeout": "30s"}}},
                            {"name": "envoy.filters.http.router",
                             "typed_config": {
                                 "@type": "type.googleapis.com/envoy."
                                          "extensions.filters.http."
                                          "router.v3.Router"}}]}}]}]}],
            "clusters": clusters + [{
                "name": "extproc",
                "type": "STRICT_DNS",
                "connect_timeout": "5s",
                "typed_extension_protocol_options": {
                    "envoy.extensions.upstreams.http.v3."
                    "HttpProtocolOptions": {
                        "@type": "type.googleapis.com/envoy.extensions."
                                 "upstreams.http.v3.HttpProtocolOptions",
                        "explicit_http_config": {"http2_protocol_options":
                                                 {}}}},
                "load_assignment": {
                    "cluster_name": "extproc",
                    "endpoints": [{"lb_endpoints": [{"endpoint": {
                        "address": {"socket_address": {
                            "address": extproc_host,
                            "port_value": 50051}}}}]}]}}]},
    }


def render_compose(config_path: str, out_dir: str,
                   envoy_image: str = "envoyproxy/envoy:v1.31-latest",
                   router_image: str = "semantic-router-tpu:latest",
                   with_mock_backends: bool = True) -> List[str]:
    """Write docker-compose.yaml, envoy.yaml and the router config into
    ``out_dir``; returns the file names written."""
    import yaml

    cfg = load_config(config_path)
    os.makedirs(out_dir, exist_ok=True)

    services: Dict[str, Dict] = {
        "router": {
            "image": router_image,
            "command": ["python", "-m", PACKAGE,
                        "serve-extproc", "--config",
                        "/etc/vsr/config.yaml", "--port", "50051"],
            "volumes": ["./config.yaml:/etc/vsr/config.yaml:ro"],
            "expose": ["50051"],
        },
        "envoy": {
            "image": envoy_image,
            "command": ["envoy", "-c", "/etc/envoy/envoy.yaml"],
            "volumes": ["./envoy.yaml:/etc/envoy/envoy.yaml:ro"],
            "ports": ["8801:8801"],
            "depends_on": ["router"],
        },
    }
    if with_mock_backends:
        for card in cfg.model_cards:
            services[f"backend-{_sanitize(card.name)}"] = {
                "image": router_image,
                "command": ["python", "-c",
                            f"from {PACKAGE}.router import "
                            "MockVLLMServer; import time; "
                            "MockVLLMServer(port=8000).start(); "
                            "time.sleep(10**9)"],
                "expose": ["8000"],
            }
            services["envoy"]["depends_on"].append(
                f"backend-{_sanitize(card.name)}")

    compose = {"services": services}
    with open(config_path) as f:
        config_text = f.read()

    written = []
    for name, payload in (
            ("docker-compose.yaml", yaml.safe_dump(compose,
                                                   sort_keys=False)),
            ("envoy.yaml", yaml.safe_dump(_envoy_config(cfg),
                                          sort_keys=False)),
            ("config.yaml", config_text)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(payload)
        written.append(name)
    return written
