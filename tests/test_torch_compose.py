"""The port's compose renderer (``semantic_router_tpu_torch.runtime.
compose``) and its event bus's ``wait_for`` against the JAX package's, on
the CPU: both renderings of the fixture config are equal apart from the
module their commands name, the rendered ``envoy.yaml`` meets the
committed deployment's contract (``assert_envoy_contract`` of
``tests/test_envoy_golden.py``) and the compose topology checks of
``tests/test_canonical_recipes.py``; the ``compose`` subcommand writes the
same files; ``EventBus.wait_for`` answers as the JAX bus does for an event
already in the ring, one that arrives later, and a time-out."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import yaml

from semantic_router_tpu.runtime import compose as jcompose
from semantic_router_tpu.runtime import events as jevents
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.runtime import compose as tcompose
from semantic_router_tpu_torch.runtime import events as tevents
from test_envoy_golden import _hcm, assert_envoy_contract

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(d) -> dict:
    return {name: (d / name).read_text() for name in
            ("docker-compose.yaml", "envoy.yaml", "config.yaml")}


@pytest.fixture()
def rendered(fixture_config_path, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jfiles = jcompose.render_compose(fixture_config_path, str(jdir))
    tfiles = tcompose.render_compose(fixture_config_path, str(tdir))
    assert tfiles == jfiles
    return _read(jdir), _read(tdir), tdir


def test_renderings_equal_but_the_module(rendered):
    want, got, _ = rendered
    assert got["envoy.yaml"] == want["envoy.yaml"]
    assert got["config.yaml"] == want["config.yaml"]
    assert got["docker-compose.yaml"] == want["docker-compose.yaml"] \
        .replace("semantic_router_tpu", "semantic_router_tpu_torch")
    assert got["docker-compose.yaml"] != want["docker-compose.yaml"]


def test_rendered_bootstrap_meets_the_deploy_contract(rendered):
    envoy = yaml.safe_load(rendered[1]["envoy.yaml"])
    assert_envoy_contract(envoy, expect_extproc_port=50051)


def test_every_model_card_has_exact_route(rendered, fixture_config_path):
    envoy = yaml.safe_load(rendered[1]["envoy.yaml"])
    routes = _hcm(envoy)["route_config"]["virtual_hosts"][0]["routes"]
    matched = {h["string_match"]["exact"]
               for r in routes
               for h in r["match"].get("headers", [])
               if h.get("name") == "x-vsr-selected-model"}
    cards = {m.name for m in load_config(fixture_config_path).model_cards}
    assert matched == cards


def test_render_topology(rendered):
    _, got, _ = rendered
    services = yaml.safe_load(got["docker-compose.yaml"])["services"]
    assert "router" in services and "envoy" in services
    assert any(s.startswith("backend-") for s in services)
    cmd = services["router"]["command"]
    assert cmd[:4] == ["python", "-m", "semantic_router_tpu_torch",
                       "serve-extproc"]
    for name, svc in services.items():
        if name.startswith("backend-"):
            assert "from semantic_router_tpu_torch.router import " \
                "MockVLLMServer" in svc["command"][-1]
    envoy = yaml.safe_load(got["envoy.yaml"])
    clusters = {c["name"]: c for c in envoy["static_resources"]["clusters"]}
    assert "extproc" in clusters
    hcm = _hcm(envoy)
    ext = next(f for f in hcm["http_filters"]
               if f["name"] == "envoy.filters.http.ext_proc")
    assert ext["typed_config"]["failure_mode_allow"] is True
    assert ext["typed_config"]["processing_mode"][
        "request_body_mode"] == "BUFFERED"
    assert len(hcm["route_config"]["virtual_hosts"][0]["routes"]) >= 2


@pytest.mark.parametrize("names", [["org/model-a", "org-model-a"],
                                   ["Llama 3", "llama-3"]])
def test_colliding_service_tokens_refused(names):
    cfg = {"default_model": names[0],
           "routing": {"modelCards": [{"name": n} for n in names],
                       "decisions": []}}
    from semantic_router_tpu.config import RouterConfig as JRouterConfig

    with pytest.raises(ValueError) as jerr:
        jcompose._envoy_config(JRouterConfig.from_dict(cfg))
    with pytest.raises(ValueError) as terr:
        tcompose._envoy_config(load_config(cfg))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["org/Model_v1.5", "a--b", "-x-", "Q"])
def test_sanitize_matches(name):
    for sep in ("-", "_"):
        assert tcompose._sanitize(name, sep) == jcompose._sanitize(name, sep)


def test_cli_compose(fixture_config_path, tmp_path):
    out = tmp_path / "dep"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "semantic_router_tpu_torch", "compose",
         "--config", fixture_config_path, "--out-dir", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip())
    assert report["rendered"] == sorted(["docker-compose.yaml",
                                         "envoy.yaml", "config.yaml"])
    jdir = tmp_path / "jax"
    jcompose.render_compose(fixture_config_path, str(jdir))
    assert (out / "envoy.yaml").read_text() == \
        (jdir / "envoy.yaml").read_text()


# ---------------------------------------------------------------------------
# EventBus.wait_for

@pytest.mark.parametrize("mod", [jevents, tevents], ids=["jax", "port"])
def test_wait_for_in_history_later_and_timeout(mod):
    bus = mod.EventBus()
    first = bus.emit("engine_ready", n=1)
    bus.emit("engine_ready", n=2)
    bus.emit("other")
    got = bus.wait_for("engine_ready", timeout=0.01)
    assert got.detail == {"n": 2} and got is not first   # the latest

    t = threading.Timer(0.05, lambda: bus.emit("config_reloaded", v=7))
    t.start()
    t0 = time.monotonic()
    got = bus.wait_for("config_reloaded", timeout=5.0)
    t.join()
    assert got is not None and got.detail == {"v": 7}
    assert time.monotonic() - t0 < 5.0

    t0 = time.monotonic()
    assert bus.wait_for("never", timeout=0.05) is None
    assert time.monotonic() - t0 >= 0.05
    # waiting leaves no subscriber behind
    assert bus._subs == []


def test_wait_for_agrees_between_packages():
    outs = []
    for mod in (jevents, tevents):
        bus = mod.EventBus(history=2)
        for i in range(3):
            bus.emit("a" if i == 0 else "b", i=i)
        # "a" fell off the two-event ring: it is waited for, not found
        outs.append((bus.wait_for("a", timeout=0.02),
                     bus.wait_for("b", timeout=0.02).detail))
    assert outs[1] == outs[0] == (None, {"i": 2})
