"""Checkpoint download at boot on both packages, on the CPU: the
downloader's cases of the reference's own tests (a cached copy and a
literal path, gated errors, ``ensure_all`` degrading with no CLI); a
fake ``hf`` CLI on ``PATH`` that "downloads" a small seeded ModernBERT
checkpoint for one repo id and answers 401 for another, through which
both packages' ``ModelDownloader`` resolve, report and skip alike; and
both packages' ``build_engine`` resolving missing checkpoints with the
same ``download_started`` / ``download_done`` events, serving the
downloaded task (probabilities within 1e-4) and leaving the gated one
unloaded, or failing the boot with ``download_failed`` when a fault
escapes the downloader.  The port's ``serve(device="cpu")`` boots such a
config and answers a request through the downloaded task.  Nothing here
reaches the network: the CLI is the fake, or ``_hf_cli`` returns None."""

import json
import os
import stat
import sys

import numpy as np
import pytest

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.runtime import bootstrap as jboot
from semantic_router_tpu.runtime import events as jevents
from semantic_router_tpu.runtime import modeldownload as jmd
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.runtime import bootstrap as tboot
from semantic_router_tpu_torch.runtime import events as tevents
from semantic_router_tpu_torch.runtime import modeldownload as tmd
from test_torch_router import _write_checkpoint

PACKAGES = {"jax": jmd, "port": tmd}
LABELS = ["business", "health", "other"]
TOL = 1e-4

FAKE_HF = """#!{python}
import os, shutil, sys
args = sys.argv[1:]
repo, target = args[1], args[args.index("--local-dir") + 1]
with open(os.environ["FAKE_HF_LOG"], "a") as f:
    f.write(repo + "\\n")
if args[0] != "download":
    sys.exit(2)
if repo == "org/good":
    shutil.copytree(os.environ["FAKE_HF_SRC"], target, dirs_exist_ok=True)
    sys.exit(0)
if repo == "org/full":
    sys.stderr.write("disk full\\n")
    sys.exit(1)
sys.stderr.write("401 Client Error: Unauthorized (gated repo)\\n")
sys.exit(1)
"""


@pytest.fixture
def fake_hf(tmp_path, monkeypatch):
    """A fake ``hf`` first on PATH; the checkpoint it serves for
    ``org/good``; the log of the repo ids it was asked for."""
    src = str(tmp_path / "hub" / "good")
    module = _write_checkpoint(src, LABELS, seed=9)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "hf"
    script.write_text(FAKE_HF.format(python=sys.executable))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "hf.log"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_HF_SRC", src)
    monkeypatch.setenv("FAKE_HF_LOG", str(log))
    monkeypatch.delenv("HF_TOKEN", raising=False)
    for md in PACKAGES.values():
        assert md._hf_cli() == "hf"

    def asked():
        return log.read_text().split()

    return {"module": module, "asked": asked, "src": src}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_local_path_resolution_and_presence(pkg, tmp_path):
    d = PACKAGES[pkg].ModelDownloader(cache_dir=str(tmp_path))
    local = tmp_path / "org__model"
    local.mkdir()
    assert not d.is_present("org/model")
    (local / "config.json").write_text("{}")
    # config.json alone is what an interrupted download leaves
    assert not d.is_present("org/model")
    (local / "model.safetensors").write_bytes(b"x")
    assert d.is_present("org/model")
    assert d.local_path("org/model") == str(local)
    # literal config paths win
    assert d.local_path(str(local)) == str(local)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_gated_detection(pkg):
    gated = PACKAGES[pkg].is_gated_error
    assert gated("401 unauthorized", "org/m", "tok")
    assert gated("", "google/gemma-2b", "tok")
    assert gated("exit status 1", "org/m", "")  # no token
    assert not gated("disk full", "org/m", "tok")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ensure_all_degrades_not_crashes(pkg, tmp_path, monkeypatch):
    md = PACKAGES[pkg]
    monkeypatch.setattr(md, "_hf_cli", lambda: None)  # zero egress
    present = tmp_path / "have"
    present.mkdir()
    (present / "config.json").write_text("{}")
    d = md.ModelDownloader(cache_dir=str(tmp_path))
    resolved = d.ensure_all({
        "intent": {"checkpoint": str(present)},
        "pii": {"checkpoint": "org/not-downloaded"}})
    assert resolved == {"intent": str(present)}
    assert d.state.phase == "degraded"
    assert d.state.ready_models == 1


def test_fake_cli_downloads_and_skips_alike(fake_hf, tmp_path):
    specs = {"intent": {"checkpoint": "org/good"},
             "pii": {"checkpoint": "org/gated"},
             "none": {"kind": "sequence"}}
    seen = {}
    for pkg, md in PACKAGES.items():
        states = []
        d = md.ModelDownloader(cache_dir=str(tmp_path / pkg),
                               reporter=lambda s: states.append(s.to_dict()))
        resolved = d.ensure_all(specs)
        target = str(tmp_path / pkg / "org__good")
        assert resolved == {"intent": target}
        assert sorted(os.listdir(target)) == sorted(
            os.listdir(fake_hf["src"]) + [".srt-complete"])
        assert d.state.phase == "degraded"
        # a complete cache is not downloaded again
        asked = len(fake_hf["asked"]())
        assert d.download("org/good") == target
        assert len(fake_hf["asked"]()) == asked
        seen[pkg] = states
    assert seen["port"] == seen["jax"]
    assert fake_hf["asked"]() == ["org/good", "org/gated"] * 2


def test_a_failure_with_a_token_raises_in_download(fake_hf, tmp_path):
    errors = {}
    for pkg, md in PACKAGES.items():
        d = md.ModelDownloader(cache_dir=str(tmp_path / pkg),
                               hf_token="tok")
        with pytest.raises(RuntimeError, match="disk full") as exc:
            d.download("org/full")
        errors[pkg] = str(exc.value)
        # ensure_all turns it into an unloaded task, not a failed boot
        assert d.ensure_all({"x": {"checkpoint": "org/full"}}) == {}
    assert errors["port"] == errors["jax"]


def _specs() -> dict:
    return {"engine": {"seq_len_buckets": [16, 64], "max_batch_size": 4},
            "classifier_models": {
                "intent": {"checkpoint": "org/good", "kind": "sequence"},
                "guard": {"checkpoint": "org/gated", "kind": "sequence"}}}


class _Events:
    """The download events on both packages' default buses."""

    STAGES = ("download_started", "download_done", "download_failed")

    def __init__(self) -> None:
        self.rows = {"jax": [], "port": []}
        self._unsub = [
            jevents.default_bus.subscribe(lambda ev: self._add("jax", ev)),
            tevents.default_bus.subscribe(lambda ev: self._add("port", ev))]

    def _add(self, pkg, ev) -> None:
        if ev.stage in self.STAGES:
            self.rows[pkg].append((ev.stage, dict(ev.detail)))

    def close(self) -> None:
        for unsub in self._unsub:
            unsub()


def test_build_engine_downloads_on_both(fake_hf, tmp_path, monkeypatch):
    import torch

    events = _Events()
    engines = {}
    try:
        monkeypatch.setenv("SRT_MODEL_CACHE", str(tmp_path / "jax"))
        engines["jax"] = jboot.build_engine(JRouterConfig.from_dict(_specs()))
        monkeypatch.setenv("SRT_MODEL_CACHE", str(tmp_path / "port"))
        engines["port"] = tboot.build_engine(load_config(_specs()),
                                             device="cpu")
    finally:
        events.close()
    try:
        assert events.rows["port"] == events.rows["jax"] == [
            ("download_started", {"tasks": ["guard", "intent"]}),
            ("download_done", {"resolved": ["intent"]})]
        assert sorted(engines["port"].tasks()) == ["intent"]
        assert "guard" not in engines["jax"].tasks()
        text = "w1 w5 w9 w33"
        got = engines["port"].classify("intent", text).probs
        want = engines["jax"].classify("intent", text).probs
        assert got.keys() == want.keys() == set(LABELS)
        assert max(abs(got[k] - want[k]) for k in got) <= TOL
        # the downloaded weights are the checkpoint's
        g = engines["port"].trunk_group("intent")
        ids = torch.tensor([g.tokenizer.encode(text).ids])
        with torch.no_grad():
            plain = torch.softmax(fake_hf["module"].eval()(ids), -1)[0]
        np.testing.assert_allclose([got[k] for k in LABELS], plain.numpy(),
                                   atol=1e-5)
    finally:
        for e in engines.values():
            e.shutdown()


def test_an_isolated_registry_takes_the_port_download_events(
        fake_hf, tmp_path, monkeypatch):
    # a recorded divergence: the JAX build_engine emits on its process
    # default_bus whatever registry it is given, the port's on the
    # registry's own bus (the default bus only for the default registry)
    from semantic_router_tpu.runtime.registry import \
        RuntimeRegistry as JRegistry
    from semantic_router_tpu_torch.runtime.registry import \
        RuntimeRegistry as TRegistry

    jreg, treg = JRegistry.isolated(), TRegistry.isolated()
    own = []
    unsub = treg.get("events").subscribe(
        lambda ev: own.append((ev.stage, dict(ev.detail)))
        if ev.stage in _Events.STAGES else None)
    events = _Events()
    engines = []
    try:
        monkeypatch.setenv("SRT_MODEL_CACHE", str(tmp_path / "jax"))
        engines.append(jboot.build_engine(JRouterConfig.from_dict(_specs()),
                                          registry=jreg))
        monkeypatch.setenv("SRT_MODEL_CACHE", str(tmp_path / "port"))
        engines.append(tboot.build_engine(load_config(_specs()),
                                          device="cpu", registry=treg))
    finally:
        events.close()
        unsub()
        for e in engines:
            e.shutdown()
    want = [("download_started", {"tasks": ["guard", "intent"]}),
            ("download_done", {"resolved": ["intent"]})]
    assert events.rows["jax"] == want
    assert own == want and events.rows["port"] == []
    assert treg.get("events") is not tevents.default_bus


def test_a_downloader_fault_fails_the_boot_on_both(fake_hf, tmp_path,
                                                   monkeypatch):
    # a cache root under a file: the target directory cannot be made, an
    # OSError that escapes ensure_all
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    monkeypatch.setenv("SRT_MODEL_CACHE", str(blocker / "cache"))
    events = _Events()
    try:
        with pytest.raises(OSError) as jexc:
            jboot.build_engine(JRouterConfig.from_dict(_specs()))
        with pytest.raises(OSError) as texc:
            tboot.build_engine(load_config(_specs()), device="cpu")
    finally:
        events.close()
    assert type(texc.value) is type(jexc.value)
    assert events.rows["port"] == events.rows["jax"]
    assert [s for s, _ in events.rows["port"]] == ["download_started",
                                                   "download_failed"]


def test_port_serve_boots_from_a_download(fake_hf, tmp_path, monkeypatch):
    import http.client

    import yaml

    from semantic_router_tpu_torch.router import MockVLLMServer

    monkeypatch.setenv("SRT_MODEL_CACHE", str(tmp_path / "cache"))
    d = _specs()
    d["default_model"] = "m"
    d["routing"] = {"modelCards": [{"name": "m"}], "decisions": []}
    path = str(tmp_path / "router.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    backend = MockVLLMServer().start()
    server, tracker = tboot.serve(path, backend.url, port=0, device="cpu",
                                  block=False, watch_config=False)
    try:
        assert tracker.ready and server.kube_operator is None
        assert sorted(server.router.engine.tasks()) == ["intent"]
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("POST", "/api/v1/classify/intent",
                     body=json.dumps({"text": "w1 w5 w9 w33"}),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200, body
        want = server.router.engine.classify("intent", "w1 w5 w9 w33")
        assert body["label"] == want.label and want.label in LABELS
    finally:
        server.stop()
        server.router.shutdown()
        server.router.engine.shutdown()
        reg = server.registry
        reg.runtimestats.stop()
        reg.slo.stop()
        reg.resilience.stop()
        backend.stop()
