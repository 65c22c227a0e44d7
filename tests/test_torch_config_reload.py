"""Config hot reload, against the JAX package where it has a counterpart,
on the CPU: ``ConfigWatcher.poll_once`` through an unchanged mtime, a
half-written file, the finished file and a broken callback; both
``serve(..., block=False, watch_config=True)`` paths over the fixture
config answering with a renamed decision after ``poll_once()`` (and the
backend resolver kept from the boot's config, as the reference's
server keeps it); the swap carrying the semantic cache, the memory
store, the vector stores and the state plane; ``engine.quant``,
``engine.kernels``, ``engine.packing`` and the cascade flipped by a
reload reaching the live engine as a fresh engine under the new config
has them, with batches in flight answered within 1e-4 of the plain
path; an invalid file and a refused one leaving the old config serving;
and ``server.stop()`` ending every reload's grace timer."""

import copy
import json
import os
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from semantic_router_tpu.config import ConfigWatcher as JWatcher
from semantic_router_tpu.runtime.events import WARMUP_DONE
from semantic_router_tpu.runtime.events import default_bus as jbus
from semantic_router_tpu_torch.config import ConfigWatcher, get, \
    load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import MmBertEmbeddingModel
from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_kernel_knobs, apply_packing_knobs, attach_config_watcher, \
    build_router
from semantic_router_tpu_torch.runtime import bootstrap as tboot
from semantic_router_tpu_torch.runtime.events import CONFIG_RELOADED
from test_torch_router import _write_checkpoint

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _touch(path, dt=5.0):
    """Give ``path`` an mtime ``dt`` seconds past its current one."""
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + dt))


KW_CONFIG = {
    "default_model": "m1",
    "routing": {
        "modelCards": [{"name": "m1"}, {"name": "m2"}],
        "signals": {"keywords": [{"name": "urgent_kw",
                                  "keywords": ["urgent"]}]},
        "decisions": [{"name": "urgent_route", "priority": 100,
                       "rules": {"operator": "OR", "conditions": [
                           {"type": "keyword", "name": "urgent_kw"}]},
                       "modelRefs": [{"model": "m2"}]}]}}


def _renamed(d, name):
    d = copy.deepcopy(d)
    d["routing"]["decisions"][0]["name"] = name
    return d


def test_poll_once_matches_the_reference(tmp_path):
    rows = []
    for watcher_cls in (JWatcher, ConfigWatcher):
        path = str(tmp_path / f"{watcher_cls.__module__}.yaml")
        with open(path, "w") as f:
            f.write(yaml.safe_dump(KW_CONFIG))
        seen = []
        broken = [False]

        def on_reload(cfg):
            seen.append(cfg.decisions[0].name)
            if broken[0]:
                raise RuntimeError("swap failed")

        w = watcher_cls(path, on_reload)
        got = [w.poll_once()]                       # unchanged mtime
        full = yaml.safe_dump(_renamed(KW_CONFIG, "second"))
        with open(path, "w") as f:                  # caught mid-write
            f.write(full[:len(full) // 2])
        _touch(path)
        got.append(w.poll_once())
        mtime = os.stat(path).st_mtime
        with open(path, "w") as f:                  # finished, same mtime
            f.write(full)
        os.utime(path, (mtime, mtime))
        got.append(w.poll_once())
        got.append(w.poll_once())                   # nothing new
        broken[0] = True
        with open(path, "w") as f:
            f.write(yaml.safe_dump(_renamed(KW_CONFIG, "third")))
        _touch(path)
        got.append(w.poll_once())                   # the callback raises
        got.append(w.poll_once())
        broken[0] = False
        with open(path, "w") as f:
            f.write(yaml.safe_dump(_renamed(KW_CONFIG, "fourth")))
        _touch(path)
        got.append(w.poll_once())                   # the watcher lives on
        rows.append((got, seen))
    assert rows[1] == rows[0]
    assert rows[1] == ([False, False, True, False, True, False, True],
                       ["second", "third", "fourth"])
    assert get().decisions[0].name == "fourth"


def _chat(url, text):
    req = urllib.request.Request(
        url + "/v1/chat/completions",
        data=json.dumps({"model": "auto", "messages": [
            {"role": "user", "content": text}]}).encode(), method="POST")
    req.add_header("content-type", "application/json")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, {k.lower(): v for k, v in resp.headers.items()}


def _with_backend_refs(text, url):
    """The config with every model on ``url`` and an upstream credential."""
    d = yaml.safe_load(text)
    for card in d["routing"]["modelCards"]:
        card["backend_refs"] = [{"endpoint": url, "weight": 100}]
    d["authz"] = {"credentials": [{"api_key": "sk-reloaded",
                                   "header": "x-upstream-key"}]}
    return yaml.safe_dump(d, sort_keys=False)


def test_serve_and_hot_reload_both(fixture_config_path, tmp_path):
    from semantic_router_tpu.runtime.bootstrap import serve as jserve

    backend, moved = MockVLLMServer().start(), MockVLLMServer().start()
    with open(fixture_config_path) as f:
        fixture = f.read()
    ckpt = str(tmp_path / "intent")
    d = yaml.safe_load(fixture)
    labels = [r["name"] for r in d["routing"]["signals"]["domains"]]
    _write_checkpoint(ckpt, labels, seed=3)
    paths = {"jax": str(tmp_path / "jax.yaml"),
             "port": str(tmp_path / "port.yaml")}
    shutil.copy(fixture_config_path, paths["jax"])
    d["classifier_models"] = {"intent": {"checkpoint": ckpt,
                                         "kind": "sequence"}}
    with open(paths["port"], "w") as f:
        f.write(yaml.safe_dump(d, sort_keys=False))
    status = str(tmp_path / "status.json")
    jserver, _ = jserve(paths["jax"], port=0, default_backend=backend.url,
                        mock_models=True, watch_config=True, block=False)
    tserver, tracker = tboot.serve(paths["port"], backend.url, port=0,
                                   device="cpu", status_path=status,
                                   block=False)
    servers = {"jax": jserver, "port": tserver}
    try:
        assert tracker.ready and tserver.watcher is not None
        for name, srv in servers.items():
            st, h = _chat(srv.url, "this is urgent asap")
            assert st == 200
            assert h["x-vsr-selected-decision"] == "urgent_route", name
        for name, srv in servers.items():
            with open(paths[name]) as f:
                text = f.read().replace("urgent_route", "renamed_urgent")
            with open(paths[name], "w") as f:
                # the reload also gives every model a backend of its own
                # and a credential: the server keeps the boot's resolver
                # and credentials, as the reference's does
                f.write(_with_backend_refs(text, moved.url))
            _touch(paths[name])
            assert srv.watcher.poll_once()
        for name, srv in servers.items():
            st, h = _chat(srv.url, "this is urgent asap")
            assert st == 200
            assert h["x-vsr-selected-decision"] == "renamed_urgent", name
        assert moved.hits == 0 and backend.hits == 4
        assert not any("x-upstream-key" in h for h in backend.headers_seen)
        assert tserver.cfg.decisions[0].name == \
            jserver.cfg.decisions[0].name
    finally:
        jserver.watcher.stop()
        jserver.stop()
        tserver.stop()
        tserver.router.shutdown()
        tserver.router.engine.shutdown()
        reg = tserver.registry
        reg.runtimestats.stop()
        reg.slo.stop()
        reg.resilience.stop()
        # the JAX engine warms on a thread of its own: wait for it before
        # shutting it down
        t0 = time.perf_counter()
        while not jbus.recent(5, WARMUP_DONE) \
                and time.perf_counter() - t0 < 120:
            time.sleep(0.05)
        jserver.router.shutdown()
        jserver.router.engine.shutdown()
        backend.stop()
        moved.stop()


# -- the swap on a live server with a tiny CPU engine --------------------


BASE = {
    "default_model": "m1",
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128, 512]},
    "semantic_cache": {"enabled": True, "backend_type": "memory",
                       "similarity_threshold": 0.99},
    "stateplane": {"enabled": True, "backend": "memory",
                   "heartbeat_s": 0.5},
    "vectorstore": {"backend": "memory"},
    "routing": {
        "modelCards": [{"name": "m1"}, {"name": "m2"}, {"name": "m3"}],
        "signals": {
            "keywords": [{"name": "urgent_kw", "keywords": ["urgent"]}],
            "domains": [{"name": n} for n, _ in [("business", 0),
                                                 ("law", 1)]]},
        "decisions": [
            {"name": "urgent_route", "priority": 200,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "urgent_kw"}]},
             "modelRefs": [{"model": "m2"}],
             "plugins": [{"type": "semantic-cache", "configuration": {
                 "enabled": True, "similarity_threshold": 0.99}}]},
            {"name": "business_route", "priority": 100,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "domain", "name": "business"}]},
             "modelRefs": [{"model": "m3"}]}]}}

TEXTS = ["urgent: the invoice is wrong", "what is the capital of france",
         "sue them for breach of contract now and forever " * 2,
         "segfault in my rust program when the arena reallocs", "ok",
         "quarterly revenue and margins " * 6]


class _Live:
    """A port server over a tiny CPU engine, its config in a file and its
    watcher driven by ``reload``."""

    def __init__(self, root, d):
        self.path = os.path.join(root, "router.yaml")
        self.write(d)
        cfg = load_config(self.path)
        self.registry = RuntimeRegistry.isolated()
        self.engine = ttesting.make_shared_trunk_engine(
            device="cpu", seed=5, engine_cfg=cfg.engine,
            token_tasks=[("pii", ["O", "B-EMAIL_ADDRESS"])])
        # the semantic cache embeds on the engine's embedding task
        emb = MmBertEmbeddingModel(ttesting.tiny_config(2))
        ttesting.init_weights(emb, 9)
        self.engine.register_task(
            "embedding", "embedding", emb,
            self.engine.trunk_group("intent").tokenizer, [],
            max_seq_len=512)
        apply_packing_knobs(cfg, self.engine)
        apply_kernel_knobs(cfg, self.engine)
        self.backend = MockVLLMServer().start()
        self.server = RouterServer(
            build_router(cfg, self.engine, registry=self.registry),
            self.backend.url, registry=self.registry,
            config_path=self.path).start()
        self.events = []
        self._unsub = self.registry.get("events").subscribe(
            lambda ev: self.events.append(ev)
            if ev.stage == CONFIG_RELOADED else None)
        self.watcher = attach_config_watcher(self.server, self.path,
                                             self.engine, self.registry,
                                             start=False)

    def write(self, d):
        with open(self.path, "w") as f:
            f.write(yaml.safe_dump(d, sort_keys=False))
        if hasattr(self, "watcher"):
            _touch(self.path)

    def reload(self, d):
        self.write(d)
        return self.watcher.poll_once()

    def close(self):
        self._unsub()
        self.server.stop()
        self.server.router.shutdown()
        self.engine.shutdown()
        self.backend.stop()
        tboot.close_ann(self.registry)
        tboot.close_stateplane(self.registry)
        for slot in ("runtimestats", "slo", "resilience"):
            self.registry.get(slot).stop()


@pytest.fixture
def live(tmp_path):
    lv = _Live(str(tmp_path), BASE)
    yield lv
    lv.close()


def test_reload_carries_cache_memory_vectorstores_and_plane(live):
    old = live.server.router
    assert old.stateplane is not None and old.cache is not None
    st, h = _chat(live.server.url, TEXTS[0])
    assert st == 200 and h["x-vsr-selected-decision"] == "urgent_route"
    assert live.reload(_renamed(BASE, "renamed"))
    new = live.server.router
    assert new is not old and live.server.cfg is new.cfg
    for attr in ("cache", "stateplane", "memory_store", "vectorstores"):
        assert getattr(new, attr) is getattr(old, attr), attr
    assert live.registry.get("stateplane") is old.stateplane
    st, h = _chat(live.server.url, TEXTS[0])
    assert h["x-vsr-selected-decision"] == "renamed"
    # the same prompt again: a hit in the carried cache
    assert h.get("x-vsr-cache-hit") == "true"
    assert [ev.detail for ev in live.events] == [{"decisions": 2}]


def _probs(results):
    return {t: [r.probs for r in rs] for t, rs in results.items()}


def test_engine_knobs_reach_the_live_engine(live):
    tasks = [n for n, _ in ttesting.SHARED_TRUNK_TASKS]
    want = _probs(live.engine.classify_multi(tasks, TEXTS))
    flips = [
        {"quant": {"mode": "bf16"}},
        {"quant": {"mode": "int8"}},
        {"kernels": {"epilogue": {"enabled": True},
                     "bgmv": {"enabled": True, "min_tasks": 2}}},
        {"packing": {"enabled": False}},
        {"cascade": {"enabled": True}},
        {"packing": {"enabled": True, "max_segments_per_row": 4},
         "kernels": {"epilogue": {"enabled": True},
                     "bgmv": {"enabled": False}}},
    ]
    d = copy.deepcopy(BASE)
    for flip in flips:
        d["engine"] = dict(d["engine"], **flip)
        assert live.reload(d)
        new_cfg = load_config(live.path)
        fresh = ttesting.make_shared_trunk_engine(
            device="cpu", seed=5, engine_cfg=new_cfg.engine,
            token_tasks=[("pii", ["O", "B-EMAIL_ADDRESS"])])
        try:
            apply_packing_knobs(new_cfg, fresh)
            apply_kernel_knobs(new_cfg, fresh)
            got, exp = live.engine.kernels_report(), fresh.kernels_report()
            for rep in (got, exp):
                rep.pop("rebuilds")
            assert got == exp, flip
            pg, pe = live.engine.packing_report(), fresh.packing_report()
            assert (pg["knobs"], pg["scheduler"]) == \
                (pe["knobs"], pe["scheduler"]), flip
        finally:
            fresh.shutdown()
        casc = live.registry.get("cascade")
        assert (casc is not None) == ("cascade" in d["engine"])
        assert live.server.router.cascade is casc
    assert live.engine.kernels_report()["groups"]
    meta = next(iter(live.engine.kernels_report()["groups"].values()))
    assert meta == {"quant": "int8", "epilogue": True, "bgmv": False}
    # f32 again: the answers are the boot's
    d["engine"]["quant"] = {"mode": "off"}
    assert live.reload(d)
    got = _probs(live.engine.classify_multi(tasks, TEXTS))
    for t in tasks:
        for g, w in zip(got[t], want[t]):
            assert max(abs(g[k] - w[k]) for k in w) <= TOL


def test_batches_in_flight_across_flips(live):
    """Kernel and packing flips (f32 throughout) while 4 threads classify:
    every answer within 1e-4 of the plain path's, none lost."""
    tasks = [n for n, _ in ttesting.SHARED_TRUNK_TASKS]
    want = _probs(live.engine.classify_multi(tasks, TEXTS))
    stop, errors, answers = threading.Event(), [], [0]

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            idx = sorted(rng.choice(len(TEXTS), 3, replace=False))
            try:
                got = _probs(live.engine.classify_multi(
                    tasks, [TEXTS[i] for i in idx]))
                for t in tasks:
                    for j, i in enumerate(idx):
                        diff = max(abs(got[t][j][k] - want[t][i][k])
                                   for k in want[t][i])
                        assert diff <= TOL, (t, i, diff)
                answers[0] += 1
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    d = copy.deepcopy(BASE)
    try:
        for i in range(6):
            d["engine"] = dict(d["engine"], kernels={
                "epilogue": {"enabled": i % 2 == 0},
                "bgmv": {"enabled": i % 3 == 0, "min_tasks": 2}},
                packing={"enabled": i % 2 == 1})
            assert live.reload(d)
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors[:3]
    assert answers[0] >= 4
    assert len(live.events) == 6


# an option the port still refuses (the routing flywheel and then MCP
# classifiers, once the refused option here, are served now)
REFUSED = copy.deepcopy(BASE)
REFUSED.setdefault("engine", {})["mesh_shape"] = {"data": 1}
GHOST = _renamed(BASE, "ghost_route")
GHOST["routing"]["decisions"][0]["rules"]["conditions"] = [
    {"type": "keyword", "name": "ghost_signal"}]


@pytest.mark.parametrize("bad", [GHOST, REFUSED],
                         ids=["invalid", "refused"])
def test_a_bad_file_leaves_the_old_config_serving(live, bad):
    old = live.server.router
    assert not live.reload(bad)
    assert live.server.router is old and not live.events
    st, h = _chat(live.server.url, TEXTS[0])
    assert h["x-vsr-selected-decision"] == "urgent_route"
    assert live.reload(_renamed(BASE, "fixed"))
    st, h = _chat(live.server.url, "urgent again")
    assert h["x-vsr-selected-decision"] == "fixed"


def test_stop_ends_every_grace_timer(live):
    routers = [live.server.router]
    for i in range(3):
        assert live.reload(_renamed(BASE, f"r{i}"))
        routers.append(live.server.router)
    assert sum(t.is_alive() for t, _ in live.server._retiring) == 3
    live.server.stop()
    assert not live.server._retiring
    assert not [t for t in threading.enumerate()
                if t.name == "router-retire" and t.is_alive()]
    for r in routers[:-1]:
        assert r.dispatcher.pool._shutdown


def test_a_new_snapshot_never_serves_the_old_kernel_toggles(live):
    """A batch reads its snapshot and then the live kernel toggles: the
    toggles change before the snapshots they invalidate are replaced, so
    a batch that finds a new snapshot finds the new toggles too."""
    seen = []
    publish = live.engine._publish

    def spy(g, demux):
        seen.append(dict(live.engine._kernels["bgmv"]))
        publish(g, demux)

    live.engine._publish = spy
    d = copy.deepcopy(BASE)
    d["engine"]["kernels"] = {"bgmv": {"enabled": True, "min_tasks": 2}}
    assert live.reload(d)
    assert seen and all(k == {"enabled": True, "min_tasks": 2}
                        for k in seen)
