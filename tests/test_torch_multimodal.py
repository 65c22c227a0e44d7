"""The multimodal surface on the port against the JAX package's, on the
CPU: ``register_multimodal`` / ``embed_multimodal`` (the task kind, its
info, ``images`` winning over ``image_refs``, the wrong-kind errors) on
one tiny seeded SigLIP; a ``build_engine`` from a SigLIP checkpoint
directory; ``EmbeddingSignal``'s image leg (image rules in the shared
space, the per-branch fail-open of a bad image or a missing task, the
request memo) and both routers over image-modality rules with PNG
``data:`` URIs; ``imagegen``'s two backends against a local stub; and
the server's ``image_generation`` branch, plain, streamed and through
``/v1/messages``, its 502s and its feedback, each answer compared with
the JAX server's on the same config."""

import base64
import copy
import http.client
import io
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.config.schema import EmbeddingRule as JRule
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.models import siglip as jsig
from semantic_router_tpu.router import imagegen as jimg
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.signals import RequestContext as JContext
from semantic_router_tpu.signals.base import Message as JMessage
from semantic_router_tpu.signals.embedding_signal import \
    EmbeddingSignal as JEmbeddingSignal
from semantic_router_tpu.utils import tokenization as jtok
from semantic_router_tpu_torch.config import InferenceEngineConfig, \
    load_config
from semantic_router_tpu_torch.config.schema import EmbeddingRule
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import siglip as tsig
from semantic_router_tpu_torch.models.convert import \
    siglip_params_from_flax
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router import imagegen as timg
from semantic_router_tpu_torch.runtime import build_engine
from semantic_router_tpu_torch.signals import RequestContext
from semantic_router_tpu_torch.signals.base import Message
from semantic_router_tpu_torch.signals.embedding_signal import \
    EmbeddingSignal
from semantic_router_tpu_torch.utils import tokenization as ttok
from test_torch_siglip import TEXT, TOL, VISION

MM = "multimodal"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png_uri(color, size=(20, 16)) -> str:
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


@pytest.fixture(scope="module")
def siglip_params():
    jm = jsig.SiglipModel(jsig.SiglipTowerConfig(**TEXT),
                          jsig.SiglipTowerConfig(**VISION))
    params = jm.init(jax.random.PRNGKey(21), jnp.ones((1, 16), jnp.int32),
                     jnp.zeros((1, 24, 24, 3)))
    rng = np.random.default_rng(22)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a))
        .astype(np.float32), params)


def _embedders(params):
    je = jsig.SiglipEmbedder(jsig.SiglipTowerConfig(**TEXT),
                             jsig.SiglipTowerConfig(**VISION), params,
                             tokenizer=jtok.HashTokenizer(99))
    tm = tsig.SiglipModel(tsig.SiglipTowerConfig(**TEXT),
                          tsig.SiglipTowerConfig(**VISION))
    tm.load_state_dict(siglip_params_from_flax(params))
    te = tsig.SiglipEmbedder(tsig.SiglipTowerConfig(**TEXT),
                             tsig.SiglipTowerConfig(**VISION), tm,
                             tokenizer=ttok.HashTokenizer(99), device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines(siglip_params):
    """(JAX engine, port engine): one embedding task and the SigLIP task
    ``multimodal``, on the same weights."""
    jeng = jtesting.make_test_engine(
        tasks=[("embedding", "embedding", [])], seed=23)
    teng = ttesting.make_test_engine(
        tasks=[("embedding", "embedding", [])], device="cpu",
        engine_cfg=InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                         seq_len_buckets=[32, 128, 512]),
        flax_params={"embedding": jeng._tasks["embedding"].params})
    je, te = _embedders(siglip_params)
    jeng.register_multimodal(MM, je)
    teng.register_multimodal(MM, te)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


# -- the engine ----------------------------------------------------------


def test_embed_multimodal_matches_jax(engines):
    jeng, teng = engines
    px = np.random.default_rng(24).normal(size=(3, 24, 24, 3)).astype(
        np.float32)
    refs = [_png_uri((200, 10, 10)), _png_uri((10, 10, 200), (30, 9))]
    for kwargs in ({"texts": ["a red square", "blue"]},
                   {"images": px},
                   {"image_refs": refs},
                   {"texts": ["x"], "images": px, "image_refs": refs},
                   {"texts": [], "images": px[:0], "image_refs": refs},
                   {}):
        got = teng.embed_multimodal(MM, **kwargs)
        want = jeng.embed_multimodal(MM, **kwargs)
        assert sorted(got) == sorted(want), kwargs
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL)
    both = teng.embed_multimodal(MM, images=px, image_refs=refs)
    assert both["image"].shape == (3, 32)  # images win over image_refs


def test_multimodal_task_is_listed_like_jax(engines):
    jeng, teng = engines
    assert teng.task_kind(MM) == jeng.task_kind(MM) == "multimodal"
    assert sorted(teng.tasks()) == sorted(jeng.tasks())
    assert teng.task_info(MM) == jeng.task_info(MM) == {
        "task": MM, "kind": "multimodal", "max_seq_len": 0}
    assert teng.task_labels(MM) == jeng.task_labels(MM) == []
    assert teng.has_task(MM)
    assert f"task:{MM}" in teng.graph_report()
    # never warmed: its tower steps key on the shapes a call brings
    teng.warmup()
    assert not [s for s in teng.steps() if s["group"] == f"task:{MM}"]


@pytest.mark.parametrize("method, args", [
    ("classify", (MM, "x")), ("embed", (MM, ["x"])),
    ("generate", (MM, ["x"])), ("embed_multimodal", ("embedding",)),
    ("embed_multimodal", ("absent",))])
def test_wrong_kind_errors_match_jax(engines, method, args):
    msgs = []
    for eng in reversed(engines):
        with pytest.raises((TypeError, KeyError)) as exc:
            getattr(eng, method)(*args)
        msgs.append((type(exc.value), str(exc.value)))
    assert msgs[0] == msgs[1]


def test_embedder_on_another_device_is_refused(siglip_params):
    _, te = _embedders(siglip_params)
    te.device = torch.device("meta")
    eng = InferenceEngine(InferenceEngineConfig(), device="cpu")
    try:
        with pytest.raises(ValueError, match="meta"):
            eng.register_multimodal("mm", te)
    finally:
        eng.shutdown()


def test_embedder_steps_run_in_the_engine_cache(engines):
    _, teng = engines
    te = teng._tasks[MM].generator
    assert te.graphs is teng._tasks[MM].graphs
    assert te.graphs.gate is teng._gate
    teng.embed_multimodal(MM, texts=["a", "b", "c"])
    assert ("text", 3) in te.graphs.keys() and te.last_graph == "eager"


def test_counting_a_step_leaves_other_threads_forwards_alone():
    """Steps counted on one thread (each first execution) while a tower
    runs on another, as an image rule's query runs beside the batcher:
    the other forwards never fail, and the counts hold only their own
    thread's work."""
    from semantic_router_tpu_torch.observability.programstats import \
        StepCost

    tower = tsig.SiglipVisionTower(tsig.SiglipTowerConfig(**VISION)).eval()
    px = torch.randn(2, 24, 24, 3)
    mlp = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.GELU(),
                              torch.nn.Linear(8, 8))
    x = torch.randn(4, 8)
    stop, errors, counts = threading.Event(), [], set()

    def other():
        while not stop.is_set():
            try:
                with torch.inference_mode():
                    tower(px)
            except Exception as exc:
                errors.append(exc)
                return

    t = threading.Thread(target=other)
    t.start()
    try:
        for _ in range(200):
            with torch.inference_mode(), StepCost() as cost:
                mlp(x)
            counts.add(cost.flops)
    finally:
        stop.set()
        t.join()
    assert errors == []
    assert counts == {2 * 2 * 4 * 8 * 8}


# -- the bootstrap --------------------------------------------------------


def test_build_engine_loads_a_siglip_checkpoint_like_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    st = pytest.importorskip("safetensors.torch")
    tokenizers = pytest.importorskip("tokenizers")
    pytest.importorskip("safetensors.numpy")
    from semantic_router_tpu.runtime.bootstrap import \
        build_engine as jbuild_engine

    cfg = transformers.SiglipConfig(text_config=dict(TEXT),
                                    vision_config=dict(VISION))
    torch.manual_seed(3)
    hf = transformers.SiglipModel(cfg).eval()
    ckpt = tmp_path / "siglip"
    ckpt.mkdir()
    st.save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
                 str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps(
        dict(cfg.to_dict(), architectures=["SiglipModel"])))
    words = ["[PAD]", "[UNK]", "a", "photo", "of", "cat", "invoice"]
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(ckpt / "tokenizer.json"))
    d = {"engine": {"seq_len_buckets": [16, 64]},
         "classifier_models": {"mm": {"checkpoint": str(ckpt),
                                      "kind": "multimodal"}}}
    jeng = jbuild_engine(JRouterConfig.from_dict(copy.deepcopy(d)))
    teng = build_engine(load_config(copy.deepcopy(d)), device="cpu")
    try:
        assert teng.task_kind("mm") == jeng.task_kind("mm") == "multimodal"
        px = np.random.default_rng(25).normal(size=(2, 24, 24, 3)).astype(
            np.float32)
        texts = ["a photo of a cat", "invoice", "dog"]
        got = teng.embed_multimodal("mm", texts=texts, images=px)
        want = jeng.embed_multimodal("mm", texts=texts, images=px)
        for k in ("text", "image"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL)
        assert teng._tasks["mm"].generator.pad_id == 1
    finally:
        teng.shutdown()
        jeng.shutdown()


# -- the image leg of the embedding family ---------------------------------


class _MM:
    """A shared-space stand-in (the reference's test double): texts with
    'photo' and every image land on axis 0; the image ``bad`` cannot be
    read."""

    tokenizer = None

    def embed_text(self, texts):
        out = np.zeros((len(texts), 4), np.float32)
        for i, t in enumerate(texts):
            out[i, 0 if "photo" in t else 1] = 1.0
        return out

    def embed_image(self, images):
        out = np.zeros((len(images), 4), np.float32)
        out[:, 0] = 1.0
        return out

    def embed_image_refs(self, refs):
        for r in refs:
            if r == "bad":
                raise ValueError("unreadable image")
        return self.embed_image(refs)


def _ctxs(text, image=None):
    imgs = [image] if image is not None else []
    return (RequestContext(messages=[Message("user", text, images=imgs)]),
            JContext(messages=[JMessage("user", text, images=imgs)]))


def _rules(cls, *specs):
    return [cls(**s) for s in specs]


SUPPORT = dict(name="support", threshold=0.99,
               candidates=["how to configure the system"])
VISUAL = dict(name="visual", threshold=0.9, query_modality="image",
              candidates=["a photo"])
NEVER = dict(name="never", threshold=0.9, query_modality="image",
             candidates=["a chart"], aggregation_method="any")


def _signals(teng, jeng, specs, task="embedding", mm="mm"):
    return (EmbeddingSignal(teng, _rules(EmbeddingRule, *specs), task=task,
                            multimodal_task=mm),
            JEmbeddingSignal(jeng, _rules(JRule, *specs), task=task,
                             multimodal_task=mm))


def _same_result(got, want):
    assert [(h.rule, h.detail) for h in got.hits] == \
        [(h.rule, h.detail) for h in want.hits]
    for g, w in zip(got.hits, want.hits):
        assert abs(g.confidence - w.confidence) <= TOL
    assert got.error == want.error


@pytest.fixture
def stub_engines(engines):
    jeng, teng = engines
    jeng.register_multimodal("mm", _MM())
    teng.register_multimodal("mm", _MM())
    return jeng, teng


@pytest.mark.parametrize("case", [
    ("look", "data-uri-stub"), ("look", None),
    ("how to configure the system", "bad"),
    ("how to configure the system", "data-uri-stub"),
    ("how to configure the system", None)])
def test_image_rules_match_jax(stub_engines, case):
    """Image rules hit only with an image, with ``modality: image``; a bad
    image records ``image: ...`` and keeps the text rules' hits."""
    jeng, teng = stub_engines
    text, image = case
    tsig_, jsig_ = _signals(teng, jeng, [SUPPORT, VISUAL, NEVER])
    tctx, jctx = _ctxs(text, image)
    got, want = tsig_.evaluate(tctx), jsig_.evaluate(jctx)
    _same_result(got, want)
    if image == "bad":
        assert [h.rule for h in got.hits] == ["support"]
        assert got.error.startswith("image: ValueError")
    if image == "data-uri-stub":
        assert "visual" in [h.rule for h in got.hits]
        assert got.hits[-1].detail == {"modality": "image"}
        assert tctx.ext[("query_img_emb", "mm")].shape == (4,)


def test_missing_tasks_fail_open_per_branch_like_jax(stub_engines):
    """No text task: the image rules still run; no multimodal task: the
    text rules' hits stand and the error names the task."""
    jeng, teng = stub_engines
    for task, mm in (("absent", "mm"), ("embedding", "absent")):
        tsig_, jsig_ = _signals(teng, jeng, [SUPPORT, VISUAL], task=task,
                                mm=mm)
        tctx, jctx = _ctxs("how to configure the system", "x")
        got, want = tsig_.evaluate(tctx), jsig_.evaluate(jctx)
        _same_result(got, want)
        assert got.error == "task 'absent' not loaded"
        assert [h.rule for h in got.hits] == \
            (["visual"] if task == "absent" else ["support"])


def test_image_query_memo_is_read_like_jax(stub_engines):
    """A request whose memo already holds the image embedding is scored
    on it: no image is decoded (``bad`` would fail)."""
    jeng, teng = stub_engines
    tsig_, jsig_ = _signals(teng, jeng, [VISUAL, NEVER])
    tctx, jctx = _ctxs("look", "bad")
    emb = np.asarray([1.0, 0, 0, 0], np.float32)
    tctx.ext[("query_img_emb", "mm")] = emb
    jctx.ext[("query_img_emb", "mm")] = emb
    got, want = tsig_.evaluate(tctx), jsig_.evaluate(jctx)
    _same_result(got, want)
    assert got.error is None and [h.rule for h in got.hits] == ["visual"]


def test_candidates_are_embedded_once_in_the_shared_space(engines):
    jeng, teng = engines
    calls = []
    te = teng._tasks[MM].generator
    orig = te.embed_text
    te.embed_text = lambda texts: calls.append(list(texts)) or orig(texts)
    try:
        sig = EmbeddingSignal(teng, _rules(EmbeddingRule, VISUAL, NEVER),
                              multimodal_task=MM)
        for _ in range(3):
            sig.evaluate(_ctxs("x", _png_uri((1, 2, 3)))[0])
    finally:
        te.embed_text = orig
    assert sorted(calls) == [["a chart"], ["a photo"]]
    assert set(sig.bank._cache) == {"mm_cands:visual", "mm_cands:never"}


ROUTE_CFG = {
    "default_model": "text-model",
    "routing": {
        "modelCards": [{"name": "text-model"}, {"name": "vision-model"},
                       {"name": "reasoning-model"}],
        "signals": {
            "embeddings": [
                {"name": "red_things", "threshold": -1.0,
                 "query_modality": "image", "aggregation_method": "max",
                 "candidates": ["a red square", "a fire truck"]},
                {"name": "billing", "threshold": 0.2,
                 "candidates": ["invoice for march", "refund my order"]}],
            "complexity": [
                {"name": "hard_vision", "threshold": -1.0,
                 "hard": {"candidates": ["prove the theorem"],
                          "image_candidates": ["a dense chart"]},
                 "easy": {"candidates": ["say hi"],
                          "image_candidates": ["a plain photo"]}}]},
        "decisions": [
            {"name": "see", "priority": 20,
             "rules": {"operator": "AND", "conditions": [
                 {"type": "embedding", "name": "red_things"}]},
             "modelRefs": [{"model": "vision-model"}]},
            {"name": "pay", "priority": 10,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "embedding", "name": "billing"}]},
             "modelRefs": [{"model": "text-model"}]},
            {"name": "think", "priority": 5,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "complexity", "name": "hard_vision"}]},
             "modelRefs": [{"model": "reasoning-model"}]}]}}


def _image_body(text, uri):
    content = [{"type": "text", "text": text}]
    if uri is not None:
        content.append({"type": "image_url", "image_url": {"url": uri}})
    return {"model": "auto", "messages": [{"role": "user",
                                            "content": content}]}


@pytest.mark.parametrize("text, color", [
    ("what is in this picture", (220, 20, 20)),
    ("refund my order please", None),
    ("invoice for march", (20, 220, 20)),
    ("prove the theorem", (0, 0, 0)),
    ("look", "https://example.com/cat.png"),
    ("look", "data:image/png;base64,!!notpng")])
def test_routers_match_jax_on_image_rules(engines, text, color):
    """Both routers over image-modality and text rules, with a PNG data
    URI (or a refused / unreadable reference): decision, model, matches,
    confidences and the family's error equal."""
    jeng, teng = engines
    uri = color if isinstance(color, str) or color is None \
        else _png_uri(color)
    jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(ROUTE_CFG)),
                 engine=jeng)
    tr = Router(load_config(copy.deepcopy(ROUTE_CFG)), engine=teng)
    try:
        body = _image_body(text, uri)
        want = jr.route(copy.deepcopy(body))
        got = tr.route(copy.deepcopy(body))
        assert got.kind == want.kind
        assert (got.decision.decision.name if got.decision else None) == \
            (want.decision.decision.name if want.decision else None)
        assert got.model == want.model
        gm, wm = got.signals.matches, want.signals.matches
        assert {t: sorted(n) for t, n in gm.items()} == \
            {t: sorted(n) for t, n in wm.items()}
        for key, conf in want.signals.confidences.items():
            assert abs(got.signals.confidences[key] - conf) <= TOL, key
        if isinstance(color, tuple):
            assert "red_things" in gm.get("embedding", ())
        elif isinstance(color, str):
            assert "red_things" not in gm.get("embedding", ())
    finally:
        jr.shutdown()
        tr.shutdown()


# -- image generation ----------------------------------------------------

B64 = base64.b64encode(b"\x89PNG fake image bytes").decode()


class ImageStub:
    """A stdlib image backend: ``POST /v1/images/generations`` (the openai
    shape) and ``POST /v1/chat/completions`` (vllm_omni: the image as a
    content part); ``fail`` answers 500.  Keeps every request."""

    def __init__(self, fail: bool = False) -> None:
        stub = self
        self.fail = fail
        self.requests = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("content-length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                stub.requests.append((self.path, body,
                                      self.headers.get("authorization")))
                if stub.fail:
                    self.send_response(500)
                    self.send_header("content-length", "0")
                    self.end_headers()
                    return
                if self.path == "/v1/images/generations":
                    out = {"created": 1, "data": [{
                        "b64_json": B64,
                        "revised_prompt": "a red fox, " + body["prompt"]}]}
                else:
                    out = {"model": body.get("model") or "omni",
                           "choices": [{"message": {"content": [
                               {"type": "image_url", "image_url": {
                                   "url": "data:image/png;base64," + B64}}
                           ]}}]}
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def stub():
    s = ImageStub()
    yield s
    s.stop()


@pytest.mark.parametrize("conf", [
    {"backend": "openai", "model": "dall-e-3", "api_key": "k1"},
    {"backend": "openai"},
    {"backend": "vllm_omni", "model": "omni-1"},
    {"backend": "vllm_omni"}])
@pytest.mark.parametrize("req", [
    {"prompt": "a fox"},
    {"prompt": "a fox", "width": 512, "height": 256, "quality": "hd",
     "style": "vivid", "num_inference_steps": 20, "guidance_scale": 3.5,
     "seed": 7, "negative_prompt": "blur", "model": "m2"}])
def test_backends_send_and_read_like_jax(stub, conf, req):
    out = []
    for mod in (jimg, timg):
        stub.requests.clear()
        backend = mod.build_backend(dict(conf, base_url=stub.url + "/"))
        result = backend.generate(mod.GenerateRequest(**req))
        out.append((backend.name, backend.timeout_s, list(stub.requests),
                    result.__dict__))
    assert out[0] == out[1]
    assert out[1][3]["backend"] == conf["backend"]


def test_backend_errors_and_health_match_jax(stub):
    for conf in ({"backend": "mock"}, {"backend": "dall-e"}):
        msgs = []
        for mod in (jimg, timg):
            with pytest.raises(ValueError) as exc:
                mod.build_backend(conf)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    dead = "http://127.0.0.1:9"
    for conf in ({"backend": "openai", "base_url": dead},
                 {"backend": "vllm_omni", "base_url": dead}):
        assert timg.build_backend(conf).health_check() is \
            jimg.build_backend(conf).health_check() is False
    stub.fail = True
    for mod in (jimg, timg):
        with pytest.raises(Exception) as exc:
            mod.build_backend({"backend": "openai",
                               "base_url": stub.url}).generate(
                mod.GenerateRequest(prompt="x"))
        assert "500" in str(exc.value)


@pytest.mark.parametrize("resp", [
    dict(image_url="http://img/1.png", revised_prompt="r", model="m",
         backend="openai"),
    dict(image_base64=B64, backend="vllm_omni"), dict()])
def test_image_chat_completion_matches_jax(resp):
    got = timg.image_chat_completion(timg.GenerateResponse(**resp), "p")
    want = jimg.image_chat_completion(jimg.GenerateResponse(**resp), "p")
    for d in (got, want):
        assert d.pop("id").startswith("chatcmpl-")
        assert d.pop("created") > 0
    assert got == want


def _imagegen_cfg(conf):
    return {
        "default_model": "text-model",
        "routing": {
            "modelCards": [{"name": "text-model"},
                           {"name": "image-model"}],
            "signals": {"keywords": [{"name": "draw", "operator": "OR",
                                      "keywords": ["draw", "paint"]}]},
            "decisions": [{
                "name": "paint", "priority": 10,
                "rules": {"operator": "OR", "conditions": [
                    {"type": "keyword", "name": "draw"}]},
                "modelRefs": [{"model": "image-model"}],
                "plugins": [{"type": "image_generation",
                             "configuration": conf}]}]}}


def _post(url, path, body):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, raw
    finally:
        conn.close()


# headers that carry a per-request id or the time
_VARYING = {"date", "server", "x-vsr-request-id", "x-vsr-decision-record"}


def _stable(headers):
    return {k: v for k, v in headers.items() if k not in _VARYING}


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def _parsed(raw, headers):
    if headers.get("content-type") == "text/event-stream":
        frames = [f[len("data: "):] for f in raw.decode().split("\n\n")
                  if f]
        return [f if f == "[DONE]" else _strip_times(json.loads(f))
                for f in frames]
    return _strip_times(json.loads(raw))


def _serve_pair(cfg, backend_url):
    jcfg = JRouterConfig.from_dict(copy.deepcopy(cfg))
    jrouter = JRouter(jcfg)
    jserver = JServer(jrouter, jcfg, default_backend=backend_url).start()
    trouter = Router(load_config(copy.deepcopy(cfg)))
    tserver = RouterServer(trouter, backend_url).start()
    return (jserver, jrouter), (tserver, trouter)


@pytest.mark.parametrize("backend", ["openai", "vllm_omni"])
@pytest.mark.parametrize("form", ["plain", "stream", "anthropic"])
def test_image_generation_decision_matches_jax(stub, backend, form,
                                              monkeypatch):
    """The decision's image backend answers; the client gets a chat
    completion (or one SSE chunk and [DONE], or a Messages answer) with
    ``x-vsr-image-backend``, as from the JAX server; the text backend is
    never called, and the feedback and the session turn are recorded."""
    conf = {"backend": backend, "base_url": stub.url, "model": "img-1",
            "width": 512, "height": 512}
    mock = MockVLLMServer().start()
    (js, jr), (ts, tr) = _serve_pair(_imagegen_cfg(conf), mock.url)
    feedback = []
    orig = tr.record_feedback
    monkeypatch.setattr(tr, "record_feedback", lambda route, success=True,
                        **kw: feedback.append(success)
                        or orig(route, success=success, **kw))
    body = {"model": "auto", "messages": [
        {"role": "user", "content": "draw a fox in the snow"}]}
    path = "/v1/chat/completions"
    if form == "stream":
        body["stream"] = True
    if form == "anthropic":
        body = {"model": "auto", "max_tokens": 64, "messages": [
            {"role": "user", "content": "draw a fox in the snow"}]}
        path = "/v1/messages"
    try:
        answers = []
        for server in (js, ts):
            stub.requests.clear()
            status, headers, raw = _post(server.url, path, body)
            answers.append((status, _stable(headers),
                            _parsed(raw, headers), list(stub.requests)))
        assert answers[1] == answers[0]
        status, headers, payload, reqs = answers[1]
        assert status == 200
        assert headers["x-vsr-image-backend"] == backend
        assert headers["x-vsr-selected-decision"] == "paint"
        assert len(reqs) == 1 and "draw a fox" in json.dumps(reqs[0][1])
        assert mock.hits == 0
        if form == "stream":
            assert payload[-1] == "[DONE]" and len(payload) == 2
        assert feedback == [True]
    finally:
        for server, router in ((js, jr), (ts, tr)):
            server.stop()
            router.shutdown()
        mock.stop()


@pytest.mark.parametrize("case", ["unknown_backend", "backend_fails"])
def test_image_generation_failures_match_jax(case, monkeypatch):
    """A backend that cannot be built or fails answers 502
    ``imagegen_error`` on both servers; a failed call is fed back as a
    failure."""
    failing = ImageStub(fail=True)
    conf = {"backend": "mock"} if case == "unknown_backend" \
        else {"backend": "openai", "base_url": failing.url}
    mock = MockVLLMServer().start()
    (js, jr), (ts, tr) = _serve_pair(_imagegen_cfg(conf), mock.url)
    feedback = []
    orig = tr.record_feedback

    def spy(route, success=True, **kw):
        feedback.append(success)
        return orig(route, success=success, **kw)

    monkeypatch.setattr(tr, "record_feedback", spy)
    body = {"model": "auto", "messages": [
        {"role": "user", "content": "paint me a lake"}]}
    try:
        answers = []
        for server in (js, ts):
            status, headers, raw = _post(server.url,
                                         "/v1/chat/completions", body)
            answers.append((status, _stable(headers), json.loads(raw)))
        assert answers[1] == answers[0]
        assert answers[1][0] == 502
        assert answers[1][2]["error"]["type"] == "imagegen_error"
        assert feedback == ([] if case == "unknown_backend" else [False])
        assert mock.hits == 0
    finally:
        for server, router in ((js, jr), (ts, tr)):
            server.stop()
            router.shutdown()
        mock.stop()
        failing.stop()


def test_imagegen_backend_is_kept_per_decision_and_configuration(stub):
    mock = MockVLLMServer().start()
    conf = {"backend": "openai", "base_url": stub.url}
    (js, jr), (ts, tr) = _serve_pair(_imagegen_cfg(conf), mock.url)
    try:
        a = ts._imagegen_backend("paint", conf)
        assert ts._imagegen_backend("paint", dict(conf)) is a
        assert ts._imagegen_backend("other", conf) is not a
        assert ts._imagegen_backend("paint", dict(conf, model="x")) is not a
    finally:
        for server, router in ((js, jr), (ts, tr)):
            server.stop()
            router.shutdown()
        mock.stop()


def test_a_disabled_plugin_goes_to_the_text_backend(stub):
    mock = MockVLLMServer().start()
    conf = {"backend": "openai", "base_url": stub.url, "enabled": False}
    (js, jr), (ts, tr) = _serve_pair(_imagegen_cfg(conf), mock.url)
    try:
        status, headers, _ = _post(ts.url, "/v1/chat/completions", {
            "model": "auto", "messages": [{"role": "user",
                                           "content": "draw a cat"}]})
        assert status == 200 and "x-vsr-image-backend" not in headers
        assert mock.hits == 1 and not stub.requests
    finally:
        for server, router in ((js, jr), (ts, tr)):
            server.stop()
            router.shutdown()
        mock.stop()
