"""The port's 2D-Matryoshka embedding path against the JAX package on the
CPU: ``MmBertEmbeddingModel`` and ``ModernBertModel(exit_layer=...)`` on
the same Flax weights (carried over with ``params_from_flax``) and the
same numpy inputs, ``truncate_normalize`` / ``matryoshka_views``, and the
engine's ``embed`` against the JAX engine's; tolerance 1e-4 in float32."""

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.models import embeddings as jemb
from semantic_router_tpu.models import modernbert as jmb
from semantic_router_tpu.ops import matryoshka as jmat
from semantic_router_tpu_torch.config import InferenceEngineConfig, \
    load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import (
    MmBertEmbeddingModel,
    ModernBertConfig,
    ModernBertModel,
    params_from_flax,
)
from semantic_router_tpu_torch.ops import matryoshka_views, \
    truncate_normalize
from semantic_router_tpu_torch.runtime import build_engine

TINY = ttesting.TINY
TEXTS = [
    "how to configure the system",
    "keep it concise",
    "solve this step by step",
    "hello",
    " ".join(f"w{i}" for i in range(40)),   # the 128 bucket
    "how to configure the system",
]


def _inputs(B=3, S=20, lengths=(20, 13, 5), seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], size=(B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    return np.where(mask == 1, ids, 0), mask


def _emb_pair(pooling="mean", bottleneck=(), seed=0):
    """(flax module, flax params, torch module) on the same weights."""
    jm = jemb.MmBertEmbeddingModel(
        jmb.ModernBertConfig(**TINY, num_labels=0), pooling=pooling,
        bottleneck_dims=bottleneck)
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))
    tm = MmBertEmbeddingModel(ModernBertConfig(**TINY, num_labels=0),
                              pooling=pooling, bottleneck_dims=bottleneck)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm.eval()


class TestEmbeddingModelParity:
    @pytest.mark.parametrize("pooling,bottleneck",
                             [("mean", ()), ("cls", ()), ("mean", (24,))],
                             ids=["mean", "cls", "mean_bottleneck24"])
    @pytest.mark.parametrize("exit_layer", [None, 1, 2])
    @pytest.mark.parametrize("output_dim", [None, 16])
    def test_matches_flax(self, pooling, bottleneck, exit_layer, output_dim):
        jm, params, tm = _emb_pair(pooling, bottleneck)
        ids, mask = _inputs()
        ref = np.asarray(jm.apply(params, jnp.asarray(ids),
                                  jnp.asarray(mask), exit_layer=exit_layer,
                                  output_dim=output_dim))
        with torch.no_grad():
            got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                     exit_layer=exit_layer, output_dim=output_dim).numpy()
        width = output_dim or (bottleneck[-1] if bottleneck
                               else TINY["hidden_size"])
        assert got.shape == ref.shape == (3, width)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)

    def test_flax_tree_carries_bottleneck(self):
        _, params, tm = _emb_pair("mean", (24, 8))
        sd = params_from_flax(params)
        assert sd["dense_0.weight"].shape == (24, TINY["hidden_size"])
        assert sd["dense_1.weight"].shape == (8, 24)
        assert set(sd) == set(tm.state_dict())

    def test_refuses_unknown_pooling(self):
        with pytest.raises(ValueError, match="pooling"):
            MmBertEmbeddingModel(ModernBertConfig(**TINY), pooling="max")


class TestTrunkEarlyExit:
    @pytest.mark.parametrize("exit_layer", [None, 0, 1, 2, 5, -1])
    def test_matches_flax(self, exit_layer):
        jcfg = jmb.ModernBertConfig(**TINY, num_labels=0)
        jm = jmb.ModernBertModel(jcfg)
        params = jm.init(jax.random.PRNGKey(4), jnp.ones((1, 8), jnp.int32))
        tm = ModernBertModel(ModernBertConfig(**TINY, num_labels=0))
        tm.load_state_dict(params_from_flax(params))
        ids, mask = _inputs()
        ref = np.asarray(jm.apply(params, jnp.asarray(ids),
                                  jnp.asarray(mask), exit_layer=exit_layer))
        with torch.no_grad():
            got = tm.eval()(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask),
                            exit_layer=exit_layer).numpy()
        real = mask.astype(bool)
        np.testing.assert_allclose(got[real], ref[real], atol=1e-4, rtol=0)
        want = {None: 2, 0: 0, 1: 1, 2: 2, 5: 2, -1: 0}[exit_layer]
        assert tm.layers_run(exit_layer) == want

    def test_exit_skips_the_top_layers(self):
        """Layers at or past the exit never run; the final norm applies to
        the last layer that did."""
        tm = ModernBertModel(ModernBertConfig(**TINY)).eval()
        ttesting.init_weights(tm, 3)
        ran = []
        for i, layer in enumerate(tm.layers):
            layer.register_forward_hook(
                lambda *_a, i=i: ran.append(i))
        ids, mask = _inputs()
        with torch.no_grad():
            out = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                     exit_layer=1)
            x = tm.layers[0](tm.embeddings(torch.from_numpy(ids).long()),
                             torch.from_numpy(mask))
        assert ran == [0, 0]
        torch.testing.assert_close(out, tm.final_norm(x), atol=0, rtol=0)


class TestMatryoshkaOps:
    @pytest.mark.parametrize("dim", [None, 4, 16, 64])
    def test_truncate_normalize_matches_jax(self, dim):
        x = np.random.default_rng(2).standard_normal((3, 16)).astype(
            np.float32)
        x[1] = 0.0  # the 1e-9 floor keeps a zero row zero
        got = truncate_normalize(torch.from_numpy(x), dim)
        ref = np.asarray(jmat.truncate_normalize(jnp.asarray(x), dim))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
        assert not got[1].any()

    def test_bf16_input_comes_back_float32(self):
        x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
        got = truncate_normalize(x.to(torch.bfloat16), 4)
        assert got.dtype == torch.float32 and got.shape == (2, 4)

    def test_views_match_jax(self):
        x = np.random.default_rng(3).standard_normal((4, 32)).astype(
            np.float32)
        x[2] = 0.0
        got = matryoshka_views(x, [8, 16, 32])
        ref = jmat.matryoshka_views(x, [8, 16, 32])
        assert sorted(got) == sorted(ref) == [8, 16, 32]
        for d in got:
            np.testing.assert_allclose(got[d], ref[d], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the engine's embed path


MATRYOSHKA = dict(matryoshka_layers=[1], matryoshka_dims=[8, 16])


def _engine_cfg(**kw):
    return InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                 seq_len_buckets=[32, 128, 512], **kw)


@pytest.fixture(scope="module")
def embed_pair():
    """(JAX engine, port engine): the default trio plus the embedding task,
    on the same weights."""
    jeng = jtesting.make_embedding_engine(seed=0)
    teng = ttesting.make_embedding_engine(
        engine_cfg=_engine_cfg(**MATRYOSHKA), device="cpu",
        flax_params={n: t.params for n, t in jeng._tasks.items()})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


VARIANTS = [(None, None), (1, None), (None, 8), (1, 16), (2, 16)]


class TestEngineEmbed:
    @pytest.mark.parametrize("exit_layer,output_dim", VARIANTS)
    def test_matches_jax_engine(self, embed_pair, exit_layer, output_dim):
        jeng, teng = embed_pair
        got = teng.embed("embedding", TEXTS, exit_layer, output_dim)
        ref = jeng.embed("embedding", TEXTS, exit_layer, output_dim)
        assert got.dtype == np.float32
        assert got.shape == ref.shape == (len(TEXTS),
                                          output_dim or TINY["hidden_size"])
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got[0], got[5])  # same text, same row

    def test_empty(self, embed_pair):
        _, teng = embed_pair
        assert teng.embed("embedding", []).shape == (0, 0)

    def test_variants_never_share_a_forward(self, embed_pair):
        _, teng = embed_pair
        want = {v: teng.embed("embedding", TEXTS[:4], *v) for v in VARIANTS}
        steps0 = len(teng.steps())
        jobs = [(v, text) for v in VARIANTS for text in TEXTS[:4]] * 2
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = list(pool.map(
                lambda j: (j, teng.embed_async("embedding", [j[1]], *j[0])[0]),
                jobs))
            got = [(j, f.result(timeout=60)) for j, f in futs]
        for (v, text), row in got:
            np.testing.assert_allclose(row, want[v][TEXTS.index(text)],
                                       atol=1e-6, rtol=0)
        steps = [s for s in teng.steps()[steps0:]
                 if s["group"] == "task:embedding"]
        assert steps and sum(s["rows"] for s in steps) == len(jobs)
        for s in steps:
            assert s["flavor"] == "embed"
            assert s["layers"] == (2 if s["exit_layer"] is None
                                   else s["exit_layer"])
            assert s["padded_rows"] >= s["rows"]
            assert s["padded_rows"] & (s["padded_rows"] - 1) == 0

    def test_warmup_runs_every_variant(self, embed_pair):
        _, teng = embed_pair
        module = teng._tasks["embedding"].module
        seen = []
        lock = threading.Lock()

        def hook(_m, args, kwargs):
            with lock:
                seen.append((args[0].shape[1], kwargs.get("exit_layer"),
                             kwargs.get("output_dim")))

        handle = module.register_forward_pre_hook(hook, with_kwargs=True)
        try:
            teng.warmup(buckets=[32, 128])
        finally:
            handle.remove()
        variants = teng._matryoshka_variants()
        assert variants == [(None, None), (1, None), (None, 8), (None, 16),
                            (1, 8), (1, 16)]
        assert sorted(seen, key=repr) == sorted(
            [(b, el, od) for b in (32, 128) for el, od in variants], key=repr)

    def test_refusals(self, embed_pair):
        _, teng = embed_pair
        with pytest.raises(TypeError, match="embed"):
            teng.classify("embedding", "x")
        with pytest.raises(TypeError, match="classify"):
            teng.embed("intent", ["x"])
        with pytest.raises(KeyError):
            teng.embed("ghost", ["x"])
        assert teng.task_kind("embedding") == "embedding"
        assert not teng.fused_covers(["embedding"])
        with pytest.raises(ValueError, match="MmBertEmbeddingModel"):
            teng.register_task("e2", "embedding",
                               teng._tasks["intent"].module,
                               teng._tasks["intent"].tokenizer, [])


def test_embedding_task_never_joins_a_trunk_group():
    eng = ttesting.make_test_engine(
        tasks=[("intent", "sequence", ["a", "b"]),
               ("embedding", "embedding", [])], device="cpu")
    try:
        assert list(eng.trunk_group_info().values()) == [["intent"]]
        # re-registering a fused member as an embedding task evicts it
        eng.register_task("intent", "embedding",
                          eng._tasks["embedding"].module,
                          eng._tasks["embedding"].tokenizer, [])
        assert eng.trunk_group_info() == {}
        assert eng.embed("intent", ["x y"]).shape == (1, TINY["hidden_size"])
    finally:
        eng.shutdown()


def test_schema_reads_matryoshka_knobs():
    cfg = load_config({"engine": {"matryoshka_layers": [6, 11],
                                  "matryoshka_dims": [64, 128]}})
    assert cfg.engine.matryoshka_layers == [6, 11]
    assert cfg.engine.matryoshka_dims == [64, 128]


def test_build_engine_loads_an_embedding_checkpoint(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tokenizers = pytest.importorskip("tokenizers")
    module = MmBertEmbeddingModel(ModernBertConfig(**TINY))
    ttesting.init_weights(module, 5, std=0.2)
    root = str(tmp_path / "emb")
    os.makedirs(root)
    st.save_file({k: v.contiguous() for k, v in module.state_dict().items()},
                 os.path.join(root, "model.safetensors"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(dict(TINY, model_type="modernbert"), f)
    vocab = {"[PAD]": 0, "[UNK]": 1}
    vocab.update({f"w{i}": i + 2 for i in range(100)})
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(os.path.join(root, "tokenizer.json"))
    cfg = load_config({
        "engine": {"seq_len_buckets": [16, 64], "max_batch_size": 4},
        "classifier_models": {"embedding": {"checkpoint": root,
                                            "kind": "embedding"}}})
    eng = build_engine(cfg, device="cpu")
    try:
        assert eng.task_kind("embedding") == "embedding"
        got = eng.embed("embedding", ["w1 w2 w3 w77"], exit_layer=1,
                        output_dim=16)
        ids = torch.tensor([eng._tasks["embedding"].tokenizer.encode(
            "w1 w2 w3 w77").ids])
        with torch.no_grad():
            want = module.eval()(ids, exit_layer=1, output_dim=16).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("layout", ["masked_lm", "masked_lm_bottleneck"])
def test_build_engine_reads_an_hf_masked_lm_checkpoint(tmp_path, layout):
    """A checkpoint in the HF masked-LM layout (``model.*`` plus the MLM
    head and decoder, and here a bottleneck ``dense_0``) loads its trunk
    through both packages' ``build_engine``, whose embeddings agree;
    the tensors the reference's converter ignores are dropped, and the
    config's other tasks still load."""
    st = pytest.importorskip("safetensors.torch")
    tokenizers = pytest.importorskip("tokenizers")
    from semantic_router_tpu.config import RouterConfig as JRouterConfig
    from semantic_router_tpu.runtime.bootstrap import \
        build_engine as jbuild_engine

    fields = {k: TINY[k] for k in ("vocab_size", "hidden_size",
                                   "intermediate_size", "num_hidden_layers",
                                   "num_attention_heads",
                                   "max_position_embeddings")}
    module = MmBertEmbeddingModel(ModernBertConfig(**fields))
    ttesting.init_weights(module, 6, std=0.2)
    rng = np.random.default_rng(6)
    H, V = fields["hidden_size"], fields["vocab_size"]
    state = {k: v.contiguous() for k, v in module.state_dict().items()}
    state["head.dense.weight"] = torch.from_numpy(
        rng.standard_normal((H, H), np.float32))
    state["head.norm.weight"] = torch.ones(H)
    state["decoder.weight"] = torch.from_numpy(
        rng.standard_normal((V, H), np.float32))
    state["decoder.bias"] = torch.zeros(V)
    if layout == "masked_lm_bottleneck":
        state["dense_0.weight"] = torch.from_numpy(
            rng.standard_normal((8, H), np.float32))
    root = str(tmp_path / "mlm")
    os.makedirs(root)
    st.save_file(state, os.path.join(root, "model.safetensors"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(dict(fields, model_type="modernbert",
                       architectures=["ModernBertForMaskedLM"]), f)
    vocab = {"[PAD]": 0, "[UNK]": 1}
    vocab.update({f"w{i}": i + 2 for i in range(100)})
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(os.path.join(root, "tokenizer.json"))
    cls_root = str(tmp_path / "cls")
    from test_torch_router import _write_checkpoint

    _write_checkpoint(cls_root, ["a", "b"])
    d = {"engine": {"seq_len_buckets": [16, 64], "max_batch_size": 4},
         "classifier_models": {
             "embedding": {"checkpoint": root, "kind": "embedding"},
             "intent": {"checkpoint": cls_root, "kind": "sequence"}}}
    texts = ["w1 w2 w3 w77", "w5", " ".join(f"w{i}" for i in range(30))]
    jeng = jbuild_engine(JRouterConfig.from_dict(d))
    eng = build_engine(load_config(d), device="cpu")
    try:
        assert sorted(eng.tasks()) == ["embedding", "intent"]
        got = eng.embed("embedding", texts)
        want = jeng.embed("embedding", texts)
        assert got.shape == want.shape == (len(texts), H)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        ids = torch.tensor([eng._tasks["embedding"].tokenizer.encode(
            texts[0]).ids])
        with torch.no_grad():
            np.testing.assert_allclose(
                got[0], module.eval()(ids)[0].numpy(), atol=1e-5, rtol=0)
    finally:
        eng.shutdown()
        jeng.shutdown()
