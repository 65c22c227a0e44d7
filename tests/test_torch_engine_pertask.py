"""The port's per-task path, content-addressed trunk groups, stride
windows and ``fuse_trunks`` against the JAX engine on the same weights, on
the CPU: the same labels, probabilities within 1e-4 (float32), the same
token spans, the same windows."""

import json
import os

import numpy as np
import pytest
import torch

from semantic_router_tpu.config.schema import \
    InferenceEngineConfig as JEngineConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.utils import tokenization as jtok
from semantic_router_tpu_torch.config import InferenceEngineConfig, \
    load_config
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.engine.classify import _leaf_digest
from semantic_router_tpu_torch.models import (
    ModernBertConfig,
    ModernBertForSequenceClassification,
)
from semantic_router_tpu_torch.runtime import build_engine
from semantic_router_tpu_torch.runtime.bootstrap import serve
from semantic_router_tpu_torch.utils import tokenization as ttok

PII = ("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS", "B-PERSON",
               "I-PERSON"])
LORA = ("fact_check",)
SEQ_TASKS = [name for name, _ in jtesting.SHARED_TRUNK_TASKS]
TEXTS = [
    "how do I file quarterly taxes for a small business",
    "is this medication safe with alcohol",
    "write a python function that sorts a list",
    "hello",
    "contact jane at jane@example.com or call tomorrow",
    "how do I file quarterly taxes for a small business",
]
LONG = " ".join(f"w{i % 97} x{i}" for i in range(800))  # 1600 tokens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the suite runs in several worker processes on few cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_params(engine):
    return {name: t.params for name, t in engine._tasks.items()}


def _pair(fuse):
    jeng = jtesting.make_shared_trunk_engine(
        token_tasks=[PII], lora_tasks=LORA, seed=5, fuse=fuse)
    teng = ttesting.make_shared_trunk_engine(
        token_tasks=[PII], lora_tasks=LORA, device="cpu",
        flax_params=_flax_params(jeng), fuse=fuse)
    return jeng, teng


@pytest.fixture(scope="module")
def unfused_pair():
    """(JAX, port) engines over one trunk, every task per task."""
    jeng, teng = _pair(False)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


@pytest.fixture(scope="module")
def fused_pair():
    jeng, teng = _pair(None)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _assert_same_class(a, b, tol=1e-4):
    assert a.label == b.label and a.index == b.index
    assert a.truncated == b.truncated
    assert set(a.probs) == set(b.probs)
    for k in a.probs:
        assert abs(a.probs[k] - b.probs[k]) <= tol, (k, a.probs, b.probs)


def _spans(res):
    return [(e.type, e.start, e.end, e.text) for e in res.entities]


# -- the per-task path ----------------------------------------------------------


class TestPerTaskParity:
    def test_no_trunk_group(self, unfused_pair):
        jeng, teng = unfused_pair
        assert teng.trunk_group_info() == jeng.trunk_group_info() == {}
        for task in SEQ_TASKS + [PII[0]]:
            assert teng.task_info(task) == jeng.task_info(task)
            assert teng.task_labels(task) == jeng.task_labels(task)
        assert not teng.fused_covers(SEQ_TASKS)

    @pytest.mark.parametrize("task", SEQ_TASKS)
    def test_classify(self, unfused_pair, task):
        jeng, teng = unfused_pair
        for text in TEXTS:
            _assert_same_class(teng.classify(task, text),
                               jeng.classify(task, text))

    def test_token_spans(self, unfused_pair):
        jeng, teng = unfused_pair
        for text in TEXTS:
            got = teng.token_classify("pii", text, threshold=0.0)
            want = jeng.token_classify("pii", text, threshold=0.0)
            assert _spans(got) == _spans(want)
            for a, b in zip(got.entities, want.entities):
                assert abs(a.score - b.score) <= 1e-4

    def test_truncation_is_flagged(self, unfused_pair):
        jeng, teng = unfused_pair
        a, b = teng.classify("intent", LONG), jeng.classify("intent", LONG)
        assert a.truncated and b.truncated
        _assert_same_class(a, b)
        tok = teng.token_classify("pii", LONG)
        assert tok.truncated == jeng.token_classify("pii", LONG).truncated

    def test_classify_multi_and_batch(self, unfused_pair):
        jeng, teng = unfused_pair
        got = teng.classify_multi(SEQ_TASKS, TEXTS)
        want = jeng.classify_multi(SEQ_TASKS, TEXTS)
        for task in SEQ_TASKS:
            for a, b in zip(got[task], want[task]):
                _assert_same_class(a, b)
        steps = teng.steps()[-3:]
        assert {s["group"] for s in steps} == \
            {f"task:{t}" for t in SEQ_TASKS}
        assert all(s["flavor"] == "split" and s["graph"] == "eager"
                   and s["layers"] == ttesting.TINY["num_hidden_layers"]
                   for s in steps)
        census = teng.shape_census()
        assert all(f"task:{t}" in census for t in SEQ_TASKS)

    def test_unfused_equals_fused(self, unfused_pair, fused_pair):
        _, unfused = unfused_pair
        _, fused = fused_pair
        for task in SEQ_TASKS:
            for text in TEXTS:
                _assert_same_class(unfused.classify(task, text),
                                   fused.classify(task, text))
        assert _spans(unfused.token_classify("pii", TEXTS[4], 0.0)) == \
            _spans(fused.token_classify("pii", TEXTS[4], 0.0))

    def test_warmup_runs_every_per_task_task(self, unfused_pair):
        _, teng = unfused_pair
        def census():
            return set().union(*(c.keys() for c in teng._live_caches()))

        before = census()
        teng.warmup(buckets=[32])
        new = census() - before
        for t in SEQ_TASKS + ["pii"]:
            assert not teng._step_fresh(f"task:{t}", "split", (32, 1))
        assert all(k[2:] == (32, 1) for k in new)


class _MeanHead(torch.nn.Module):
    """A classifier the head bank cannot stack: embedding, masked mean,
    dense — the reference test's tiny Flax ``Head``."""

    def __init__(self, vocab=1024, width=16, n=3):
        super().__init__()
        self.embed = torch.nn.Embedding(vocab, width)
        self.dense = torch.nn.Linear(width, n)

    def forward(self, ids, mask):
        m = mask.to(torch.float32)[..., None]
        pooled = (self.embed(ids) * m).sum(1) / m.sum(1).clamp_min(1.0)
        return self.dense(pooled)


def _mean_head_pair(max_seq_len=32):
    """The JAX engine with the reference's tiny Flax head, and the port's
    with ``_MeanHead`` on the same weights."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from semantic_router_tpu.engine.classify import \
        InferenceEngine as JEngine

    class Head(fnn.Module):
        n: int = 3

        @fnn.compact
        def __call__(self, ids, mask):
            emb = fnn.Embed(1024, 16)(ids)
            pooled = (emb * mask[..., None]).sum(1) / \
                jnp.maximum(mask.sum(1, keepdims=True), 1)
            return fnn.Dense(self.n)(pooled)

    jeng = JEngine(JEngineConfig(seq_len_buckets=[16, 32], max_batch_size=8,
                                 max_wait_ms=1))
    mod = Head()
    params = mod.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                      jnp.ones((1, 8), jnp.int32))
    jeng.register_task("intent", "sequence", mod, params,
                       jtok.HashTokenizer(), ["a", "b", "c"],
                       max_seq_len=max_seq_len)
    teng = InferenceEngine(InferenceEngineConfig(
        seq_len_buckets=[16, 32], max_batch_size=8, max_wait_ms=1),
        device="cpu")
    head = _MeanHead()
    p = params["params"]
    with torch.no_grad():
        head.embed.weight.copy_(torch.from_numpy(
            np.array(p["Embed_0"]["embedding"])))
        head.dense.weight.copy_(torch.from_numpy(
            np.array(p["Dense_0"]["kernel"]).T))
        head.dense.bias.copy_(torch.from_numpy(
            np.array(p["Dense_0"]["bias"])))
    teng.register_task("intent", "sequence", head, ttok.HashTokenizer(),
                       ["a", "b", "c"], max_seq_len=max_seq_len)
    return jeng, teng


class TestRegistration:
    def test_a_module_the_bank_cannot_stack_serves_per_task(self):
        jeng, teng = _mean_head_pair()
        try:
            assert teng.trunk_group_info() == {}
            for text in TEXTS:
                _assert_same_class(teng.classify("intent", text),
                                   jeng.classify("intent", text))
            text = " ".join(f"word{i}" for i in range(200))
            _assert_same_class(teng.classify_windowed("intent", text, 8),
                               jeng.classify_windowed("intent", text, 8))
        finally:
            jeng.shutdown()
            teng.shutdown()

    def test_re_registration_as_unfused_leaves_the_group(self, fused_pair):
        jeng, _ = fused_pair
        teng = ttesting.make_shared_trunk_engine(
            token_tasks=[PII], lora_tasks=LORA, device="cpu",
            flax_params=_flax_params(jeng))
        try:
            t = teng._tasks["user_feedback"]
            teng.register_task("user_feedback", "sequence", t.module,
                               t.tokenizer, t.labels, max_seq_len=512,
                               fuse=False)
            (members,) = teng.trunk_group_info().values()
            assert "user_feedback" not in members and len(members) == 3
            assert "trunk_group" not in teng.task_info("user_feedback")
            for task in SEQ_TASKS:
                for text in TEXTS[:3]:
                    _assert_same_class(teng.classify(task, text),
                                       jeng.classify(task, text))
            teng.classify("intent", TEXTS[0])
            assert teng.steps()[-1]["group"] == "trunk0"
            teng.classify("user_feedback", TEXTS[0])
            assert teng.steps()[-1]["group"] == "task:user_feedback"
        finally:
            teng.shutdown()

    def test_fuse_trunks_false_in_the_engine_config(self, fused_pair):
        jeng, _ = fused_pair
        cfg = InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                    seq_len_buckets=[32, 128, 512],
                                    fuse_trunks=False)
        teng = ttesting.make_shared_trunk_engine(
            token_tasks=[PII], lora_tasks=LORA, device="cpu",
            engine_cfg=cfg, flax_params=_flax_params(jeng))
        try:
            assert teng.trunk_group_info() == {}
            # an explicit fuse=True wins over the config default
            t = teng._tasks["intent"]
            teng.register_task("intent", "sequence", t.module, t.tokenizer,
                               t.labels, max_seq_len=512, fuse=True)
            assert list(teng.trunk_group_info().values()) == [["intent"]]
            _assert_same_class(teng.classify("intent", TEXTS[0]),
                               jeng.classify("intent", TEXTS[0]))
        finally:
            teng.shutdown()


# -- stride windows -----------------------------------------------------------


class TestClassifyWindowed:
    @pytest.mark.parametrize("fuse", [None, False])
    @pytest.mark.parametrize("stride", [0, 16, 64, 200])
    def test_long_text_matches_jax(self, fused_pair, unfused_pair, fuse,
                                   stride):
        jeng, teng = fused_pair if fuse is None else unfused_pair
        got = teng.classify_windowed("intent", LONG, stride=stride)
        want = jeng.classify_windowed("intent", LONG, stride=stride)
        assert got.truncated is False and want.truncated is False
        _assert_same_class(got, want)
        assert abs(sum(got.probs.values()) - 1.0) < 1e-5
        # the plain path on the same text: flagged tail-drop
        assert teng.classify("intent", LONG).truncated is True

    def test_windows_bypass_the_fused_group(self, fused_pair):
        _, teng = fused_pair
        n = len(teng.steps())
        teng.classify_windowed("intent", LONG, stride=64)
        steps = teng.steps()[n:]
        assert steps and all(s["group"] == "task:intent" for s in steps)

    def test_short_text_is_classify(self, fused_pair):
        jeng, teng = fused_pair
        plain = teng.classify("intent", "short request")
        windowed = teng.classify_windowed("intent", "short request")
        assert windowed.probs == plain.probs
        _assert_same_class(windowed,
                           jeng.classify_windowed("intent", "short request"))

    def test_windows_serve_float32_under_quant(self, fused_pair):
        jeng, _ = fused_pair
        teng = ttesting.make_shared_trunk_engine(
            token_tasks=[PII], lora_tasks=LORA, device="cpu",
            flax_params=_flax_params(jeng))
        try:
            teng.configure_quant({"mode": "bf16"})
            quantized = teng.classify("intent", TEXTS[0])
            assert teng.steps()[-1]["quant"] == "bf16"
            assert quantized.probs != jeng.classify("intent", TEXTS[0]).probs
            _assert_same_class(
                teng.classify_windowed("intent", LONG, stride=64),
                jeng.classify_windowed("intent", LONG, stride=64))
        finally:
            teng.shutdown()

    def test_window_consensus_on_uniform_text(self, fused_pair):
        _, teng = fused_pair
        text = " ".join("alpha" for _ in range(1200))
        out = teng.classify_windowed("intent", text, stride=4)
        single = teng.classify("intent", "alpha " * 300)
        assert out.label == single.label


@pytest.mark.parametrize("n_words", [0, 5, 30, 31, 32, 100, 257])
@pytest.mark.parametrize("max_length,stride", [(32, 0), (32, 8), (16, 13),
                                               (64, 20)])
def test_encode_windows_matches_jax(n_words, max_length, stride):
    text = " ".join(f"tok{i}" for i in range(n_words))
    got = ttok.encode_windows(ttok.HashTokenizer(), text, max_length, stride)
    want = jtok.encode_windows(jtok.HashTokenizer(), text, max_length,
                               stride)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.ids, a.attention_mask, a.offsets, a.truncated,
                a.total_tokens) == (b.ids, b.attention_mask, b.offsets,
                                    b.truncated, b.total_tokens)
        assert len(a) <= max_length


@pytest.mark.parametrize("stride", [-1, 30, 31])
def test_encode_windows_refuses_a_stride_past_the_window(stride):
    text = " ".join(f"tok{i}" for i in range(100))
    with pytest.raises(ValueError, match="stride"):
        ttok.encode_windows(ttok.HashTokenizer(), text, 32, stride)
    with pytest.raises(ValueError, match="stride"):
        jtok.encode_windows(jtok.HashTokenizer(), text, 32, stride)


# -- content-addressed trunk groups --------------------------------------------


class TestContentAddressedFingerprint:
    """Two loads of one frozen trunk fuse; a one-weight difference splits
    them; equivalent tokenizer objects do not split a group."""

    def _two_task_engine(self, copy_trunk: bool, perturb: bool = False):
        eng = InferenceEngine(InferenceEngineConfig(
            max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=[32, 128]),
            device="cpu")
        tok = ttok.HashTokenizer(vocab_size=ttesting.TINY["vocab_size"])
        trunk = None
        for i, (name, labels) in enumerate(
                [("task_a", ["x", "y"]), ("task_b", ["p", "q", "r"])]):
            module = ModernBertForSequenceClassification(
                ttesting.tiny_config(len(labels)))
            ttesting.init_weights(module, 7 + i)
            if trunk is None:
                trunk = module.model
            elif copy_trunk:
                # distinct tensors with identical bytes: the two
                # checkpoint files, one frozen trunk shape
                module.model.load_state_dict(trunk.state_dict())
                if perturb:
                    with torch.no_grad():
                        module.model.embeddings.tok_embeddings.weight[
                            0, 0] += 1e-3
            assert module.model is not trunk or i == 0
            eng.register_task(name, "sequence", module, tok, labels,
                              max_seq_len=128)
        return eng, trunk

    def test_identical_content_distinct_tensors_fuse(self):
        eng, trunk = self._two_task_engine(copy_trunk=True)
        try:
            (members,) = eng.trunk_group_info().values()
            assert sorted(members) == ["task_a", "task_b"]
            # the second module serves through the group's one trunk
            assert eng._tasks["task_b"].module.model is trunk
            res = eng.classify("task_b", "hello fused world")
            assert res.label in ("p", "q", "r")
        finally:
            eng.shutdown()

    def test_single_weight_difference_splits_groups(self):
        eng, _ = self._two_task_engine(copy_trunk=True, perturb=True)
        try:
            assert len(eng.trunk_group_info()) == 2
        finally:
            eng.shutdown()

    def test_equivalent_tokenizer_instances_do_not_split(self):
        eng = InferenceEngine(InferenceEngineConfig(
            max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=[32, 128]),
            device="cpu")
        trunk = None
        try:
            for i, name in enumerate(["t1", "t2"]):
                module = ModernBertForSequenceClassification(
                    ttesting.tiny_config(2), model=trunk)
                ttesting.init_weights(module, 9 + i,
                                      skip="model." if trunk else "")
                trunk = module.model
                # a fresh HashTokenizer per task: same vocab, same content
                eng.register_task(name, "sequence", module,
                                  ttok.HashTokenizer(
                                      vocab_size=ttesting.TINY["vocab_size"]),
                                  ["a", "b"], max_seq_len=128)
            assert len(eng.trunk_group_info()) == 1
        finally:
            eng.shutdown()

    def test_digest_memo(self):
        t = torch.arange(16.0)
        d1 = _leaf_digest(t)
        assert _leaf_digest(t) == d1             # memo hit
        assert _leaf_digest(t.clone()) == d1     # content equal
        t2 = t.clone()
        t2[3] += 1.0
        assert _leaf_digest(t2) != d1
        t[3] += 1.0                              # in place: a new version
        assert _leaf_digest(t) == _leaf_digest(t2)
        assert _leaf_digest(t.to(torch.float64)) != _leaf_digest(t)

    def test_fused_parity_with_jax_on_copied_trunks(self, fused_pair):
        """The JAX shared-trunk engine against a port engine whose members
        each carry their own copy of the trunk: one group, same answers."""
        jeng, _ = fused_pair
        params = _flax_params(jeng)
        eng = InferenceEngine(InferenceEngineConfig(
            max_batch_size=8, max_wait_ms=1.0,
            seq_len_buckets=[32, 128, 512]), device="cpu")
        try:
            for name, labels in jtesting.SHARED_TRUNK_TASKS:
                if name in LORA:
                    continue
                module = ModernBertForSequenceClassification(
                    ModernBertConfig(**ttesting.TINY,
                                     num_labels=len(labels)))
                from semantic_router_tpu_torch.models.convert import \
                    params_from_flax
                module.load_state_dict(params_from_flax(params[name]))
                eng.register_task(name, "sequence", module,
                                  ttok.HashTokenizer(), labels,
                                  max_seq_len=512)
            assert len(eng.trunk_group_info()) == 1
            for task in ("intent", "user_feedback"):
                for text in TEXTS:
                    _assert_same_class(eng.classify(task, text),
                                       jeng.classify(task, text))
        finally:
            eng.shutdown()


# -- fuse_trunks through the bootstrap ------------------------------------------


def _write_checkpoint(root, labels, seed):
    st = pytest.importorskip("safetensors.torch")
    tokenizers = pytest.importorskip("tokenizers")
    fields = dict(ttesting.TINY)
    module = ModernBertForSequenceClassification(
        ModernBertConfig(**fields, num_labels=len(labels)))
    ttesting.init_weights(module, seed, std=0.2)
    os.makedirs(root, exist_ok=True)
    st.save_file({k: v.contiguous() for k, v in module.state_dict().items()},
                 os.path.join(root, "model.safetensors"))
    hf = dict(fields, model_type="modernbert",
              id2label={str(i): lab for i, lab in enumerate(labels)})
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf, f)
    vocab = {"[PAD]": 0, "[UNK]": 1}
    vocab.update({f"w{i}": i + 2 for i in range(100)})
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(os.path.join(root, "tokenizer.json"))


@pytest.mark.parametrize("fuse_trunks", [True, False])
def test_build_engine_fuse_trunks(tmp_path, fuse_trunks):
    """Two checkpoint files holding one trunk (same seed): one fused group
    by content, or, with ``fuse_trunks: false``, two per-task tasks; the
    answers are the same either way."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_checkpoint(a, ["x", "y", "z"], seed=3)
    _write_checkpoint(b, ["x", "y", "z"], seed=3)
    raw = {"engine": {"seq_len_buckets": [16, 64], "max_batch_size": 4,
                      "fuse_trunks": fuse_trunks},
           "classifier_models": {
               "one": {"checkpoint": a, "kind": "sequence"},
               "two": {"checkpoint": b, "kind": "sequence",
                       "tokenizer": a}}}
    cfg = load_config(raw)
    assert cfg.engine.fuse_trunks is fuse_trunks
    eng = build_engine(cfg, device="cpu")
    try:
        groups = list(eng.trunk_group_info().values())
        assert groups == ([["one", "two"]] if fuse_trunks else [])
        r1 = eng.classify("one", "w1 w2 w3 w77")
        r2 = eng.classify("two", "w1 w2 w3 w77")
        assert r1.probs == pytest.approx(r2.probs, abs=1e-6)
        group = eng.steps()[-1]["group"]
        assert group == ("trunk0" if fuse_trunks else "task:two")
    finally:
        eng.shutdown()


def test_every_entry_point_needs_the_card_unless_asked(monkeypatch,
                                                       tmp_path):
    """Without ``device=`` the engine builders and ``serve`` run on
    ``cuda``, and raise where no card is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ttesting.make_test_engine,
                 ttesting.make_shared_trunk_engine,
                 ttesting.make_embedding_engine):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    path = tmp_path / "router.yaml"
    path.write_text(json.dumps({"classifier_models": {
        "intent": {"checkpoint": str(tmp_path), "kind": "sequence"}}}))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(str(path), "http://127.0.0.1:9")
