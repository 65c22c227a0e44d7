"""The port's DeBERTa-v3 against the JAX package's on the same weights, on
the CPU: relative-position buckets bit-equal, sequence and token logits
within 1e-4 (float32) with padded rows, the HF state dict loading as the
JAX converter reads it, and DeBERTa tasks served on the engine's per-task
path as the JAX engine serves them (never fused)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.config.schema import \
    InferenceEngineConfig as JEngineConfig
from semantic_router_tpu.engine.classify import \
    InferenceEngine as JInferenceEngine
from semantic_router_tpu.models import deberta as jdeb
from semantic_router_tpu.utils import tokenization as jtok
from semantic_router_tpu_torch.config import InferenceEngineConfig
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.models import deberta as tdeb
from semantic_router_tpu_torch.models.convert import (
    deberta_params_from_flax,
    hf_state_for,
)
from semantic_router_tpu_torch.utils import tokenization as ttok

TOL = 1e-4
TINY = dict(vocab_size=200, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, position_buckets=16)
VARIANTS = {
    "v3": {},
    "unshared_keys_abs_pos": dict(share_att_key=False,
                                  position_biased_input=True),
    "c2p_only_tanh": dict(pos_att_type=("c2p",), pooler_hidden_act="tanh"),
    "no_buckets": dict(position_buckets=-1, norm_rel_ebd="none"),
}
LABELS = ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS", "B-PERSON"]
TEXTS = ["please email jane at jane@example.com today",
         "what is the capital of france",
         "hi",
         " ".join(f"w{i}" for i in range(40))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitter(params, seed: int):
    """JAX init plus seeded noise, so biases and norms are not trivial."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a))
        .astype(np.float32), params)


def _pair(kind: str, variant: str, num_labels: int, seed: int):
    """(JAX module, Flax params, port module) on the same weights."""
    cfg = dict(TINY, **VARIANTS[variant], num_labels=num_labels)
    jcls = jdeb.DebertaV3ForTokenClassification if kind == "token" \
        else jdeb.DebertaV3ForSequenceClassification
    tcls = tdeb.DebertaV3ForTokenClassification if kind == "token" \
        else tdeb.DebertaV3ForSequenceClassification
    jm = jcls(jdeb.DebertaV3Config(**cfg))
    ids = jnp.ones((1, 8), jnp.int32)
    params = _jitter(jm.init(jax.random.PRNGKey(seed), ids), seed)
    tm = tcls(tdeb.DebertaV3Config(**cfg))
    tm.load_state_dict(deberta_params_from_flax(params))
    return jm, params, tm.eval()


def _batch(B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, TINY["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(1, B):  # rows padded to S - 5b; row 1 on, all padding
        mask[b, max(0, S - 5 * b):] = 0
    if B > 3:
        mask[3] = 0
    return ids * mask, mask


@pytest.mark.parametrize("S, bucket, max_pos", [
    (10, 16, 64), (64, 16, 64), (37, 8, 64), (128, 256, 512),
    (512, 256, 512), (300, 32, 512), (20, -1, -1)])
def test_relative_positions_bit_equal(S, bucket, max_pos):
    np.testing.assert_array_equal(
        tdeb.build_relative_position(S, bucket, max_pos),
        jdeb.build_relative_position(S, bucket, max_pos))
    rel = np.arange(-2 * S, 2 * S + 1).reshape(1, -1)
    if bucket > 0:
        got = tdeb.make_log_bucket_position(rel, bucket, max_pos)
        want = jdeb.make_log_bucket_position(rel, bucket, max_pos)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_relative_positions_cached_per_length_and_device():
    m = tdeb.DebertaV3Model(tdeb.DebertaV3Config(**TINY))
    a = m.relative_positions(12, torch.device("cpu"))
    assert m.relative_positions(12, torch.device("cpu")) is a
    np.testing.assert_array_equal(
        a.numpy(), jdeb.build_relative_position(12, 16, 64))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", ["sequence", "token"])
def test_logits_match_jax(kind, variant):
    jm, params, tm = _pair(kind, variant, 5, seed=3)
    ids, mask = _batch(5, 24, seed=4)
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(),
                 torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_config_from_hf_matches_jax():
    from types import SimpleNamespace

    hf = dict(TINY, relative_attention=True, pos_att_type=["p2c", "c2p"],
              share_att_key=True, norm_rel_ebd="layer_norm",
              position_biased_input=False,
              id2label={"0": "a", "1": "b", "2": "c"})
    want = jdeb.DebertaV3Config.from_hf(SimpleNamespace(**hf))
    for got in (tdeb.DebertaV3Config.from_hf(hf),
                tdeb.DebertaV3Config.from_hf(SimpleNamespace(**hf))):
        for f in ("vocab_size", "hidden_size", "num_hidden_layers",
                  "position_buckets", "pos_att_type", "share_att_key",
                  "norm_rel_ebd", "position_biased_input", "num_labels",
                  "max_rel", "att_span", "layer_norm_eps"):
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("kind", ["sequence", "token"])
def test_hf_state_dict_loads_as_the_jax_converter_reads_it(kind):
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.DebertaV2Config(
        **TINY, relative_attention=True, pos_att_type=["p2c", "c2p"],
        share_att_key=True, norm_rel_ebd="layer_norm",
        position_biased_input=False, type_vocab_size=0, num_labels=4,
        pooler_hidden_size=TINY["hidden_size"])
    torch.manual_seed(7)
    hcls = transformers.DebertaV2ForTokenClassification if kind == "token" \
        else transformers.DebertaV2ForSequenceClassification
    hf = hcls(hcfg).eval()
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = tdeb.DebertaV3Config.from_hf(hcfg)
    cfg.num_labels = 4
    tcls = tdeb.DebertaV3ForTokenClassification if kind == "token" \
        else tdeb.DebertaV3ForSequenceClassification
    tm = tcls(cfg).eval()
    tm.load_state_dict(hf_state_for(tm, state))
    jcfg = jdeb.DebertaV3Config.from_hf(hcfg)
    jcfg.num_labels = 4
    jcls = jdeb.DebertaV3ForTokenClassification if kind == "token" \
        else jdeb.DebertaV3ForSequenceClassification
    ids, mask = _batch(3, 16, seed=8)
    want = np.asarray(jcls(jcfg).apply(
        jdeb.deberta_params_from_state_dict(state), jnp.asarray(ids),
        jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        ref = hf(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long()).logits
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # real rows agree with HF itself (its padded rows are not zeroed
    # the same way)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=TOL,
                               rtol=0)


def test_hf_state_missing_a_tensor_is_refused_by_name():
    tm = tdeb.DebertaV3ForSequenceClassification(tdeb.DebertaV3Config(**TINY))
    state = {k: v.numpy() for k, v in tm.state_dict().items()
             if k != "pooler.dense.weight"}
    state["deberta.embeddings.position_ids"] = np.arange(64)
    with pytest.raises(ValueError, match="pooler.dense.weight"):
        hf_state_for(tm, state)


def _engines(max_seq_len: int = 32):
    jcfg = JEngineConfig(max_batch_size=4, max_wait_ms=1.0,
                         seq_len_buckets=[16, 32])
    tcfg = InferenceEngineConfig(max_batch_size=4, max_wait_ms=1.0,
                                 seq_len_buckets=[16, 32])
    jeng, teng = JInferenceEngine(jcfg), InferenceEngine(tcfg, device="cpu")
    for name, kind, labels, seed in (
            ("fact_check", "sequence", ["no_fact_check_needed",
                                        "needs_fact_check"], 11),
            ("jailbreak", "sequence", ["benign", "jailbreak"], 12),
            ("pii", "token", LABELS, 13)):
        jm, params, tm = _pair(kind, "v3", len(labels), seed)
        jeng.register_task(name, kind, jm, params,
                           jtok.HashTokenizer(TINY["vocab_size"]), labels,
                           max_seq_len=max_seq_len)
        teng.register_task(name, kind, tm,
                           ttok.HashTokenizer(TINY["vocab_size"]), labels,
                           max_seq_len=max_seq_len)
    return jeng, teng


def test_engine_serves_deberta_per_task_like_jax():
    jeng, teng = _engines()
    try:
        # never fused: no trunk, no stackable head
        assert teng.trunk_group_info() == {} == jeng.trunk_group_info()
        assert not teng.fused_covers(["fact_check", "jailbreak"])
        for task in ("fact_check", "jailbreak"):
            got = teng.classify_batch(task, TEXTS)
            want = jeng.classify_batch(task, TEXTS)
            for g, w in zip(got, want):
                assert g.label == w.label and g.truncated == w.truncated
                for lab in w.probs:
                    assert abs(g.probs[lab] - w.probs[lab]) <= TOL
        got = teng.classify_multi(["fact_check", "jailbreak"], TEXTS[:2])
        want = jeng.classify_multi(["fact_check", "jailbreak"], TEXTS[:2])
        for task in want:
            assert [r.label for r in got[task]] == \
                [r.label for r in want[task]]
        for text in TEXTS:
            g = teng.token_classify("pii", text, threshold=0.2)
            w = jeng.token_classify("pii", text, threshold=0.2)
            assert [(e.type, e.start, e.end) for e in g.entities] == \
                [(e.type, e.start, e.end) for e in w.entities]
            for ge, we in zip(g.entities, w.entities):
                assert abs(ge.score - we.score) <= TOL
        steps = [s for s in teng.steps() if s["group"] == "task:fact_check"]
        assert steps and all(s["flavor"] == "split" for s in steps)
        assert teng.task_info("pii")["kind"] == "token"
        teng.warmup()  # captures (eagerly, here) every bucket at batch 1
    finally:
        teng.shutdown()
        jeng.shutdown()


def test_engine_windowed_deberta_like_jax():
    jeng, teng = _engines(max_seq_len=16)
    try:
        text = " ".join(f"w{i % 50}" for i in range(60))
        got = teng.classify_windowed("fact_check", text, stride=4)
        want = jeng.classify_windowed("fact_check", text, stride=4)
        assert got.label == want.label
        for lab in want.probs:
            assert abs(got.probs[lab] - want.probs[lab]) <= TOL
    finally:
        teng.shutdown()
        jeng.shutdown()
