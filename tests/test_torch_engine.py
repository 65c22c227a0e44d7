"""The port's engine (semantic_router_tpu_torch.engine) against the JAX
engine on the same weights, on the CPU: the same labels, probabilities
within 1e-4, the same token spans; plus the batcher, knobs, tokenization
and config pieces the engine stands on."""

import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from semantic_router_tpu.engine import batcher as jbatcher
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.engine.kernels import normalize_kernels as jnorm
from semantic_router_tpu.utils import tokenization as jtok
from semantic_router_tpu_torch.engine import batcher as tbatcher
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.engine.kernels import normalize_kernels
from semantic_router_tpu_torch.utils import tokenization as ttok

PII = ("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS", "B-PERSON",
               "I-PERSON"])
TEXTS = [
    "how do I file quarterly taxes for a small business",
    "is this medication safe with alcohol",
    "write a python function that sorts a list",
    "hello",
    "contact jane at jane@example.com or call tomorrow",
    "how do I file quarterly taxes for a small business",
]
SEQ_TASKS = [name for name, _ in jtesting.SHARED_TRUNK_TASKS]


def _flax_params(engine):
    return {name: t.params for name, t in engine._tasks.items()}


@pytest.fixture(scope="module")
def shared_pair():
    """(JAX engine, port engine) sharing one trunk, on the same weights."""
    jeng = jtesting.make_shared_trunk_engine(token_tasks=[PII], seed=3)
    teng = ttesting.make_shared_trunk_engine(
        token_tasks=[PII], device="cpu", flax_params=_flax_params(jeng))
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _assert_same_class(a, b, tol=1e-4):
    assert a.label == b.label and a.index == b.index
    assert a.truncated == b.truncated
    assert set(a.probs) == set(b.probs)
    for k in a.probs:
        assert abs(a.probs[k] - b.probs[k]) <= tol, (k, a.probs, b.probs)


class TestSharedTrunkParity:
    def test_one_group(self, shared_pair):
        jeng, teng = shared_pair
        assert list(teng.trunk_group_info().values()) == \
            list(jeng.trunk_group_info().values())

    @pytest.mark.parametrize("task", SEQ_TASKS)
    def test_classify(self, shared_pair, task):
        jeng, teng = shared_pair
        for text in TEXTS:
            _assert_same_class(teng.classify(task, text),
                               jeng.classify(task, text))

    def test_classify_multi_with_dedup(self, shared_pair):
        jeng, teng = shared_pair
        before = teng.fused_dedup_rows
        got = teng.classify_multi(SEQ_TASKS, TEXTS)
        want = jeng.classify_multi(SEQ_TASKS, TEXTS)
        assert teng.fused_dedup_rows > before  # TEXTS[0] == TEXTS[5]
        for task in SEQ_TASKS:
            for a, b in zip(got[task], want[task]):
                _assert_same_class(a, b)
            assert got[task][0].probs == got[task][5].probs

    def test_token_spans(self, shared_pair):
        jeng, teng = shared_pair
        for text in TEXTS:
            got = teng.token_classify("pii", text, threshold=0.0)
            want = jeng.token_classify("pii", text, threshold=0.0)
            assert [(e.type, e.start, e.end, e.text) for e in got.entities] \
                == [(e.type, e.start, e.end, e.text) for e in want.entities]
            for a, b in zip(got.entities, want.entities):
                assert abs(a.score - b.score) <= 1e-4

    def test_truncation_is_flagged(self, shared_pair):
        jeng, teng = shared_pair
        long_text = " ".join(f"w{i}" for i in range(700))
        a = teng.classify("intent", long_text)
        b = jeng.classify("intent", long_text)
        assert a.truncated and b.truncated
        _assert_same_class(a, b)

    def test_concurrent_classify_async(self, shared_pair):
        jeng, teng = shared_pair
        jobs = [(task, text) for task in SEQ_TASKS for text in TEXTS]
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = list(pool.map(
                lambda j: teng.classify_async(j[0], j[1]), jobs))
            got = [f.result(timeout=60) for f in futs]
        for (task, text), a in zip(jobs, got):
            _assert_same_class(a, jeng.classify(task, text))

    def test_epilogue_path_matches(self, shared_pair):
        jeng, teng = shared_pair
        plain = teng.classify_multi(SEQ_TASKS, TEXTS[:3])
        teng.configure_kernels({"epilogue": {"enabled": True}})
        try:
            rep = teng.kernels_report()
            assert rep["kernels"]["epilogue"]["enabled"]
            assert all(m["epilogue"] for m in rep["groups"].values())
            fused = teng.classify_multi(SEQ_TASKS, TEXTS[:3])
            spans = teng.token_classify("pii", TEXTS[4], threshold=0.0)
        finally:
            teng.configure_kernels({})
        for task in SEQ_TASKS:
            for a, b in zip(fused[task], plain[task]):
                _assert_same_class(a, b)
        want = jeng.token_classify("pii", TEXTS[4], threshold=0.0)
        assert [e.type for e in spans.entities] == \
            [e.type for e in want.entities]
        assert teng.steps()[-1]["epilogue"] is True

    def test_warmup_and_census(self, shared_pair):
        _, teng = shared_pair
        teng.warmup(buckets=[32])
        census = teng.shape_census()
        assert all(b in (32, 128, 512) for shapes in census.values()
                   for _, b in shapes)


def test_separate_trunks_match_jax():
    jeng = jtesting.make_test_engine(seed=1)
    teng = ttesting.make_test_engine(device="cpu",
                                     flax_params=_flax_params(jeng))
    try:
        assert len(teng.trunk_group_info()) == 3  # one group per trunk
        for text in TEXTS[:4]:
            for task in ("intent", "jailbreak"):
                _assert_same_class(teng.classify(task, text),
                                   jeng.classify(task, text))
            got = teng.token_classify("pii", text, threshold=0.0)
            want = jeng.token_classify("pii", text, threshold=0.0)
            assert [(e.type, e.start, e.end) for e in got.entities] == \
                [(e.type, e.start, e.end) for e in want.entities]
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_engine_refusals():
    teng = ttesting.make_shared_trunk_engine(device="cpu",
                                             token_tasks=[PII])
    try:
        with pytest.raises(KeyError):
            teng.classify("nope", "x")
        with pytest.raises(TypeError, match="token_classify"):
            teng.classify("pii", "x")
        # the BGMV knob is served: a 3-head bank engages at min_tasks 2
        teng.configure_kernels({"bgmv": {"enabled": True, "min_tasks": 2}})
        assert [m["bgmv"] for m in
                teng.kernels_report()["groups"].values()] == [True]
        assert teng.fused_covers(["intent", "fact_check"])
        assert not teng.fused_covers(["intent", "pii"])
    finally:
        teng.shutdown()


# ---------------------------------------------------------------------------
# batcher


class TestBatcher:
    @pytest.mark.parametrize("n,cap", [(1, 8), (3, 8), (8, 8), (9, 12),
                                       (20, 16)])
    def test_pow2_batch_matches_jax(self, n, cap):
        assert tbatcher.pow2_batch(n, cap) == jbatcher.pow2_batch(n, cap)

    @pytest.mark.parametrize("n", [1, 32, 33, 128, 129, 600])
    def test_pick_bucket_matches_jax(self, n):
        b = [32, 128, 512]
        assert tbatcher.pick_bucket(n, b) == jbatcher.pick_bucket(n, b)

    def test_cancelled_future_never_runs(self):
        gate = threading.Event()
        seen = []

        def runner(key, items):
            seen.extend(it.payload for it in items)
            gate.wait(timeout=10)
            return [it.payload * 10 for it in items]

        b = tbatcher.DynamicBatcher(runner, max_batch_size=8,
                                    max_wait_ms=1.0, dispatch_workers=2)
        try:
            first = b.submit("g", 1)
            deadline = threading.Event()
            for _ in range(200):  # wait until batch 1 is in the runner
                if seen:
                    break
                deadline.wait(0.01)
            assert seen == [1]
            queued = [b.submit("g", p) for p in (2, 3, 4)]
            assert queued[1].cancel()
            gate.set()
            assert first.result(timeout=10) == 10
            assert queued[0].result(timeout=10) == 20
            assert queued[2].result(timeout=10) == 40
            assert queued[1].cancelled()
            assert 3 not in seen
            assert b.stats()["cancelled"] == 1
        finally:
            gate.set()
            b.shutdown()

    def test_runner_error_fails_open(self):
        def runner(key, items):
            raise RuntimeError("boom")

        b = tbatcher.DynamicBatcher(runner, max_batch_size=4)
        try:
            f = b.submit("g", 1)
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=10)
        finally:
            b.shutdown()

    def test_submit_after_shutdown_raises(self):
        b = tbatcher.DynamicBatcher(lambda k, items: [0] * len(items))
        b.shutdown()
        with pytest.raises(RuntimeError):
            b.submit("g", 1)


@pytest.mark.parametrize("knobs", [
    None, {}, {"epilogue": {"enabled": True}},
    {"bgmv": {"enabled": True, "min_tasks": "x"}},
    {"epilogue": "on", "bgmv": {"min_tasks": 0}},
])
def test_normalize_kernels_matches_jax(knobs):
    assert normalize_kernels(knobs) == jnorm(knobs)


# ---------------------------------------------------------------------------
# tokenization


class TestTokenization:
    @pytest.mark.parametrize("max_length", [0, 5, 512])
    def test_hash_tokenizer_matches_jax(self, max_length):
        text = "Email jane.doe@example.com  about the   quarterly report"
        a = ttok.HashTokenizer(1024).encode(text, max_length=max_length)
        b = jtok.HashTokenizer(1024).encode(text, max_length=max_length)
        assert (a.ids, a.attention_mask, a.offsets, a.truncated,
                a.total_tokens) == (b.ids, b.attention_mask, b.offsets,
                                    b.truncated, b.total_tokens)

    def test_encoding_cache_encodes_once(self):
        cache = ttok.EncodingCache()
        tok = ttok.HashTokenizer(64)
        misses = []
        a = cache.get_or_encode(tok, "a b c", 16,
                                on_miss=lambda: misses.append(1))
        b = cache.get_or_encode(tok, "a b c", 16,
                                on_miss=lambda: misses.append(1))
        assert a is b and misses == [1]
        assert (cache.hits, cache.misses) == (1, 1)

    def test_decode_entity_spans_matches_jax(self):
        text = "mail jane doe now"
        offsets = [(0, 0), (0, 4), (5, 9), (10, 13), (14, 17), (0, 0)]
        labels = ["O", "O", "B-PERSON", "I-PERSON", "O", "O"]
        scores = [0.9, 0.9, 0.8, 0.7, 0.9, 0.9]
        for thr in (0.5, 0.75):
            assert ttok.decode_entity_spans(text, offsets, labels, scores,
                                            thr) == \
                jtok.decode_entity_spans(text, offsets, labels, scores, thr)
