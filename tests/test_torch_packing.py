"""Sequence-packed continuous batching in the port (engine/packing, the
packed trunk forward, per-segment pooling) against the JAX package's on
the CPU, mirroring tests/test_packing.py: the packer's planes and takes
equal JAX's exactly; the packing masks equal JAX's and the pools within
1e-6; the trunk with position / segment ids within 1e-4 of JAX's (and of
each segment alone, unpacked), the quantized and LoRA trunks riding the
same forward; the packed engine within 1e-4 of the packed JAX engine on
one set of Flax weights (mixed lengths, mixed tasks, a LoRA member, a
deduped batch, token spans, the epilogue and BGMV knobs, their plain
versions on the CPU); the scheduler, counters, auto-tuner, knobs,
report and packed warmup as the reference's."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.config.schema import \
    InferenceEngineConfig as JEngineConfig
from semantic_router_tpu.config.schema import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import packing as jpacking
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.models import lora as jl
from semantic_router_tpu.models import modernbert as jm
from semantic_router_tpu.models import quant as jquant
from semantic_router_tpu.ops import attention as jattn
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine import packing as tpacking
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import lora as tl
from semantic_router_tpu_torch.models import modernbert as tm
from semantic_router_tpu_torch.models.convert import (
    lora_params_from_flax,
    params_from_flax,
)
from semantic_router_tpu_torch.models.quant import build_quant_trunk
from semantic_router_tpu_torch.observability.metrics import (
    MetricSeries,
    MetricsRegistry,
)
from semantic_router_tpu_torch.observability.runtimestats import RuntimeStats
from semantic_router_tpu_torch.observability.tracing import Tracer
from semantic_router_tpu_torch.ops import attention as tattn
from semantic_router_tpu_torch.runtime import apply_packing_knobs
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer

TOL = 1e-4
TASKS = [name for name, _ in jtesting.SHARED_TRUNK_TASKS]
PII = ("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS", "B-PERSON",
               "I-PERSON"])
# mixed lengths: several per bucket, some near the edge, some tiny
MIXED_TEXTS = [
    "hi",
    "what is the capital of france",
    "sue them for breach of contract now and forever " * 2,
    "x",
    "does this medicine interact with alcohol at night",
    "segfault in my rust program when the arena reallocs",
    "ok",
    "tell me about tax law " * 6,
    "contact jane at jane@example.com or call bob tomorrow",
]
BUCKETS = [32, 128, 512]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh_series() -> MetricSeries:
    return MetricSeries(MetricsRegistry())


# ---------------------------------------------------------------------------
# the packer: planes and takes equal JAX's exactly


class _Enc:
    def __init__(self, n: int, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(1, 1000, n).astype(np.int32)
        self.attention_mask = np.ones(n, np.int32)

    def __len__(self) -> int:
        return len(self.ids)


def _lengths(seed: int, n: int, hi: int) -> list:
    return [int(x) for x in
            np.random.default_rng(seed).integers(1, hi, n)]


def _same_batch(a, b) -> None:
    for plane in ("ids", "mask", "position_ids", "segment_ids", "seg_row",
                  "seg_start", "seg_len"):
        np.testing.assert_array_equal(getattr(a, plane), getattr(b, plane),
                                      err_msg=plane)
    assert [vars(s) for s in a.segments] == [vars(s) for s in b.segments]
    assert (a.rows_used, a.tokens_real, a.tokens_padded) == \
        (b.rows_used, b.tokens_real, b.tokens_padded)
    assert a.fill_ratio() == b.fill_ratio()


class TestPacker:
    @pytest.mark.parametrize("seed", range(6))
    def test_pack_items_equals_jax(self, seed):
        """Seeded lengths (some past the bucket: clipped) laid out with
        row and segment padding: every plane, segment and count equal."""
        lens = _lengths(seed, 12, 40)
        encs = [_Enc(n, seed * 100 + i) for i, n in enumerate(lens)]
        kw = dict(max_rows=16, max_segments_per_row=1 + seed % 4,
                  pad_rows_to=16, pad_segments_to=16)
        _same_batch(tpacking.pack_items(encs, 32, 0, **kw),
                    jpacking.pack_items(encs, 32, 0, **kw))

    def test_pack_clips_at_the_bucket_edge(self):
        encs = [_Enc(45, 1), _Enc(5, 2)]
        t = tpacking.pack_items(encs, 32, 0, max_rows=4,
                                max_segments_per_row=4)
        j = jpacking.pack_items(encs, 32, 0, max_rows=4,
                                max_segments_per_row=4)
        _same_batch(t, j)
        assert t.segments[0].clipped and t.segments[0].length == 32
        assert not t.segments[1].clipped

    def test_pack_refuses_what_does_not_fit_like_jax(self):
        encs = [_Enc(30, i) for i in range(3)]
        for mod in (tpacking, jpacking):
            with pytest.raises(ValueError, match="does not fit"):
                mod.pack_items(encs, 32, 0, max_rows=2,
                               max_segments_per_row=4)

    @pytest.mark.parametrize("seed", range(8))
    def test_plan_take_equals_jax(self, seed):
        """FIFO lookahead, deferral counts at and past the starvation
        bound, the pow2 backlog trim: the same (take, deferred)."""
        rng = np.random.default_rng(seed)
        lens = _lengths(seed + 50, 24, 120)
        deferrals = [int(x) for x in rng.integers(0, 6, len(lens))]
        kw = dict(max_rows=int(rng.integers(1, 9)),
                  max_segments_per_row=int(rng.integers(1, 9)),
                  max_items=int(rng.integers(1, 30)),
                  deferrals=deferrals,
                  starvation_steps=int(rng.integers(0, 6)),
                  backlog_beyond=bool(seed % 2))
        assert tpacking.plan_take(lens, 128, **kw) == \
            jpacking.plan_take(lens, 128, **kw)

    @pytest.mark.parametrize("rows,segs,lens,want", [
        (4, 8, [10, 10, 10, 10], [0, 0, 0, 1]),
        (4, 2, [10, 10, 10, 10], [0, 0, 1, 1]),
        (2, 8, [30, 30, 2], [0, 1, 0]),
        (1, 8, [20, 20], [0, None]),
    ])
    def test_row_plan_equals_jax(self, rows, segs, lens, want):
        tp, jp = tpacking.RowPlan(32, rows, segs), \
            jpacking.RowPlan(32, rows, segs)
        got = [tp.add(n) for n in lens]
        assert got == [jp.add(n) for n in lens] == want
        assert tp.rows_used == jp.rows_used

    def test_starvation_bound_under_adversarial_traffic(self):
        """A long item behind a stream of short ones is deferred at most
        starvation_steps steps: the same step count as the reference."""
        def steps_until_served(mod):
            queue = [[100, 0]] + [[4, 0] for _ in range(40)]
            for step in range(1, 50):
                lens = [q[0] for q in queue]
                take, deferred = mod.plan_take(
                    lens, 128, max_rows=1, max_segments_per_row=8,
                    max_items=8, deferrals=[q[1] for q in queue],
                    starvation_steps=3)
                for i in deferred:
                    queue[i][1] += 1
                if 0 in take and queue[0][0] == 100:
                    return step
                chosen = set(take)
                queue = [q for i, q in enumerate(queue) if i not in chosen]
                queue += [[4, 0] for _ in range(len(take))]
            return None

        got = steps_until_served(tpacking)
        assert got is not None and got <= 5
        assert got == steps_until_served(jpacking)


# ---------------------------------------------------------------------------
# the masks and pools


def _planes(seed: int = 0, bucket: int = 32):
    lens = _lengths(seed, 7, 20)
    encs = [_Enc(n, seed * 10 + i) for i, n in enumerate(lens)]
    return tpacking.pack_items(encs, bucket, 0, max_rows=8,
                               max_segments_per_row=4, pad_rows_to=4,
                               pad_segments_to=8)


class TestOps:
    @pytest.mark.parametrize("seed", range(3))
    def test_block_diagonal_bias_equals_jax(self, seed):
        pb = _planes(seed)
        got = tattn.block_diagonal_bias(torch.from_numpy(pb.segment_ids))
        want = np.asarray(jattn.block_diagonal_bias(
            jnp.asarray(pb.segment_ids)))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        # padding keys are masked even against padding queries
        pad = pb.segment_ids[0] < 0
        if pad.any():
            assert (got[0, 0][np.ix_(pad, pad)] == tattn.NEG_INF).all()

    @pytest.mark.parametrize("window", [4, 8, 128])
    def test_packed_window_bias_equals_jax(self, window):
        pb = _planes(1)
        got = tattn.packed_window_bias(torch.from_numpy(pb.position_ids),
                                       window)
        want = np.asarray(jattn.packed_window_bias(
            jnp.asarray(pb.position_ids), window))
        np.testing.assert_array_equal(got.numpy(), want)

    def _hidden(self, pb, D=16):
        rng = np.random.default_rng(3)
        return rng.standard_normal(pb.ids.shape + (D,)).astype(np.float32)

    def test_packed_cls_pool_equals_jax(self):
        pb = _planes(2)
        h = self._hidden(pb)
        got = tattn.packed_cls_pool(torch.from_numpy(h),
                                    torch.from_numpy(pb.seg_row),
                                    torch.from_numpy(pb.seg_start))
        want = np.asarray(jattn.packed_cls_pool(
            jnp.asarray(h), jnp.asarray(pb.seg_row),
            jnp.asarray(pb.seg_start)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    def test_packed_mean_pool_equals_jax(self):
        pb = _planes(3)
        h = self._hidden(pb)
        got = tattn.packed_mean_pool(torch.from_numpy(h),
                                     torch.from_numpy(pb.segment_ids), 8)
        want = np.asarray(jattn.packed_mean_pool(
            jnp.asarray(h), jnp.asarray(pb.segment_ids), 8))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the trunk


TRUNK_CFG = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=3, num_attention_heads=4, pad_token_id=0,
                 local_attention=8)


def _trunk_pair(seed: int = 0):
    jcfg = jm.ModernBertConfig(**TRUNK_CFG)
    params = flax.core.unfreeze(jm.ModernBertModel(jcfg).init(
        jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))["params"]
    trunk = tm.ModernBertModel(tm.ModernBertConfig(**TRUNK_CFG))
    sd = params_from_flax({"params": {"model": params}})
    trunk.load_state_dict({k[len("model."):]: v for k, v in sd.items()})
    return jcfg, params, trunk.eval()


def _packed_trunk_batch(seed: int = 4, bucket: int = 40):
    lens = [17, 9, 3, 12, 21, 1, 30]
    rng = np.random.default_rng(seed)
    encs = []
    for n in lens:
        e = _Enc(n, int(rng.integers(0, 1000)))
        e.ids = (e.ids % (TRUNK_CFG["vocab_size"] - 1) + 1).astype(np.int32)
        encs.append(e)
    pb = tpacking.pack_items(encs, bucket, 0, max_rows=8,
                             max_segments_per_row=3, pad_rows_to=4,
                             pad_segments_to=8)
    return encs, pb


def _run_port(trunk, pb, **kw):
    with torch.no_grad():
        return trunk(torch.from_numpy(pb.ids).long(),
                     torch.from_numpy(pb.mask),
                     position_ids=torch.from_numpy(pb.position_ids),
                     segment_ids=torch.from_numpy(pb.segment_ids), **kw)


def _run_jax(module, params, pb, **kw):
    return np.asarray(module.apply(
        {"params": params}, jnp.asarray(pb.ids), jnp.asarray(pb.mask),
        position_ids=jnp.asarray(pb.position_ids),
        segment_ids=jnp.asarray(pb.segment_ids), **kw), np.float32)


class TestTrunk:
    def test_packed_trunk_matches_jax(self):
        jcfg, params, trunk = _trunk_pair()
        _, pb = _packed_trunk_batch()
        got = _run_port(trunk, pb)
        want = _run_jax(jm.ModernBertModel(jcfg), params, pb)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)

    def test_each_segment_equals_itself_unpacked(self):
        _, _, trunk = _trunk_pair(1)
        encs, pb = _packed_trunk_batch(5)
        got = _run_port(trunk, pb).numpy()
        for seg in pb.segments:
            enc = encs[seg.item_index]
            ids = np.zeros((1, 40), np.int64)
            mask = np.zeros((1, 40), np.int32)
            ids[0, :seg.length] = enc.ids[:seg.length]
            mask[0, :seg.length] = 1
            with torch.no_grad():
                alone = trunk(torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
            np.testing.assert_allclose(
                got[seg.row, seg.start:seg.start + seg.length],
                alone[0, :seg.length], atol=TOL, rtol=0)

    def test_biases_built_once_equal_per_layer_ones(self):
        """The model builds the two biases once per forward; a layer
        building them from the planes gives the same values."""
        _, pb = _packed_trunk_batch(6)
        cfg = tm.ModernBertConfig(**TRUNK_CFG)
        pos = torch.from_numpy(pb.position_ids)
        seg = torch.from_numpy(pb.segment_ids)
        once = tm.packed_attention_biases(cfg, pos, seg)
        block = tattn.block_diagonal_bias(seg)
        assert torch.equal(once[0], block)
        assert torch.equal(once[8], block + tattn.packed_window_bias(pos, 8))
        _, _, trunk = _trunk_pair(2)
        attn = trunk.layers[1].attn    # a local layer
        x = torch.randn(pb.ids.shape + (TRUNK_CFG["hidden_size"],))
        mask = torch.from_numpy(pb.mask)
        with torch.no_grad():
            assert torch.equal(attn(x, mask, None, pos, seg),
                               attn(x, mask, None, pos, seg, once))

    @pytest.mark.parametrize("impl", ["flash", "chunked"])
    def test_only_dense_packs(self, impl):
        _, pb = _packed_trunk_batch()
        trunk = tm.ModernBertModel(tm.ModernBertConfig(
            **TRUNK_CFG, attention_impl=impl)).eval()
        with pytest.raises(ValueError, match="attention_impl='dense'"):
            _run_port(trunk, pb)

    def test_without_planes_nothing_changes(self):
        _, _, trunk = _trunk_pair(3)
        _, pb = _packed_trunk_batch()
        ids, mask = torch.from_numpy(pb.ids).long(), torch.from_numpy(pb.mask)
        with torch.no_grad():
            a = trunk(ids, mask)
            b = trunk(ids, mask, position_ids=None, segment_ids=None)
        assert torch.equal(a, b)

    @pytest.mark.parametrize("mode,tol", [("bf16", 0.05), ("int8", 0.1)])
    def test_quant_trunks_pack_like_jax(self, mode, tol):
        """The bf16 / int8 serving trunks ride the packed forward: against
        JAX's at the same mode (the reference's trunk tolerances), on the
        real tokens."""
        jcfg, params, trunk = _trunk_pair(4)
        _, pb = _packed_trunk_batch(7)
        jmod, jparams = jquant.build_quant_trunk(jcfg, params, mode)
        want = _run_jax(jmod, jparams, pb)
        got = _run_port(build_quant_trunk(trunk, mode), pb).float().numpy()
        real = pb.mask.astype(bool)
        assert np.abs(got - want)[real].max() < tol

    def test_lora_trunk_packs_like_jax_per_task_index(self):
        lj = jl.LoRAConfig(rank=4, alpha=8.0, num_tasks=3)
        lt = tl.LoRAConfig(rank=4, alpha=8.0, num_tasks=3)
        jcfg = jm.ModernBertConfig(**TRUNK_CFG)
        jmod = jl.LoRAModernBertForSequenceClassification(jcfg, lj, 4)
        tmod = tl.LoRAModernBertForSequenceClassification(
            tm.ModernBertConfig(**TRUNK_CFG), lt, 4)
        rng = np.random.default_rng(9)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a))
            .astype(np.float32),
            jmod.init(jax.random.PRNGKey(9), jnp.ones((1, 8), jnp.int32)))
        tmod.load_state_dict(lora_params_from_flax(tmod, params))
        tmod.eval()
        jtrunk = jm.ModernBertModel(
            jcfg, dense_factory=lambda f, b, name: jl.LoRADense(
                f, lj, use_bias=b, name=name))
        _, pb = _packed_trunk_batch(8)
        for t in range(3):
            want = _run_jax(jtrunk, params["params"]["model"], pb,
                            task_index=jnp.asarray(t))
            got = _run_port(tmod.model, pb, task_index=torch.tensor([t]))
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the engine: packed port vs packed JAX on one set of Flax weights


def _jax_engine(kernels=None, token=True, packing=None, seed=3):
    return jtesting.make_shared_trunk_engine(
        lora_tasks=("fact_check",), token_tasks=[PII] if token else None,
        seed=seed, engine_cfg=JEngineConfig(
            max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=BUCKETS,
            kernels=dict(kernels or {}), packing=dict(packing or {})))


def _port_engine(jeng=None, kernels=None, token=True, packing=None, **kw):
    params = {n: t.params for n, t in jeng._tasks.items()} \
        if jeng is not None else None
    return ttesting.make_shared_trunk_engine(
        lora_tasks=("fact_check",), token_tasks=[PII] if token else None,
        device="cpu", flax_params=params,
        engine_cfg=InferenceEngineConfig(
            max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=BUCKETS,
            kernels=dict(kernels or {}), packing=dict(packing or {})), **kw)


def _close(a, b, tol=TOL):
    assert a.label == b.label and a.index == b.index
    assert a.truncated == b.truncated
    assert set(a.probs) == set(b.probs)
    for k in a.probs:
        assert abs(a.probs[k] - b.probs[k]) <= tol, (k, a.probs, b.probs)


def _variants(eng) -> set:
    return {p["variant"] for p in eng._runtime_stats.programs()
            if p["group"].startswith("trunk:")}


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, port engine), both packing by default, on the same
    weights, each with its own runtime stats."""
    from semantic_router_tpu.observability.metrics import \
        MetricSeries as JSeries
    from semantic_router_tpu.observability.metrics import \
        MetricsRegistry as JRegistry
    from semantic_router_tpu.observability.runtimestats import \
        RuntimeStats as JStats

    jeng = jtesting.make_shared_trunk_engine(
        lora_tasks=("fact_check",), token_tasks=[PII], seed=3,
        metrics=JSeries(JRegistry()), runtime_stats=JStats(JRegistry()))
    teng = _port_engine(jeng, metrics=fresh_series(),
                        runtime_stats=RuntimeStats(MetricsRegistry()))
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


class TestEngineParity:
    @pytest.mark.parametrize("task", TASKS)
    def test_mixed_length_batches(self, pair, task):
        jeng, teng = pair
        for a, b in zip(teng.classify_batch(task, MIXED_TEXTS),
                        jeng.classify_batch(task, MIXED_TEXTS)):
            _close(a, b)

    def test_mixed_task_fanout(self, pair):
        jeng, teng = pair
        got = teng.classify_multi(TASKS, MIXED_TEXTS)
        want = jeng.classify_multi(TASKS, MIXED_TEXTS)
        for task in TASKS:
            for a, b in zip(got[task], want[task]):
                _close(a, b)

    def test_deduped_batch(self, pair):
        jeng, teng = pair
        texts = ["hot prompt"] * 4 + ["cold one", "another distinct",
                                      "hot prompt", "third distinct"]
        before = teng.fused_dedup_rows
        got = teng.classify_multi(["intent", "fact_check"], texts)
        want = jeng.classify_multi(["intent", "fact_check"], texts)
        assert teng.fused_dedup_rows > before
        for task in ("intent", "fact_check"):
            for a, b in zip(got[task], want[task]):
                _close(a, b)
            assert got[task][0].probs == got[task][6].probs

    def test_token_spans(self, pair):
        """Token items submitted together, so they ride packed steps on
        both engines: each segment's span of the per-token logits."""
        jeng, teng = pair

        def spans(eng):
            with ThreadPoolExecutor(max_workers=len(MIXED_TEXTS)) as pool:
                return list(pool.map(lambda t: eng.token_classify(
                    "pii", t, threshold=0.0), MIXED_TEXTS))

        got, want = spans(teng), spans(jeng)
        for g, w in zip(got, want):
            assert [(e.type, e.start, e.end, e.text) for e in g.entities] \
                == [(e.type, e.start, e.end, e.text) for e in w.entities]
            for a, b in zip(g.entities, w.entities):
                assert abs(a.score - b.score) <= TOL

    def test_packed_steps_ran_on_both(self, pair):
        jeng, teng = pair
        teng.classify_multi(TASKS, MIXED_TEXTS)
        assert "packed" in _variants(teng)
        assert "packed" in {p["variant"]
                            for p in jeng._runtime_stats.programs()}
        packed = [p for p in teng._runtime_stats.programs()
                  if p["variant"] == "packed"]
        assert all("token_fill_ratio" in p and p["segments_real"] > 0
                   for p in packed)
        rec = [s for s in teng.steps() if s.get("variant", "")
               .startswith("packed:")]
        assert rec and all(s["segments"] >= 2 and s["k_pad"] >= s["segments"]
                           for s in rec)

    def test_concurrent_mixed_kind_batch(self, pair):
        _, teng = pair
        res = {}

        def seq():
            res["seq"] = teng.classify_batch("intent", MIXED_TEXTS)

        def tok():
            res["tok"] = [teng.token_classify("pii", t) for t in MIXED_TEXTS]

        threads = [threading.Thread(target=seq), threading.Thread(target=tok)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert len(res["seq"]) == len(MIXED_TEXTS)
        assert all(hasattr(r, "entities") for r in res["tok"])

    def test_step_span_carries_packing_attributes(self, pair):
        _, teng = pair
        tracer = Tracer(sample_rate=1.0)
        with tracer.span("router.route"):
            teng.classify_batch("intent", MIXED_TEXTS)
        steps = [s for s in tracer.spans("batch.execute")
                 if s.attributes.get("packing.packed")]
        assert steps, "no packed step span"
        a = steps[0].attributes
        assert a["packing.segments"] >= 2 and a["packing.rows"] >= 1
        assert 0 < a["packing.token_fill"] <= 1


@pytest.mark.parametrize("kernels", [
    {"epilogue": {"enabled": True}},
    {"bgmv": {"enabled": True, "min_tasks": 2}},
    {"epilogue": {"enabled": True}, "bgmv": {"enabled": True,
                                             "min_tasks": 2}},
], ids=["epilogue", "bgmv", "both"])
def test_kernel_knobs_pack_like_jax(kernels):
    """Epilogue on and BGMV on (pairs over segments), their plain
    versions on the CPU: the packed port against the packed JAX engine."""
    jeng = _jax_engine(kernels)
    teng = _port_engine(jeng, kernels, metrics=fresh_series(),
                        runtime_stats=RuntimeStats(MetricsRegistry()))
    try:
        got = teng.classify_multi(TASKS, MIXED_TEXTS)
        want = jeng.classify_multi(TASKS, MIXED_TEXTS)
        for task in TASKS:
            for a, b in zip(got[task], want[task]):
                _close(a, b)
        rec = [s for s in teng.steps()
               if s.get("variant", "").startswith("packed:")]
        assert rec
        if "bgmv" in kernels:
            assert all(s["bgmv"] and s["padded_pairs"] >= s["pairs"]
                       >= len(TASKS) for s in rec)
            assert all(s["variant"].endswith(f":p{s['padded_pairs']}")
                       for s in rec)
        assert all(s["epilogue"] == ("epilogue" in kernels) for s in rec)
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_without_a_packing_block_the_port_packs_as_jax():
    """No ``engine.packing`` block: both engines pack a dense group."""
    cfg = load_config({"engine": {"seq_len_buckets": BUCKETS}})
    assert cfg.engine.packing_config() == JRouterConfig.from_dict(
        {"engine": {"seq_len_buckets": BUCKETS}}).engine.packing_config()
    eng = ttesting.make_shared_trunk_engine(
        device="cpu", engine_cfg=cfg.engine,
        runtime_stats=RuntimeStats(MetricsRegistry()))
    try:
        eng.classify_batch("intent", MIXED_TEXTS)
        assert "packed" in _variants(eng)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# the scheduler, truncation and counters


class TestSchedulerAndCounters:
    def test_single_item_stays_unpacked(self):
        eng = _port_engine(runtime_stats=RuntimeStats(MetricsRegistry()))
        try:
            eng.classify("intent", "solo request")
            eng.classify_batch("intent", ["hot"] * 4)   # one unique row
            assert "packed" not in _variants(eng)
            assert "fused" in _variants(eng)
        finally:
            eng.shutdown()

    def test_overflow_clips_tags_and_counts_like_jax(self):
        long = " ".join(f"w{i}" for i in range(100))
        texts = [long, "short", "tiny", long + " x"]
        series = fresh_series()
        from semantic_router_tpu.observability.metrics import \
            MetricSeries as JSeries
        from semantic_router_tpu.observability.metrics import \
            MetricsRegistry as JRegistry

        jseries = JSeries(JRegistry())
        jeng = jtesting.make_shared_trunk_engine(
            engine_cfg=JEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                     seq_len_buckets=[32]),
            metrics=jseries)
        teng = ttesting.make_shared_trunk_engine(
            device="cpu", flax_params={n: t.params
                                       for n, t in jeng._tasks.items()},
            engine_cfg=InferenceEngineConfig(max_batch_size=8,
                                             max_wait_ms=1.0,
                                             seq_len_buckets=[32]),
            metrics=series)
        try:
            got = teng.classify_batch("intent", texts)
            want = jeng.classify_batch("intent", texts)
            assert [r.truncated for r in got] == [True, False, False, True]
            for a, b in zip(got, want):
                _close(a, b)
            assert series.bucket_overflows.get(task="intent") == \
                jseries.bucket_overflows.get(task="intent") >= 2
            assert series.packed_steps.get(group="trunk0") >= 1
        finally:
            jeng.shutdown()
            teng.shutdown()

    def test_tokenizer_truncation_flag_survives_packing(self):
        eng = _port_engine()
        try:
            long = " ".join(f"w{i}" for i in range(2000))  # > 512
            out = eng.classify_batch("intent", [long, "short", "tiny"])
            assert [r.truncated for r in out] == [True, False, False]
        finally:
            eng.shutdown()

    def test_counters_of_a_packed_step(self):
        series = fresh_series()
        eng = _port_engine(token=False, metrics=series,
                           kernels={"epilogue": {"enabled": True}})
        try:
            eng.classify_multi(TASKS, MIXED_TEXTS[:6])
            packed = series.packed_steps.get(group="trunk0")
            assert packed >= 1
            assert series.trunk_forwards.get(group="trunk0",
                                             path="fused") >= packed
            assert series.kernel_steps.get(group="trunk0",
                                           kernel="epilogue") >= packed
        finally:
            eng.shutdown()


def _payload(n_tokens: int):
    enc = HashTokenizer().encode(" ".join("w%d" % i
                                          for i in range(n_tokens - 2)))
    return SimpleNamespace(encoding=enc)


class TestContinuousAdmission:
    def test_next_step_composes_while_one_in_flight(self):
        release = threading.Event()
        seen = []
        overlap = {"max": 0, "cur": 0}
        lock = threading.Lock()

        def runner(key, items):
            with lock:
                overlap["cur"] += 1
                overlap["max"] = max(overlap["max"], overlap["cur"])
            seen.append(len(items))
            release.wait(2.0)
            with lock:
                overlap["cur"] -= 1
            return [None] * len(items)

        b = tpacking.PackingBatcher(
            runner, bucket_of=lambda k: 32, max_batch_size=4,
            max_wait_ms=500.0, dispatch_workers=4, enabled=True,
            max_inflight_steps=2)
        try:
            futs = [b.submit(("g", "t", 32), _payload(6))]
            time.sleep(0.05)
            futs += [b.submit(("g", "t", 32), _payload(6)) for _ in range(3)]
            deadline = time.time() + 1.0
            while len(seen) < 2 and time.time() < deadline:
                time.sleep(0.01)
            assert len(seen) >= 2 and overlap["max"] == 2
            release.set()
            for f in futs:
                f.result(timeout=2.0)
        finally:
            release.set()
            b.shutdown()

    def test_disabled_restores_base_composition(self):
        order = []

        def runner(key, items):
            order.append([id(i) for i in items])
            return [None] * len(items)

        b = tpacking.PackingBatcher(runner, bucket_of=lambda k: 32,
                                    max_batch_size=2, max_wait_ms=1.0,
                                    enabled=False)
        try:
            assert b._inflight_cap(("g", "t", 32)) == 1
            assert not b._ready_immediately(("g", "t", 32), [object()])
            futs = [b.submit(("g", "t", 32), _payload(4)) for _ in range(4)]
            for f in futs:
                f.result(timeout=2.0)
            flat = [x for batch in order for x in batch]
            assert flat == sorted(flat, key=flat.index)
            assert max(len(x) for x in order) <= 2
        finally:
            b.shutdown()

    def test_take_matches_jax_scheduler(self):
        """The same queue through both schedulers' take hook: the same
        batch and the same deferral ages."""
        from semantic_router_tpu.engine.batcher import BatchItem as JItem
        from semantic_router_tpu_torch.engine.batcher import BatchItem

        lens = _lengths(11, 30, 100)
        out = []
        for mod, item_cls in ((tpacking, BatchItem), (jpacking, JItem)):
            b = mod.PackingBatcher(lambda k, i: [None] * len(i),
                                   bucket_of=lambda k: 128,
                                   max_batch_size=4, enabled=True)
            try:
                items = [item_cls(_payload(n)) for n in lens]
                batch, rest = b._take_batch(("g", "t", 128), items)
                out.append(([items.index(x) for x in batch],
                            [it.deferred for it in items],
                            b._group_full(("g", "t", 128), rest)))
            finally:
                b.shutdown()
        assert out[0] == out[1]

    def test_concurrent_steps_of_one_group_agree(self):
        """Two steps of one (group, bucket) in flight at once, under more
        client threads than cores and a short switch interval: every
        result equals the same text classified alone."""
        import sys

        eng = _port_engine(token=False)
        texts = MIXED_TEXTS * 3
        try:
            alone = {t: eng.classify("intent", t) for t in MIXED_TEXTS}
            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                with ThreadPoolExecutor(max_workers=24) as pool:
                    got = list(pool.map(
                        lambda t: eng.classify("intent", t, timeout=60),
                        texts))
            finally:
                sys.setswitchinterval(old)
            for t, r in zip(texts, got):
                _close(r, alone[t], tol=1e-5)
            assert eng.batcher.stats()["items"] >= len(texts)
        finally:
            eng.shutdown()

    def test_configure_retunes_live(self):
        b = tpacking.PackingBatcher(lambda k, i: [None] * len(i),
                                    bucket_of=lambda k: 32, enabled=True)
        try:
            b.configure({"enabled": False, "max_segments_per_row": 16,
                         "max_inflight_steps": 3, "starvation_steps": 9,
                         "max_items_per_step": 12})
            assert b.enabled is False
            assert (b.max_segments_per_row, b.max_inflight_steps,
                    b.starvation_steps, b._item_budget()) == (16, 3, 9, 12)
        finally:
            b.shutdown()

    def test_engine_configure_packing_flips_live(self):
        eng = _port_engine(runtime_stats=RuntimeStats(MetricsRegistry()))
        try:
            eng.classify_batch("intent", MIXED_TEXTS)
            assert eng.packed_shape_census()["trunk0"]
            eng.configure_packing({"enabled": False})
            assert eng.batcher.enabled is False
            # the packed steps left the cache and the registries
            assert eng.packed_shape_census() == {"trunk0": []}
            assert "packed" not in _variants(eng)
            assert eng.trunk_group("intent").warm_hints
            eng.classify_batch("intent", MIXED_TEXTS)
            assert "packed" not in _variants(eng)
            eng.configure_packing({"enabled": True,
                                   "max_segments_per_row": 3})
            assert eng.batcher.max_segments_per_row == 3
            assert eng._autotuner.segments_floor == 3
            assert eng.warmup_packed_hot() > 0
            eng.classify_batch("intent", MIXED_TEXTS)
            assert "packed" in _variants(eng)
        finally:
            eng.shutdown()

    def test_demoted_bucket_stops_packing_live(self):
        eng = _port_engine(runtime_stats=RuntimeStats(MetricsRegistry()))
        try:
            tuner = eng._autotuner
            with tuner._lock:
                tuner._policy["trunk:trunk0"] = {
                    "blocked_buckets": BUCKETS}
                tuner._publish_locked()
            eng.classify_batch("intent", MIXED_TEXTS)
            assert "packed" not in _variants(eng)
            assert eng._packing_bucket_of(("__trunk__", "trunk0", 32)) \
                is None
        finally:
            eng.shutdown()


# ---------------------------------------------------------------------------
# the auto-tuner: the same policies as JAX's on the same snapshots


class _Stats:
    def __init__(self, programs):
        self._programs = programs

    def programs(self):
        return self._programs


def _prog(bucket, variant, executes, secs, rows, fill=None, segs=None):
    p = {"group": "trunk:trunk0", "bucket": bucket, "variant": variant,
         "executes": executes, "execute_s_total": secs, "rows_real": rows}
    if fill is not None:
        p["token_fill_ratio"] = fill
    if segs is not None:
        p["segments_real"] = segs
    return p


TUNER_CASES = {
    "low_fill_at_cap": [_prog(128, "packed", 100, 1.0, 100, 0.4, 800)],
    "light_traffic": [_prog(128, "packed", 100, 1.0, 100, 0.4, 400)],
    "high_fill": [_prog(128, "packed", 100, 1.0, 100, 0.92, 400)],
    "losing_bucket": [_prog(512, "packed", 100, 10.0, 100, 0.9, 100),
                      _prog(512, "fused", 100, 1.0, 100)],
    "winning_bucket": [_prog(512, "packed", 100, 1.0, 100, 0.9, 400),
                       _prog(512, "fused", 100, 1.0, 100)],
    "min_samples": [_prog(128, "packed", 3, 1.0, 3, 0.1, 6)],
    "packed_only": [_prog(512, "packed", 100, 50.0, 100, 0.9, 100)],
    "two_buckets": [_prog(128, "packed", 100, 1.0, 100, 0.3, 900),
                    _prog(512, "packed", 100, 1.0, 100, 0.3, 900),
                    _prog(512, "fused", 60, 0.01, 60)],
}


@pytest.mark.parametrize("case", sorted(TUNER_CASES))
def test_tuner_policy_equals_jax(case):
    kw = dict(target_fill=0.85, min_samples=50, segments_floor=8,
              max_segments_cap=32, unblock_after_steps=2)
    t = tpacking.ShapeAutoTuner(_Stats(TUNER_CASES[case]), None, **kw)
    j = jpacking.ShapeAutoTuner(_Stats(TUNER_CASES[case]), None, **kw)
    for n in range(4):
        if n == 2:   # no fresh samples: only the demotion leases age
            t.runtime_stats = j.runtime_stats = _Stats([])
        assert t.step() == j.step()
        assert (t.retunes, t.steps) == (j.retunes, j.steps)
        for b in (128, 512):
            assert t.blocked("trunk:trunk0", b) == j.blocked("trunk:trunk0",
                                                              b)
    assert t.report() == j.report()


def test_tuner_thread_starts_and_stops():
    t = tpacking.ShapeAutoTuner(_Stats([]), None)
    t.start(interval_s=0.5)
    try:
        assert t._thread is not None and t._thread.is_alive()
    finally:
        t.stop()
    assert t._thread is None


# ---------------------------------------------------------------------------
# knobs, the report and the packed warmup


@pytest.mark.parametrize("block", [
    {}, None, {"enabled": False}, {"max_segments_per_row": "junk"},
    {"min_segments": 1, "max_inflight_steps": 0, "starvation_steps": -3},
    {"max_items_per_step": "7", "autotune": {"target_fill": 9.0}},
    {"autotune": {"interval_s": 0.1, "min_samples": 0,
                  "max_segments_cap": None, "enabled": False}},
    {"autotune": "junk", "enabled": 0},
], ids=lambda b: str(b)[:40])
def test_normalize_packing_equals_jax(block):
    assert tpacking.normalize_packing(block) == \
        jpacking.normalize_packing(block)


def test_config_carries_packing_like_jax():
    d = {"engine": {"packing": {"enabled": True, "starvation_steps": 7,
                                "autotune": {"enabled": False}}}}
    t, j = load_config(d), JRouterConfig.from_dict(d)
    assert t.engine.packing == j.engine.packing
    assert t.engine.packing_config() == j.engine.packing_config()
    assert t.engine.packing_config()["starvation_steps"] == 7


def test_packing_report_has_jax_keys(pair):
    jeng, teng = pair
    got, want = teng.packing_report(), jeng.packing_report()
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
    assert got["knobs"] == want["knobs"]
    assert got["scheduler"] == want["scheduler"]


class TestPackedWarmup:
    def _cold(self, rs) -> int:
        return sum(p["compiles"] for p in rs.programs()
                   if p["variant"] == "packed")

    @staticmethod
    def _classify_held(eng, task, texts):
        """``classify_batch`` with the batcher's picker held until every
        item is queued, so each call composes the same steps however the
        submitting thread is scheduled."""
        b = eng.batcher
        b._ready_group = lambda: None
        b._next_deadline = lambda: None
        try:
            futs = [eng.classify_async(task, t) for t in texts]
            assert b.queue_depths()["pending_items"] == len(texts)
        finally:
            del b._ready_group, b._next_deadline
            with b._wake:
                b._wake.notify_all()
        return [f.result(timeout=30) for f in futs]

    def test_census_records_packed_shapes(self):
        eng = _port_engine(runtime_stats=RuntimeStats(MetricsRegistry()))
        try:
            eng.classify_batch("intent", MIXED_TEXTS)
            rows = [r for rs in eng.packed_shape_census().values()
                    for r in rs]
            assert rows
            for bucket, k_pad, padded_rows, flavor, _pairs in rows:
                assert bucket in BUCKETS and k_pad >= 2
                assert padded_rows >= 1 and flavor in ("seq", "tok", "both")
        finally:
            eng.shutdown()

    def test_cold_count_flat_after_kernel_flip_warmup(self):
        rs = RuntimeStats(MetricsRegistry())
        eng = _port_engine(runtime_stats=rs)
        try:
            self._classify_held(eng, "intent", MIXED_TEXTS)
            assert self._cold(rs) > 0
            eng.configure_kernels({"epilogue": {"enabled": True}})
            assert eng.warmup_packed_hot() > 0
            before = self._cold(rs)
            self._classify_held(eng, "intent", MIXED_TEXTS)
            assert self._cold(rs) == before
        finally:
            eng.shutdown()

    def test_warmup_idempotent(self):
        eng = _port_engine()
        try:
            eng.classify_batch("intent", MIXED_TEXTS)
            assert eng.warmup_packed_hot() == eng.warmup_packed_hot() > 0
        finally:
            eng.shutdown()

    def test_warmup_runs_the_entry_shape(self):
        eng = _port_engine(kernels={"bgmv": {"enabled": True,
                                             "min_tasks": 2}})
        try:
            eng.warmup(buckets=[32])
            census = eng.packed_shape_census()["trunk0"]
            assert {(32, 2, 1, f, 2 if f != "tok" else 0)
                    for f in ("seq", "tok", "both")} <= set(census)
        finally:
            eng.shutdown()

    def test_apply_packing_knobs_starts_warms_and_stops(self):
        rs = RuntimeStats(MetricsRegistry())
        eng = _port_engine(runtime_stats=rs)
        try:
            eng.classify_batch("intent", MIXED_TEXTS)
            cfg = load_config({"engine": {"packing": {
                "enabled": True, "max_inflight_steps": 3,
                "autotune": {"enabled": True, "interval_s": 1.0}}}})
            apply_packing_knobs(cfg, eng)
            assert eng.batcher.max_inflight_steps == 3
            assert eng._autotuner._thread.is_alive()
            apply_packing_knobs(load_config({"engine": {"packing": {
                "enabled": False}}}), eng)
            assert eng.batcher.enabled is False
            assert eng._autotuner._thread is None
        finally:
            eng.shutdown()
        assert eng._autotuner._thread is None

    def test_shutdown_stops_the_tuner(self):
        eng = _port_engine()
        apply_packing_knobs(load_config({}), eng)
        assert eng._autotuner._thread.is_alive()
        eng.shutdown()
        assert eng._autotuner._thread is None


def test_padding_waste_drops_under_a_short_prompt_mix():
    """The measured token-level padding waste of the packed scheduler is
    below half the fixed-row batching's on a short-prompt mix, and every
    request resolves."""
    rng = np.random.default_rng(0)
    words = "alpha beta gamma delta epsilon zeta eta theta".split()
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 25))))
             for _ in range(48)]
    waste = {}
    for label, knobs in (("packed", {"enabled": True}),
                         ("padded", {"enabled": False})):
        rs = RuntimeStats(MetricsRegistry())
        eng = _port_engine(token=False, packing=knobs, runtime_stats=rs)
        try:
            for _ in range(2):
                assert len(eng.classify_batch("intent", texts)) == len(texts)
            progs = [p for p in rs.programs()
                     if p["group"].startswith("trunk:")]
            real = sum(p.get("tokens_real", 0) for p in progs)
            padded = sum(p.get("tokens_padded", 0) for p in progs)
            waste[label] = 1.0 - real / padded
        finally:
            eng.shutdown()
    assert waste["packed"] < 0.5 * waste["padded"], waste
