"""Batch tracing (observability.batchtrace) through the port's engine
against the JAX engine on the same weights, on the CPU: the same requests
at sample rates 0, 0.1 and 1.0 give each request the same span names,
parentage and links (``batch.wait`` / ``batch.tokenize`` / ``batch.ride``
linked to a ``batch.execute`` step span, and on a sampled trace the
stage spans under the ride), the same step attributes, detailed
trunk / head stages only under the reference's gate (seq flavor, quant
off, no epilogue, no BGMV), and on the detailed path probabilities within
1e-4 of the fused step's."""

import re

import pytest

from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.observability import tracing as jtracing
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.observability import tracing as ttracing

PROB_TOL = 1e-4
PII = ("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS", "B-PERSON",
               "I-PERSON"])
SEQ = [name for name, _ in jtesting.SHARED_TRUNK_TASKS]
TEXT = "trace this request through the batcher, jane@example.com"
# rightmost 8 hex digits over 0xFFFFFFFF: in a 0.1 ratio, and out of it
SAMPLED_AT_01 = "ab" * 12 + "00000010"
UNSAMPLED_AT_01 = "ab" * 12 + "f0000000"
# attributes of the batch.execute step span (stage timings apart)
STEP_KEYS = ("group", "bucket", "kind", "batch_size", "padded_rows",
             "real_rows", "fill_ratio", "task_mix")


@pytest.fixture(scope="module")
def fused():
    jeng = jtesting.make_shared_trunk_engine(token_tasks=[PII], seed=5)
    teng = ttesting.make_shared_trunk_engine(
        token_tasks=[PII], device="cpu",
        flax_params={n: t.params for n, t in jeng._tasks.items()})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


@pytest.fixture(scope="module")
def pertask():
    jeng = jtesting.make_test_engine(seed=4)
    teng = ttesting.make_test_engine(
        device="cpu",
        flax_params={n: t.params for n, t in jeng._tasks.items()})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _traced(tracing, engine, call, rate, trace_id):
    """Run ``call(engine)`` under a ``router.route`` span of a fresh
    tracer at ``rate``: (result, the trace's span tree, step spans)."""
    t = tracing.Tracer(sample_rate=rate)
    with t.span("router.route", trace_id=trace_id) as root:
        out = call(engine)
    spans = t.trace(trace_id)
    by_id = {s.span_id: s for s in spans}
    steps = {(s.trace_id, s.span_id): s for s in t.spans("batch.execute")}
    tree = []
    for s in spans:
        parent = by_id.get(s.parent_id)
        links = []
        for link in s.links:
            step = steps[(link["trace_id"], link["span_id"])]
            links.append(step.name)
        tree.append((s.name, parent.name if parent else "", tuple(links)))
    linked = [steps[(k["trace_id"], k["span_id"])]
              for s in spans for k in s.links]
    assert root.span_id in by_id
    return out, sorted(tree), linked


def _step_attrs(step):
    a = {k: step.attributes.get(k) for k in STEP_KEYS}
    a["group"] = re.sub(r"\d+", "N", a["group"])
    a["stages"] = sorted(k for k in step.attributes
                         if k.startswith("stage."))
    return a


CALLS = {
    "seq": lambda e: e.classify_multi(SEQ, [TEXT]),
    "tok": lambda e: e.token_classify("pii", TEXT),
}


@pytest.mark.parametrize("rate, trace_id", [
    (0.0, UNSAMPLED_AT_01), (0.1, UNSAMPLED_AT_01), (0.1, SAMPLED_AT_01),
    (1.0, SAMPLED_AT_01)])
@pytest.mark.parametrize("flavor", ["seq", "tok"])
def test_fused_spans_match_jax(fused, rate, trace_id, flavor):
    jeng, teng = fused
    _, jtree, jsteps = _traced(jtracing, jeng, CALLS[flavor], rate,
                               trace_id)
    _, ttree, tsteps = _traced(ttracing, teng, CALLS[flavor], rate,
                               trace_id)
    assert ttree == jtree
    assert [_step_attrs(s) for s in tsteps] == \
        [_step_attrs(s) for s in jsteps]
    names = {n for n, _, _ in ttree}
    assert {"router.route", "batch.wait", "batch.tokenize",
            "batch.ride"} <= names
    sampled = rate >= 1.0 or (rate > 0 and trace_id == SAMPLED_AT_01)
    detailed = sampled and flavor == "seq"
    assert ("batch.trunk_forward" in names) == detailed
    assert ("batch.head_matmul" in names) == detailed
    assert ("batch.stack" in names) == sampled
    if detailed:
        assert ("batch.trunk_forward", "batch.ride", ()) in ttree


def test_detailed_step_matches_the_fused_step(fused):
    """The sampled seq step runs as two eager calls (trunk, heads): its
    probabilities against the fused step's, and against the JAX detailed
    step's, within 1e-4; the engine records it as ``fused_detailed``."""
    jeng, teng = fused
    plain = teng.classify_multi(SEQ, [TEXT])
    n0 = len(teng.steps())
    got, _, _ = _traced(ttracing, teng, CALLS["seq"], 1.0, SAMPLED_AT_01)
    want, _, _ = _traced(jtracing, jeng, CALLS["seq"], 1.0, SAMPLED_AT_01)
    (step,) = teng.steps()[n0:]
    assert step["graph"] == "eager" and step["flavor"] == "seq"
    rs = {p["variant"] for p in teng._runtime_stats.programs()
          if p["group"].startswith("trunk:")}
    assert "fused_detailed" in rs
    for task in SEQ:
        a, b, c = got[task][0], plain[task][0], want[task][0]
        assert a.label == b.label == c.label
        for k in a.probs:
            assert abs(a.probs[k] - b.probs[k]) <= PROB_TOL
            assert abs(a.probs[k] - c.probs[k]) <= PROB_TOL


@pytest.mark.parametrize("knob", ["epilogue", "bgmv"])
def test_no_detailed_step_with_a_kernel_knob(fused, knob):
    """The reference's gate: a live epilogue or BGMV knob keeps the
    sampled seq step fused (no trunk / head stages), on both engines."""
    jeng, teng = fused
    block = {knob: {"enabled": True, **({"min_tasks": 1}
                                        if knob == "bgmv" else {})}}
    for eng in (jeng, teng):
        eng.configure_kernels(block)
    try:
        trees = [_traced(mod, eng, CALLS["seq"], 1.0, SAMPLED_AT_01)[1]
                 for mod, eng in ((jtracing, jeng), (ttracing, teng))]
    finally:
        for eng in (jeng, teng):
            eng.configure_kernels({})
    assert trees[0] == trees[1]
    names = {n for n, _, _ in trees[1]}
    assert "batch.ride" in names and "batch.trunk_forward" not in names


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_pertask_spans_match_jax(pertask, rate):
    jeng, teng = pertask
    def call(e):
        return e.classify("intent", TEXT)

    _, jtree, jsteps = _traced(jtracing, jeng, call, rate, SAMPLED_AT_01)
    _, ttree, tsteps = _traced(ttracing, teng, call, rate, SAMPLED_AT_01)
    assert ttree == jtree
    assert [_step_attrs(s) for s in tsteps] == \
        [_step_attrs(s) for s in jsteps]
    names = {n for n, _, _ in ttree}
    assert ("batch.trunk_forward" in names) == (rate == 1.0)


def test_untraced_requests_emit_no_spans(fused):
    _, teng = fused
    t = ttracing.Tracer(sample_rate=1.0)
    teng.classify_multi(SEQ, [TEXT])
    assert t.spans() == []
    assert ttracing.active_span() is None


def test_batch_series_and_step_view(fused):
    """Each batch feeds the queue-wait / fill-ratio series with the trace
    id as exemplar; ``steps()`` keeps its keys as a view of the
    runtime-stats record."""
    from semantic_router_tpu_torch.observability.metrics import \
        default_series

    _, teng = fused
    before = default_series.batcher_fill_ratio.count(
        batcher=teng.batcher.name)
    _traced(ttracing, teng, CALLS["seq"], 0.0, UNSAMPLED_AT_01)
    assert default_series.batcher_fill_ratio.count(
        batcher=teng.batcher.name) == before + 1
    assert teng.batcher.stats()["observe_errors"] == 0
    step = teng.steps()[-1]
    assert set(step) == {"group", "bucket", "flavor", "rows", "padded_rows",
                         "quant", "epilogue", "bgmv", "pairs",
                         "padded_pairs", "seconds", "graph"}
