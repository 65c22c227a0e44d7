"""The port's observability modules against the JAX package's, on the same
call sequences, on the CPU: tracing (W3C extract / inject, the trace-id
ratio, the ring, force-sampling, links), metrics (byte-equal expositions
with exemplars off and on, snapshot / merge, every canonical series),
the flight recorder (the same slowest-N and breach sets), decision records
(equal but for ids and times, schema-clean), runtime stats (the same
EWMAs and cold / warm split), the program catalog (a closed-form count for
a tiny ModernBERT step, the same whether the kernels' wrappers or the
plain versions run, no TPU tier, the CPU tier flagged), the profiler and
the registry's isolation."""

import copy
import re
import time

import numpy as np
import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.observability import explain as jexplain
from semantic_router_tpu.observability import flightrec as jflightrec
from semantic_router_tpu.observability import metrics as jmetrics
from semantic_router_tpu.observability import runtimestats as jruntimestats
from semantic_router_tpu.observability import tracing as jtracing
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import \
    ModernBertForSequenceClassification
from semantic_router_tpu_torch.observability import explain as texplain
from semantic_router_tpu_torch.observability import flightrec as tflightrec
from semantic_router_tpu_torch.observability import metrics as tmetrics
from semantic_router_tpu_torch.observability import programstats
from semantic_router_tpu_torch.observability import runtimestats as \
    truntimestats
from semantic_router_tpu_torch.observability import tracing as ttracing
from semantic_router_tpu_torch.observability.profiler import \
    ProfilerControl, XLA_DUMP_UNSUPPORTED, trace_span
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.runtime import RuntimeRegistry

# -- tracing -------------------------------------------------------------------

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
HEADERS = [
    {"traceparent": f"00-{TRACE}-00f067aa0ba902b7-01"},
    {"traceparent": f"00-{TRACE}-00F067AA0BA902B7-01"},     # uppercase
    {"traceparent": f"00-{'0' * 32}-00f067aa0ba902b7-01"},  # zero trace
    {"traceparent": f"00-{TRACE}-{'0' * 16}-01"},           # zero parent
    {"traceparent": f"00-{TRACE[:-1]}-00f067aa0ba902b7-01"},
    {"traceparent": "garbage"},
    {},
]


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_extract_matches_jax(i):
    jt, jp = jtracing.Tracer.extract(HEADERS[i])
    tt, tp = ttracing.Tracer.extract(HEADERS[i])
    assert tp == jp
    if jp:  # a valid member continues its trace on both
        assert tt == jt == TRACE
    else:  # a malformed one restarts it with fresh valid ids
        assert re.fullmatch(r"[0-9a-f]{32}", tt) and tt != "0" * 32


def test_inject_matches_jax():
    jh, th = {}, {}
    jtracing.Tracer.inject(TRACE, "00f067aa0ba902b7", jh)
    ttracing.Tracer.inject(TRACE, "00f067aa0ba902b7", th)
    assert th == jh
    assert ttracing.Tracer.extract(th) == (TRACE, "00f067aa0ba902b7")


def test_trace_id_in_ratio_matches_jax():
    rng = np.random.default_rng(0)
    ids = ["".join(rng.choice(list("0123456789abcdef"), 32))
           for _ in range(200)] + ["xyz", "", "f" * 32]
    for rate in (0.0, 0.1, 0.5, 0.999, 1.0):
        for tid in ids:
            for default in (True, False):
                assert ttracing.trace_id_in_ratio(tid, rate, default) \
                    == jtracing.trace_id_in_ratio(tid, rate, default)


def _drive_tracer(mod):
    """The same call sequence on one package's Tracer: nested spans, a
    recorded span with a link, a bounded ring, force-sampling."""
    t = mod.Tracer(capacity=5, force_capacity=3)
    with t.span("root", trace_id=TRACE, a=1) as root:
        assert mod.active_span() == (t, root)
        with t.span("child") as child:
            child.set(b=2)
        for i in range(6):
            with t.span(f"leaf{i}"):
                pass
    rec = mod.Span("external", "f" * 32, "e" * 16)
    rec.add_link(TRACE, root.span_id)
    t.record(rec)
    for tid in ("a", "b", "c", "d"):
        t.force_sample(tid)
    return t, root, child


def test_tracer_ring_links_and_force_sampling_match_jax():
    jt, jroot, jchild = _drive_tracer(jtracing)
    tt, troot, tchild = _drive_tracer(ttracing)
    assert [s.name for s in tt.spans()] == [s.name for s in jt.spans()]
    assert len(tt.spans()) == 5
    assert tchild.parent_id == troot.span_id and tchild.trace_id == TRACE
    assert tchild.attributes == jchild.attributes
    (tl,), (jl,) = tt.spans("external"), jt.spans("external")
    assert tl.links == [{"trace_id": TRACE, "span_id": troot.span_id}]
    assert len(jl.links) == 1
    for tid in ("a", "b", "c", "d"):
        assert tt.is_force_sampled(tid) == jt.is_force_sampled(tid)
    assert not tt.is_force_sampled("a") and tt.is_force_sampled("d")
    assert ttracing.active_span() is None


def test_active_span_crosses_tracers():
    a, b = ttracing.Tracer(), ttracing.Tracer()
    with a.span("outer") as outer:
        with b.span("inner", trace_id=outer.trace_id,
                    parent_id=outer.span_id) as inner:
            assert ttracing.active_span() == (b, inner)
        assert ttracing.active_span() == (a, outer)


# -- metrics -------------------------------------------------------------------

def _drive_metrics(mod, exemplars: bool):
    reg = mod.MetricsRegistry()
    reg.enable_exemplars(exemplars)
    c = reg.counter("llm_test_requests_total", "Requests\nby model")
    g = reg.gauge("llm_test_depth", "Queue depth")
    h = reg.histogram("llm_test_latency_seconds", "Latency",
                      buckets=(0.01, 0.1, 1.0))
    c.inc(model="a")
    c.inc(2.5, model="b")
    g.set(7, batcher="x")
    g.set(3, batcher="y")
    for v, tid in ((0.005, TRACE), (0.05, None), (0.5, "ab" * 16), (3.0,
                                                                   TRACE)):
        h.observe(v, exemplar=tid, route="r")
    return reg


@pytest.mark.parametrize("exemplars", [False, True])
def test_exposition_is_byte_equal_to_jax(monkeypatch, exemplars):
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    j = _drive_metrics(jmetrics, exemplars).expose()
    t = _drive_metrics(tmetrics, exemplars).expose()
    assert t == j
    assert ("# {trace_id=" in t) == exemplars


def test_snapshot_and_merge_match_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    jsnap = _drive_metrics(jmetrics, False).snapshot()
    tsnap = _drive_metrics(tmetrics, False).snapshot()
    assert tmetrics.encode_snapshot(tsnap) == jmetrics.encode_snapshot(jsnap)
    jm, tm = _drive_metrics(jmetrics, False), _drive_metrics(tmetrics, False)
    jm.merge_snapshot(jsnap)
    tm.merge_snapshot(tsnap)
    assert tm.expose() == jm.expose()
    assert tmetrics.decode_snapshot(tmetrics.encode_snapshot(tsnap)) \
        == tsnap


def test_canonical_series_match_jax():
    """Every series of the reference's MetricSeries: name, kind, help and
    (histograms) bucket edges."""
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    jmetrics.MetricSeries(jreg)
    tmetrics.MetricSeries(treg)
    assert treg.families() == jreg.families()
    assert len(treg.families()) >= 33
    for name, kind, _help in treg.families():
        if kind == "histogram":
            assert tuple(treg.find(name).buckets) \
                == tuple(jreg.find(name).buckets), name


def test_histogram_percentiles_match_jax():
    jh = jmetrics.Histogram("x", "", buckets=(0.01, 0.1, 1.0, 10.0))
    th = tmetrics.Histogram("x", "", buckets=(0.01, 0.1, 1.0, 10.0))
    for v in np.random.default_rng(1).exponential(0.3, 200):
        jh.observe(float(v), k="a")
        th.observe(float(v), k="a")
    for p in (50, 90, 99):
        assert th.percentile(p, k="a") == jh.percentile(p, k="a")
    assert th.summary() == jh.summary()


# -- flight recorder -----------------------------------------------------------

def _drive_flightrec(mod, tracing_mod):
    fr = mod.FlightRecorder(slowest_n=3, threshold_s=0.5, breach_capacity=2)
    rng = np.random.default_rng(2)
    retained = []
    for i, d in enumerate(rng.uniform(0.0, 1.0, 12)):
        span = tracing_mod.Span(f"router.route", f"{i:032x}", f"{i:016x}")
        retained.append(fr.consider(f"req-{i}", f"{i:032x}", float(d),
                                    lambda s=span: [s], meta={"i": i}))
    return fr, retained


def test_flight_recorder_keeps_the_same_requests_as_jax():
    jfr, jkept = _drive_flightrec(jflightrec, jtracing)
    tfr, tkept = _drive_flightrec(tflightrec, ttracing)
    assert tkept == jkept
    jd, td = jfr.dump(), tfr.dump()
    for part in ("slowest", "breaches"):
        assert [(r["request_id"], r["duration_s"], r["meta"])
                for r in td[part]] == \
            [(r["request_id"], r["duration_s"], r["meta"])
             for r in jd[part]]
        assert all(r["spans"][0]["name"] == "router.route"
                   for r in td[part])
    assert (td["considered"], td["retained"]) == \
        (jd["considered"], jd["retained"])
    tfr.configure(slowest_n=1)
    assert len(tfr.dump()["slowest"]) == 1


def test_retention_force_samples_the_trace():
    tracer = ttracing.Tracer(sample_rate=0.0)
    fr = tflightrec.FlightRecorder(slowest_n=1)
    fr.on_retain = tracer.force_sample
    fr.consider("r", TRACE, 1.0, lambda: [])
    assert tracer.is_force_sampled(TRACE)


# -- decision records ----------------------------------------------------------

HEURISTIC_CFG = {
    "default_model": "base",
    "routing": {
        "strategy": "priority",
        "modelCards": [{"name": m} for m in ("base", "coder", "fast")],
        "signals": {"keywords": [
            {"name": "code", "keywords": ["code", "debug"]},
            {"name": "urgent", "keywords": ["urgent", "asap"]}]},
        "decisions": [
            {"name": "urgent_route", "priority": 20,
             "rules": {"operator": "AND", "conditions": [
                 {"type": "keyword", "name": "urgent"},
                 {"operator": "NOT", "conditions": [
                     {"type": "keyword", "name": "code"}]}]},
             "modelRefs": [{"model": "fast"}]},
            {"name": "code_route", "priority": 10,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "code"}]},
             "modelRefs": [{"model": "coder"}],
             "plugins": [{"type": "fast_response", "configuration": {
                 "enabled": False}}]}]},
    "observability": {"decisions": {"redact_pii": False}},
}
QUERIES = ["urgent: answer asap", "please debug this code", "hello there",
           "urgent code review"]
# per-record fields that are ids or times
VOLATILE = ("record_id", "trace_id", "ts_unix", "routing_latency_ms")


def _records(router_cls, cfg, explain_mod):
    ex = explain_mod.DecisionExplainer()
    router = router_cls(cfg, explain=ex)
    try:
        for i, q in enumerate(QUERIES):
            router.route({"model": "auto",
                          "messages": [{"role": "user", "content": q}]},
                         {"x-vsr-request-id": f"req-{i}"})
    finally:
        router.shutdown()
    return [ex.get(r["record_id"]) for r in reversed(ex.list(limit=10))]


def _stable(rec):
    rec = copy.deepcopy(rec)
    for k in VOLATILE:
        rec.pop(k)
    for row in rec["signals"].values():
        row.pop("latency_ms")
    return rec


def test_decision_records_match_jax():
    j = _records(JRouter, JRouterConfig.from_dict(copy.deepcopy(
        HEURISTIC_CFG)), jexplain)
    t = _records(Router, load_config(copy.deepcopy(HEURISTIC_CFG)),
                 texplain)
    assert len(t) == len(j) == len(QUERIES)
    for got, want in zip(t, j):
        assert texplain.validate_record(got) == []
        assert jexplain.validate_record(got) == []
        assert _stable(got) == _stable(want)


def test_explainer_ring_and_knobs_match_jax():
    def drive(mod):
        ex = mod.DecisionExplainer(ring_size=2)
        for i in range(3):
            d = mod.RecordDraft(f"{i:032x}", f"r{i}")
            rec = d.finish(kind="route", model=f"m{i}", latency_ms=1.0,
                           query="q", redact_pii=True)
            ex.commit(rec)
        ex.configure({"sample_rate": "bad", "ring_size": 1})
        return ex

    j, t = drive(jexplain), drive(texplain)
    assert t.stats() == j.stats()
    assert [r["model"] for r in t.list()] == [r["model"] for r in j.list()]
    assert t.get(f"{2:032x}")["model"] == "m2"
    assert t.begin(TRACE, "x") is not None
    t.configure({"sample_rate": 0.0})
    assert t.begin(TRACE, "x") is None


def test_durable_mirror_serves_records(tmp_path):
    from semantic_router_tpu_torch.observability.explain_store import \
        SQLiteDecisionStore

    ex = texplain.DecisionExplainer()
    store = SQLiteDecisionStore(str(tmp_path / "d.db"))
    ex.attach_durable(store)
    try:
        rec = texplain.RecordDraft(TRACE, "r").finish(
            kind="route", model="m", latency_ms=1.0, query="",
            redact_pii=True)
        rid = ex.commit(rec)
        assert store.get(rid)["model"] == "m"
        assert store.get(TRACE)["record_id"] == rid
        assert len(store) == 1 and store.list(model="m")[0]["record_id"] \
            == rid
    finally:
        ex.attach_durable(None)


# -- runtime stats -------------------------------------------------------------

STEPS = [("trunk:g0", 128, "fused", 3, 4, 0.50, True, 300, 512),
         ("trunk:g0", 128, "fused", 4, 4, 0.020, False, 400, 512),
         ("trunk:g0", 128, "fused", 1, 1, 0.010, False, 90, 128),
         ("trunk:g0", 128, "fused_detailed", 2, 2, 0.030, False, 200, 256),
         ("task:emb", 512, "split", 5, 8, 0.25, True, 0, 0),
         ("task:emb", 512, "split", 8, 8, 0.015, False, 0, 0),
         ("task:emb", 512, "split", 7, 8, 0.012, False, 0, 0)]


def _drive_runtime(mod):
    rs = mod.RuntimeStats(_metrics_of(mod)())
    for g, b, v, r, p, s, c, tr, tp in STEPS:
        rs.record_step(g, b, v, r, p, s, compiled=c, tokens_real=tr,
                       tokens_padded=tp, segments=r if tp else 0)
    for fam, s in (("domain", 0.01), ("domain", 0.03), ("pii", 0.02)):
        rs.note_family_cost(fam, s)
    return rs


def _metrics_of(mod):
    return (jmetrics if mod is jruntimestats else tmetrics).MetricsRegistry


def test_runtime_stats_match_jax():
    j, t = _drive_runtime(jruntimestats), _drive_runtime(truntimestats)
    assert t.programs() == j.programs()
    assert t.family_costs() == j.family_costs()
    for name in ("step_rows", "step_tokens", "compile_steps"):
        assert getattr(t, name).values() == getattr(j, name).values()
    assert t.step_seconds.totals() == j.step_seconds.totals()
    assert t.compile_seconds.totals() == j.compile_seconds.totals()
    emb = next(p for p in t.programs() if p["group"] == "task:emb")
    assert (emb["compiles"], emb["executes"]) == (1, 2)
    assert emb["execute_ewma_s"] == pytest.approx(
        0.2 * 0.012 + 0.8 * 0.015)
    assert t.retire(group="task:emb") == j.retire(group="task:emb") == 1


def test_step_log_and_device_rows():
    rs = truntimestats.RuntimeStats(tmetrics.MetricsRegistry(), max_steps=2)
    a, b = object(), object()
    for i in range(3):
        rs.record_step("g", 1, "fused", 1, 1, 0.1, detail={"i": i},
                       source=a)
    rs.record_step("g", 1, "fused", 1, 1, 0.1, detail={"i": 9}, source=b)
    assert rs.steps(a) == [{"i": 1}, {"i": 2}] and rs.steps(b) == [{"i": 9}]
    rs.drop_steps(a)
    assert rs.steps(a) == []

    class Dev:
        id, platform = 3, "gpu"

        @staticmethod
        def memory_stats():
            return {"bytes_in_use": 10, "bytes_limit": 100,
                    "peak_bytes_in_use": 20}

    jrs = jruntimestats.RuntimeStats(jmetrics.MetricsRegistry())
    assert rs.device_memory_row(Dev()) == jrs.device_memory_row(Dev())
    assert rs.device_memory.values() == jrs.device_memory.values()
    rs.register_provider("b0", lambda: {"pending_items": 4})
    sample = rs.sample_process()
    assert sample["queues"] == {"b0": {"pending_items": 4.0}}
    assert sample["devices"] == []  # no card here


def test_sampler_starts_and_stops():
    rs = truntimestats.RuntimeStats(tmetrics.MetricsRegistry())
    try:
        rs.start(0.05)
        rs.record_step("g", 1, "fused", 1, 1, 0.1)
        deadline = time.time() + 5
        while not rs.programs() and time.time() < deadline:
            time.sleep(0.02)
        assert rs.report()["sampler_running"]
    finally:
        rs.stop()
    assert not rs.report(sample=False)["sampler_running"]


# -- program catalog -----------------------------------------------------------

B, S = 2, 16


def _closed_form(cfg, labels: int) -> float:
    """FLOPs of one ModernBERT sequence-classifier forward: the matmuls
    (QKV, the two [S, S] attention products, Wo, GeGLU Wi and Wo, the
    head dense and the classifier)."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    N = B * S
    layer = (2 * N * H * 3 * H + 4 * B * nh * S * S * hd + 2 * N * H * H
             + 2 * N * H * 2 * I + 2 * N * I * H)
    return cfg.num_hidden_layers * layer + 2 * B * H * H + 2 * B * H * labels


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_module_count_is_the_closed_form(impl):
    """``dense`` counts the plain SDPA's aten matmuls; ``flash`` runs the
    kernel's wrapper (its plain version here), whose ``cost`` stands in
    for them: the same number either way."""
    cfg = ttesting.tiny_config(3, attention_impl=impl)
    module = ModernBertForSequenceClassification(cfg).eval()
    ids = torch.randint(1, 100, (B, S))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, 11:] = 0
    with torch.inference_mode(), programstats.StepCost() as cost:
        module(ids, mask)
    assert cost.flops == _closed_form(cfg, 3)
    assert cost.bytes_accessed > 0
    if impl == "flash":
        k1 = cost.kernels["flash_attention"]
        assert k1["calls"] == cfg.num_hidden_layers
        assert k1["flops"] == cfg.num_hidden_layers * 4 * B * \
            cfg.num_attention_heads * S * S * cfg.head_dim


def _catalog_flops(epilogue: bool, impl: str) -> dict:
    from semantic_router_tpu_torch.config import InferenceEngineConfig

    ps = programstats.ProgramCatalog(tmetrics.MetricsRegistry())
    eng = ttesting.make_shared_trunk_engine(
        tasks=[("intent", ["a", "b", "c"]), ("jailbreak", ["x", "y"])],
        engine_cfg=InferenceEngineConfig(
            max_batch_size=4, max_wait_ms=1.0, seq_len_buckets=[16],
            kernels={"epilogue": {"enabled": epilogue}}),
        model_config={**ttesting.TINY, "attention_impl": impl},
        device="cpu", program_stats=ps,
        runtime_stats=truntimestats.RuntimeStats(ps.registry))
    try:
        eng.classify_multi(["intent", "jailbreak"], ["one two three"])
        return {(r.group, r.variant): r for r in ps.rows()}
    finally:
        eng.shutdown()


def test_step_count_does_not_depend_on_the_implementation():
    plain, kernels = _catalog_flops(False, "dense"), \
        _catalog_flops(True, "flash")
    assert plain.keys() == kernels.keys()
    for key in plain:
        assert kernels[key].flops == plain[key].flops > 0
        assert kernels[key].kernels == "epilogue"
        assert plain[key].kernels == "off"
    (row,) = kernels.values()
    assert set(row.kernel_costs) == {"flash_attention", "head_epilogue"}
    cfg = ttesting.tiny_config(3)
    # one row: the trunk (every term of the closed form is linear in B),
    # then a 2-head bank: dense, and the classifier padded to 3 labels
    H = cfg.hidden_size
    trunk = (_closed_form(cfg, 0) - 2 * B * H * H) // B
    assert row.flops == trunk + 2 * H * H * 2 + 2 * 2 * H * 3


def test_peak_table_holds_the_card_and_a_flagged_cpu_tier():
    tiers = [t["tier"] for _, t in programstats._PEAK_TIERS]
    assert tiers == ["h100-pcie", "h100-sxm"]
    assert not any("tpu" in t or "v5" in t or "v6" in t for t in tiers)
    assert programstats.peak_for("NVIDIA H100 80GB HBM3")["tier"] \
        == "h100-sxm"
    assert programstats.peak_for("NVIDIA H100 PCIe")["tier"] == "h100-pcie"
    cpu = programstats.peak_for("", "cpu")
    assert cpu["placeholder"] and "placeholder" in cpu["peak_note"]
    assert programstats.peak_for("TPU v5 lite")["placeholder"]


def test_catalog_joins_costs_with_runtime_stats():
    reg = tmetrics.MetricsRegistry()
    ps = programstats.ProgramCatalog(reg)
    ps.device = "cpu"
    rs = truntimestats.RuntimeStats(reg)
    with programstats.StepCost() as cost:
        torch.randn(64, 64) @ torch.randn(64, 64)
    ps.note_compile("trunk:g0", 128, "fused:seq", (4, 128), cost,
                    measured_variant="fused")
    for s in (0.01, 0.01):
        rs.record_step("trunk:g0", 128, "fused", 4, 4, s)
    out = ps.report(runtime_stats=rs)
    (row,) = out["programs"]
    assert row["flops"] == 2 * 64 ** 3
    assert out["device"]["placeholder"]
    assert 0 < row["roofline_fraction"] and row["bound"] in ("compute",
                                                             "memory")
    assert reg.find("llm_program_flops").values()
    assert ps.retire(group="trunk:g0") == 1
    assert not reg.find("llm_program_flops").values()


# -- profiler and registry -----------------------------------------------------

def test_profiler_writes_a_trace(tmp_path):
    p = ProfilerControl(str(tmp_path))
    try:
        assert p.start()["started"]
        assert p.start()["status"] == 409
        with trace_span("engine.classify.test"):
            torch.randn(8, 8) @ torch.randn(8, 8)
        out = p.stop()
    finally:
        if p.status()["running"]:
            p.stop(force=True)
    assert out["stopped"] and "trace.json" in out["files"]
    assert p.stop()["status"] == 409
    assert XLA_DUMP_UNSUPPORTED["status"] == 501


def test_isolated_registries_share_nothing():
    a, b = RuntimeRegistry.isolated(), RuntimeRegistry.isolated()
    for slot in ("metrics", "tracer", "profiler", "flightrec",
                 "runtimestats", "programstats", "explain"):
        assert getattr(a, slot) is not getattr(b, slot), slot
    a.metric_series().model_requests.inc(model="m", decision="d")
    assert "llm_model_requests_total{" in a.metrics.expose()
    assert "llm_model_requests_total{" not in b.metrics.expose()
    assert a.runtimestats.registry is a.metrics
    d = RuntimeRegistry.with_defaults()
    assert d.metrics is tmetrics.default_registry
    with pytest.raises(ValueError):
        RuntimeRegistry(nope=1)
