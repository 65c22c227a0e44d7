"""The dual-path engine against the JAX package's, on the CPU: the
``DualPathChooser`` choosing alike over one record sequence under every
strategy (cost priors included), and ``classify_multi`` on a JAX
``InferenceEngine`` and a port engine carrying the same seeded weights —
three LoRA-head classifiers on one trunk (the traditional path, a trunk
group) and the ``MultiTaskLoRAClassifier`` bank stacked from the same
weights (the stacked path).  Labels equal and probabilities within 1e-4
on both paths, between the paths and between the packages; the
fail-open on a failing stacked run, the deadline split, ``fused_covers``
and the dispatcher's prefetch reaching the bank alike."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.config.schema import \
    InferenceEngineConfig as JEngineConfig
from semantic_router_tpu.engine import pathing as jp
from semantic_router_tpu.engine.classify import InferenceEngine as JEngine
from semantic_router_tpu.models import lora as jl
from semantic_router_tpu.models import modernbert as jm
from semantic_router_tpu.observability.runtimestats import \
    RuntimeStats as JRuntimeStats
from semantic_router_tpu.signals.base import RequestContext as JContext
from semantic_router_tpu.signals.dispatch import \
    SignalDispatcher as JDispatcher
from semantic_router_tpu.utils.tokenization import \
    HashTokenizer as JHashTokenizer
from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine import pathing as tp
from semantic_router_tpu_torch.engine.classify import InferenceEngine
from semantic_router_tpu_torch.models import lora as tl
from semantic_router_tpu_torch.models import modernbert as tm
from semantic_router_tpu_torch.models.convert import (
    lora_params_from_flax,
    params_from_flax,
)
from semantic_router_tpu_torch.observability.metrics import \
    MetricsRegistry, MetricSeries
from semantic_router_tpu_torch.observability.programstats import \
    ProgramCatalog
from semantic_router_tpu_torch.observability.runtimestats import \
    RuntimeStats
from semantic_router_tpu_torch.signals.base import RequestContext
from semantic_router_tpu_torch.signals.dispatch import SignalDispatcher
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer

TOL = 1e-4
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
            num_hidden_layers=3, num_attention_heads=4, pad_token_id=0,
            local_attention=8)
TASKS = {"intent": ["a", "b", "c", "d"], "security": ["safe", "unsafe"],
         "domain": ["x", "y", "z"]}
TEXTS = ["hello routing world", "debug this function now please",
         "what is the capital of france", "a"]
STRATEGIES = ("adaptive", "latency", "confidence", "traditional", "stacked")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the chooser -----------------------------------------------------------


def _record_sequence(seed: int):
    """A deterministic mix of records: both paths, three batch buckets,
    latencies and confidences that cross, some failures."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(60):
        path = ("traditional", "stacked")[int(rng.integers(2))]
        tasks = [["a"], ["a", "b"], ["a", "b", "c"]][int(rng.integers(3))]
        batch = int(rng.choice([1, 3, 4, 16]))
        lat = float(rng.uniform(0.001, 0.05)) * (1.5 if path == "stacked"
                                                 and i > 30 else 1.0)
        conf = float(rng.uniform(0.4, 0.99))
        ok = bool(rng.uniform() > (0.6 if i in range(40, 48) else 0.05))
        recs.append((path, tasks, batch, lat, conf, ok))
    return recs


def _requirements(mod):
    return [mod.ProcessingRequirements(tasks=["a", "b"], batch_size=4),
            mod.ProcessingRequirements(tasks=["a"], batch_size=1),
            mod.ProcessingRequirements(tasks=["a", "b", "c"], batch_size=16,
                                       priority="quality"),
            mod.ProcessingRequirements(tasks=["a", "b"], batch_size=3,
                                       confidence_threshold=0.7)]


def _priors():
    calls = [0]

    def flipping():
        calls[0] += 1
        return {"stacked": 0.004 if calls[0] % 3 else 0.02,
                "traditional": 0.01}

    def boom():
        raise RuntimeError("telemetry down")

    return {"none": None, "both": lambda: {"stacked": 0.003,
                                           "traditional": 0.009},
            "one_sided": lambda: {"stacked": 0.001},
            "raising": boom, "flipping": flipping}


@pytest.mark.parametrize("prior", sorted(_priors()))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_chooser_choices_match_jax(strategy, prior):
    """Every selection (path, confidence, reasoning, expected metrics)
    over one record sequence, and the history's metrics, are JAX's."""
    jprior, tprior = _priors()[prior], _priors()[prior]
    jc = jp.DualPathChooser(strategy, min_history=5, cost_prior=jprior)
    tc = tp.DualPathChooser(strategy, min_history=5, cost_prior=tprior)
    seen = set()
    for rec in _record_sequence(7):
        for c in (jc, tc):
            c.record(*rec)
        for jreq, treq in zip(_requirements(jp), _requirements(tp)):
            js, ts = jc.choose(jreq), tc.choose(treq)
            assert (ts.selected_path, ts.confidence, ts.reasoning) == \
                (js.selected_path, js.confidence, js.reasoning)
            assert vars(ts.expected) == vars(js.expected)
            seen.add(ts.selected_path)
    for path in ("traditional", "stacked"):
        for b in (None, 1, 4, 16):
            assert vars(tc.history.metrics(path, b)) == \
                vars(jc.history.metrics(path, b))
    if strategy in ("adaptive", "latency"):
        assert seen == {"traditional", "stacked"}
    with pytest.raises(ValueError):
        tp.DualPathChooser("fastest")


# -- the engines -----------------------------------------------------------


def _jitter(params, seed: int, std: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, std, np.shape(a))
        .astype(np.float32), params)


def _flax_trees(seed: int = 0, shared: bool = True):
    """{task: ModernBertLoRAHeadClassifier tree} over one trunk and one
    head dense (``shared``; else each task its own trunk), and the bank
    tree stacked from them."""
    ids = jnp.ones((1, 8), jnp.int32)
    lora = jl.LoRAConfig(rank=4, alpha=8.0)
    trees, trunk, dense = {}, None, None
    for i, (name, labels) in enumerate(TASKS.items()):
        mod = jl.ModernBertLoRAHeadClassifier(
            jm.ModernBertConfig(**TINY, num_labels=len(labels)), lora,
            len(labels))
        p = _jitter(mod.init(jax.random.PRNGKey(seed * 10 + i), ids),
                    seed * 10 + i)["params"]
        if shared and trunk is not None:
            p = dict(p, model=trunk, head_dense=dense)
        trunk, dense = p["model"], p["head_dense"]
        trees[name] = {"params": p}
    names = list(TASKS)
    bank = {"model": trees[names[0]]["params"]["model"],
            "head_dense": trees[names[0]]["params"]["head_dense"],
            "head_lora": {
                "lora_A": np.stack([trees[n]["params"]["lora_A"]
                                    for n in names]),
                "lora_B": np.stack([trees[n]["params"]["lora_B"]
                                    for n in names])}}
    for n in names:
        bank[f"head_norm_{n}"] = trees[n]["params"]["head_norm"]
        bank[f"classifier_{n}"] = trees[n]["params"]["classifier"]
    return trees, {"params": bank}


def _bank_modules(mod):
    names = list(TASKS)
    labels = {n: len(l) for n, l in TASKS.items()}
    cfg = mod[1].ModernBertConfig(**TINY)
    return mod[0].MultiTaskLoRAClassifier(
        cfg, mod[0].LoRAConfig(rank=4, alpha=8.0, num_tasks=len(names)),
        names, labels, {n: "sequence" for n in names}) if mod[0] is jl \
        else tl.MultiTaskLoRAClassifier(
            cfg, tl.LoRAConfig(rank=4, alpha=8.0, num_tasks=len(names)),
            names, labels, {n: "sequence" for n in names})


def _registered(name: str, narrow: bool) -> list:
    """The label set a task registers: with ``narrow``, intent's first
    two of its head's four."""
    return TASKS[name][:2] if narrow and name == "intent" else TASKS[name]


def _jax_engine(strategy: str, shared: bool = True, seed: int = 0,
                narrow: bool = False):
    trees, bank_tree = _flax_trees(seed, shared)
    # a runtime-stats sink of its own: the chooser's cost prior reads it
    eng = JEngine(JEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                seq_len_buckets=[32]),
                  runtime_stats=JRuntimeStats())
    tok = JHashTokenizer(vocab_size=TINY["vocab_size"])
    for name, labels in TASKS.items():
        mod = jl.ModernBertLoRAHeadClassifier(
            jm.ModernBertConfig(**TINY, num_labels=len(labels)),
            jl.LoRAConfig(rank=4, alpha=8.0), len(labels))
        eng.register_task(name, "sequence", mod, trees[name], tok,
                          _registered(name, narrow), max_seq_len=32)
    eng.register_stacked_bank(_bank_modules((jl, jm)), bank_tree, tok,
                              max_seq_len=32, strategy=strategy)
    return eng


def _port_engine(strategy: str, shared: bool = True, seed: int = 0,
                 narrow: bool = False):
    trees, bank_tree = _flax_trees(seed, shared)
    reg = MetricsRegistry()
    eng = InferenceEngine(
        InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                              seq_len_buckets=[32]),
        device="cpu", metrics=MetricSeries(reg),
        runtime_stats=RuntimeStats(), program_stats=ProgramCatalog())
    eng.test_registry = reg
    tok = HashTokenizer(vocab_size=TINY["vocab_size"])
    for name, labels in TASKS.items():
        mod = tl.ModernBertLoRAHeadClassifier(
            tm.ModernBertConfig(**TINY, num_labels=len(labels)),
            tl.LoRAConfig(rank=4, alpha=8.0), len(labels))
        mod.load_state_dict(params_from_flax(trees[name]))
        eng.register_task(name, "sequence", mod, tok,
                          _registered(name, narrow), max_seq_len=32)
    bank = _bank_modules((tl, tm))
    bank.load_state_dict(lora_params_from_flax(bank, bank_tree))
    eng.register_stacked_bank(bank, tok, max_seq_len=32, strategy=strategy)
    return eng


@pytest.fixture
def engines():
    made = []

    def make(strategy="adaptive", shared=True, narrow=False):
        pair = (_jax_engine(strategy, shared, narrow=narrow),
                _port_engine(strategy, shared, narrow=narrow))
        made.extend(pair)
        return pair

    yield make
    for e in made:
        e.shutdown()


def _assert_same(got, want) -> None:
    assert list(got) == list(want)
    for task in want:
        assert len(got[task]) == len(want[task])
        for g, w in zip(got[task], want[task]):
            assert g.label == w.label and g.index == w.index
            assert list(g.probs) == list(w.probs)
            np.testing.assert_allclose(list(g.probs.values()),
                                       list(w.probs.values()), atol=TOL)
            assert abs(g.confidence - w.confidence) <= TOL
            assert g.truncated == w.truncated


@pytest.mark.parametrize("strategy", ["traditional", "stacked"])
def test_classify_multi_matches_jax_on_each_path(engines, strategy):
    jeng, teng = engines(strategy)
    tasks = list(TASKS)
    for texts in (TEXTS, TEXTS[:1]):
        want = jeng.classify_multi(tasks, texts)
        got = teng.classify_multi(tasks, texts)
        _assert_same(got, want)
        for e in (jeng, teng):
            assert e.last_path_selection.selected_path == strategy
        assert teng.last_path_selection.reasoning == \
            jeng.last_path_selection.reasoning
    # the tasks' trunk group serves the traditional side
    assert teng.trunk_group_info() == {"trunk0": tasks}
    groups = {s["group"] for s in teng.steps()}
    assert groups == ({"trunk0"} if strategy == "traditional"
                      else {"stacked"})


def test_both_paths_compute_the_same_function(engines):
    jeng, teng = engines("adaptive")
    tasks = list(TASKS)
    outs = {}
    for path in ("traditional", "stacked"):
        for e in (jeng, teng):
            e.path_chooser.strategy = path
        outs[path] = (jeng.classify_multi(tasks, TEXTS),
                      teng.classify_multi(tasks, TEXTS))
        assert teng.last_path_selection.selected_path == path
    _assert_same(outs["stacked"][1], outs["traditional"][1])
    _assert_same(outs["stacked"][0], outs["traditional"][0])
    _assert_same(outs["stacked"][1], outs["traditional"][0])


def test_adaptive_records_both_paths_and_matches_jax_cold(engines):
    """A cold adaptive chooser stacks a multi-task call and keeps one task
    traditional, as JAX's; each outcome is recorded on its path."""
    jeng, teng = engines("adaptive")
    for tasks in (list(TASKS), ["intent"], ["intent", "domain"]):
        want = jeng.classify_multi(tasks, TEXTS[:2])
        got = teng.classify_multi(tasks, TEXTS[:2])
        _assert_same(got, want)
        assert (teng.last_path_selection.selected_path,
                teng.last_path_selection.reasoning) == \
            (jeng.last_path_selection.selected_path,
             jeng.last_path_selection.reasoning)
    for e in (jeng, teng):
        h = e.path_chooser.history
        assert h.metrics("stacked").total == 2
        assert h.metrics("traditional").total == 1


def test_single_task_goes_traditional_and_matches_batch(engines):
    _jeng, teng = engines("adaptive")
    out = teng.classify_multi(["intent"], TEXTS)
    assert teng.last_path_selection.selected_path == "traditional"
    direct = teng.classify_batch("intent", TEXTS)
    for got, want in zip(out["intent"], direct):
        assert got.label == want.label
        assert abs(got.confidence - want.confidence) <= 1e-6


def test_a_failing_stacked_run_fails_open_like_jax(engines, monkeypatch):
    jeng, teng = engines("adaptive")

    def boom(*a, **k):
        raise RuntimeError("stacked path down")

    jeng._stacked["apply_fn"] = boom
    monkeypatch.setattr(teng._stacked.module, "forward", boom)
    want = jeng.classify_multi(list(TASKS), TEXTS)
    got = teng.classify_multi(list(TASKS), TEXTS)
    _assert_same(got, want)
    for e in (jeng, teng):
        sel = e.last_path_selection
        assert sel.selected_path == "traditional"
        assert "fail-open" in sel.reasoning
        m = e.path_chooser.history.metrics("stacked")
        assert m.total == 1 and m.success_rate == 0.0
        assert e.path_chooser.history.metrics("traditional").total == 1
    assert teng.last_path_selection.reasoning == \
        jeng.last_path_selection.reasoning


@pytest.mark.parametrize("strategy", ["adaptive", "stacked"])
def test_the_deadline_splits_like_jax(engines, strategy):
    """A stacked run slower than half the budget times out to the
    traditional path under ``adaptive`` and is recorded at the budget;
    a pinned ``stacked`` strategy keeps the whole budget and serves it."""
    jeng, teng = engines(strategy)
    tasks = list(TASKS)
    for e in (jeng, teng):
        e.classify_multi(tasks, TEXTS[:1])      # first runs off the clock
        e.path_chooser.strategy = "traditional"
        e.classify_multi(tasks, TEXTS[:1])
        e.path_chooser.strategy = strategy
    released = []
    for e in (jeng, teng):
        real = e._stacked_run
        gate = threading.Event()
        released.append(gate)

        def slow(*a, _real=real, _gate=gate):
            _gate.wait(1.2)
            return _real(*a)

        e._stacked_run = slow
    timeouts = {"adaptive": 1.6, "stacked": 3.0}
    outs = []
    for e, gate in zip((jeng, teng), released):
        n_before = len(e.path_chooser.history._records)
        t0 = time.perf_counter()
        outs.append(e.classify_multi(tasks, TEXTS[:1],
                                     timeout=timeouts[strategy]))
        took = time.perf_counter() - t0
        gate.set()
        rec = list(e.path_chooser.history._records)[n_before]
        assert rec.path == "stacked"
        if strategy == "adaptive":
            assert e.last_path_selection.selected_path == "traditional"
            assert "exceeded 0.8s budget" in e.last_path_selection.reasoning
            assert rec.latency_s == 0.8 and rec.ok and rec.confidence == 0.0
            assert took < 1.6
        else:
            assert e.last_path_selection.selected_path == "stacked"
            assert rec.ok and rec.latency_s >= 1.0
    _assert_same(outs[1], outs[0])
    assert teng.last_path_selection.reasoning == \
        jeng.last_path_selection.reasoning


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fused_covers_matches_jax(engines, strategy):
    """Per-task tasks (each its own trunk): the bank covers a call only
    when the chooser would stack it now."""
    jeng, teng = engines(strategy, shared=False)
    assert teng.trunk_group_info() == {
        f"trunk{i}": [t] for i, t in enumerate(TASKS)}
    for tasks in (list(TASKS), ["intent"], ["intent", "security"],
                  ["intent", "nope"][:1], []):
        assert teng.fused_covers(tasks) == jeng.fused_covers(tasks)
    want = {"adaptive": True, "latency": True, "confidence": True,
            "traditional": False, "stacked": True}[strategy]
    assert teng.fused_covers(list(TASKS)) is want
    teng._stacked = None
    assert not teng.fused_covers(list(TASKS))


def test_registration_needs_the_traditional_side(engines):
    _jeng, teng = engines("adaptive")
    bank = tl.MultiTaskLoRAClassifier(
        tm.ModernBertConfig(**TINY), tl.LoRAConfig(rank=4, num_tasks=1),
        ["unregistered"], {"unregistered": 2})
    with pytest.raises(ValueError, match="no traditional registration"):
        teng.register_stacked_bank(bank, HashTokenizer(vocab_size=512))
    # a re-registration retires the old bank's steps and pool
    teng.classify_multi(list(TASKS), TEXTS[:1])
    old = teng._stacked
    old_pool = teng._stacked_pool
    teng.register_stacked_bank(old.module, old.tokenizer, max_seq_len=32)
    assert old.graphs.retired and teng._stacked is not old
    assert old_pool._shutdown


class _Evaluator:
    def __init__(self, engine, task):
        self.engine, self.prefetch_task = engine, task


def test_the_dispatcher_prefetch_reaches_the_bank(engines):
    jeng, teng = engines("stacked", shared=False)
    body = {"messages": [{"role": "user", "content": TEXTS[1]}]}
    memos = []
    for eng, disp, ctx_cls in ((jeng, JDispatcher([]), JContext),
                               (teng, SignalDispatcher([]), RequestContext)):
        ctx = ctx_cls.from_openai_body(body)
        disp._prefetch_fused(ctx, [_Evaluator(eng, t) for t in TASKS])
        disp.shutdown()
        assert eng.last_path_selection.selected_path == "stacked"
        memos.append({k[1]: v for k, v in ctx.class_memo.items()})
    assert sorted(memos[1]) == sorted(TASKS)
    _assert_same({t: [memos[1][t]] for t in sorted(TASKS)},
                 {t: [memos[0][t]] for t in sorted(TASKS)})
    assert [s["group"] for s in teng.steps()] == ["stacked"]


def test_the_stacked_step_is_recorded_and_cataloged(engines):
    _jeng, teng = engines("stacked")
    teng.classify_multi(list(TASKS), TEXTS)
    teng.classify_multi(list(TASKS), TEXTS)
    steps = [s for s in teng.steps() if s["group"] == "stacked"]
    assert len(steps) == 2
    assert {(s["bucket"], s["padded_rows"], s["flavor"]) for s in steps} \
        == {(32, 4, "stacked")}
    assert teng.shape_census()["stacked"] == [(4, 32)]
    cat = teng._program_stats.catalog()
    rows = [p for p in cat["programs"] if p["group"] == "stacked"]
    assert len(rows) == 1 and rows[0]["variant"] == "stacked"
    assert "stacked" in teng.graph_report()
    text = teng.test_registry.expose()
    assert 'llm_engine_trunk_forwards_total{group="stacked",path=' \
           '"stacked"} 2' in text


@pytest.mark.parametrize("strategy", ["traditional", "stacked"])
def test_a_narrow_label_set_decodes_by_index_like_jax(engines, strategy):
    """A label list narrower than its head names the other classes by
    index on both paths, as the reference's width-tolerant decode does."""
    jeng, teng = engines(strategy, narrow=True)
    texts = TEXTS + [f"text number {i}" for i in range(4)]
    want = jeng.classify_multi(list(TASKS), texts)
    got = teng.classify_multi(list(TASKS), texts)
    _assert_same(got, want)
    assert list(got["intent"][0].probs) == ["a", "b", "2", "3"]
    assert teng.last_path_selection.selected_path == strategy


def test_more_texts_than_the_batch_cap_fail_open_like_jax(engines):
    """A stacked pass pads rows to at most ``max_batch_size`` (8 here): 12
    texts do not fit, the pass fails and the call is served
    traditionally, in both packages."""
    jeng, teng = engines("stacked")
    texts = TEXTS + [f"text number {i}" for i in range(8)]
    want = jeng.classify_multi(list(TASKS), texts)
    got = teng.classify_multi(list(TASKS), texts)
    _assert_same(got, want)
    for e in (jeng, teng):
        assert e.last_path_selection.selected_path == "traditional"
        assert "fail-open" in e.last_path_selection.reasoning
