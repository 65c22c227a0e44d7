"""The model-selection harness in the port against the JAX package, on
the CPU: the candidates of the fixture config and of seeded variants
equal the reference's; the keyword scorer equals it on seeded answers;
both packages' benchmark runners against one mock backend (the port's
``MockVLLMServer``, which echoes request facts) give the same records
but latency, the same JSONL rows but latency, and the same features and
labels downstream; a dead endpoint becomes zero-quality records with
their errors in both; and the CLI's report and its file equal the
reference's, latencies aside."""

import copy
import json
import random

import pytest
import yaml

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.modelselection import analyzer as janalyzer
from semantic_router_tpu.modelselection import benchmark as jbench
from semantic_router_tpu.training import selection_train as jst
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.modelselection import analyzer as tanalyzer
from semantic_router_tpu_torch.modelselection import benchmark as tbench
from semantic_router_tpu_torch.router import MockVLLMServer
from semantic_router_tpu_torch.training import selection_train as tst


def _variants(path):
    with open(path) as f:
        base = yaml.safe_load(f)
    out = [base]
    rng = random.Random(4)
    for i in range(4):
        d = copy.deepcopy(base)
        d["routing"]["modelCards"] = d["routing"].get("modelCards", []) + [
            {"name": f"extra-{i}", "quality_score": rng.random(),
             "pricing": {"input": 0.5 * i, "output": 1.5 * i},
             "tags": ["t"]}]
        d["default_model"] = f"default-{i}" if i % 2 else \
            d.get("default_model", "")
        out.append(d)
    return out


def test_candidates_equal_the_reference(fixture_config_path):
    for d in _variants(fixture_config_path):
        want = janalyzer.candidates_from_config(
            JRouterConfig.from_dict(copy.deepcopy(d)))
        got = tanalyzer.candidates_from_config(load_config(copy.deepcopy(d)))
        assert [c.__dict__ for c in got] == [c.__dict__ for c in want]


@pytest.mark.parametrize("seed", range(6))
def test_keyword_scorer_equals_the_reference(seed):
    rng = random.Random(seed)
    words = ["hash", "table", "the", "four", "answer", "x", "derivative",
             "2", "revenue", "symptoms", "éa"]
    for _ in range(20):
        q = " ".join(rng.choice(words) for _ in range(rng.randrange(0, 6)))
        exp = " ".join(rng.choice(words) for _ in range(rng.randrange(0, 4)))
        ans = " ".join(rng.choice(words) for _ in range(rng.randrange(0, 8)))
        assert tbench.keyword_scorer(ans, tbench.BenchmarkQuery(q, "c", exp)) \
            == jbench.keyword_scorer(ans, jbench.BenchmarkQuery(q, "c", exp))
    assert [q.__dict__ for q in tbench.synthetic_queries(9)] \
        == [q.__dict__ for q in jbench.synthetic_queries(9)]


@pytest.fixture
def backend():
    b = MockVLLMServer().start()
    yield b
    b.stop()


def _rows(results):
    return [{k: v for k, v in r.__dict__.items() if k != "latency_ms"}
            for r in results]


def test_runs_equal_the_reference_downstream(backend, tmp_path):
    queries = {"jax": jbench.synthetic_queries(8),
               "port": tbench.synthetic_queries(8)}
    out = {}
    for name, mod in (("jax", jbench), ("port", tbench)):
        runner = mod.BenchmarkRunner(lambda m: backend.url, concurrency=3)
        results = runner.run(queries[name], ["model-a", "model-b"])
        path = str(tmp_path / f"{name}.jsonl")
        assert runner.write_jsonl(results, path) == 16
        out[name] = (results, path)
    assert _rows(out["port"][0]) == _rows(out["jax"][0])
    assert all(r.error == "" and r.latency_ms > 0 for r in out["port"][0])
    lines = {n: [dict(json.loads(l), latency_ms=0) for l in open(p)]
             for n, (_, p) in out.items()}
    assert lines["port"] == lines["jax"]
    # latencies aside, the same corpus: the same features and labels
    trec = tst.load_routing_jsonl(out["port"][1])
    jrec = jst.load_routing_jsonl(out["port"][1])
    tf, tl, tc = tst.featurize(trec)
    jf, jl, jc = jst.featurize(jrec)
    assert (tf.tolist(), tl, tc) == (jf.tolist(), jl, jc)


def test_a_dead_endpoint_becomes_zero_quality_records():
    got = tbench.BenchmarkRunner(lambda m: "http://127.0.0.1:1",
                                 timeout_s=0.5).run(
        [tbench.BenchmarkQuery("hi"), tbench.BenchmarkQuery("yo")],
        ["m", "n"])
    want = jbench.BenchmarkRunner(lambda m: "http://127.0.0.1:1",
                                  timeout_s=0.5).run(
        [jbench.BenchmarkQuery("hi"), jbench.BenchmarkQuery("yo")],
        ["m", "n"])
    assert [(r.query, r.model, r.quality, r.error.split(":")[0])
            for r in got] == [(r.query, r.model, r.quality,
                               r.error.split(":")[0]) for r in want]
    assert all(r.error for r in got)
    # an unresolvable model fails the same way
    got = tbench.BenchmarkRunner(lambda m: "").run_one(
        tbench.BenchmarkQuery("q"), "m")
    want = jbench.BenchmarkRunner(lambda m: "").run_one(
        jbench.BenchmarkQuery("q"), "m")
    assert (got.quality, got.error) == (want.quality, want.error)


@pytest.mark.parametrize("table", [False, True])
def test_cli_equals_the_reference(backend, tmp_path, capsys, table):
    endpoint = (f"a={backend.url},b={backend.url}" if table
                else backend.url)
    reports, lines = {}, {}
    for name, mod in (("jax", jbench), ("port", tbench)):
        out = str(tmp_path / f"{name}.jsonl")
        assert mod.main(["--endpoint", endpoint, "--models", "a,b", "--n",
                         "4", "--out", out, "--concurrency", "2"]) == 0
        reports[name] = json.loads(capsys.readouterr().out)
        reports[name].pop("out")
        lines[name] = [dict(json.loads(l), latency_ms=0) for l in open(out)]
    assert reports["port"] == reports["jax"]
    assert reports["port"]["records"] == 8 and reports["port"]["errors"] == 0
    assert lines["port"] == lines["jax"]
