"""The port's fleet simulator against the JAX package's, on the CPU:
``slice_tokens_per_s``, ``simulate``, ``optimize_fleet`` and
``workload_from_replay_report`` on seeded workloads, and the CLI's
``optimize`` / ``whatif`` / ``catalog`` commands, compared exactly (the
same JSON, the same exit codes); an unfittable model raises alike."""

import dataclasses
import json

import numpy as np
import pytest

from semantic_router_tpu import fleetsim as jfs
from semantic_router_tpu.fleetsim import __main__ as jcli
from semantic_router_tpu.fleetsim import sim as jsim
from semantic_router_tpu_torch import fleetsim as tfs
from semantic_router_tpu_torch.fleetsim import __main__ as tcli
from semantic_router_tpu_torch.fleetsim import sim as tsim

SEEDS = (0, 1, 2, 3)


def _rows(seed: int) -> list:
    """A seeded workload: 1-4 models from 1B to 80B parameters, some with
    their own token counts and latency targets."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(int(rng.integers(1, 5))):
        row = {"model": f"m{i}",
               "param_b": float(rng.choice([1.5, 8.0, 14.0, 32.0, 70.0,
                                            80.0])),
               "requests_per_s": float(np.round(rng.uniform(0.1, 40.0), 3))}
        if rng.random() < 0.5:
            row["avg_prompt_tokens"] = int(rng.integers(64, 4096))
            row["avg_completion_tokens"] = int(rng.integers(16, 1024))
        if rng.random() < 0.5:
            row["slo_p50_latency_s"] = float(rng.choice([0.5, 2.0, 10.0]))
        rows.append(row)
    return rows


def _report(rep) -> dict:
    return json.loads(json.dumps(rep.to_dict()))


def test_catalog_is_the_references():
    assert {k: dataclasses.asdict(v) for k, v in tfs.TPU_CATALOG.items()} \
        == {k: dataclasses.asdict(v) for k, v in jfs.TPU_CATALOG.items()}


@pytest.mark.parametrize("param_b", [0.5, 8.0, 30.0, 70.0, 400.0])
@pytest.mark.parametrize("eff", [0.3, 0.55])
def test_slice_tokens_per_s_matches(param_b, eff):
    for name, spec in tfs.TPU_CATALOG.items():
        assert tsim.slice_tokens_per_s(spec, param_b, eff) == \
            jsim.slice_tokens_per_s(jfs.TPU_CATALOG[name], param_b, eff)


@pytest.mark.parametrize("seed", SEEDS)
def test_optimize_and_simulate_match(seed):
    rows = _rows(seed)
    twl = [tfs.ModelLoad(**r) for r in rows]
    jwl = [jfs.ModelLoad(**r) for r in rows]
    talloc = tfs.optimize_fleet(twl)
    jalloc = jfs.optimize_fleet(jwl)
    assert talloc.slices == jalloc.slices
    assert _report(tfs.simulate(twl, talloc)) == \
        _report(jfs.simulate(jwl, jalloc))
    # a what-if on a fleet cut to one slice a model
    cut = {m: {s: 1 for s in per} for m, per in talloc.slices.items()}
    assert _report(tfs.simulate(twl, tfs.FleetAllocation(slices=cut),
                                efficiency=0.4)) == \
        _report(jfs.simulate(jwl, jfs.FleetAllocation(slices=cut),
                             efficiency=0.4))


def test_unfittable_model_raises_alike():
    t = {"nano": tsim.SliceSpec("nano", 1, 100, 4, 400, 1.0)}
    j = {"nano": jsim.SliceSpec("nano", 1, 100, 4, 400, 1.0)}
    with pytest.raises(ValueError, match="fits") as te:
        tfs.optimize_fleet([tfs.ModelLoad("m", 70, 1)], catalog=t)
    with pytest.raises(ValueError, match="fits") as je:
        jfs.optimize_fleet([jfs.ModelLoad("m", 70, 1)], catalog=j)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("case", ["mapped", "partial", "unmapped", "empty"])
def test_workload_from_replay_report_matches(case):
    rng = np.random.default_rng(7)
    report = {"signals_per_s": 42.5, "decisions": {
        f"d{i}": int(rng.integers(1, 50)) for i in range(5)}}
    if case == "empty":
        report["decisions"] = {}
    params = {"small": 8.0, "mid": 32.0, "big": 70.0}
    mapping = {"mapped": {"d0": "small", "d1": "mid", "d2": "big",
                          "d3": "mid", "d4": "small"},
               "partial": {"d0": "big", "d3": "small"},
               "unmapped": None, "empty": None}[case]
    for rps in (None, 100.0):
        got = tfs.workload_from_replay_report(report, params, mapping, rps)
        want = jfs.workload_from_replay_report(report, params, mapping, rps)
        assert [dataclasses.asdict(x) for x in got] == \
            [dataclasses.asdict(x) for x in want]


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("seed", SEEDS)
def test_cli_matches(seed, tmp_path, capsys):
    wl = tmp_path / "w.json"
    wl.write_text(json.dumps(_rows(seed)))
    t = _cli(tcli.main, ["optimize", "--workload", str(wl)], capsys)
    j = _cli(jcli.main, ["optimize", "--workload", str(wl)], capsys)
    assert t == j and t[0] == 0
    alloc = json.loads(t[1])["allocation"]
    # the optimized fleet, and the same fleet with each model's slices
    # cut to one: what-if exits 1 when that fleet is infeasible
    for fleet in (alloc, {m: {s: 1 for s in per}
                          for m, per in alloc.items()}):
        path = tmp_path / "f.json"
        path.write_text(json.dumps(fleet))
        argv = ["whatif", "--workload", str(wl), "--fleet", str(path),
                "--efficiency", "0.3"]
        t = _cli(tcli.main, argv, capsys)
        j = _cli(jcli.main, argv, capsys)
        assert t == j
        assert t[0] == (0 if json.loads(t[1])["feasible"] else 1)


def test_cli_catalog_matches(capsys):
    assert _cli(tcli.main, ["catalog"], capsys) == \
        _cli(jcli.main, ["catalog"], capsys)


def test_undersized_fleet_is_infeasible_on_both(tmp_path, capsys):
    wl = tmp_path / "w.json"
    wl.write_text(json.dumps([{"model": "big", "param_b": 70,
                               "requests_per_s": 50}]))
    fleet = tmp_path / "f.json"
    fleet.write_text(json.dumps({"big": {"v5p-8": 1}}))
    argv = ["whatif", "--workload", str(wl), "--fleet", str(fleet)]
    t = _cli(tcli.main, argv, capsys)
    assert t == _cli(jcli.main, argv, capsys)
    assert t[0] == 1 and not json.loads(t[1])["feasible"]
