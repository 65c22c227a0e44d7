"""Config validation at load, against the JAX package: the bad and good
configs of the reference's loader tests through both packages'
``loads_config`` and ``load_config(path)`` (the same ones refused, with
``ConfigError`` naming the same field, the warnings alike);
``validate_config``'s findings (path, message, fatal) on the fixture
config and on seeded mutations of it (a dropped signal, a duplicated
name, a bad regex, a ghost model); ``export_canonical``,
``is_canonical`` and ``migrate_flat``; and the ``validate`` and
``migrate-config`` subcommands (rc and output)."""

import copy
import json

import numpy as np
import pytest
import yaml

from semantic_router_tpu.__main__ import main as jmain
from semantic_router_tpu.config import ConfigError as JConfigError
from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.config import export_canonical as jexport
from semantic_router_tpu.config import is_canonical as jis_canonical
from semantic_router_tpu.config import load_config as jload
from semantic_router_tpu.config import loads_config as jloads
from semantic_router_tpu.config import migrate_flat as jmigrate
from semantic_router_tpu.config import validate_config as jvalidate
from semantic_router_tpu_torch.__main__ import main as tmain
from semantic_router_tpu_torch.config import (
    ConfigError,
    export_canonical,
    is_canonical,
    load_config,
    loads_config,
    migrate_flat,
    validate_config,
)

# the reference loader tests' bad configs, each with the word its error
# must name
BAD = {
    "unknown_signal": ("""
routing:
  signals:
    domains:
      - name: business
  decisions:
    - name: d1
      rules:
        operator: OR
        conditions:
          - {type: domain, name: nonexistent}
      modelRefs: [{model: m1}]
  modelCards:
    - {name: m1}
""", "nonexistent"),
    "ghost_model": ("""
routing:
  modelCards:
    - {name: m1}
  signals:
    domains: [{name: business}]
  decisions:
    - name: d1
      rules:
        operator: OR
        conditions: [{type: domain, name: business}]
      modelRefs: [{model: ghost-model}]
""", "ghost-model"),
    "duplicate_names": ("""
routing:
  signals:
    domains: [{name: a}, {name: a}]
""", "duplicate"),
    "descending_buckets": ("""
engine:
  seq_len_buckets: [512, 128]
routing:
  modelCards: [{name: m1}]
""", "ascending"),
    "ghost_domain_no_signals": ("""
routing:
  decisions:
    - name: d
      rules:
        operator: OR
        conditions: [{type: domain, name: ghost}]
""", "ghost"),
}

GOOD = {
    "empty": "{}\n",
    "keyword_route": """
default_model: m1
routing:
  modelCards: [{name: m1}, {name: m2}]
  signals:
    keywords: [{name: kw, keywords: [urgent]}]
  decisions:
    - name: urgent
      rules: {operator: OR, conditions: [{type: keyword, name: kw}]}
      modelRefs: [{model: m2}]
    - name: no_models
      rules: {operator: OR, conditions: [{type: keyword, name: kw}]}
""",
}


def _findings(errors):
    return [(e.path, e.message, e.fatal) for e in errors]


@pytest.mark.parametrize("via", ["text", "path"])
@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_config_refused_as_the_reference_refuses(name, via, tmp_path):
    text, word = BAD[name]
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    msgs = []
    for load, err in ((jloads if via == "text" else jload, JConfigError),
                      (loads_config if via == "text" else load_config,
                       ConfigError)):
        with pytest.raises(err, match=word) as exc:
            load(text if via == "text" else str(path))
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("via", ["text", "path"])
@pytest.mark.parametrize("name", sorted(GOOD))
def test_good_config_loads_with_the_same_warnings(name, via, tmp_path):
    text = GOOD[name]
    path = tmp_path / "good.yaml"
    path.write_text(text)
    jc = jloads(text) if via == "text" else jload(str(path))
    tc = loads_config(text) if via == "text" else load_config(str(path))
    assert _findings(validate_config(tc)) == _findings(jvalidate(jc))
    assert [d.name for d in tc.decisions] == [d.name for d in jc.decisions]


def test_dict_config_validates_only_when_asked():
    d = yaml.safe_load(BAD["ghost_model"][0])
    assert [x.name for x in load_config(copy.deepcopy(d)).decisions] == ["d1"]
    with pytest.raises(ConfigError, match="ghost-model"):
        load_config(copy.deepcopy(d), validate=True)


def test_fixture_loads_clean_in_both(fixture_config_path):
    jc, tc = jload(fixture_config_path), load_config(fixture_config_path)
    assert _findings(validate_config(tc)) == _findings(jvalidate(jc)) == []
    assert tc.used_signal_types() == jc.used_signal_types()


def _fixture(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _mutate(d, kind, rng):
    """One seeded mutation of the fixture dict."""
    d = copy.deepcopy(d)
    routing = d["routing"]
    if kind == "dropped_signal":
        fams = sorted(f for f, rules in routing["signals"].items() if rules)
        fam = fams[int(rng.integers(len(fams)))]
        rules = routing["signals"][fam]
        rules.pop(int(rng.integers(len(rules))))
    elif kind == "duplicated_name":
        if rng.integers(2):
            decs = routing["decisions"]
            decs.append(copy.deepcopy(decs[int(rng.integers(len(decs)))]))
        else:
            cards = routing["modelCards"]
            cards.append(copy.deepcopy(cards[int(rng.integers(len(cards)))]))
    elif kind == "bad_regex":
        routing["signals"]["keywords"].append(
            {"name": f"bad_re_{int(rng.integers(100))}", "method": "regex",
             "keywords": ["fine", "(unclosed[", "ok+"]})
    elif kind == "ghost_model":
        decs = [x for x in routing["decisions"] if x.get("modelRefs")]
        dec = decs[int(rng.integers(len(decs)))]
        dec["modelRefs"][0]["model"] = f"ghost-{int(rng.integers(1000))}"
    return d


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["dropped_signal", "duplicated_name",
                                  "bad_regex", "ghost_model"])
def test_findings_equal_on_seeded_mutations(kind, seed, fixture_config_path):
    d = _mutate(_fixture(fixture_config_path), kind,
                np.random.default_rng(seed))
    want = _findings(jvalidate(JRouterConfig.from_dict(copy.deepcopy(d))))
    got = _findings(validate_config(load_config(copy.deepcopy(d))))
    assert got == want
    if kind != "dropped_signal":
        assert any(f[2] for f in got), got
    text = yaml.safe_dump(d)
    refused = []
    for loads, err in ((jloads, JConfigError), (loads_config, ConfigError)):
        try:
            loads(text)
            refused.append(None)
        except err as exc:
            refused.append(str(exc))
    assert refused[1] == refused[0]


FLAT = {
    "default_model": "m1",
    "model_cards": [{"name": "m1"}, {"name": "m2"}],
    "signals": {"keywords": [{"name": "kw", "keywords": ["urgent"]}]},
    "decisions": [{"name": "urgent", "rules": {
        "operator": "OR", "conditions": [{"type": "keyword", "name": "kw"}]},
        "modelRefs": [{"model": "m2"}]}],
    "semantic_cache": {"enabled": True, "similarity_threshold": 0.9},
    "observability": {"tracing": {"sample_rate": 0.5}},
}


def test_canonical_export_and_migration_equal(fixture_config_path):
    d = _fixture(fixture_config_path)
    for raw in (d, FLAT):
        assert is_canonical(copy.deepcopy(raw)) == \
            jis_canonical(copy.deepcopy(raw))
        assert export_canonical(load_config(copy.deepcopy(raw))) == \
            jexport(JRouterConfig.from_dict(copy.deepcopy(raw)))
        assert migrate_flat(copy.deepcopy(raw)) == \
            jmigrate(copy.deepcopy(raw))
    migrated = migrate_flat(copy.deepcopy(FLAT))
    assert is_canonical(migrated) and not is_canonical(FLAT)
    again = loads_config(yaml.safe_dump(migrated))
    assert [x.name for x in again.decisions] == ["urgent"]
    assert again.semantic_cache.similarity_threshold == 0.9


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("check", [False, True])
@pytest.mark.parametrize("which", ["flat", "fixture"])
def test_migrate_config_command(which, check, fixture_config_path, tmp_path,
                                capsys):
    src = fixture_config_path
    if which == "flat":
        src = str(tmp_path / "flat.yaml")
        with open(src, "w") as f:
            f.write(yaml.safe_dump(FLAT))
    outs = []
    for main, name in ((jmain, "j"), (tmain, "t")):
        argv = ["migrate-config", "--config", src]
        if check:
            argv.append("--check")
        dst = tmp_path / f"{name}.yaml"
        outs.append((_run(main, argv, capsys),
                     _run(main, argv + ["--out", str(dst)], capsys),
                     dst.read_text() if dst.exists() else None))
    (jstd, jfile, jtext), (tstd, tfile, ttext) = outs
    assert tstd == jstd and ttext == jtext
    assert tfile[0] == jfile[0]
    if tfile[0] == 0:
        assert json.loads(tfile[1]) == dict(json.loads(jfile[1]),
                                            out=str(tmp_path / "t.yaml"))
    if not check:
        assert tstd[0] == 0 and yaml.safe_load(tstd[1])["routing"]


@pytest.mark.parametrize("which", ["fixture", "bad"])
def test_validate_command(which, fixture_config_path, tmp_path, capsys):
    path = fixture_config_path
    if which == "bad":
        path = str(tmp_path / "bad.yaml")
        with open(path, "w") as f:
            f.write(BAD["ghost_domain_no_signals"][0])
    (jrc, jout, _), (trc, tout, _) = (_run(m, ["validate", "--config", path],
                                           capsys) for m in (jmain, tmain))
    assert trc == jrc == (0 if which == "fixture" else 1)
    assert json.loads(tout) == json.loads(jout)
    assert sorted(json.loads(tout)) == (
        ["decisions", "models", "signal_families", "valid", "warnings"]
        if which == "fixture" else ["error", "valid"])
