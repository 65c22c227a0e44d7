"""LoRA training in the port against the JAX package, on the CPU, at the
JAX tests' widths (hidden 64, 4 layers, 4 heads, window 32): the dataset
builders and batch iterators give identical arrays; the four losses and
their gradients agree within 1e-6; one train step of the sequence and
token models agrees (loss within 1e-5, each adapter gradient within 1e-4
of its largest magnitude) on the Flax-initialised weights carried in
through ``lora_params_from_flax``, at init and with the adapters moved
off it; AdamW and Adam alone agree within 1e-6 after three steps on given
gradients and leave the frozen base untouched; the first ten logged
losses of ``finetune_classifier`` agree within 1e-4 relative; the JAX
tests' own bars hold on the port (loss falls and accuracy > 0.5, token F1
> 0.6 through the port's engine, MNR and mining improve MRR with only the
adapters changed); ``evaluate_sequence`` / ``evaluate_token`` give the
JAX functions' reports on the JAX tests' ``OracleEngine``; adapter files
load across the packages with identical key names and logits; a mesh over
more than one device raises; the CLIs with ``--device cpu`` write an
``adapters.npz`` the JAX ``load_adapters`` reads, and exit non-zero
without a GPU and without ``--device``."""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_router_tpu.models import lora as jl
from semantic_router_tpu.models import modernbert as jm
from semantic_router_tpu.parallel import make_lora_optimizer as j_adamw
from semantic_router_tpu.training import datasets as jd
from semantic_router_tpu.training import embed_finetune as jef
from semantic_router_tpu.training import evaluate as jev
from semantic_router_tpu.training import finetune as jft
from semantic_router_tpu.training import token_finetune as jtf
from semantic_router_tpu.utils.tokenization import HashTokenizer as JTok
from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine.classify import InferenceEngine
from semantic_router_tpu_torch.models import lora as tl
from semantic_router_tpu_torch.models import modernbert as tm
from semantic_router_tpu_torch.models.convert import (
    flax_adapter_key,
    lora_params_from_flax,
    port_adapter_name,
)
from semantic_router_tpu_torch.parallel import make_lora_optimizer, \
    make_train_step
from semantic_router_tpu_torch.parallel.train_step import cross_entropy_loss
from semantic_router_tpu_torch.training import datasets as td
from semantic_router_tpu_torch.training import embed_finetune as tef
from semantic_router_tpu_torch.training import evaluate as tev
from semantic_router_tpu_torch.training import finetune as tft
from semantic_router_tpu_torch.training import token_finetune as ttf
from semantic_router_tpu_torch.training.loop import run_lora_training
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-6
STEP_LOSS_TOL = 1e-5
GRAD_REL_TOL = 1e-4
OPT_TOL = 1e-6
HISTORY_REL_TOL = 1e-4
ENTITIES = ["EMAIL", "PHONE", "CARD"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(num_labels: int, max_len: int = 64):
    kw = dict(vocab_size=1024, hidden_size=64, intermediate_size=96,
              num_hidden_layers=4, num_attention_heads=4,
              max_position_embeddings=max_len, local_attention=32,
              num_labels=num_labels)
    return jm.ModernBertConfig(**kw), tm.ModernBertConfig(**kw)


def _models(kind: str, n_labels: int, rank: int = 4, alpha: float = 8.0):
    jcfg, tcfg = _cfgs(n_labels)
    if kind == "sequence":
        return (jl.LoRAModernBertForSequenceClassification(
                    jcfg, jl.LoRAConfig(rank=rank, alpha=alpha), n_labels),
                tl.LoRAModernBertForSequenceClassification(
                    tcfg, tl.LoRAConfig(rank=rank, alpha=alpha), n_labels))
    return (jl.LoRAModernBertForTokenClassification(
                jcfg, jl.LoRAConfig(rank=rank, alpha=alpha), n_labels),
            tl.LoRAModernBertForTokenClassification(
                tcfg, tl.LoRAConfig(rank=rank, alpha=alpha), n_labels))


def _flax_init(jmod, seed: int = 0):
    return jmod.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))


def _moved(params, seed: int):
    """The adapter leaves moved off their init (``lora_B`` = 0 makes every
    ``lora_A`` gradient exactly zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a))
        .astype(np.float32)
        if str(getattr(p[-1], "key", p[-1])).startswith("lora_")
        else np.asarray(a), params)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(tmod, params):
    tmod.load_state_dict(lora_params_from_flax(tmod, params), strict=True)
    return tmod


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- datasets and iterators ---------------------------------------------------


def test_datasets_equal_the_reference(tmp_path):
    for task in ("intent", "jailbreak", "fact_check"):
        assert td.synthetic_sequence_dataset(task, 10, seed=3) \
            == jd.synthetic_sequence_dataset(task, 10, seed=3)
        assert td.task_labels(task) == jd.task_labels(task)
    with pytest.raises(ValueError):
        td.synthetic_sequence_dataset("nope")
    rows_t, rows_j = td.synthetic_token_dataset(30, 5), \
        jd.synthetic_token_dataset(30, 5)
    assert [dataclasses.asdict(r) for r in rows_t] \
        == [dataclasses.asdict(r) for r in rows_j]
    assert td.bio_labels(["PHONE", "EMAIL", "PHONE"]) \
        == jd.bio_labels(["PHONE", "EMAIL", "PHONE"])
    path = tmp_path / "tok.jsonl"
    path.write_text("".join(json.dumps(dataclasses.asdict(r)) + "\n"
                            for r in rows_j[:6]) + "\n")
    assert [dataclasses.asdict(r) for r in td.load_token_jsonl(str(path))] \
        == [dataclasses.asdict(r) for r in jd.load_token_jsonl(str(path))]
    index = {l: i for i, l in enumerate(td.bio_labels(ENTITIES))}
    tok = HashTokenizer()
    for row in rows_t:
        offsets = tok.encode(row.text).offsets
        np.testing.assert_array_equal(td.align_bio(row, offsets, index),
                                      jd.align_bio(row, offsets, index))
    with pytest.raises(ValueError):
        td.align_bio(rows_t[0], tok.encode(rows_t[0].text).offsets,
                     {"O": 0})
    assert tft.synthetic_dataset(["a", "b", "c"], 9, seed=2) \
        == jft.synthetic_dataset(["a", "b", "c"], 9, seed=2)
    seq = tmp_path / "seq.jsonl"
    seq.write_text('{"text": "a b", "label": "x"}\n\n'
                   '{"text": "c", "label": 2}\n')
    assert tft.load_jsonl_dataset(str(seq)) \
        == jft.load_jsonl_dataset(str(seq))
    for domain in ("programming", "finance", "unknown"):
        assert dataclasses.asdict(tef.synthetic_pair_dataset(domain, 20, 4)) \
            == dataclasses.asdict(jef.synthetic_pair_dataset(domain, 20, 4))
    pairs = tmp_path / "pairs.jsonl"
    pairs.write_text('{"anchor": "a", "positive": "p", "negative": "n"}\n'
                     '{"anchor": "b", "positive": "p"}\n')
    assert dataclasses.asdict(tef.load_pairs_jsonl(str(pairs))) \
        == dataclasses.asdict(jef.load_pairs_jsonl(str(pairs)))


@pytest.mark.parametrize("kind", ["sequence", "token"])
def test_batch_iterators_equal_the_reference(kind):
    tok = HashTokenizer()
    if kind == "sequence":
        labels = ["a", "b", "c"]
        data = tft.synthetic_dataset(labels, 7, seed=1)
        kw = dict(labels=labels, batch_size=8, seq_buckets=(8, 16, 32),
                  seed=4)
        it_t = tft.batch_iterator(data, tok, tft.TrainConfig(**kw))
        it_j = jft.batch_iterator(data, JTok(), jft.TrainConfig(**kw))
    else:
        rows = td.synthetic_token_dataset(13, 2)
        kw = dict(entity_types=ENTITIES, batch_size=4, seq_buckets=(8, 16),
                  seed=5)
        it_t = ttf.token_batch_iterator(rows, tok,
                                        ttf.TokenTrainConfig(**kw))
        it_j = jtf.token_batch_iterator(rows, JTok(),
                                        jtf.TokenTrainConfig(**kw))
    for _ in range(9):  # across an epoch boundary
        for a, b in zip(next(it_t), next(it_j)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# -- losses -------------------------------------------------------------------


def _loss_inputs(name: str):
    rng = np.random.default_rng(11)
    if name == "cross_entropy":
        return [rng.normal(size=(6, 5)).astype(np.float32)], \
            rng.integers(0, 5, 6).astype(np.int32)
    if name == "masked_token":
        labels = rng.integers(0, 5, (3, 7)).astype(np.int32)
        labels[0, 4:] = ttf.IGNORE_INDEX
        labels[2, :] = ttf.IGNORE_INDEX
        return [rng.normal(size=(3, 7, 5)).astype(np.float32)], labels

    def unit(n):
        x = rng.normal(size=(n, 16)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return ([unit(6), unit(6)] if name == "mnr"
            else [unit(6), unit(6), unit(6)]), None


LOSSES = {
    "cross_entropy": (lambda x, y: jft_loss_ce(x, y),
                      lambda x, y: cross_entropy_loss(x, y)),
    "masked_token": (lambda x, y: jtf.masked_token_cross_entropy(x, y),
                     lambda x, y: ttf.masked_token_cross_entropy(x, y)),
    "mnr": (lambda a, p: jef.mnr_loss(a, p, 0.05),
            lambda a, p: tef.mnr_loss(a, p, 0.05)),
    "triplet": (lambda a, p, n: jef.triplet_margin_loss(a, p, n, 0.1),
                lambda a, p, n: tef.triplet_margin_loss(a, p, n, 0.1)),
}


def jft_loss_ce(logits, labels):
    from semantic_router_tpu.parallel import cross_entropy_loss as jce

    return jce(logits, labels)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_and_gradients_match_jax(name):
    xs, labels = _loss_inputs(name)
    jfn, tfn = LOSSES[name]
    if labels is None:
        jval, jgrads = jax.value_and_grad(
            lambda *a: jfn(*a), argnums=tuple(range(len(xs))))(
                *[jnp.asarray(x) for x in xs])
        txs = [_t(x).requires_grad_(True) for x in xs]
        tval = tfn(*txs)
    else:
        jval, jgrads = jax.value_and_grad(
            lambda x: jfn(x, jnp.asarray(labels)), argnums=(0,))(
                jnp.asarray(xs[0]))
        txs = [_t(xs[0]).requires_grad_(True)]
        tval = tfn(txs[0], _t(labels))
    tval.backward()
    assert abs(tval.item() - float(jval)) <= LOSS_TOL
    for tx, jg in zip(txs, jgrads):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg),
                                   atol=LOSS_TOL, rtol=0)


def test_masked_token_loss_of_no_labelled_token_is_zero():
    labels = torch.full((2, 3), ttf.IGNORE_INDEX)
    assert float(ttf.masked_token_cross_entropy(torch.randn(2, 3, 4),
                                                labels)) == 0.0


# -- one train step ------------------------------------------------------------


def _step_inputs(kind: str):
    tok = HashTokenizer()
    if kind == "sequence":
        labels = ["a", "b", "c"]
        cfg = tft.TrainConfig(labels=labels, batch_size=4,
                              seq_buckets=(16, 32), seed=2)
        it = tft.batch_iterator(tft.synthetic_dataset(labels, 6, 1), tok,
                                cfg)
        return next(it), len(labels), jft_loss_ce, cross_entropy_loss
    cfg = ttf.TokenTrainConfig(entity_types=ENTITIES, batch_size=4,
                               seq_buckets=(16, 32), seed=2)
    it = ttf.token_batch_iterator(td.synthetic_token_dataset(12, 1), tok,
                                  cfg)
    return next(it), len(cfg.labels), jtf.masked_token_cross_entropy, \
        ttf.masked_token_cross_entropy


_JAX_STEPS: dict = {}


def _jax_loss_and_grads(kind: str, n_labels: int, jloss):
    """(Flax module, jitted value_and_grad) per kind, compiled once for the
    init and moved cases."""
    if kind not in _JAX_STEPS:
        jmod = _models(kind, n_labels)[0]

        def jfn(p, ids, mask, labels):
            return jloss(jmod.apply(p, ids, mask, task_index=0), labels)

        _JAX_STEPS[kind] = (jmod, jax.jit(jax.value_and_grad(jfn)))
    return _JAX_STEPS[kind]


@pytest.mark.parametrize("moved", [False, True], ids=["init", "moved"])
@pytest.mark.parametrize("kind", ["sequence", "token"])
def test_one_train_step_matches_jax(kind, moved):
    (ids, mask, labels), n_labels, jloss, tloss = _step_inputs(kind)
    jmod, vg = _jax_loss_and_grads(kind, n_labels, jloss)
    tmod = _models(kind, n_labels)[1]
    params = _flax_init(jmod, 3)
    if moved:
        params = _moved(params, 4)
    _port(tmod, params)
    jval, jgrads = vg(params, jnp.asarray(ids), jnp.asarray(mask),
                      jnp.asarray(labels))
    init_state, step = make_train_step(
        lambda m, i, k: m(i, k), make_lora_optimizer(tmod), tloss)
    tval = step(init_state(tmod), _t(ids), _t(mask),
                _t(labels).long())["loss"]
    # the step leaves the gradients it took at the weights before its update
    tgrads = {n: p.grad for n, p in tmod.named_parameters()
              if p.grad is not None}
    assert abs(float(tval) - float(jval)) <= STEP_LOSS_TOL
    jflat = _flat(jgrads)
    assert sorted(tgrads) == sorted(
        port_adapter_name(k) for k in jflat if k.rsplit("/", 1)[-1]
        .startswith("lora_"))
    for name, g in tgrads.items():
        want = jflat[flax_adapter_key(name)]
        bound = GRAD_REL_TOL * float(np.abs(want).max())
        assert float(np.abs(g.numpy() - want).max()) <= bound, name
        if not moved and name.endswith("lora_A"):
            assert not np.any(want) and not torch.any(g)


# -- the optimizers alone --------------------------------------------------------


class _Toy(torch.nn.Module):
    def __init__(self, w, a, b):
        super().__init__()
        self.layer = torch.nn.Module()
        self.layer.weight = torch.nn.Parameter(_t(w.T.copy()))
        self.layer.lora_A = torch.nn.Parameter(_t(a))
        self.layer.lora_B = torch.nn.Parameter(_t(b))


@pytest.mark.parametrize("which", ["adamw", "adam"])
def test_optimizer_alone_matches_optax(which):
    rng = np.random.default_rng(7)
    w = rng.normal(size=(8, 6)).astype(np.float32)
    a = rng.normal(size=(8, 3)).astype(np.float32)
    b = rng.normal(size=(3, 6)).astype(np.float32)
    grads = [{"kernel": rng.normal(size=w.shape).astype(np.float32),
              "lora_A": (rng.normal(size=a.shape) * 10.0 ** -k)
              .astype(np.float32),
              "lora_B": rng.normal(size=b.shape).astype(np.float32)}
             for k in range(3)]
    grads[1]["lora_A"][0, 0] = 1e-8  # about eps: Adam's sensitive spot
    params = {"params": {"layer": {"kernel": w, "lora_A": a, "lora_B": b}}}
    lr = 3e-3
    if which == "adamw":
        opt = j_adamw(lr, weight_decay=0.01)
    else:
        flat = jax.tree_util.tree_map_with_path(
            lambda p, _: jl.lora_param_filter(
                tuple(str(getattr(k, "key", k)) for k in p), None), params)
        opt = optax.multi_transform(
            {True: optax.adam(lr), False: optax.set_to_zero()}, flat)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    toy = _Toy(w, a, b)
    topt = make_lora_optimizer(toy, lr, 0.01) if which == "adamw" \
        else tef.make_adapter_adam(toy, lr)
    assert not toy.layer.weight.requires_grad
    for g in grads:
        jg = {"params": {"layer": {k: jnp.asarray(v) for k, v in g.items()}}}
        upd, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        toy.layer.lora_A.grad = _t(g["lora_A"])
        toy.layer.lora_B.grad = _t(g["lora_B"])
        topt.step()
    got = jp["params"]["layer"]
    np.testing.assert_array_equal(toy.layer.weight.detach().numpy().T, w)
    np.testing.assert_array_equal(np.asarray(got["kernel"]), w)
    for leaf in ("lora_A", "lora_B"):
        np.testing.assert_allclose(
            getattr(toy.layer, leaf).detach().numpy(),
            np.asarray(got[leaf]), atol=OPT_TOL, rtol=0)


# -- fine-tunes ----------------------------------------------------------------


def test_finetune_history_matches_jax():
    labels = ["alpha", "beta", "gamma"]
    data = jft.synthetic_dataset(labels, n_per_label=16)
    kw = dict(labels=labels, rank=4, alpha=8.0, learning_rate=5e-3,
              batch_size=8, num_steps=10, max_seq_len=64,
              seq_buckets=(32, 64))
    jcfg, tcfg = _cfgs(3)
    jmod, tmod = _models("sequence", 3)
    params = _flax_init(jmod, 0)
    _, jhist = jft.finetune_classifier(
        data, jft.TrainConfig(**kw), model_config=jcfg, tokenizer=JTok(),
        base_params=params, log_every=1)
    trained, thist = tft.finetune_classifier(
        data, tft.TrainConfig(**kw), model_config=tcfg,
        tokenizer=HashTokenizer(), base_params=lora_params_from_flax(
            tmod, params), log_every=1, device="cpu")
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == list(range(1, 11))
    assert set(thist[0]) == set(jhist[0]) == {"step", "loss", "wall_s",
                                              "accuracy"}
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= HISTORY_REL_TOL * abs(j["loss"])
    assert not trained.training


def test_finetune_learns_synthetic_and_adapters_roundtrip(tmp_path):
    """The JAX test's bar (tests/test_training.py) on the port, from the
    port's own seeded init, on one device."""
    labels = ["alpha", "beta", "gamma"]
    data = tft.synthetic_dataset(labels, n_per_label=24)
    cfg = tft.TrainConfig(labels=labels, rank=4, alpha=8.0,
                          learning_rate=5e-3, batch_size=8, num_steps=60,
                          max_seq_len=64, seq_buckets=(32, 64))
    module, history = tft.finetune_classifier(data, cfg, log_every=20,
                                              device="cpu")
    assert history[-1]["loss"] < history[0]["loss"]
    assert history[-1]["accuracy"] > 0.5
    path = str(tmp_path / "adapters.npz")
    tft.save_adapters(module, path)
    blobs = dict(np.load(path))
    assert blobs and all(k.rsplit("/", 1)[-1].startswith("lora_")
                         for k in blobs)
    fresh = tl.LoRAModernBertForSequenceClassification(
        module.config, module.lora, 3)
    fresh.load_state_dict({k: v.detach().clone() for k, v in
                           module.state_dict().items()})
    with torch.no_grad():
        for name, p in fresh.named_parameters():
            if tl.lora_param_filter(name):
                p.zero_()
    tft.load_adapters(fresh, path)
    for name, p in fresh.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(), dict(module.named_parameters())[name]
            .detach().numpy())
    with pytest.raises(KeyError):
        np.savez(str(tmp_path / "bad.npz"),
                 **{"params/model/nope/lora_A": np.zeros(1)})
        tft.load_adapters(fresh, str(tmp_path / "bad.npz"))


def test_only_adapters_change_and_init_is_seeded():
    labels = ["a", "b"]
    data = tft.synthetic_dataset(labels, 8)
    cfg = tft.TrainConfig(labels=labels, rank=4, alpha=8.0, batch_size=4,
                          num_steps=3, max_seq_len=32, seq_buckets=(32,),
                          learning_rate=1e-2, seed=5)
    jcfg, tcfg = _cfgs(2, 32)
    before = tl.LoRAModernBertForSequenceClassification(
        tcfg, tl.LoRAConfig(rank=4, alpha=8.0), 2)
    tl.init_lora_weights(before, torch.Generator().manual_seed(5))
    module, _ = tft.finetune_classifier(data, cfg, model_config=tcfg,
                                        device="cpu")
    moved = 0
    for name, p in module.named_parameters():
        p0 = dict(before.named_parameters())[name]
        if tl.lora_param_filter(name):
            assert not p.requires_grad or name.endswith(("lora_A",
                                                         "lora_B"))
            moved += int(not torch.equal(p, p0))
        else:
            assert torch.equal(p, p0), name
            assert not p.requires_grad
    assert moved > 0
    assert all(not torch.any(p) for n, p in before.named_parameters()
               if n.endswith("lora_B"))


@pytest.mark.parametrize("entry", ["loop", "sequence", "token"])
def test_a_mesh_over_more_than_one_device_raises(entry):
    mesh = {"dp": 2, "tp": 1}
    with pytest.raises(ValueError, match="not ported"):
        if entry == "loop":
            run_lora_training(lambda m, i, k: m(i, k), torch.nn.Linear(2, 2),
                              iter([]), 1, 1e-3, mesh_shape=mesh)
        elif entry == "sequence":
            tft.finetune_classifier(
                [("a", "a")], tft.TrainConfig(labels=["a"], mesh_shape=mesh),
                device="cpu")
        else:
            ttf.finetune_token_classifier(
                td.synthetic_token_dataset(4), ttf.TokenTrainConfig(
                    entity_types=ENTITIES, mesh_shape={"data": 4}),
                device="cpu")
    # a one-device mesh is the one device this port trains on
    toy = _Toy(np.zeros((2, 2), np.float32), np.zeros((2, 1), np.float32),
               np.zeros((1, 2), np.float32))
    assert run_lora_training(lambda m, i, k: m(i, k), toy, iter([]), 0,
                             1e-3, mesh_shape={"dp": 1, "tp": 1}) \
        == (toy, [])


def _train_pii(seed_rows: int = 3):
    tok = HashTokenizer()
    cfg = ttf.TokenTrainConfig(entity_types=ENTITIES, rank=8, alpha=16.0,
                               batch_size=8, num_steps=120, max_seq_len=64,
                               seq_buckets=(64,), learning_rate=3e-3)
    module, history = ttf.finetune_token_classifier(
        td.synthetic_token_dataset(n=64, seed=seed_rows), cfg, tokenizer=tok,
        device="cpu")
    return module, history, cfg, tok


def test_trained_token_model_scores_on_heldout_through_the_engine():
    """The JAX test's bar (tests/test_training_breadth.py): span F1 > 0.6
    on held-out rows through the port's engine, for the trained module
    (the per-task path) and for its merged serving module (the fused
    bank), which give the same spans."""
    module, history, cfg, tok = _train_pii()
    assert set(history[-1]) == {"step", "loss", "wall_s"}
    held_out = td.synthetic_token_dataset(n=16, seed=99)
    eng = InferenceEngine(InferenceEngineConfig(seq_len_buckets=[64]),
                          device="cpu")
    try:
        eng.register_task("pii", "token", module, tok, cfg.labels)
        eng.register_task("pii_served", "token",
                          tl.merged_module(module), tok, cfg.labels)
        assert eng.trunk_group("pii_served") is not None
        # the untrained weights form a trunk group of their own: a group
        # is keyed on the trunk's content, not its shape
        fresh = tl.LoRAModernBertForTokenClassification(
            module.config, module.lora, len(cfg.labels))
        tl.init_lora_weights(fresh, torch.Generator().manual_seed(cfg.seed))
        eng.register_task("pii_init", "token", tl.merged_module(fresh), tok,
                          cfg.labels)
        assert eng.trunk_group("pii_init") is not \
            eng.trunk_group("pii_served")
        report = tev.evaluate_token(eng, "pii", held_out)
        assert report.f1 > 0.6, report.to_dict()
        served = tev.evaluate_token(eng, "pii_served", held_out)
        assert served.to_dict() == report.to_dict()
        for row in held_out:
            a = eng.token_classify("pii", row.text).entities
            b = eng.token_classify("pii_served", row.text).entities
            assert [(e.type, e.start, e.end) for e in a] \
                == [(e.type, e.start, e.end) for e in b]
    finally:
        eng.shutdown()


def test_merged_module_equals_the_trained_forward():
    jmod, tmod = _models("sequence", 3)
    _port(tmod, _moved(_flax_init(jmod, 1), 2))
    served = tl.merged_module(tmod)
    assert isinstance(served, tm.ModernBertForSequenceClassification)
    assert served.config.attention_impl == "flash"
    assert not any(p.requires_grad for p in served.parameters())
    (ids, mask, _), *_ = _step_inputs("sequence")
    with torch.no_grad():
        np.testing.assert_allclose(served(_t(ids), _t(mask)).numpy(),
                                   tmod(_t(ids), _t(mask)).numpy(),
                                   atol=1e-5, rtol=0)
    emb = tl.LoRAMmBertEmbeddingModel(_cfgs(2)[1], tl.LoRAConfig(rank=4))
    tl.init_lora_weights(emb, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for n, p in emb.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(0, 0.05)
        np.testing.assert_allclose(
            tl.merged_module(emb)(_t(ids), _t(mask)).numpy(),
            emb(_t(ids), _t(mask)).numpy(), atol=1e-5, rtol=0)
    with pytest.raises(TypeError):
        tl.merged_module(torch.nn.Linear(2, 2))


# -- evaluation ------------------------------------------------------------------


def _oracle():
    spec = importlib.util.spec_from_file_location(
        "_jax_training_breadth", REPO / "tests" / "test_training_breadth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TestEvaluationHarness.OracleEngine()


def test_evaluation_reports_equal_the_reference():
    eng = _oracle()
    for task, seed in (("intent", 1), ("jailbreak", 2)):
        data = td.synthetic_sequence_dataset(task, n_per_label=8, seed=seed)
        assert tev.evaluate_sequence(eng, task, data).to_dict() \
            == jev.evaluate_sequence(eng, task, data).to_dict()
    rows = td.synthetic_token_dataset(n=24, seed=2)
    got = tev.evaluate_token(eng, "pii", rows)
    want = jev.evaluate_token(eng, "pii", rows)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()
    with pytest.raises(ValueError):
        tev.evaluate_sequence(eng, "intent", [])


# -- adapter files across the packages --------------------------------------------


@pytest.mark.parametrize("kind", ["sequence", "token", "embedding"])
def test_adapter_files_load_across_the_packages(kind, tmp_path):
    if kind == "embedding":
        jcfg, tcfg = _cfgs(2)
        jmod = jl.LoRAMmBertEmbeddingModel(jcfg, jl.LoRAConfig(rank=4))
        tmod = tl.LoRAMmBertEmbeddingModel(tcfg, tl.LoRAConfig(rank=4))
        save_t, load_t = tef.save_embedding_adapters, \
            tef.load_embedding_adapters
        save_j, load_j = jef.save_embedding_adapters, \
            jef.load_embedding_adapters
    else:
        jmod, tmod = _models(kind, 5)
        save_t, load_t = tft.save_adapters, tft.load_adapters
        save_j, load_j = jft.save_adapters, jft.load_adapters
    base = _flax_init(jmod, 4)
    trained = _moved(base, 5)
    (ids, mask, _), *_ = _step_inputs("sequence")

    apply = jax.jit(jmod.apply)

    def jout(p):
        return np.asarray(apply(p, jnp.asarray(ids), jnp.asarray(mask)))

    # JAX writes, the port reads
    path_j = str(tmp_path / "jax.npz")
    save_j(trained, path_j)
    _port(tmod, base)
    load_t(tmod, path_j)
    with torch.no_grad():
        got = tmod(_t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, jout(trained), atol=1e-5, rtol=0)
    # the port writes the same keys, and JAX reads them
    path_t = str(tmp_path / "port.npz")
    save_t(tmod, path_t)
    keys_t, keys_j = set(np.load(path_t).files), set(np.load(path_j).files)
    assert keys_t == keys_j
    assert all(port_adapter_name(flax_adapter_key(port_adapter_name(k)))
               == port_adapter_name(k) for k in keys_t)
    restored = load_j(base, path_t)
    np.testing.assert_allclose(jout(restored), got, atol=1e-5, rtol=0)
    for k, v in np.load(path_t).items():
        np.testing.assert_array_equal(v, _flat(trained)[k])


# -- embedding fine-tunes ----------------------------------------------------------


TOK = HashTokenizer(vocab_size=2048)
FAST = tef.EmbedTrainConfig(seq_len=32, batch_size=12, steps=50,
                            learning_rate=1e-3, iterations=2, seed=3)


def test_cache_mnr_improves_retrieval_and_only_adapters_change():
    pairs = tef.synthetic_pair_dataset("programming", n=48, seed=3)
    module, _ = tef._make_lora_embedder(FAST, device="cpu")
    before_state = {k: v.clone() for k, v in module.state_dict().items()}
    before = tef.evaluate_retrieval_mrr(module, TOK, pairs, FAST.seq_len)
    module, history = tef.finetune_cache_embeddings(
        pairs, FAST, tokenizer=TOK, module=module)
    after = tef.evaluate_retrieval_mrr(module, TOK, pairs, FAST.seq_len)
    assert history[-1]["loss"] < history[0]["loss"]
    assert after > before, (before, after)
    moved = 0
    for k, v in module.state_dict().items():
        if tl.lora_param_filter(k):
            moved += int(not torch.equal(v, before_state[k]))
        else:
            assert torch.equal(v, before_state[k]), k
    assert moved > 0


def test_domain_adaptation_mining_improves():
    pairs = tef.synthetic_pair_dataset("medical", n=48, seed=5)
    module0, _ = tef._make_lora_embedder(FAST, device="cpu")
    before = tef.evaluate_retrieval_mrr(module0, TOK, pairs, FAST.seq_len)
    module, history = tef.finetune_domain_embeddings(
        pairs, FAST, tokenizer=TOK, device="cpu")
    after = tef.evaluate_retrieval_mrr(module, TOK, pairs, FAST.seq_len)
    assert {h["round"] for h in history} == {0, 1}
    assert after > before, (before, after)


def test_embed_step_and_mining_match_jax():
    """On the same Flax-initialised embedder: ``embed_texts`` within 1e-5,
    the same hard negatives (never gold), and the first step's MNR loss
    within 1e-4 relative of the JAX loss on the JAX trainer's first batch
    (its seeded draw, its towers, ``mnr_loss``)."""
    cfg = tef.EmbedTrainConfig(seq_len=32, batch_size=8, steps=1, seed=6,
                               learning_rate=1e-3, iterations=1)
    jcfg = jm.ModernBertConfig(hidden_size=128, intermediate_size=256,
                               num_hidden_layers=2, num_attention_heads=4,
                               vocab_size=2048, pad_token_id=0)
    jmod, params, _ = jef._make_lora_embedder(cfg, jcfg)
    params = _moved(params, 8)
    tmod = tl.LoRAMmBertEmbeddingModel(tef.default_embed_config(),
                                       tl.LoRAConfig(rank=cfg.lora_rank))
    state = lora_params_from_flax(tmod, params)
    _port(tmod, params)
    pairs = tef.synthetic_pair_dataset("programming", n=16, seed=6)
    np.testing.assert_allclose(
        tef.embed_texts(tmod, TOK, pairs.corpus, cfg.seq_len, batch=8),
        jef.embed_texts(jmod, params, TOK, pairs.corpus, cfg.seq_len,
                        batch=8), atol=1e-5, rtol=0)
    negs = tef.mine_hard_negatives(tmod, TOK, pairs, cfg)
    assert negs == jef.mine_hard_negatives(jmod, params, TOK, pairs, cfg)
    assert all(n != g for n, g in zip(negs, pairs.gold))
    idx = np.random.default_rng(cfg.seed).choice(
        len(pairs.anchors), size=cfg.batch_size, replace=False)
    towers = [jef.embed_texts(jmod, params, TOK, [texts[i] for i in idx],
                              cfg.seq_len, batch=8)
              for texts in (pairs.anchors, pairs.positives)]
    want = float(jef.mnr_loss(jnp.asarray(towers[0]), jnp.asarray(towers[1]),
                              cfg.temperature))
    th = tef.finetune_cache_embeddings(pairs, cfg, tokenizer=TOK,
                                       base_params=state, device="cpu")[1]
    assert abs(th[0]["loss"] - want) <= 1e-4 * abs(want)


# -- the command lines -----------------------------------------------------------


def _cli(module: str, *args, cuda_visible: bool = True):
    env = dict(os.environ)
    if not cuda_visible:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_classifier_cli_writes_adapters_jax_reads(tmp_path):
    out = str(tmp_path / "adapters.npz")
    tft.main(["--labels", "a,b", "--steps", "3", "--batch-size", "4",
              "--rank", "4", "--alpha", "8", "--out", out,
              "--device", "cpu"])
    jmod = jl.LoRAModernBertForSequenceClassification(
        jm.ModernBertConfig(vocab_size=1024, hidden_size=64,
                            intermediate_size=96, num_hidden_layers=4,
                            num_attention_heads=4,
                            max_position_embeddings=512,
                            local_attention=32, num_labels=2),
        jl.LoRAConfig(rank=4, alpha=8.0), 2)
    base = _flax_init(jmod)
    loaded = _flat(jft.load_adapters(base, out))
    blobs = dict(np.load(out))
    assert blobs and set(blobs) <= set(loaded)
    for k, v in blobs.items():
        np.testing.assert_array_equal(loaded[k], v)


def test_embedding_cli_writes_adapters_jax_reads(tmp_path, capsys):
    tef.main(["--mode", "domain", "--steps", "2", "--iterations", "1",
              "--output", str(tmp_path), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mode"] == "domain" and 0.0 <= line["mrr"] <= 1.0
    jmod, params, _ = jef._make_lora_embedder(jef.EmbedTrainConfig())
    loaded = _flat(jef.load_embedding_adapters(
        params, str(tmp_path / "adapters.npz")))
    blobs = dict(np.load(tmp_path / "adapters.npz"))
    assert blobs and set(blobs) <= set(loaded)
    assert json.loads((tmp_path / "history.json").read_text())["history"]


def test_clis_without_a_gpu_and_without_device_exit_nonzero(monkeypatch):
    proc = _cli("semantic_router_tpu_torch.training.finetune", "--labels",
                "a,b", "--steps", "1", cuda_visible=False)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(REPO / "adapters.npz")
    # the embedding CLI raises the same error before any work (an uncaught
    # exception under ``python -m`` exits 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tef.main(["--steps", "1", "--output", str(REPO / "no-such-dir")])
    assert not os.path.exists(REPO / "no-such-dir")
