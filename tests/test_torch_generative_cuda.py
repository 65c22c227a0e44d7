"""DeBERTa-v3 classifiers and the Qwen3 guard on the card, at tiny widths,
against the port on the CPU: a DeBERTa per-task step captured and
replayed equal to its eager forward and to the CPU's logits; the guard's
prefill and decode step captured once per shape and replayed, tokens
equal to the eager step's and to the CPU's wherever the CPU's top-2
margin is clear, adapters switching with no new capture; DeBERTa and
generative checkpoints booting through ``build_engine`` with no device
argument and routing as the CPU build does.  ``cuda``-marked: skips
without a GPU.  Imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_generative_cuda.py``; chip_smoke.py's phase 13 does)."""

import pytest
import torch

from semantic_router_tpu_torch.config import InferenceEngineConfig
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.models import deberta as tdeb
from semantic_router_tpu_torch.models import generate as tgen
from semantic_router_tpu_torch.models.lora import LoRAConfig
from semantic_router_tpu_torch.models.qwen3 import Qwen3Config
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer

TOL = 1e-4
MARGIN = 1e-3
DEB = dict(vocab_size=200, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=512, position_buckets=32)
QWEN = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16)
TEXTS = ["please check whether the moon landing happened in 1969",
         "call me at 555 0100 or write to jane@example.com",
         " ".join(f"w{i}" for i in range(90)), "hi"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph capture has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _seeded(module, seed: int, std: float = 0.05):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            p.copy_(torch.randn(p.shape, generator=gen) * std
                    + (1.0 if p.dim() == 1 and "bias" not in name else 0.0))
    return module


def _deberta_engine(device, kind: str, labels):
    cfg = tdeb.DebertaV3Config(**DEB, num_labels=len(labels))
    cls = tdeb.DebertaV3ForTokenClassification if kind == "token" \
        else tdeb.DebertaV3ForSequenceClassification
    module = _seeded(cls(cfg), 3 if kind == "token" else 4)
    eng = InferenceEngine(InferenceEngineConfig(
        max_batch_size=4, max_wait_ms=1.0, seq_len_buckets=[32, 128]),
        device=device)
    eng.register_task("t", kind, module, HashTokenizer(200), labels,
                      max_seq_len=128)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sequence", "token"])
def test_deberta_step_replays_equal_to_eager_and_the_cpu(cuda, kind):
    labels = ["a", "b", "c"]
    card, cpu = (_deberta_engine(d, kind, labels) for d in (cuda, "cpu"))
    try:
        for _ in range(2):  # capture, then replay
            for text in TEXTS:
                if kind == "token":
                    g = card.token_classify("t", text, threshold=0.0)
                    w = cpu.token_classify("t", text, threshold=0.0)
                    assert [(e.type, e.start, e.end) for e in g.entities] \
                        == [(e.type, e.start, e.end) for e in w.entities]
                else:
                    g, w = card.classify("t", text), cpu.classify("t", text)
                    assert g.label == w.label
                    for lab in w.probs:
                        assert abs(g.probs[lab] - w.probs[lab]) <= TOL
        hows = {s["graph"] for s in card.steps()}
        assert hows == {"captured", "replayed"}
        module = card._tasks["t"].module
        ids = torch.randint(3, 200, (4, 128), generator=torch.Generator()
                            .manual_seed(0))
        mask = torch.ones(4, 128, dtype=torch.int32)
        mask[1, 60:] = 0
        mask[3] = 0
        (replay,), how = card._task_step(card._tasks["t"], 128, 4,
                                         [ids, mask])
        (replay2,), how2 = card._task_step(card._tasks["t"], 128, 4,
                                           [ids, mask])
        assert (how, how2) == ("captured", "replayed")
        with torch.inference_mode():
            eager = module(ids.to(cuda), mask.to(cuda)).float().cpu()
            ref = cpu._tasks["t"].module(ids, mask)
        assert torch.isfinite(replay2).all()
        torch.testing.assert_close(replay2, eager, atol=1e-5, rtol=0)
        torch.testing.assert_close(replay2, ref, atol=TOL, rtol=0)
    finally:
        card.shutdown()
        cpu.shutdown()


def _guard(device, lora=LoRAConfig(rank=4, alpha=8.0, num_tasks=2)):
    cfg = Qwen3Config(**QWEN)
    dec = _seeded(tgen.Qwen3Decoder(cfg, lora), 7, std=0.08)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name.endswith("lora_B"):
                p[0].zero_()  # adapter 0: the identity
    return tgen.GreedyGenerator(cfg, dec, HashTokenizer(512),
                                device=device)


def _agree(card, cpu):
    """Tokens equal up to the first step where the CPU's top-2 margin is
    under MARGIN (a near-tie either side may break), and always the
    first token."""
    for g, w in zip(card, cpu):
        assert g.token_ids[:1] == w.token_ids[:1]
        for t, (a, b) in enumerate(zip(g.token_ids, w.token_ids)):
            if w.margins[t] < MARGIN:
                break
            assert a == b, t


@pytest.mark.cuda
def test_guard_decode_replays_equal_to_eager_and_the_cpu(cuda):
    card, cpu = _guard(cuda), _guard("cpu")
    prompts = [tgen.build_guard_prompt(t) for t in TEXTS[:3]]
    for adapter in (0, 1, 0):
        replay = card.generate(prompts, 12, task_index=adapter)
        stats = dict(card.stats)
        eager = card.generate(prompts, 12, task_index=adapter, eager=True)
        want = cpu.generate(prompts, 12, task_index=adapter)
        assert [r.token_ids for r in replay] == [r.token_ids for r in eager]
        _agree(replay, want)
        assert set(stats["graph"]) <= {"captured", "replayed"}
    # one prefill and one decode capture for the shape, whichever adapter
    assert card.graphs.captured() == 2
    assert stats["graph"] == {"replayed": stats["steps"]}
    assert stats["prefill_graph"] == "replayed"
    a0 = card.generate(prompts, 12, task_index=0)
    a1 = card.generate(prompts, 12, task_index=1)
    assert [r.token_ids for r in a0] != [r.token_ids for r in a1]


@pytest.mark.cuda
def test_engine_guard_on_the_card(cuda):
    eng = InferenceEngine(InferenceEngineConfig(), device=cuda)
    eng.register_generative("jailbreak", _guard(cuda),
                            labels=["benign", "jailbreak"],
                            adapter_index={"default": 0, "strict": 1})
    try:
        v = eng.guard_classify("jailbreak", TEXTS[0], adapter="strict",
                               max_new_tokens=8)
        assert v.safety in tgen.GUARD_SAFETY_LEVELS
        report = eng.graph_report()["task:jailbreak"]
        assert report["graphs"] == 2 and report["pool_bytes"] >= 0
        with pytest.raises(KeyError):
            eng.generate("jailbreak", ["x"], adapter="absent")
    finally:
        eng.shutdown()


def _write_safetensors(path: str, module) -> None:
    """The module's float32 tensors in the safetensors layout (an 8-byte
    header length, a JSON header, the raw buffers): no package needed."""
    import json
    import struct

    header, blobs, offset = {}, [], 0
    for name, t in module.state_dict().items():
        raw = t.detach().float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.cuda
def test_build_engine_boots_each_kind_on_the_card(cuda, tmp_path):
    """DeBERTa sequence and token checkpoints and a generative Qwen3
    checkpoint with adapters (``config.json``, ``model.safetensors``,
    ``tokenizer.json``) boot through ``build_engine`` with no device
    argument (on the card) and route as the CPU build does."""
    import json

    from semantic_router_tpu_torch.config import load_config
    from semantic_router_tpu_torch.models.qwen3 import Qwen3ForCausalLM
    from semantic_router_tpu_torch.runtime import build_engine, \
        build_router

    tokenizers = pytest.importorskip("tokenizers")
    words = ["[PAD]", "[UNK]"] + sorted({w for t in TEXTS
                                         for w in t.lower().split()})
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    deb_hf = dict(DEB, model_type="deberta-v2", relative_attention=True,
                  pos_att_type=["p2c", "c2p"], share_att_key=True,
                  norm_rel_ebd="layer_norm", position_biased_input=False)
    ckpts = {}
    for name, module, hf in (
            ("fact", _seeded(tdeb.DebertaV3ForSequenceClassification(
                tdeb.DebertaV3Config(**DEB, num_labels=2)), 11),
             dict(deb_hf, id2label={"0": "no_fact_check_needed",
                                    "1": "needs_fact_check"})),
            ("pii", _seeded(tdeb.DebertaV3ForTokenClassification(
                tdeb.DebertaV3Config(**DEB, num_labels=3)), 12),
             dict(deb_hf, id2label={"0": "O", "1": "B-EMAIL_ADDRESS",
                                    "2": "I-EMAIL_ADDRESS"})),
            ("guard", _seeded(Qwen3ForCausalLM(Qwen3Config(**QWEN)), 13,
                              std=0.08),
             dict(QWEN, model_type="qwen3", eos_token_id=[3, 4],
                  tie_word_embeddings=True))):
        root = tmp_path / name
        root.mkdir()
        _write_safetensors(str(root / "model.safetensors"), module)
        (root / "config.json").write_text(json.dumps(hf))
        tok.save(str(root / "tokenizer.json"))
        ckpts[name] = str(root)
    config = {
        "default_model": "base",
        "engine": {"seq_len_buckets": [32, 128], "max_batch_size": 4},
        "classifier_models": {
            "fact_check": {"checkpoint": ckpts["fact"], "kind": "sequence"},
            "pii": {"checkpoint": ckpts["pii"], "kind": "token",
                    "architecture": "deberta-v3"},
            "jailbreak": {"checkpoint": ckpts["guard"], "kind": "generative",
                          "adapters": ["default", "strict"],
                          "lora": {"rank": 4, "alpha": 8}}},
        "routing": {
            "signals": {
                "jailbreak": [{"name": "guard", "method": "classifier",
                               "threshold": 0.5}],
                "pii": [{"name": "any_pii", "threshold": 0.0}],
                "fact_check": [{"name": "needs_fact_check"},
                               {"name": "no_fact_check_needed"}]},
            "decisions": [
                {"name": "guarded", "priority": 200,
                 "rules": {"operator": "OR", "conditions": [
                     {"type": "jailbreak", "name": "guard"}]},
                 "modelRefs": [{"model": "guard-model"}]},
                {"name": "checked", "priority": 100,
                 "rules": {"operator": "OR", "conditions": [
                     {"type": "fact_check", "name": "needs_fact_check"}]},
                 "modelRefs": [{"model": "careful-model"}]}]}}
    cfg = load_config(config)
    card = build_engine(cfg)
    cpu = build_engine(cfg, device="cpu")
    routers = [build_router(cfg, e) for e in (card, cpu)]
    try:
        assert card.device.type == "cuda"
        assert {t: card.task_kind(t) for t in card.tasks()} == {
            "fact_check": "sequence", "pii": "token",
            "jailbreak": "generative"}
        assert card._tasks["jailbreak"].generator.eos_token_ids == {3, 4}
        for text in TEXTS:
            body = {"model": "auto",
                    "messages": [{"role": "user", "content": text}]}
            got, want = (r.route(dict(body)) for r in routers)
            assert (got.decision is None) == (want.decision is None)
            if want.decision is not None:
                assert got.decision.decision.name == \
                    want.decision.decision.name
            assert got.model == want.model
            assert {t: sorted(n) for t, n in got.signals.matches.items()} \
                == {t: sorted(n) for t, n in want.signals.matches.items()}
        assert "task:jailbreak" in card.graph_report()
    finally:
        for r in routers:
            r.shutdown()
        card.shutdown()
        cpu.shutdown()
