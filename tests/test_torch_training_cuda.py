"""LoRA training on the card, cut to tiny sizes: one train step of the
sequence and of the token classifier on ``cuda`` matches the same step of
the CPU port on the same seeded weights and batch (the loss within 1e-4
relative, each adapter gradient within 1e-4 of its largest magnitude, the
updated adapters within 1e-4 of theirs), with the adapters moved off
their zero init so every gradient is live; the base stays bit-identical.
Then the trained token model, merged into a plain classifier with flash
attention, serves from an engine on the card through K1 and K2 with the
trained module's labels.  ``cuda``-marked: skips without a GPU.  Imports
no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_training_cuda.py``; chip_smoke.py runs it after phase
22)."""

import dataclasses

import numpy as np
import pytest
import torch

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.models.lora import (
    LoRAConfig,
    LoRAModernBertForSequenceClassification,
    LoRAModernBertForTokenClassification,
    init_lora_weights,
    lora_param_filter,
    merged_module,
)
from semantic_router_tpu_torch.models.modernbert import ModernBertConfig
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.parallel import make_lora_optimizer, \
    make_train_step
from semantic_router_tpu_torch.parallel.train_step import cross_entropy_loss
from semantic_router_tpu_torch.training.datasets import \
    synthetic_token_dataset
from semantic_router_tpu_torch.training.finetune import TrainConfig, \
    batch_iterator, synthetic_dataset
from semantic_router_tpu_torch.training.token_finetune import (
    TokenTrainConfig,
    masked_token_cross_entropy,
    token_batch_iterator,
)
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available(), reason="needs a CUDA device")]

TOL = 1e-4
CFG = dict(vocab_size=1024, hidden_size=64, intermediate_size=96,
           num_hidden_layers=4, num_attention_heads=4,
           max_position_embeddings=128, local_attention=32)
ENTITIES = ["EMAIL", "PHONE", "CARD"]


@pytest.fixture(autouse=True)
def _exact_f32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _setup(kind: str):
    tok = HashTokenizer()
    if kind == "sequence":
        labels = ["a", "b", "c"]
        batch = next(batch_iterator(
            synthetic_dataset(labels, 8, seed=1), tok,
            TrainConfig(labels=labels, batch_size=8, seq_buckets=(32, 64))))
        cls, n, loss = LoRAModernBertForSequenceClassification, 3, \
            cross_entropy_loss
    else:
        tcfg = TokenTrainConfig(entity_types=ENTITIES, batch_size=8,
                                seq_buckets=(32,))
        batch = next(token_batch_iterator(synthetic_token_dataset(16, 1),
                                          tok, tcfg))
        cls, n, loss = LoRAModernBertForTokenClassification, \
            len(tcfg.labels), masked_token_cross_entropy
    module = cls(ModernBertConfig(**CFG, num_labels=n),
                 LoRAConfig(rank=4, alpha=8.0), n)
    init_lora_weights(module, torch.Generator().manual_seed(7))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(8)
        for name, p in sorted(module.named_parameters()):
            if name.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return module, batch, loss


def _step(module, batch, loss, device: str):
    module = module.to(device)
    init_state, step = make_train_step(
        lambda m, i, k: m(i, k), make_lora_optimizer(module, 1e-3), loss)
    state = init_state(module)
    ids, mask, labels = (torch.from_numpy(a).to(device) for a in batch)
    metrics = step(state, ids, mask, labels.long())
    grads = {n: p.grad.detach().cpu() for n, p in module.named_parameters()
             if p.grad is not None}
    return float(metrics["loss"]), grads, {
        k: v.detach().cpu() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("kind", ["sequence", "token"])
def test_one_train_step_on_the_card_matches_the_cpu(kind):
    module, batch, loss = _setup(kind)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    cpu = type(module)(module.config, module.lora,
                       module.classifier.out_features)
    cpu.load_state_dict(before)
    c_loss, c_grads, c_state = _step(cpu, batch, loss, "cpu")
    g_loss, g_grads, g_state = _step(module, batch, loss, "cuda")
    assert abs(g_loss - c_loss) <= TOL * abs(c_loss)
    assert sorted(g_grads) == sorted(c_grads) \
        and all(lora_param_filter(n) for n in g_grads)
    for name, g in c_grads.items():
        scale = float(g.abs().max())
        assert scale > 0, name
        assert float((g_grads[name] - g).abs().max()) <= TOL * scale, name
    for name, t in before.items():
        if lora_param_filter(name):
            assert float((g_state[name] - c_state[name]).abs().max()) <= TOL
            assert not torch.equal(g_state[name], t), name
        else:
            assert torch.equal(g_state[name], t), name


def test_trained_token_model_serves_through_k1_and_k2():
    module, batch, loss = _setup("token")
    _step(module, batch, loss, "cuda")
    labels = TokenTrainConfig(entity_types=ENTITIES).labels
    served = merged_module(module)
    assert dataclasses.replace(served.config).attention_impl == "flash"
    engine = InferenceEngine(load_config({"engine": {
        "max_batch_size": 8, "max_wait_ms": 1.0, "seq_len_buckets": [32],
        "kernels": {"epilogue": {"enabled": True}}}}).engine, device="cuda")
    tok = HashTokenizer()
    try:
        engine.register_task("pii", "token", served, tok, labels,
                             max_seq_len=32)
        rows = synthetic_token_dataset(8, 5)
        _cuda.reset_launch_counts()
        for row in rows:
            engine.token_classify("pii", row.text)
        launches = _cuda.launch_counts()
        assert launches["flash_attention"] > 0
        assert launches["head_epilogue"] > 0
        g = engine.trunk_group("pii")
        ids = np.zeros((len(rows), 32), np.int64)
        mask = np.zeros((len(rows), 32), np.int32)
        for i, row in enumerate(rows):
            e = tok.encode(row.text, max_length=32)
            ids[i, :len(e.ids)] = e.ids
            mask[i, :len(e.ids)] = 1
        ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
        with torch.inference_mode():
            _, got = g.forward(ids, mask, "tok", g.demux, True)
            want = module.eval()(ids, mask)
        got = got[:, :, g.demux["tok_row_of"]["pii"], :len(labels)]
        real = mask.bool()
        assert float((got[real] - want[real]).abs().max()) <= TOL
    finally:
        engine.shutdown()
