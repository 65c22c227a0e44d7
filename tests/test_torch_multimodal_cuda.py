"""The multimodal surface and the bounded guard caches on the card, at tiny
widths, against the port on the CPU: SigLIP tower steps captured once per
(tower, batch) and replayed bit for bit equal to the eager run and within
1e-4 of the CPU's embeddings; an engine's ``embed_multimodal`` on the
card as on the CPU; the generator keeping at most ``MAX_CACHED_SHAPES``
KV shapes and graphs over prompts of many lengths, a returning shape
captured again with the same tokens.
``cuda``-marked: skips without a GPU.  Imports no JAX (``python -m pytest
--noconftest -m cuda tests/test_torch_multimodal_cuda.py``; chip_smoke.py's
phase 14 does)."""

import numpy as np
import pytest
import torch

from semantic_router_tpu_torch.config import InferenceEngineConfig
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.models import generate as tgen
from semantic_router_tpu_torch.models import siglip as tsig
from semantic_router_tpu_torch.models.qwen3 import Qwen3Config
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer

TOL = 1e-4
TEXT = dict(vocab_size=99, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16, projection_size=64)
VISION = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, image_size=32, patch_size=8,
              num_channels=3)
QWEN = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16)


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


def _embedder(device):
    tt, tv = tsig.SiglipTowerConfig(**TEXT), tsig.SiglipTowerConfig(**VISION)
    model = _seeded(tsig.SiglipModel(tt, tv), 5)
    return tsig.SiglipEmbedder(tt, tv, model, tokenizer=HashTokenizer(99),
                               device=device)


def _pixels(B: int) -> np.ndarray:
    return np.random.default_rng(B).normal(
        size=(B, 32, 32, 3)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5])
def test_tower_steps_replay_equal_to_eager_and_the_cpu(cuda, B):
    card, cpu = _embedder(cuda), _embedder("cpu")
    texts = [f"text number {i} " * (i + 1) for i in range(B)]
    px = _pixels(B)
    eager_t = card.embed_text(texts, eager=True)
    eager_i = card.embed_image(px, eager=True)
    hows = []
    for _ in range(3):  # capture, then replay
        t = card.embed_text(texts)
        hows.append(card.last_graph)
        i = card.embed_image(px)
        hows.append(card.last_graph)
        np.testing.assert_array_equal(t, eager_t)
        np.testing.assert_array_equal(i, eager_i)
    assert hows == ["captured"] * 2 + ["replayed"] * 4
    np.testing.assert_allclose(eager_t, cpu.embed_text(texts), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(eager_i, cpu.embed_image(px), atol=TOL,
                               rtol=TOL)
    assert card.graphs.keys() == {("text", B), ("image", B)}


@pytest.mark.cuda
def test_engine_embeds_like_the_cpu(cuda):
    out = {}
    px = _pixels(2)
    for dev in (cuda, "cpu"):
        eng = InferenceEngine(InferenceEngineConfig(), device=dev)
        eng.register_multimodal("multimodal", _embedder(dev))
        try:
            out[str(dev)] = eng.embed_multimodal(
                "multimodal", texts=["a", "b c"], images=px)
            assert eng._tasks["multimodal"].graphs.keys() == {
                ("text", 2), ("image", 2)}
        finally:
            eng.shutdown()
    for k in ("text", "image"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], atol=TOL,
                                   rtol=TOL)


@pytest.mark.cuda
def test_generator_keeps_a_bounded_set_of_shapes_on_the_card(cuda):
    qcfg = Qwen3Config(**QWEN)
    dec = _seeded(tgen.Qwen3Decoder(qcfg), 7)
    gen = tgen.GreedyGenerator(qcfg, dec, HashTokenizer(512),
                               eos_token_ids=[3], device=cuda)
    calls = [("short prompt", 6), (" ".join(f"w{i}" for i in range(40)), 6),
             ("mid prompt", 100), (" ".join(f"v{i}" for i in range(50)), 150),
             ("x y", 250), ("z", 300)]
    tokens, pools = [], []
    for prompt, n in calls * 2:
        tokens.append(gen.generate([prompt], max_new_tokens=n)[0].token_ids)
        pools.append(gen.graphs.pool_bytes())
        assert len(gen._caches) <= tgen.MAX_CACHED_SHAPES
        assert {(k[1], k[-1]) for k in gen.graphs.keys()} <= set(gen._caches)
        # every shape of the second pass was evicted: captured again
        assert len(tokens) <= len(calls) \
            or gen.stats["prefill_graph"] == "captured"
    assert tokens[len(calls):] == tokens[:len(calls)]
    # once the bound is reached the kept graphs' pool stops growing
    assert max(pools[len(calls):]) <= max(pools[:len(calls)])
