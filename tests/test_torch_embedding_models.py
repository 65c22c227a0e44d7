"""The port's Qwen3 embedding model and Gemma3 encoder against the JAX
package's on the same weights, on the CPU, in float32, within 1e-4
(the ROADMAP's tolerance for model paths): ``last_token_pool`` on padded
rows; ``Qwen3EmbeddingModel``; ``GemmaModel`` over every layer kind
(sliding and full, GQA and MHA, linear rope scaling, causal on and off,
windows narrower and wider than the sequence); ``GemmaEmbeddingModel``
with and without a bottleneck; padded rows included everywhere.  Flax
params cross through ``models.convert.lora_params_from_flax``, which must
fit each module exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.models import gemma as jg
from semantic_router_tpu.models import qwen3 as jq
from semantic_router_tpu_torch.models import gemma as tg
from semantic_router_tpu_torch.models import qwen3 as tq
from semantic_router_tpu_torch.models.convert import lora_params_from_flax

TOL = 1e-4
B, S = 3, 24
QWEN_TINY = dict(vocab_size=300, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=16)
GEMMA_TINY = dict(vocab_size=300, hidden_size=48, intermediate_size=80,
                  num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, sliding_window=6,
                  query_pre_attn_scalar=16.0, rope_theta=10000.0,
                  rope_local_base_freq=1000.0, sliding_pattern=3)
# every Gemma layer kind: (overrides, causal)
GEMMA_VARIANTS = {
    "bidirectional_gqa": ({}, False),
    "causal_gqa": ({}, True),
    "mha_scaled_rope": (dict(num_key_value_heads=4,
                             rope_scaling_factor=4.0), False),
    "causal_scaled_rope": (dict(rope_scaling_factor=8.0), True),
    "explicit_layer_types": (dict(layer_types=(
        "full_attention", "sliding_attention", "full_attention")), False),
    "window_past_sequence": (dict(sliding_window=64), False),
    "one_kv_head_bias": (dict(num_key_value_heads=1, attention_bias=True),
                         False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int, vocab: int = 300):
    """[B, S] ids and a mask with padded rows: full, half, 3 tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _jitter(params, seed: int, std: float = 0.05):
    """Random params with every leaf moved off its init (Gemma's norm
    weights start at zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, std, np.shape(a))
        .astype(np.float32), params)


def _pair(jmodule, tmodule, ids, seed):
    params = _jitter(jmodule.init(jax.random.PRNGKey(seed),
                                  jnp.asarray(ids)), seed)
    tmodule.load_state_dict(lora_params_from_flax(tmodule, params))
    return params, tmodule.eval()


def _close(want, got, valid=None):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert want.shape == got.shape
    if valid is not None:  # padded positions are not compared
        want, got = want[valid], got[valid]
    err = float(np.max(np.abs(want - got)))
    assert err <= TOL, err
    return err


def test_last_token_pool_matches_on_padded_rows():
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(B, S, 8)).astype(np.float32)
    _ids, mask = _inputs(3)
    mask = np.concatenate([mask, np.zeros((1, S), np.int32)])
    hidden = np.concatenate([hidden, hidden[:1]])
    want = jq.last_token_pool(jnp.asarray(hidden), jnp.asarray(mask))
    got = tq.last_token_pool(torch.from_numpy(hidden),
                             torch.from_numpy(mask))
    assert np.array_equal(np.asarray(want), got.numpy())
    # the rows' last real tokens, and position 0 for an all-padding row
    assert np.array_equal(got.numpy(), hidden[[0, 1, 2, 3],
                                              [S - 1, S // 2 - 1, 2, 0]])


@pytest.mark.parametrize("variant", ["gqa", "mha_bias"])
def test_qwen3_embedding_model_matches(variant):
    cfg = dict(QWEN_TINY)
    if variant == "mha_bias":
        cfg.update(num_key_value_heads=4, attention_bias=True)
    ids, mask = _inputs(11)
    params, tm = _pair(jq.Qwen3EmbeddingModel(jq.Qwen3Config(**cfg)),
                       tq.Qwen3EmbeddingModel(tq.Qwen3Config(**cfg)), ids,
                       11)
    want = jq.Qwen3EmbeddingModel(jq.Qwen3Config(**cfg)).apply(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(want, got)
    assert torch.allclose(got.norm(dim=-1), torch.ones(B), atol=1e-5)


def test_flax_state_for_refuses_a_tree_that_does_not_fit():
    cfg = dict(QWEN_TINY)
    ids, _ = _inputs(1)
    params = jq.Qwen3EmbeddingModel(jq.Qwen3Config(**cfg)).init(
        jax.random.PRNGKey(0), jnp.asarray(ids))
    wider = tq.Qwen3EmbeddingModel(tq.Qwen3Config(
        **dict(cfg, num_hidden_layers=3)))
    with pytest.raises(KeyError, match="missing"):
        lora_params_from_flax(wider, params)
    narrower = tq.Qwen3EmbeddingModel(tq.Qwen3Config(
        **dict(cfg, intermediate_size=64)))
    with pytest.raises(ValueError, match="shape mismatch"):
        lora_params_from_flax(narrower, params)


def _gemma_cfgs(variant: str):
    over, causal = GEMMA_VARIANTS[variant]
    kw = dict(GEMMA_TINY, **over)
    return (jg.GemmaConfig(**kw, causal=causal),
            tg.GemmaConfig(**kw, causal=causal))


@pytest.mark.parametrize("variant", sorted(GEMMA_VARIANTS))
def test_gemma_model_matches_on_every_layer_kind(variant):
    jcfg, tcfg = _gemma_cfgs(variant)
    ids, mask = _inputs(21)
    params, tm = _pair(jg.GemmaModel(jcfg), tg.GemmaModel(tcfg), ids, 21)
    want = jg.GemmaModel(jcfg).apply(params, jnp.asarray(ids),
                                     jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(want, got, valid=mask.astype(bool))
    kinds = {tcfg.layer_type(i) for i in range(tcfg.num_hidden_layers)}
    assert kinds == {"sliding_attention", "full_attention"}


@pytest.mark.parametrize("bottleneck", [(), (96, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_gemma_embedding_model_matches(bottleneck, causal):
    kw = dict(GEMMA_TINY, rope_scaling_factor=2.0)
    jcfg = jg.GemmaConfig(**kw, causal=causal)
    tcfg = tg.GemmaConfig(**kw, causal=causal)
    ids, mask = _inputs(31)
    params, tm = _pair(jg.GemmaEmbeddingModel(jcfg, bottleneck),
                       tg.GemmaEmbeddingModel(tcfg, bottleneck), ids, 31)
    want = jg.GemmaEmbeddingModel(jcfg, bottleneck).apply(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(want, got)
    assert got.shape == (B, bottleneck[-1] if bottleneck else 48)
    assert torch.allclose(got.norm(dim=-1), torch.ones(B), atol=1e-5)


def test_gemma_rmsnorm_and_config_match():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    want = jg.GemmaRMSNorm().apply({"params": {"weight": w}},
                                   jnp.asarray(x))
    norm = tg.GemmaRMSNorm(16)
    norm.load_state_dict({"weight": torch.from_numpy(w)})
    with torch.no_grad():
        _close(want, norm(torch.from_numpy(x)))
    hf = {"vocab_size": 262144, "hidden_size": 768,
          "intermediate_size": 1152, "num_hidden_layers": 24,
          "num_attention_heads": 3, "num_key_value_heads": 1,
          "head_dim": 256, "rope_theta": 1e6, "rope_local_base_freq": 1e4,
          "sliding_window": 512, "query_pre_attn_scalar": 256,
          "rope_scaling": {"rope_type": "linear", "factor": 8.0},
          "layer_types": ["sliding_attention"] * 5 + ["full_attention"],
          "max_position_embeddings": 2048}

    class Obj:
        pass

    obj = Obj()
    obj.__dict__.update(hf)
    want = dataclasses.asdict(jg.GemmaConfig.from_hf(obj))
    want.pop("dtype")
    assert dataclasses.asdict(tg.GemmaConfig.from_hf(hf)) == want
    assert dataclasses.asdict(tg.GemmaConfig.from_hf(obj)) == want
