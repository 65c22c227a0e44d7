"""Parity of the PyTorch port's ModernBERT and head bank with the JAX
reference on the CPU: the same Flax weights (carried over with
``params_from_flax``) and the same numpy inputs through both.  Optionally
also against ``transformers.ModernBertModel``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.engine.testing import TINY as JAX_TINY
from semantic_router_tpu.models import lora as jlora
from semantic_router_tpu.models import modernbert as jmb
from semantic_router_tpu_torch.engine.testing import TINY
from semantic_router_tpu_torch.models import (
    ModernBertConfig,
    ModernBertForSequenceClassification,
    ModernBertForTokenClassification,
    ModernBertModel,
    apply_head_bank,
    head_bank_entry,
    params_from_flax,
    read_safetensors,
    stack_head_bank,
)
from semantic_router_tpu_torch.models.lora import bank_to_device

SMALL_YARN = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96,
    num_hidden_layers=4, num_attention_heads=4,
    max_position_embeddings=256, local_attention=8, pad_token_id=0,
    rope_scaling={"rope_type": "yarn", "factor": 4.0,
                  "original_max_position_embeddings": 64},
)


def test_tiny_is_the_reference_tiny():
    assert TINY == JAX_TINY


def _inputs(vocab, B=3, S=20, lengths=(20, 13, 5), seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    ids = np.where(mask == 1, ids, 0)
    return ids, mask


def _pair(kind, fields, num_labels=5, seed=0, **jax_overrides):
    """(flax module, flax params, torch module) on the same weights."""
    jcfg = jmb.ModernBertConfig(**{**fields, "num_labels": num_labels,
                                   **jax_overrides})
    tcfg = ModernBertConfig(**{**fields, "num_labels": num_labels,
                               **jax_overrides})
    jcls = {"trunk": jmb.ModernBertModel,
            "sequence": jmb.ModernBertForSequenceClassification,
            "token": jmb.ModernBertForTokenClassification}[kind]
    tcls = {"trunk": ModernBertModel,
            "sequence": ModernBertForSequenceClassification,
            "token": ModernBertForTokenClassification}[kind]
    jm = jcls(jcfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))
    tm = tcls(tcfg)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm.eval()


def _run(jm, params, tm, ids, mask):
    ref = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(),
                 torch.from_numpy(mask)).numpy()
    return got, ref


class TestModernBertParity:
    @pytest.mark.parametrize("fields", [TINY, SMALL_YARN],
                             ids=["tiny", "4layer_h64_yarn"])
    @pytest.mark.parametrize("kind", ["trunk", "sequence", "token"])
    def test_matches_flax(self, fields, kind):
        jm, params, tm = _pair(kind, fields)
        ids, mask = _inputs(fields["vocab_size"])
        got, ref = _run(jm, params, tm, ids, mask)
        if kind == "sequence":
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        else:  # padded positions are not compared
            real = mask.astype(bool)
            np.testing.assert_allclose(got[real], ref[real], atol=1e-4,
                                       rtol=0)

    @pytest.mark.parametrize("impl", ["chunked", "flash"])
    def test_attention_impls_match_dense_flax(self, impl):
        fields = dict(SMALL_YARN, chunk_block_size=8)
        jm, params, _ = _pair("sequence", fields)
        tm = ModernBertForSequenceClassification(ModernBertConfig(
            **{**fields, "num_labels": 5, "attention_impl": impl}))
        tm.load_state_dict(params_from_flax(params))
        ids, mask = _inputs(fields["vocab_size"])
        got, ref = _run(jm, params, tm.eval(), ids, mask)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)

    def test_mean_pooling(self):
        jm, params, tm = _pair("sequence", TINY,
                               classifier_pooling="mean")
        ids, mask = _inputs(TINY["vocab_size"])
        got, ref = _run(jm, params, tm, ids, mask)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)

    def test_hf_names_and_from_hf(self):
        tm = ModernBertForSequenceClassification(
            ModernBertConfig(**{**TINY, "num_labels": 3}))
        names = set(tm.state_dict())
        assert "model.embeddings.tok_embeddings.weight" in names
        assert "model.layers.1.attn.Wqkv.weight" in names
        assert "model.layers.0.attn_norm.weight" not in names  # identity
        assert {"head.dense.weight", "head.norm.weight", "classifier.weight",
                "classifier.bias"} <= names
        cfg = ModernBertConfig.from_hf(
            {**TINY, "id2label": {"0": "a", "1": "b", "2": "c"}})
        assert cfg.num_labels == 3 and cfg.local_attention == 8


class TestHuggingFaceOracle:
    def test_trunk_matches_transformers(self):
        transformers = pytest.importorskip("transformers")
        hcfg = transformers.ModernBertConfig(
            **{k: v for k, v in SMALL_YARN.items() if k != "rope_scaling"},
            attn_implementation="eager", reference_compile=False)
        torch.manual_seed(0)
        hf = transformers.ModernBertModel(hcfg).eval()
        tm = ModernBertModel(ModernBertConfig.from_hf(hcfg)).eval()
        tm.load_state_dict(hf.state_dict())
        ids, mask = _inputs(SMALL_YARN["vocab_size"])
        with torch.no_grad():
            ref = hf(torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long()
                     ).last_hidden_state.numpy()
            got = tm(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask)).numpy()
        real = mask.astype(bool)
        np.testing.assert_allclose(got[real], ref[real], atol=2e-4,
                                   rtol=1e-3)


def _bank_entries(D=32, seed=6):
    rng = np.random.default_rng(seed)
    entries = []
    for i, L in enumerate((5, 2, 3)):
        entries.append({
            "dense_kernel": (rng.standard_normal((D, D)) * 0.1
                             ).astype(np.float32),
            "dense_bias": (rng.standard_normal(D) * 0.1).astype(np.float32),
            "lora_A": (rng.standard_normal((D, 4)) * 0.1).astype(np.float32)
            if i == 1 else None,
            "lora_B": (rng.standard_normal((4, D)) * 0.1).astype(np.float32)
            if i == 1 else None,
            "scale": 2.0 if i == 1 else 0.0,
            "norm_scale": (1 + 0.1 * rng.standard_normal(D)
                           ).astype(np.float32),
            "norm_bias": None,
            "cls_kernel": (rng.standard_normal((D, L)) * 0.1
                           ).astype(np.float32),
            "cls_bias": rng.standard_normal(L).astype(np.float32),
            "kind": "sequence",
        })
    return entries


class TestHeadBank:
    def test_stack_matches_jax(self):
        entries = _bank_entries()
        jb = jlora.stack_head_bank(entries)
        tb = stack_head_bank(entries)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k])

    @pytest.mark.parametrize("epilogue", [False, True])
    def test_apply_with_lora_delta_matches_jax(self, epilogue):
        entries = _bank_entries()
        pooled = np.random.default_rng(7).standard_normal((6, 32)).astype(
            np.float32)
        jb = {k: jnp.asarray(v)
              for k, v in jlora.stack_head_bank(entries).items()}
        act = lambda h: jax.nn.gelu(h, approximate=False)  # noqa: E731
        ref = jlora.apply_head_bank(jb, jnp.asarray(pooled), act, 1e-5,
                                    epilogue=epilogue)
        tb = bank_to_device(stack_head_bank(entries), torch.device("cpu"))
        got = apply_head_bank(tb, torch.from_numpy(pooled), "gelu", 1e-5,
                              epilogue=epilogue)
        assert got.shape == (6, 3, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0)

    @pytest.mark.parametrize("kind", ["sequence", "token"])
    def test_head_bank_entry_matches_jax(self, kind):
        jm, params, tm = _pair(kind, TINY, num_labels=4)
        je = jlora.head_bank_entry(jm, params)
        te = head_bank_entry(tm)
        assert je["kind"] == te["kind"] == kind
        for k in ("dense_kernel", "norm_scale", "cls_kernel", "cls_bias"):
            np.testing.assert_allclose(te[k], np.asarray(je[k]), atol=0)
        assert te["dense_bias"] is None and je["dense_bias"] is None

    def test_bank_applies_like_the_standalone_module(self):
        """The fused head math reproduces the module's own forward."""
        _, _, tm = _pair("sequence", TINY)
        ids, mask = _inputs(TINY["vocab_size"])
        ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
        bank = bank_to_device(stack_head_bank([head_bank_entry(tm)]),
                              torch.device("cpu"))
        with torch.no_grad():
            want = tm(ids_t, mask_t)
            pooled = tm.model(ids_t, mask_t)[:, 0]
            for epilogue in (False, True):
                got = apply_head_bank(bank, pooled, "gelu", 1e-5,
                                      epilogue=epilogue)[:, 0]
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           atol=1e-5, rtol=0)


class TestSafetensorsReader:
    def test_numpy_reader_matches_library(self, tmp_path):
        st = pytest.importorskip("safetensors.torch")
        tensors = {
            "a": torch.randn(3, 4),
            "b": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "c": torch.randn(5).to(torch.bfloat16),
        }
        path = str(tmp_path / "model.safetensors")
        st.save_file(tensors, path)
        got = read_safetensors(path)
        for k, v in tensors.items():
            np.testing.assert_array_equal(got[k], v.float().numpy()
                                          if v.dtype == torch.bfloat16
                                          else v.numpy())
