"""The port's LoRA modules against the JAX package's on the same weights,
on the CPU: ``LoRADelta``, the stacked ``MultiTaskLoRAClassifier``
(sequence and token kinds, CLS and mean pooling), and the trunk-adapted
``LoRAModernBertForSequenceClassification``,
``LoRAModernBertForTokenClassification`` and ``LoRAMmBertEmbeddingModel``
per ``task_index``, within 1e-4 (float32).  Also: ``lora_param_filter``
picks the adapters JAX's picks, an adapter merged into the base
(``merge_lora_into_base``) equals the adapter, ``lora_params_from_flax``
refuses a tree that does not fit, and the plain and quantized trunks
give the same bits with and without a ``task_index``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.models import lora as jl
from semantic_router_tpu.models import modernbert as jm
from semantic_router_tpu_torch.models import lora as tl
from semantic_router_tpu_torch.models import modernbert as tm
from semantic_router_tpu_torch.models.convert import (
    lora_params_from_flax,
    params_from_flax,
)
from semantic_router_tpu_torch.models.quant import build_quant_trunk

TOL = 1e-4
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
            num_hidden_layers=3, num_attention_heads=4, pad_token_id=0,
            local_attention=8)
T = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitter(params, seed: int, std: float = 0.05):
    """Every leaf moved off its init (a zero-init ``lora_B`` would make
    every adapter the identity)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, std, np.shape(a))
        .astype(np.float32), params)


def _inputs(seed: int = 0, B: int = 3, S: int = 24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S - 7:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _cfgs(**over):
    return jm.ModernBertConfig(**TINY, **over), \
        tm.ModernBertConfig(**TINY, **over)


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


def test_lora_delta_matches_jax():
    lora_j, lora_t = jl.LoRAConfig(rank=4, num_tasks=T), \
        tl.LoRAConfig(rank=4, num_tasks=T)
    x = np.random.default_rng(1).normal(size=(2, 5, 16)).astype(np.float32)
    xt = np.random.default_rng(2).normal(size=(T, 2, 5, 16)) \
        .astype(np.float32)
    mod = jl.LoRADelta(12, lora_j)
    params = _jitter(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    port = tl.LoRADelta(16, 12, lora_t)
    _load(port, params_from_flax(params))
    with torch.no_grad():
        for inp in (x, xt):
            _close(port(torch.from_numpy(inp)),
                   mod.apply(params, jnp.asarray(inp)))


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_multitask_lora_classifier_matches_jax(pooling):
    jcfg, tcfg = _cfgs(classifier_pooling=pooling)
    names = ["intent", "pii", "security"]
    labels = {"intent": 5, "pii": 3, "security": 2}
    kinds = {"intent": "sequence", "pii": "token", "security": "sequence"}
    jbank = jl.MultiTaskLoRAClassifier(
        jcfg, jl.LoRAConfig(rank=4, num_tasks=3), task_names=names,
        task_labels=labels, task_kinds=kinds)
    ids, mask = _inputs(4)
    params = _jitter(jbank.init(jax.random.PRNGKey(2), jnp.asarray(ids)), 5)
    tbank = tl.MultiTaskLoRAClassifier(
        tcfg, tl.LoRAConfig(rank=4, num_tasks=3), names, labels, kinds)
    _load(tbank, lora_params_from_flax(tbank, params))
    want = jbank.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tbank(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert list(got) == names
    assert tuple(got["pii"].shape) == (3, 24, 3)
    assert tuple(got["intent"].shape) == (3, 5)
    for task in names:
        _close(got[task], want[task])


def _lora_pair(kind: str, seed: int, **over):
    jcfg, tcfg = _cfgs(**over)
    lj, lt = jl.LoRAConfig(rank=4, alpha=8.0, num_tasks=T), \
        tl.LoRAConfig(rank=4, alpha=8.0, num_tasks=T)
    if kind == "sequence":
        jmod = jl.LoRAModernBertForSequenceClassification(jcfg, lj, 4)
        tmod = tl.LoRAModernBertForSequenceClassification(tcfg, lt, 4)
    elif kind == "token":
        jmod = jl.LoRAModernBertForTokenClassification(jcfg, lj, 5)
        tmod = tl.LoRAModernBertForTokenClassification(tcfg, lt, 5)
    else:
        jmod = jl.LoRAMmBertEmbeddingModel(jcfg, lj, pooling=kind)
        tmod = tl.LoRAMmBertEmbeddingModel(tcfg, lt, pooling=kind)
    ids, _ = _inputs(seed)
    params = _jitter(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(ids)),
                     seed + 10)
    _load(tmod, lora_params_from_flax(tmod, params))
    return jmod, params, tmod


@pytest.mark.parametrize("kind", ["sequence", "token", "mean", "cls"])
def test_lora_trunk_matches_jax_per_task_index(kind):
    jmod, params, tmod = _lora_pair(kind, 7)
    ids, mask = _inputs(8)
    outs = []
    for t in range(T):
        want = jmod.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                          task_index=t)
        with torch.no_grad():
            got = tmod(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       task_index=torch.tensor([t]))
            as_int = tmod(torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), task_index=t)
        _close(got, want)
        assert torch.equal(got, as_int)
        outs.append(got)
    # the adapters differ: each task index selects its own
    assert not torch.allclose(outs[0], outs[1], atol=1e-3)
    if kind in ("mean", "cls"):
        norms = outs[0].norm(dim=-1)
        np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)


def test_lora_param_filter_picks_the_adapters_jax_picks():
    jmod, params, tmod = _lora_pair("sequence", 3)
    jax_paths = []
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: jax_paths.append(
            tuple(getattr(k, "key", str(k)) for k in path)), params)
    want = sorted(".".join(p[1:]).replace("layers_", "layers.")
                  for p in jax_paths
                  if jl.lora_param_filter(p, None))
    trainable = sorted(n for n, _ in tmod.named_parameters()
                       if tl.lora_param_filter(n))
    assert trainable == want
    # 3 layers x (Wqkv, Wo, Wi, Wo) x (A, B)
    assert len(trainable) == 3 * 4 * 2
    assert not tl.lora_param_filter("model.layers.0.attn.Wqkv.weight")
    assert tl.lora_param_filter("head_lora.lora_B")


def test_merging_an_adapter_equals_the_adapter():
    """Each adapter merged into the base kernels of a plain classifier
    (``merge_lora_into_base``, the "merged" deployment) gives that
    adapter's logits."""
    jmod, params, tmod = _lora_pair("sequence", 11)
    _jcfg, tcfg = _cfgs()
    ids, mask = _inputs(12)
    scale = tmod.lora.scale
    for t in range(T):
        plain = tm.ModernBertForSequenceClassification(
            dataclasses.replace(tcfg, num_labels=4))
        state = {}
        for name, v in tmod.state_dict().items():
            if tl.lora_param_filter(name):
                continue
            if name.startswith("model.") and name.endswith(".weight") \
                    and f"{name[:-len('weight')]}lora_A" in tmod.state_dict():
                prefix = name[:-len("weight")]
                a = tmod.state_dict()[prefix + "lora_A"][t].numpy()
                b = tmod.state_dict()[prefix + "lora_B"][t].numpy()
                merged = tl.merge_lora_into_base(v.numpy().T, a, b, scale)
                v = torch.from_numpy(np.ascontiguousarray(merged.T))
            state[name] = v
        _load(plain, state)
        with torch.no_grad():
            want = plain(torch.from_numpy(ids).long(),
                         torch.from_numpy(mask))
            got = tmod(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       task_index=t)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=0)


def test_lora_params_from_flax_refuses_a_tree_that_does_not_fit():
    _jmod, params, tmod = _lora_pair("sequence", 2)
    other = tl.LoRAModernBertForTokenClassification(
        tm.ModernBertConfig(**TINY), tl.LoRAConfig(rank=4, num_tasks=T), 4)
    state = lora_params_from_flax(other, params)  # same names and shapes
    assert set(state) == set(other.state_dict())
    wide = tl.LoRAModernBertForSequenceClassification(
        tm.ModernBertConfig(**TINY), tl.LoRAConfig(rank=8, num_tasks=T), 4)
    with pytest.raises(ValueError, match="shape"):
        lora_params_from_flax(wide, params)
    bank = tl.MultiTaskLoRAClassifier(
        tm.ModernBertConfig(**TINY), tl.LoRAConfig(rank=4, num_tasks=1),
        ["a"], {"a": 2})
    with pytest.raises(KeyError, match="missing"):
        lora_params_from_flax(bank, params)


@pytest.mark.parametrize("mode", ["off", "bf16", "int8"])
def test_plain_and_quant_trunks_ignore_the_task_index(mode):
    """The projection seam passes ``task_index`` to every dense; the plain
    ``Dense`` and ``QuantDense`` ignore it, so a trunk gives the same
    bits with and without one."""
    torch.manual_seed(0)
    trunk = tm.ModernBertModel(tm.ModernBertConfig(**TINY)).eval()
    serving = build_quant_trunk(trunk, mode)
    ids, mask = _inputs(5)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        plain = serving(ids_t, mask_t)
        with_index = serving(ids_t, mask_t, task_index=torch.tensor([2]))
    assert torch.equal(plain, with_index)
    assert plain.dtype == (torch.float32 if mode == "off"
                           else torch.bfloat16)
