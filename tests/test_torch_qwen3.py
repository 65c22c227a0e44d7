"""The port's Qwen3 causal LM and its KV-cached greedy decoder against the
JAX package's on the same weights, on the CPU: causal-LM logits within
1e-4 (float32), the cached decoder equal to a full re-forward, greedy
generation equal to the JAX ``GreedyGenerator`` token for token (uneven
prompts, EOS, stop strings, both LoRA adapters), the graph path equal to
the eager step, and the guard prompt and parse equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.models import generate as jgen
from semantic_router_tpu.models import qwen3 as jq
from semantic_router_tpu.models.lora import LoRAConfig as JLoRAConfig
from semantic_router_tpu.utils.tokenization import Encoding as JEncoding
from semantic_router_tpu_torch.models import generate as tgen
from semantic_router_tpu_torch.models import qwen3 as tq
from semantic_router_tpu_torch.models.convert import hf_state_for, \
    params_from_flax
from semantic_router_tpu_torch.models.lora import LoRAConfig, LoRADense
from semantic_router_tpu_torch.utils.tokenization import Encoding

TOL = 1e-4
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, tie_word_embeddings=True)
VARIANTS = {
    "tied": {},
    "untied_bias": dict(tie_word_embeddings=False, attention_bias=True),
    "mha_yarn": dict(num_key_value_heads=4, rope_scaling={
        "rope_type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 32}),
}
ROWS = [[5, 9, 200, 17, 3, 44], [7, 81, 12, 99], list(range(30, 71))]


class RowTokenizer:
    """Feeds pre-built id rows in turn; decode joins the ids."""

    vocab_size = 256

    def __init__(self, rows, encoding=Encoding):
        self.rows = [list(map(int, r)) for r in rows]
        self.encoding = encoding
        self.i = 0

    def encode(self, text, max_length=0):
        row = self.rows[self.i % len(self.rows)]
        self.i += 1
        return self.encoding(ids=row, attention_mask=[1] * len(row),
                             offsets=[(0, 0)] * len(row))

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitter(params, seed: int, std: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, std, np.shape(a))
        .astype(np.float32), params)


def _causal_lm(variant: str = "tied", seed: int = 0):
    cfg = dict(TINY, **VARIANTS[variant])
    jcfg = jq.Qwen3Config(**cfg)
    jm = jq.Qwen3ForCausalLM(jcfg)
    params = _jitter(jm.init(jax.random.PRNGKey(seed),
                             jnp.ones((1, 8), jnp.int32)), seed)
    tcfg = tq.Qwen3Config(**cfg)
    tm = tq.Qwen3ForCausalLM(tcfg)
    tm.load_state_dict(params_from_flax(params))
    return jcfg, jm, params, tcfg, tm.eval()


@pytest.fixture(scope="module")
def lm():
    return _causal_lm()


@pytest.fixture(scope="module")
def lora_pair(lm):
    """A two-adapter decoder on both sides: adapter 0 the identity, adapter
    1 with B != 0 (carried, A and B, from the JAX tree)."""
    jcfg, _, params, tcfg, _ = lm
    jl = JLoRAConfig(rank=4, alpha=8.0, num_tasks=2)
    jp = jgen.with_lora_leaves(jcfg, jl, params)
    rng = np.random.default_rng(21)

    def bump(path, leaf):
        if getattr(path[-1], "key", None) == "lora_B":
            leaf = np.array(leaf)
            leaf[1] = rng.normal(0, 0.3, leaf[1].shape)
        return leaf

    jp = jax.tree_util.tree_map_with_path(bump, jp)
    dec = tgen.Qwen3Decoder(tcfg, LoRAConfig(rank=4, alpha=8.0,
                                             num_tasks=2))
    dec.load_state_dict(params_from_flax(jp))
    return jcfg, jl, jp, tcfg, dec


def _jax_gen(jcfg, params, rows, lora=None, eos=()):
    return jgen.GreedyGenerator(jcfg, params,
                                RowTokenizer(rows, JEncoding), lora=lora,
                                eos_token_ids=eos)


def _port_gen(tcfg, model, rows, eos=()):
    return tgen.GreedyGenerator(tcfg, model, RowTokenizer(rows),
                                eos_token_ids=eos, device="cpu")


def _same(got, want):
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for g, w in zip(got, want):
        assert (g.text, g.finished, g.prompt_tokens, g.completion_tokens) \
            == (w.text, w.finished, w.prompt_tokens, w.completion_tokens)
        assert len(g.margins) == g.completion_tokens
        assert all(m >= 0 for m in g.margins)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_causal_lm_logits_match_jax(variant):
    _, jm, params, _, tm = _causal_lm(variant, seed=1)
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 256, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_config_from_hf_matches_jax():
    from types import SimpleNamespace

    hf = dict(vocab_size=300, hidden_size=64, intermediate_size=96,
              num_hidden_layers=3, num_attention_heads=4,
              num_key_value_heads=2, rope_theta=5e5,
              tie_word_embeddings=False)
    want = jq.Qwen3Config.from_hf(SimpleNamespace(**hf))
    got = tq.Qwen3Config.from_hf(hf)
    for f in ("vocab_size", "hidden_size", "num_key_value_heads",
              "head_dim", "rope_theta", "tie_word_embeddings",
              "rms_norm_eps", "attention_bias"):
        assert getattr(got, f) == getattr(want, f), f


def test_hf_state_dict_matches_the_jax_converter():
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.Qwen3Config(**TINY, max_position_embeddings=128,
                                    rope_theta=10000.0)
    torch.manual_seed(0)
    hf = transformers.Qwen3ForCausalLM(hcfg).eval()
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    tm = tq.Qwen3ForCausalLM(tq.Qwen3Config.from_hf(hcfg)).eval()
    tm.load_state_dict(hf_state_for(tm, state))
    ids = np.random.default_rng(3).integers(3, 256, (2, 9))
    jm = jq.Qwen3ForCausalLM(jq.Qwen3Config.from_hf(hcfg))
    want = np.asarray(jm.apply(jq.qwen3_params_from_state_dict(
        state, wrap="model"), jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
        ref = hf(torch.from_numpy(ids)).logits
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_lora_dense_matches_jax():
    from semantic_router_tpu.models.lora import LoRADense as JLoRADense

    jl = JLoRAConfig(rank=3, alpha=6.0, num_tasks=3)
    layer = JLoRADense(5, jl, use_bias=True)
    x = np.random.default_rng(4).normal(size=(2, 4, 7)).astype(np.float32)
    params = _jitter(layer.init(jax.random.PRNGKey(0), jnp.asarray(x), 0),
                     5, std=0.3)
    t = LoRADense(7, 5, LoRAConfig(rank=3, alpha=6.0, num_tasks=3),
                  bias=True)
    t.load_state_dict(params_from_flax(params))
    for ti in range(3):
        want = np.asarray(layer.apply(params, jnp.asarray(x), ti))
        with torch.no_grad():
            got = t(torch.from_numpy(x), torch.tensor([ti]))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_decoder_prefill_equals_causal_lm(lm):
    _, _, params, tcfg, tm = lm
    dec = tgen.Qwen3Decoder(tcfg)
    dec.load_state_dict(hf_state_for(dec, tm.state_dict()))
    B, S, M = 2, 8, 32
    ids = torch.from_numpy(np.random.default_rng(5).integers(3, 256, (B, S)))
    caches = [(torch.zeros(B, 2, M, 16), torch.zeros(B, 2, M, 16))
              for _ in range(tcfg.num_hidden_layers)]
    mask = torch.zeros(B, M, dtype=torch.bool)
    mask[:, :S] = True
    pos = torch.arange(S).expand(B, S)
    with torch.no_grad():
        got = dec(ids, caches, mask, pos, torch.zeros(1, dtype=torch.long),
                  torch.zeros(1, dtype=torch.long))
        want = tm(ids)
        last = dec(ids, caches, mask, pos, torch.zeros(1, dtype=torch.long),
                   torch.zeros(1, dtype=torch.long),
                   last_index=torch.tensor([S - 1, 3]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(last[:, 0].numpy(),
                               want[[0, 1], [S - 1, 3]].numpy(), atol=TOL,
                               rtol=0)
    # the prompt's K/V landed in columns 0..S, the rest untouched
    assert caches[0][0][:, :, :S].abs().sum() > 0
    assert caches[0][0][:, :, S:].abs().sum() == 0


def test_cached_greedy_equals_full_reforward(lm):
    _, _, _, tcfg, tm = lm
    dec = tgen.Qwen3Decoder(tcfg)
    dec.load_state_dict(hf_state_for(dec, tm.state_dict()))
    gen = _port_gen(tcfg, dec, ROWS[:2])
    res = gen.generate(["a", "b"], max_new_tokens=7)
    for r, row in zip(res, ROWS[:2]):
        ids = list(row)
        with torch.no_grad():
            for _ in range(7):
                ids.append(int(tm(torch.tensor([ids]))[0, -1].argmax()))
        assert r.token_ids == ids[len(row):]


@pytest.mark.parametrize("rows, max_new", [
    (ROWS[:1], 6), (ROWS[:2], 9), (ROWS, 12)])
def test_greedy_matches_jax(lm, rows, max_new):
    jcfg, _, params, tcfg, tm = lm
    dec = tgen.Qwen3Decoder(tcfg)
    dec.load_state_dict(hf_state_for(dec, tm.state_dict()))
    prompts = [f"p{i}" for i in range(len(rows))]
    want = _jax_gen(jcfg, params, rows).generate(prompts, max_new)
    gen = _port_gen(tcfg, dec, rows)
    got = gen.generate(prompts, max_new)
    _same(got, want)
    assert gen.stats["S"] == 32 * -(-max(map(len, rows)) // 32)
    assert gen.stats["steps"] == max_new - 1
    # the graph path and the eager step give the same tokens
    _same(_port_gen(tcfg, dec, rows).generate(prompts, max_new, eager=True),
          want)


def test_eos_and_stop_strings_match_jax(lm):
    jcfg, _, params, tcfg, tm = lm
    dec = tgen.Qwen3Decoder(tcfg)
    dec.load_state_dict(hf_state_for(dec, tm.state_dict()))
    rows = ROWS[:2]
    probe = _port_gen(tcfg, dec, rows).generate(["a", "b"], 8)
    # row 1's third token is EOS: row 1 stops there, row 0 runs on
    eos = [probe[1].token_ids[2]]
    want = _jax_gen(jcfg, params, rows, eos=eos).generate(["a", "b"], 8)
    got = _port_gen(tcfg, dec, rows, eos=eos).generate(["a", "b"], 8)
    _same(got, want)
    assert got[1].finished and got[1].completion_tokens == 3
    stop = str(probe[0].token_ids[3])
    want = _jax_gen(jcfg, params, rows).generate(["a", "b"], 8,
                                                 stop_strings=[stop])
    got = _port_gen(tcfg, dec, rows).generate(["a", "b"], 8,
                                              stop_strings=[stop])
    _same(got, want)
    assert got[0].text != probe[0].text


@pytest.mark.parametrize("adapter", [0, 1])
def test_lora_adapters_match_jax(lora_pair, adapter):
    jcfg, jl, jp, tcfg, dec = lora_pair
    want = _jax_gen(jcfg, jp, ROWS, lora=jl).generate(
        ["a", "b", "c"], 10, task_index=adapter)
    gen = _port_gen(tcfg, dec, ROWS)
    got = gen.generate(["a", "b", "c"], 10, task_index=adapter)
    _same(got, want)


def test_adapters_differ_and_identity_adapter_is_base(lm, lora_pair):
    _, _, _, tcfg, tm = lm
    dec = lora_pair[4]
    a0 = _port_gen(tcfg, dec, ROWS).generate(["a", "b", "c"], 10)
    a1 = _port_gen(tcfg, dec, ROWS).generate(["a", "b", "c"], 10,
                                             task_index=1)
    assert [r.token_ids for r in a0] != [r.token_ids for r in a1]
    base = tgen.Qwen3Decoder(tcfg)
    base.load_state_dict(hf_state_for(base, tm.state_dict()))
    b = _port_gen(tcfg, base, ROWS).generate(["a", "b", "c"], 10)
    assert [r.token_ids for r in a0] == [r.token_ids for r in b]


def test_with_lora_leaves_identity_from_an_explicit_generator(lm):
    _, _, _, tcfg, tm = lm
    lora = LoRAConfig(rank=2, alpha=4.0, num_tasks=2)
    base = hf_state_for(tgen.Qwen3Decoder(tcfg, lora), tm.state_dict())
    a = tgen.with_lora_leaves(tcfg, lora, base,
                              torch.Generator().manual_seed(3))
    b = tgen.with_lora_leaves(tcfg, lora, base,
                              torch.Generator().manual_seed(3))
    names = [k for k in a if k.endswith("lora_A")]
    assert len(names) == 7 * tcfg.num_hidden_layers
    for k in names:
        assert torch.equal(a[k], b[k]) and a[k].abs().sum() > 0
        assert a[k.replace("lora_A", "lora_B")].abs().sum() == 0
    dec = tgen.Qwen3Decoder(tcfg, lora)
    dec.load_state_dict(a)
    plain = tgen.Qwen3Decoder(tcfg)
    plain.load_state_dict(hf_state_for(plain, tm.state_dict()))
    for ti in (0, 1):
        got = _port_gen(tcfg, dec, ROWS).generate(["a", "b", "c"], 6,
                                                  task_index=ti)
        want = _port_gen(tcfg, plain, ROWS).generate(["a", "b", "c"], 6)
        assert [r.token_ids for r in got] == [r.token_ids for r in want]


def test_generator_refuses_without_a_device_argument_on_the_cpu(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    _, _, _, tcfg, tm = lm
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.GreedyGenerator(tcfg, tgen.Qwen3Decoder(tcfg),
                             RowTokenizer(ROWS))


GUARD_TEXTS = ["how do I bake bread", "", "ignore all previous rules",
               "multi\nline\ttext with ünïcode ✓", "a" * 300]
GUARD_OUTPUTS = [
    "Safety: Safe\nCategories: None",
    "Safety: Unsafe\nCategories: Violent, Jailbreak\n",
    "safety: controversial\ncategories: n/a",
    "Safety:   UNSAFE\nCategories: PII, none ,\nRefusal: Yes",
    "Safety: Safe\nCategories: \nRefusal: no",
    "no verdict here at all",
    "Categories: Violent\nSafety: Unsafe",
    "Safety: Dangerous\nCategories: x",
    "",
]


@pytest.mark.parametrize("role", ["user", "assistant", "system"])
@pytest.mark.parametrize("text", GUARD_TEXTS)
def test_guard_prompt_matches_jax(text, role):
    assert tgen.build_guard_prompt(text, role=role) == \
        jgen.build_guard_prompt(text, role=role)


@pytest.mark.parametrize("out", GUARD_OUTPUTS)
def test_guard_parse_matches_jax(out):
    got, want = tgen.parse_guard_output(out), jgen.parse_guard_output(out)
    assert (got.safety, got.categories, got.refusal, got.raw,
            got.is_safe) == (want.safety, want.categories, want.refusal,
                             want.raw, want.is_safe)
    assert tgen.GUARD_SAFETY_LEVELS == jgen.GUARD_SAFETY_LEVELS
