"""The port's quantized trunk (ops.quant, models.quant, ``engine.quant``)
against the JAX package on the CPU: int8 weights bit-identical and scales
within one ulp, dequantize within 1e-6, the dequantizing matmul within
1e-2, each mode's trunk and engine against the JAX ones at the same mode
under the reference's parity policy (tests/test_kernels.py
``TestQuantParitySuite``: max deviation of the probabilities within the
normalized ``max_logit_diff``, top-class agreement at least
``min_top_agree`` outside the ``margin_floor`` ties), ``off`` byte-identical
to the float32 engine, and the group selector."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.config.schema import \
    InferenceEngineConfig as JEngineConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.engine.kernels import \
    normalize_quant as jnormalize_quant
from semantic_router_tpu.engine.kernels import quant_selects as \
    jquant_selects
from semantic_router_tpu.models import modernbert as jmb
from semantic_router_tpu.models import quant as jquant
from semantic_router_tpu.ops import quant as jops
from semantic_router_tpu_torch.config import InferenceEngineConfig, \
    load_config
from semantic_router_tpu_torch.engine import normalize_quant, quant_selects
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import (
    ModernBertConfig,
    ModernBertModel,
    QuantDense,
    build_quant_trunk,
    params_from_flax,
    quantize_trunk_params,
)
from semantic_router_tpu_torch.ops import (
    dequant_matmul,
    dequantize,
    quantize_per_channel,
)

TASKS = ["intent", "fact_check", "user_feedback"]
CORPUS = [
    "the quarterly contract needs legal review",
    "tiny",
    "my throat hurts and i have a fever since tuesday",
    "refactor the parser to use a visitor pattern",
    "what is the capital of france",
    "the quarterly contract needs legal review",
    "sue the landlord over the broken lease terms",
    "train a neural network on tabular data",
    "is this investment portfolio diversified enough",
    "hello world",
    "symptoms include nausea and a mild headache",
    "deploy the service behind a load balancer",
    " ".join(f"word{i}" for i in range(50)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# ops


W_SHAPES = [(64, 48), (3, 32, 24), (16, 1)]


@pytest.mark.parametrize("shape", W_SHAPES)
def test_quantize_per_channel_matches_jax(shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] *= 100.0  # one loud channel
    qj, sj = (np.asarray(a) for a in jops.quantize_per_channel(w))
    qt, st = quantize_per_channel(torch.from_numpy(w))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_max_ulp(st.numpy(), sj, maxulp=1)
    np.testing.assert_allclose(
        dequantize(qt, st).numpy(), np.asarray(jops.dequantize(qj, sj)),
        atol=1e-6, rtol=0)
    # symmetric round-to-nearest: per-channel error at most scale/2
    err = np.abs(dequantize(qt, st).numpy() - w)
    assert np.all(err <= st.numpy()[..., None, :] / 2 + 1e-6)


def test_dequantize_to_bf16_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    qt, st = quantize_per_channel(torch.from_numpy(w))
    want = np.asarray(jops.dequantize(qt.numpy(), st.numpy(), jnp.bfloat16),
                      np.float32)
    got = dequantize(qt, st, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_dequant_matmul_matches_jax(with_bias, x_dtype):
    """Within 1e-2 of the reference for a float32 x, which keeps the bf16
    product in float32 until the scale; ``torch.matmul`` rounds it to bf16
    first.  For a bf16 x both round the result to bf16 as well, so the
    extra rounding can move it by one bf16 ulp (2^-7 relative; 1e-2
    absolute would not hold at |y| > 2 even for a single rounding).  The
    extra rounding is measured against the exact product of the same
    bf16 operands: at most half a bf16 ulp of the product, scaled."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 24)).astype(np.float32) * 0.2
    x = rng.standard_normal((5, 64)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32) if with_bias else None
    qt, st = quantize_per_channel(torch.from_numpy(w))
    jx = jnp.asarray(x).astype(jnp.dtype(x_dtype))
    want = np.asarray(jops.dequant_matmul(
        jx, qt.numpy(), st.numpy(), bias=None if b is None else
        jnp.asarray(b)), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    got = dequant_matmul(tx, qt, st, bias=None if b is None
                         else torch.from_numpy(b))
    assert got.dtype == tx.dtype
    if x_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                                   rtol=2.0 ** -7)
    # the bf16 rounding of the product before the scale
    prod = tx.to(torch.bfloat16).double() @ qt.double()
    rounded = prod.to(torch.bfloat16).double()
    extra = ((rounded - prod).abs() * st.double()).max().item()
    half_ulp = (prod.abs() * 2.0 ** -8 * st.double()).max().item()
    assert extra <= half_ulp


# --------------------------------------------------------------------------
# the trunk


def _trunk_pair(seed=0):
    cfg = jtesting.tiny_config(3)
    params = flax.core.unfreeze(jmb.ModernBertModel(cfg).init(
        jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))["params"]
    trunk = ModernBertModel(ModernBertConfig(**ttesting.TINY))
    sd = params_from_flax({"params": {"model": params}})
    trunk.load_state_dict({k[len("model."):]: v for k, v in sd.items()})
    return cfg, params, trunk.eval()


def _trunk_inputs():
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 1000, (3, 24)).astype(np.int32)
    mask = (np.arange(24)[None] < np.array([[24], [17], [6]])).astype(
        np.int32)
    return ids, mask


@pytest.mark.parametrize("mode,tol", [("off", 1e-4), ("bf16", 0.05),
                                      ("int8", 0.1)])
def test_trunk_matches_jax(mode, tol):
    """Each mode's serving trunk against the JAX one at the same mode (the
    reference's own trunk tolerances against float32: 0.05 bf16, 0.1
    int8), on the real rows."""
    cfg, params, trunk = _trunk_pair()
    ids, mask = _trunk_inputs()
    jmod, jparams = jquant.build_quant_trunk(cfg, params, mode)
    want = np.asarray(jmod.apply({"params": jparams}, jnp.asarray(ids),
                                 jnp.asarray(mask)), np.float32)
    serving = build_quant_trunk(trunk, mode)
    with torch.no_grad():
        got = serving(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == (torch.float32 if mode == "off" else torch.bfloat16)
    real = mask.astype(bool)
    diff = np.abs(got.float().numpy() - want)[real]
    assert diff.max() < tol, (mode, diff.max())


def test_off_is_the_trunk_and_bf16_shares_its_parameters():
    _, _, trunk = _trunk_pair()
    assert build_quant_trunk(trunk, "off") is trunk
    bf16 = build_quant_trunk(trunk, "bf16")
    src = dict(trunk.named_parameters())
    for name, p in bf16.named_parameters():
        assert p is src[name], name
    with pytest.raises(ValueError, match="unknown quant mode"):
        build_quant_trunk(trunk, "fp8")


def test_int8_state_matches_the_jax_tree():
    _, params, trunk = _trunk_pair()
    state = quantize_trunk_params(trunk)
    jq = jquant.quantize_trunk_params(params)
    wqkv = jq["layers_0"]["attn"]["Wqkv"]
    assert set(wqkv) == {"kernel_q", "scale"}
    np.testing.assert_array_equal(state["layers.0.attn.Wqkv.kernel_q"],
                                  np.asarray(wqkv["kernel_q"]))
    np.testing.assert_array_max_ulp(state["layers.0.attn.Wqkv.scale"].numpy(),
                                    np.asarray(wqkv["scale"]), maxulp=1)
    assert "embeddings.tok_embeddings.weight" in state
    assert "final_norm.weight" in state and \
        "final_norm.kernel_q" not in state
    int8 = build_quant_trunk(trunk, "int8", state)
    dense = [m for m in int8.modules() if isinstance(m, QuantDense)]
    assert len(dense) == 4 * ttesting.TINY["num_hidden_layers"]
    assert int8.embeddings.tok_embeddings.weight is \
        trunk.embeddings.tok_embeddings.weight


# --------------------------------------------------------------------------
# the engine, against the JAX engine at the same mode


def _jax_engine(quant):
    return jtesting.make_shared_trunk_engine(
        lora_tasks=("fact_check",),
        engine_cfg=JEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                 seq_len_buckets=[32, 128, 512],
                                 quant=dict(quant or {})))


def _port_engine(jeng, quant):
    return ttesting.make_shared_trunk_engine(
        lora_tasks=("fact_check",), device="cpu",
        engine_cfg=InferenceEngineConfig(
            max_batch_size=8, max_wait_ms=1.0,
            seq_len_buckets=[32, 128, 512], quant=dict(quant or {})),
        flax_params={n: t.params for n, t in jeng._tasks.items()})


def _probs(eng):
    out = eng.classify_multi(TASKS, CORPUS)
    return {t: np.array([[r.probs[k] for k in sorted(r.probs)] for r in rs])
            for t, rs in out.items()}


@pytest.fixture(scope="module")
def jax_goldens():
    """{mode: {task: probs}} of the JAX engine, and its weights."""
    out, params = {}, None
    for mode in ("off", "bf16", "int8"):
        eng = _jax_engine({"mode": mode})
        try:
            out[mode] = _probs(eng)
            params = params or {n: t.params for n, t in eng._tasks.items()}
        finally:
            eng.shutdown()
    return out, params


@pytest.fixture(scope="module")
def port_f32(jax_goldens):
    """The port engine's probabilities with no quant block at all."""
    eng = _port_engine(_Params(jax_goldens[1]), None)
    try:
        return _probs(eng)
    finally:
        eng.shutdown()


class _Params:
    """Stands in for a JAX engine where only its weights are read."""

    def __init__(self, params):
        self._tasks = {n: _T(p) for n, p in params.items()}


class _T:
    def __init__(self, params):
        self.params = params


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_engine_meets_the_parity_policy_against_jax(jax_goldens, mode):
    goldens, params = jax_goldens
    par = normalize_quant({"mode": mode})["parity"]
    eng = _port_engine(_Params(params), {"mode": mode})
    try:
        assert eng.kernels_report()["groups"]["trunk0"]["quant"] == mode
        got = _probs(eng)
    finally:
        eng.shutdown()
    agree = total = 0
    worst = 0.0
    for t in TASKS:
        g, q = goldens[mode][t], got[t]
        worst = max(worst, float(np.abs(q - g).max()))
        assert np.abs(q - g).max() <= par["max_logit_diff"], t
        top = np.sort(g, axis=-1)
        confident = top[:, -1] - top[:, -2] >= par["margin_floor"]
        total += int(confident.sum())
        agree += int((g.argmax(-1)[confident]
                      == q.argmax(-1)[confident]).sum())
    assert total > 0
    assert agree / total >= par["min_top_agree"], (agree, total)
    # measured: ~5e-3 (bf16) and ~8e-3 (int8) at these widths — the two
    # packages round in different places (XLA's fused elementwise chains
    # versus one rounding per torch op, and torch's bf16 GEMM output)
    assert worst < 2e-2, worst


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_engine_quantized_against_its_own_float32(jax_goldens, port_f32,
                                                  mode):
    """The reference's gate itself: the quantized port against the
    float32 port."""
    par = normalize_quant({"mode": mode})["parity"]
    eng = _port_engine(_Params(jax_goldens[1]), {"mode": mode})
    try:
        got = _probs(eng)
    finally:
        eng.shutdown()
    for t in TASKS:
        g, q = port_f32[t], got[t]
        assert np.abs(q - g).max() <= par["max_logit_diff"]
        top = np.sort(g, axis=-1)
        confident = top[:, -1] - top[:, -2] >= par["margin_floor"]
        assert (g.argmax(-1)[confident] == q.argmax(-1)[confident]).all()


def test_off_is_byte_identical(jax_goldens, port_f32):
    goldens, params = jax_goldens
    eng = _port_engine(_Params(params), {"mode": "off"})
    try:
        g = eng.trunk_group("intent")
        assert g.demux["trunk"] is g.trunk
        got = _probs(eng)
    finally:
        eng.shutdown()
    for t in TASKS:
        assert np.array_equal(got[t], port_f32[t])
        np.testing.assert_allclose(got[t], goldens["off"][t], atol=1e-4)


@pytest.mark.parametrize("groups,want", [
    (["some_other_task"], "off"), (["intent"], "int8"), (["trunk0"], "int8"),
    ([], "int8")])
def test_group_selector(jax_goldens, port_f32, groups, want):
    quant = {"mode": "int8", "groups": groups}
    assert quant_selects(normalize_quant(quant), "trunk0", TASKS) == \
        jquant_selects(jnormalize_quant(quant), "trunk0", TASKS) == want
    eng = _port_engine(_Params(jax_goldens[1]), quant)
    try:
        assert eng.kernels_report()["groups"]["trunk0"]["quant"] == want
        if want == "off":
            got = _probs(eng)
            for t in TASKS:
                assert np.array_equal(got[t], port_f32[t])
    finally:
        eng.shutdown()


def test_configure_quant_rebuilds_only_the_affected_groups():
    eng = ttesting.make_test_engine(
        tasks=[("intent", "sequence", ["a", "b"]),
               ("jailbreak", "sequence", ["benign", "jailbreak"]),
               ("embedding", "embedding", [])], device="cpu")
    try:
        gi, gj = eng.trunk_group("intent"), eng.trunk_group("jailbreak")
        before = eng.kernels_report()["rebuilds"]
        eng.configure_quant({"mode": "bf16", "groups": ["intent"]})
        assert gi.demux["quant"] == "bf16" and gj.demux["quant"] == "off"
        assert gj.demux["trunk"] is gj.trunk
        assert eng.kernels_report()["rebuilds"] == before + 1
        served = gi.demux["trunk"]
        eng.configure_quant({"mode": "bf16", "groups": ["intent"]})
        assert gi.demux["trunk"] is served  # an unchanged mode keeps it
        res = eng.classify("intent", "hello there")
        assert abs(sum(res.probs.values()) - 1.0) < 1e-5
        # embedding tasks stay float32
        assert eng.embed("embedding", ["hello"]).dtype == np.float32
        assert eng._tasks["embedding"].module.model.config.dtype == \
            torch.float32
        eng.configure_quant({"mode": "off"})
        assert gi.demux["trunk"] is gi.trunk
        assert eng.kernels_report()["quant"]["mode"] == "off"
    finally:
        eng.shutdown()


def test_schema_and_bootstrap_apply_engine_quant():
    from semantic_router_tpu_torch.runtime import apply_kernel_knobs

    cfg = load_config({"engine": {"quant": {"mode": "INT8",
                                            "groups": ["intent"],
                                            "parity": {"min_top_agree": 2}}}})
    assert cfg.engine.quant_config() == jnormalize_quant(cfg.engine.quant)
    assert cfg.engine.quant_config()["mode"] == "int8"
    assert normalize_quant({"mode": "fp4"})["mode"] == "off"
    eng = ttesting.make_shared_trunk_engine(device="cpu")
    try:
        apply_kernel_knobs(cfg, eng)
        assert eng.trunk_group("intent").demux["quant"] == "int8"
    finally:
        eng.shutdown()


def test_int8_serving_weights_are_a_quarter():
    trunk = ModernBertModel(ModernBertConfig(**ttesting.TINY))
    int8 = build_quant_trunk(trunk, "int8")

    def dense_bytes(m):
        return sum(t.numel() * t.element_size()
                   for n, t in list(m.named_parameters())
                   + list(m.named_buffers())
                   if ".attn." in n or ".mlp." in n)

    f32, q = dense_bytes(trunk), dense_bytes(int8)
    # int8 weights plus a float32 scale per output channel
    assert q < 0.3 * f32
