"""The port's SigLIP against the JAX package's on the same weights, on the
CPU, at a tiny width (hidden 32, 2 layers, 4 heads, image 24, patch 8,
16 text positions): attention with and without a key mask, the MLP, an
encoder layer, both towers, the MAP head and ``SiglipModel``'s logits
within 1e-4 (float32); both converters (the Flax tree, and an HF
``SiglipModel`` state dict with its packed MAP-head projection) giving
the same tensors; ``SiglipEmbedder`` padding texts with no mask, eager
and through the step cache; ``preprocess_image`` and ``decode_image_ref``
equal to JAX's exactly, refusals included."""

import base64
import io
from urllib.parse import quote_from_bytes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.models import siglip as jsig
from semantic_router_tpu.utils import tokenization as jtok
from semantic_router_tpu_torch.models import siglip as tsig
from semantic_router_tpu_torch.models.convert import (
    siglip_params_from_flax,
    siglip_state_from_hf,
)
from semantic_router_tpu_torch.utils import tokenization as ttok

TOL = 1e-4
TEXT = dict(vocab_size=99, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16, projection_size=32)
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, image_size=24, patch_size=8,
              num_channels=3)
TEXTS = ["a photo of a cat", "an invoice for march", "hi",
         " ".join(f"w{i}" for i in range(30))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitter(params, seed: int):
    """JAX init plus seeded noise, so biases, norms and the logit scale
    are not trivial."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a))
        .astype(np.float32), params)


def _configs():
    return (jsig.SiglipTowerConfig(**TEXT), jsig.SiglipTowerConfig(**VISION),
            tsig.SiglipTowerConfig(**TEXT), tsig.SiglipTowerConfig(**VISION))


def _port(module, params):
    module.load_state_dict(siglip_params_from_flax(params))
    return module.eval()


def _pixels(B: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(B, 24, 24, 3)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def model_pair():
    """(JAX SiglipModel, its params, the port's SiglipModel)."""
    jt, jv, tt, tv = _configs()
    jm = jsig.SiglipModel(jt, jv)
    params = _jitter(jm.init(jax.random.PRNGKey(0), jnp.ones((1, 16),
                                                             jnp.int32),
                             jnp.zeros((1, 24, 24, 3))), 1)
    return jm, params, _port(tsig.SiglipModel(tt, tv), params)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_jax(masked):
    jt, _, tt, _ = _configs()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 16, 32)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 16), np.int32)
        mask[1, 9:] = 0
        mask[2, 2:] = 0
    jm = jsig.SiglipAttention(jt)
    params = _jitter(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    want = jm.apply(params, jnp.asarray(x),
                    None if mask is None else jnp.asarray(mask))
    tm = _port(tsig.SiglipAttention(tt), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("name", ["SiglipMLP", "SiglipEncoderLayer",
                                  "SiglipMAPHead"])
def test_blocks_match_jax(name):
    jt, _, tt, _ = _configs()
    x = np.random.default_rng(6).normal(size=(2, 9, 32)).astype(np.float32)
    jm = getattr(jsig, name)(jt)
    params = _jitter(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), 3)
    tm = _port(getattr(tsig, name)(tt), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm.apply(params, jnp.asarray(x)))


def test_text_tower_matches_jax():
    jt, _, tt, _ = _configs()
    ids = np.random.default_rng(7).integers(1, 99, (3, 16)).astype(np.int64)
    mask = np.ones((3, 16), np.int32)
    mask[2, 5:] = 0
    jm = jsig.SiglipTextTower(jt)
    params = _jitter(jm.init(jax.random.PRNGKey(3), jnp.asarray(ids)), 4)
    tm = _port(tsig.SiglipTextTower(tt), params)
    with torch.no_grad():
        for m in (None, mask):
            got = tm(torch.from_numpy(ids),
                     None if m is None else torch.from_numpy(m))
            _close(got, jm.apply(params, jnp.asarray(ids),
                                 None if m is None else jnp.asarray(m)))


def test_vision_tower_matches_jax():
    _, jv, _, tv = _configs()
    px = _pixels(3)
    jm = jsig.SiglipVisionTower(jv)
    params = _jitter(jm.init(jax.random.PRNGKey(4), jnp.asarray(px)), 5)
    tm = _port(tsig.SiglipVisionTower(tv), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(px))
    _close(got, jm.apply(params, jnp.asarray(px)))


def test_model_embeddings_and_logits_match_jax(model_pair):
    jm, params, tm = model_pair
    ids = np.random.default_rng(8).integers(1, 99, (4, 16)).astype(np.int64)
    px = _pixels(3, seed=9)
    jt_, jv_, jl_ = jm.apply(params, jnp.asarray(ids), jnp.asarray(px))
    with torch.no_grad():
        t, v, logits = tm(torch.from_numpy(ids), torch.from_numpy(px))
    _close(t, jt_)
    _close(v, jv_)
    _close(logits, jl_)
    assert logits.shape == (3, 4)
    np.testing.assert_allclose(t.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def _tiny_hf():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.SiglipConfig(text_config=dict(TEXT),
                                    vision_config=dict(VISION))
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    hf = transformers.SiglipModel(cfg).eval()
    with torch.no_grad():  # a non-trivial scale and bias
        hf.logit_scale.fill_(0.7)
        hf.logit_bias.fill_(-0.3)
    return hf


def test_hf_converter_matches_the_jax_converter():
    """An HF state dict through the port's converter equals the JAX
    converter's tree carried by the Flax converter, tensor for tensor;
    the port's model on it answers as HF's and as JAX's."""
    hf = _tiny_hf()
    state = hf.state_dict()
    via_hf = siglip_state_from_hf(state)
    via_flax = siglip_params_from_flax(
        jsig.siglip_params_from_state_dict(
            {k: v.numpy() for k, v in state.items()}))
    assert sorted(via_hf) == sorted(via_flax)
    for k in via_hf:
        assert torch.equal(via_hf[k], via_flax[k]), k
    _, _, tt, tv = _configs()
    tm = tsig.SiglipModel(tt, tv)
    assert sorted(tm.state_dict()) == sorted(via_hf)
    tm.load_state_dict(via_hf)
    tm.eval()
    rng = np.random.default_rng(10)
    ids = rng.integers(1, 99, (2, 16))
    px = rng.normal(size=(2, 3, 24, 24)).astype(np.float32)
    with torch.no_grad():
        out = hf(input_ids=torch.tensor(ids),
                 pixel_values=torch.tensor(px))
        t, v, logits = tm(torch.tensor(ids),
                          torch.tensor(px.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(logits.numpy(),
                               out.logits_per_image.numpy(), atol=1e-4,
                               rtol=1e-4)
    jt, jv, _, _ = _configs()
    jm = jsig.SiglipModel(jt, jv)
    jt_, jv_, jl_ = jm.apply(jsig.siglip_params_from_state_dict(
        {k: v.numpy() for k, v in state.items()}), jnp.asarray(ids),
        jnp.asarray(px.transpose(0, 2, 3, 1)))
    _close(t, jt_)
    _close(v, jv_)
    _close(logits, jl_)


def _embedders(model_pair):
    jm, params, tm = model_pair
    jt, jv, tt, tv = _configs()
    je = jsig.SiglipEmbedder(jt, jv, params,
                             tokenizer=jtok.HashTokenizer(99), pad_id=1)
    te = tsig.SiglipEmbedder(tt, tv, tm,
                             tokenizer=ttok.HashTokenizer(99), pad_id=1,
                             device="cpu")
    return je, te


@pytest.mark.parametrize("eager", [False, True])
def test_embedder_matches_jax(model_pair, eager):
    """Texts padded to 16 with the pad id and no mask, images as
    preprocessed arrays, both as JAX's embedder embeds them."""
    je, te = _embedders(model_pair)
    np.testing.assert_array_equal(
        te.text_ids(TEXTS),
        np.asarray([[*jtok.HashTokenizer(99).encode(t, max_length=16).ids,
                     *[1] * 16][:16] for t in TEXTS]))
    got = te.embed_text(TEXTS, eager=eager)
    np.testing.assert_allclose(got, je.embed_text(TEXTS), atol=TOL,
                               rtol=TOL)
    assert te.last_graph == "eager"
    px = _pixels(2, seed=11)
    np.testing.assert_allclose(te.embed_image(px, eager=eager),
                               je.embed_image(px), atol=TOL, rtol=TOL)
    assert got.dtype == np.float32 and got.shape == (4, 32)
    keys = te.graphs.keys()
    assert keys == (set() if eager else {("text", 4), ("image", 2)})


def test_embedder_with_no_tokenizer_refuses_text(model_pair):
    _, _, tm = model_pair
    _, _, tt, tv = _configs()
    te = tsig.SiglipEmbedder(tt, tv, tm, device="cpu")
    with pytest.raises(ValueError, match="no tokenizer"):
        te.embed_text(["x"])


@pytest.mark.parametrize("shape, size", [
    ((100, 80, 3), 24), ((24, 24, 3), 24), ((7, 300, 3), 24),
    ((50, 50, 3), 224)])
def test_preprocess_image_equals_jax(shape, size):
    img = np.random.default_rng(12).integers(0, 256, shape).astype(np.uint8)
    got = tsig.preprocess_image(img, size)
    want = jsig.preprocess_image(img, size)
    assert got.dtype == want.dtype and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


def _png(size, color=None, mode="RGB") -> bytes:
    Image = pytest.importorskip("PIL.Image")
    if color is None:
        arr = np.random.default_rng(sum(size)).integers(
            0, 256, (size[1], size[0], 3)).astype(np.uint8)
        im = Image.fromarray(arr).convert(mode)
    else:
        im = Image.new(mode, size, color)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("form", ["base64_uri", "bare_base64", "percent",
                                  "rgba", "gray"])
def test_decode_image_ref_equals_jax(form, model_pair):
    if form == "rgba":
        raw = _png((5, 3), (10, 20, 30, 128), mode="RGBA")
    elif form == "gray":
        raw = _png((6, 6), 77, mode="L")
    else:
        raw = _png((9, 7))
    b64 = base64.b64encode(raw).decode()
    ref = {"base64_uri": f"data:image/png;base64,{b64}",
           "bare_base64": b64,
           "percent": "data:image/png," + quote_from_bytes(raw)}.get(
        form, f"data:image/png;base64,{b64}")
    got = tsig.decode_image_ref(ref)
    want = jsig.decode_image_ref(ref)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    je, te = _embedders(model_pair)
    np.testing.assert_allclose(te.embed_image_refs([ref, ref]),
                               je.embed_image_refs([ref, ref]), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("ref", ["http://example.com/x.png",
                                 "https://example.com/x.png",
                                 "data:image/png;base64"])
def test_decode_image_ref_refusals_equal_jax(ref):
    msgs = []
    for mod in (tsig, jsig):
        with pytest.raises(ValueError) as exc:
            mod.decode_image_ref(ref)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_embedder_without_a_device_argument_needs_cuda(model_pair):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, _, tm = model_pair
    _, _, tt, tv = _configs()
    with pytest.raises(RuntimeError):
        tsig.SiglipEmbedder(tt, tv, tm)
