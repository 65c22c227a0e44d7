"""The retrieval plane on the card, cut to tiny sizes: the ANN bank's
views live on the card (float32, bfloat16, int8 with its scale) and its
top-k step gives the CPU port's slots (near ties aside) with scores
within 1e-5 at every mode, equal scores ranking the lower slot first; an
``AnnVectorStore`` on the card embeds each chunk at ingest and each query
at search through K1 (one launch a layer) and returns the CPU port's
hits; the shared semantic cache with the ANN plane owning similarity
finds a paraphrase through the card's bank.  ``cuda``-marked: skips
without a GPU.  Imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_retrieval_cuda.py``; chip_smoke.py's phase 16 does)."""

import numpy as np
import pytest
import torch

from semantic_router_tpu_torch.ann import AnnIndex, DeviceBank, \
    TopKPrograms, normalize_ann, normalize_rows
from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.engine.testing import TINY, init_weights
from semantic_router_tpu_torch.models import MmBertEmbeddingModel, \
    ModernBertConfig
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.stateplane import SharedSemanticCache, \
    StatePlane, build_backend
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer
from semantic_router_tpu_torch.vectorstore.ann_store import AnnVectorStore

SCORE_TOL = 1e-5
TIE_GAP = 1e-5
EMBED_TOL = 1e-4
DOCS = [
    "Boil the water before adding pasta. Salt the water well.",
    "The borrow checker enforces ownership. A value has one owner.",
    "Night trains cross Europe. Sleeper cabins hold two berths.",
    "Estimated taxes are due four times a year. Keep receipts.",
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bank's views live on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _rows(n, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, dim)).astype(np.float32)
    return normalize_rows(centers[rng.integers(0, 32, n)]
                          + 0.05 * rng.standard_normal((n, dim))
                          .astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_bank_on_card_matches_cpu(cuda_device, mode):
    rows = _rows(4096, 64, seed=1)
    rows[100:104] = rows[99]  # exact duplicates: ties
    ids = [f"r{i}" for i in range(len(rows))]
    views = {}
    for dev in (cuda_device, "cpu"):
        bank = DeviceBank(dim=64, min_capacity=16, mode=mode,
                          recall_floor=0.0, device=dev)
        bank.extend(ids, rows)
        for i in range(0, 4096, 97):
            bank.delete(f"r{i}")
        views[dev] = bank.publish()
    card = views[cuda_device]
    held = card.qbank if mode == "int8" else card.bank_t
    assert held.device.type == "cuda"
    assert held.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                          "int8": torch.int8}[mode]
    assert card.recall == views["cpu"].recall
    queries = np.concatenate([rows[99:100], _rows(15, 64, seed=2)])
    for nq in (1, 16):
        ts, ti = TopKPrograms().run(card, queries[:nq], 8)
        cs, ci = TopKPrograms().run(views["cpu"], queries[:nq], 8)
        assert ts.dtype == np.float32
        np.testing.assert_allclose(ts, cs, atol=SCORE_TOL)
        gaps = np.abs(np.diff(cs, axis=1)) < TIE_GAP
        near = np.zeros_like(ci, bool)
        near[:, 1:] |= gaps & (cs[:, 1:] != cs[:, :-1])
        near[:, :-1] |= gaps & (cs[:, 1:] != cs[:, :-1])
        assert (ti[~near] == ci[~near]).all()
    # the duplicates of row 99 rank by slot on the card too
    assert ti[0][:5].tolist() == [99, 100, 101, 102, 103]


def _embedding_engine(device):
    module = MmBertEmbeddingModel(ModernBertConfig(**TINY,
                                                   attention_impl="flash"))
    init_weights(module, 7)
    engine = InferenceEngine(InferenceEngineConfig(), device=device)
    engine.register_task("embedding", "embedding", module,
                         HashTokenizer(vocab_size=TINY["vocab_size"]), [],
                         max_seq_len=128)
    return engine


def _store(device, engine):
    embed = lambda text: engine.embed("embedding", [text])[0]
    idx = AnnIndex("vs:kb", normalize_ann({"enabled": True,
                                           "min_capacity": 16}),
                   TopKPrograms(), device=device)
    return AnnVectorStore(idx, embed_fn=embed, chunk_sentences=1,
                          overlap_sentences=0), idx


@pytest.mark.cuda
def test_ann_store_embeds_through_k1(cuda_device):
    card, cpu = _embedding_engine(cuda_device), _embedding_engine("cpu")
    stores = {}
    layers = TINY["num_hidden_layers"]
    try:
        for dev, eng in ((cuda_device, card), ("cpu", cpu)):
            store, idx = _store(dev, eng)
            stores[dev] = (store, idx)
            _cuda.reset_launch_counts()
            for i, text in enumerate(DOCS):
                store.ingest(f"d{i}", text, metadata={"source": f"d{i}"})
            chunks = len(store.chunks)
            if dev == cuda_device:
                assert _cuda.launch_counts()["flash_attention"] \
                    == chunks * layers
            idx.flush()
        card_view = stores[cuda_device][1].bank.view()
        assert card_view.bank_t.device.type == "cuda"
        for q in ("how long to boil pasta", "sleeper cabins on trains"):
            _cuda.reset_launch_counts()
            got = stores[cuda_device][0].search(q, top_k=2)
            assert _cuda.launch_counts()["flash_attention"] == layers
            want = stores["cpu"][0].search(q, top_k=2)
            assert [h.chunk.metadata["source"] for h in got] \
                == [h.chunk.metadata["source"] for h in want]
            np.testing.assert_allclose([h.score for h in got],
                                       [h.score for h in want],
                                       atol=EMBED_TOL)
    finally:
        for store, idx in stores.values():
            idx.close()
        card.shutdown()
        cpu.shutdown()


@pytest.mark.cuda
def test_shared_cache_similarity_on_the_card(cuda_device):
    engine = _embedding_engine(cuda_device)
    embed = lambda text: engine.embed("embedding", [text])[0]
    plane = StatePlane(build_backend({"backend": "memory"}),
                       replica_id="c", namespace="cuda16")
    idx = AnnIndex("cache", normalize_ann({"enabled": True,
                                           "min_capacity": 16}),
                   TopKPrograms(), device=cuda_device)
    try:
        q = "how do I rotate the api credentials for billing"
        e = engine.embed("embedding", [q, q + " please"])
        cache = SharedSemanticCache(plane, embed,
                                    similarity_threshold=float(
                                        e[0] @ e[1]) - 0.05)
        cache.attach_ann(idx)
        cache.add(q, "rotate them in the console", model="m")
        idx.flush()
        assert idx.bank.view().bank_t.device.type == "cuda"
        assert cache.similarity_owner() == "ann"
        hit = cache.find_similar(q + " please")
        assert hit is not None and hit.response == "rotate them in the " \
                                                   "console"
    finally:
        idx.close()
        plane.close()
        engine.shutdown()
